"""Cost of one eager run, counted op by op (the counterpart of the
reference's ``roofline.hlo_cost``, which walks XLA's optimized HLO; torch
eager has no HLO, so the port counts what actually executes).

``analyze(fn, *args, **kwargs)`` runs ``fn`` once and records:

  flops: ``torch.utils.flop_counter.FlopCounterMode`` over every executed
         op (matrix products, convolutions, attention; elementwise ops
         count 0, where the reference charges 1 an element). Every
         executed op counts, so a Python loop counts by its trips, which is
         what ``hlo_cost`` works out for ``while`` loops from their trip
         counts, and a backward under activation checkpointing counts the
         recomputed forward.
  bytes: the operand and result bytes of each executed aten op that is
         not a view (a ``TorchDispatchMode`` sees every op). This is the
         eager counterpart of the reference's "operand+output sizes at
         fusion boundaries": eager runs no fusion, so every op is a
         boundary and the count is an upper bound on HBM traffic.
  collectives: per-kind operand bytes of the ``c10d`` / functional
         collectives in the same dispatch record (the ops
         ``torch.distributed.tensor.debug.CommDebugMode`` names).

Counts are per process. On DTensors ``FlopCounterMode`` counts GLOBAL
FLOPs, so a per-device figure must come from a run on local tensors.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: a collective op's name fragment -> its kind
_KIND_OF = (("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
            ("allgather", "all-gather"), ("all_gather", "all-gather"),
            ("reduce_scatter", "reduce-scatter"),
            ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
            ("send", "collective-permute"))

#: ops that alias their input without their schema saying so
_VIEWS = (torch.ops.aten._unsafe_view,)


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _collective_kind(func) -> str | None:
    """The kind of a ``c10d`` / ``_c10d_functional`` op, or None."""
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional", "c10d_functional"):
        return None
    name = func.__name__
    for frag, kind in _KIND_OF:
        if frag in name:
            return kind
    return None


def _collective_operand(func, args):
    """The tensors a collective sends: ``c10d``'s gather / scatter /
    all-to-all ops take (outputs, inputs, ...), every other one takes its
    inputs first."""
    name = func.__name__
    if func.namespace == "c10d" and any(
            f in name for f in ("allgather", "reduce_scatter", "alltoall")):
        return args[1]
    return args[0]


class _Record(TorchDispatchMode):
    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _collective_kind(func)
        if kind is not None:
            self.cost.collectives[kind] += _nbytes(
                _collective_operand(func, args))
        if not (func.is_view or func.overloadpacket in _VIEWS):
            self.cost.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def analyze(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` once and count its cost."""
    cost = Cost()
    with FlopCounterMode(display=False) as flops, _Record(cost):
        fn(*args, **kwargs)
    cost.flops = float(flops.get_total_flops())
    return cost

