"""Cost of one eager run, counted op by op (the counterpart of the
reference's ``roofline.hlo_cost``, which walks XLA's optimized HLO; torch
eager has no HLO, so the port counts what actually executes).

``analyze(fn, *args, **kwargs)`` runs ``fn`` once and records:

  flops: ``torch.utils.flop_counter``'s formulas over every executed op,
         by ``FlopCounterMode``'s rules (matrix products, convolutions,
         attention; elementwise ops count 0, where the reference charges 1
         an element). Every
         executed op counts, so a Python loop counts by its trips, which is
         what ``hlo_cost`` works out for ``while`` loops from their trip
         counts, and a backward under activation checkpointing counts the
         recomputed forward.
  bytes: the operand and result bytes of each executed aten op that is
         not a view (a ``TorchDispatchMode`` sees every op). This is the
         eager counterpart of the reference's "operand+output sizes at
         fusion boundaries": eager runs no fusion, so every op is a
         boundary and the count is an upper bound on HBM traffic.
  collectives: per-kind bytes of the ``c10d`` / functional collectives
         in the same dispatch record (the ops
         ``torch.distributed.tensor.debug.CommDebugMode`` names), each
         charged the larger of what it sends and what it returns, as
         ``hlo_cost`` charges ``max(operand, result)``: an all-gather its
         gathered result, a reduce-scatter its operand, an all-reduce,
         an all-to-all and a send the tensor they take.
  peak_bytes: the most bytes the run's own allocations held at once, the
         counterpart of XLA's ``temp_size_in_bytes``, counted by storage:
         a storage counts once, from the op that allocated it (a result
         that is not a view and shares no input's storage) until the
         storage itself is freed (a ``weakref`` finalizer on it), however
         many tensors alias it and whichever of them lives longest. A
         functional collective's wrapper (``_wrap_tensor_autograd``,
         ``wait_tensor``) returns its input's storage on a real rank; on
         meta tensors its kernel returns a fresh one and lets the input
         go, so there the bytes move to the wrapper's result, which a
         real rank holds as the collective's. The arguments ``fn`` was
         given are not included; the step's own outputs (a train step's
         new state) are. This follows the allocator's count of the run's
         bytes.

Counts are per process, which on DTensors is per rank: the recorder
declines the ops whose arguments are DTensors, so it counts the local
ops DTensor runs on the rank's shards and the collectives it runs for
them, never the global op. DTensor's sharding propagation runs each op
once more on fake tensors of the GLOBAL shape; ops on fake tensors pass
through uncounted. So a run to be counted holds real or meta tensors
(the dry-run's are meta), not fake ones.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: a collective op's name fragment -> its kind
_KIND_OF = (("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
            ("allgather", "all-gather"), ("all_gather", "all-gather"),
            ("reduce_scatter", "reduce-scatter"),
            ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
            ("send", "collective-permute"))

#: ops that alias their input without their schema saying so, and the
#: functional collectives' wrappers, which move no data
_VIEWS = (torch.ops.aten._unsafe_view,)
_WRAPPERS = ("wait_tensor", "_wrap_tensor_autograd")


def _is_wrapper(func) -> bool:
    return (func.namespace == "_c10d_functional" and
            func.__name__.split(".")[0] in _WRAPPERS)


def _is_view(func) -> bool:
    return (func.is_view or func.overloadpacket in _VIEWS or
            _is_wrapper(func))


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    peak_bytes: float = 0.0


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


def _collective_bytes(func, args, out) -> int:
    """A collective's charge: the larger of the bytes it sends and those
    of its result. ``c10d``'s gather / scatter / all-to-all ops take
    (outputs, inputs, ...) and every other ``c10d`` op works in place on
    its first argument; a functional op takes its inputs first and
    returns its result."""
    name = func.__name__
    if func.namespace != "c10d":
        return max(_nbytes(args[0]), _nbytes(out))
    if any(f in name for f in ("allgather", "reduce_scatter", "alltoall")):
        return max(_nbytes(args[1]), _nbytes(args[0]))
    return _nbytes(args[0])


def _subclass_types():
    """(DTensor, FakeTensor); DTensor is None where torch lacks it."""
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:                     # torch built without distributed
        DTensor = None
    from torch._subclasses.fake_tensor import FakeTensor
    return DTensor, FakeTensor


_DECOMPOSES: dict = {}


def _decomposes(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd kernel, the ops
    ``FlopCounterMode`` counts by their decomposition."""
    if func not in _DECOMPOSES:
        _DECOMPOSES[func] = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), "CompositeImplicitAutograd")
    return _DECOMPOSES[func]


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _Record(TorchDispatchMode):
    """Counts every op it runs. FLOPs follow ``FlopCounterMode``'s rules:
    ``flop_registry``'s formula for an op it lists, and an op with a
    decomposition counted by its parts (whose bytes the op's own count
    already holds)."""

    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost
        self.live = 0
        self.counted = weakref.WeakKeyDictionary()  # storage -> finalizer
        self.inner = 0
        self.dtensor, self.fake = _subclass_types()

    def _free(self, n: int) -> None:
        self.live -= n

    def _hold(self, func, ins, outs) -> None:
        """The storages ``func`` allocated for ``outs`` live until freed.
        A view's, an in-place result's and an ``out=`` result's storage is
        an input's, counted where it was allocated (or an argument's)."""
        if _is_wrapper(func):
            self._move(ins, outs)
            return
        if _is_view(func):
            return
        theirs = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if id(st) in theirs or st in self.counted:
                continue
            n = st.nbytes()
            self.live += n
            self.counted[st] = weakref.finalize(st, self._free, n)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)

    def _move(self, ins, outs) -> None:
        """A collective's wrapper moves no data: where its result is a
        plain tensor on another storage (the meta kernel's
        ``empty_like``), the bytes counted for the input's storage follow
        the result's. A real rank's ``AsyncCollectiveTensor`` wraps the
        input itself."""
        for i, o in zip(ins, outs):
            if type(o) is not torch.Tensor:
                continue
            src, dst = i.untyped_storage(), o.untyped_storage()
            fin = self.counted.get(src)
            if dst is src or dst in self.counted or fin is None or \
                    not fin.alive:
                continue
            _, _, (n,), _ = fin.detach()
            self.counted[dst] = weakref.finalize(dst, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.dtensor is not None and any(
                issubclass(t, self.dtensor) for t in types):
            return NotImplemented           # DTensor runs the local ops
        if any(issubclass(t, self.fake) for t in types):
            return func(*args, **kwargs)    # sharding propagation
        out = None
        if func is not torch.ops.prim.device.default and \
                func.overloadpacket not in flop_registry and \
                _decomposes(func):
            self.inner += 1
            try:
                with self:
                    out = func.decompose(*args, **kwargs)
            finally:
                self.inner -= 1
        if out is None or out is NotImplemented:
            out = func(*args, **kwargs)
            formula = flop_registry.get(func.overloadpacket)
            if formula is not None:
                self.cost.flops += formula(*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if any(isinstance(t, self.fake) for t in outs):
            return out                      # propagation's factories
        if self.inner:
            return out
        ins = _tensors((args, kwargs))
        kind = _collective_kind(func)
        if kind is not None:
            self.cost.collectives[kind] += _collective_bytes(func, args,
                                                             out)
        if not _is_view(func):
            self.cost.bytes += sum(t.numel() * t.element_size()
                                   for t in ins + outs)
        self._hold(func, ins, outs)
        return out


def analyze(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` once and count its cost."""
    cost = Cost()
    with _Record(cost):
        fn(*args, **kwargs)
    cost.flops = float(cost.flops)
    return cost
