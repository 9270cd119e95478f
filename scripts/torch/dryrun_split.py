"""One dry-run cell's per-rank FLOPs and collective bytes split by op and
call site: where a rank does or sends more than its share.

    PYTHONPATH=src python scripts/torch/dryrun_split.py --arch rwkv6-3b \\
        --shape prefill_32k --layers 1 [--multi-pod] [--top 20]

Traces the cell as ``launch.dryrun`` does, as rank 0 of a ``"fake"`` world
of 256 ranks (512 with ``--multi-pod``) on meta tensors, with the config
cut to ``--layers`` layers (full width; zamba2-7b's ``attn_every`` period
is 6), and adds each op's FLOPs under (op, the autograd node running it or
``fwd``, the innermost ``repro_torch/models`` or ``training`` line that
called it and its caller, past the per-rank helpers of
``models/common.py``, the operands' local shapes), and each collective's
bytes (as ``op_cost`` charges them) under (kind, node, site, shapes).
Prints the totals, the collective bytes by kind, and the largest entries
of each.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import logging
import os
import traceback

import torch

SITES = ("repro_torch/models", "repro_torch/training")
COMMON = os.path.join("repro_torch", "models", "common.py")


def _site() -> str:
    """The two innermost model lines on the stack, inner first, past the
    per-rank helpers of ``models/common.py`` (``gather``, ``psum``,
    ``recut``, ...), so that a collective names the line that asked."""
    frames = [f for f in traceback.extract_stack()
              if any(s in f.filename for s in SITES)
              and not f.filename.endswith(COMMON)]
    return "<".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                    for f in frames[:-3:-1]) or "?"


def split(arch: str, shape: str, layers: int, world: int):
    """(the cell's ``Cost``, Counter of FLOPs by (op, node, site, shapes),
    Counter of collective bytes by (kind, node, site, shapes)); this
    process must be rank 0 of a world of ``world`` ranks."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline import op_cost
    flops, coll = collections.Counter(), collections.Counter()
    dispatch = op_cost._Record.__torch_dispatch__

    def counted(self, func, types, args=(), kwargs=None):
        before = self.cost.flops
        sent = dict(self.cost.collectives)
        out = dispatch(self, func, types, args, kwargs)
        added = self.cost.flops - before
        moved = {k: v - sent[k] for k, v in self.cost.collectives.items()
                 if v != sent[k]}
        if (added or moved) and not self.inner:
            node = torch._C._current_autograd_node()
            node = type(node).__name__ if node else "fwd"
            shapes = tuple(tuple(a.shape) for a in args
                           if isinstance(a, torch.Tensor))
            if added:
                flops[(func.__name__, node, _site(), shapes)] += added
            for kind, n in moved.items():
                coll[(kind, node, _site(), shapes)] += n
        return out
    op_cost._Record.__torch_dispatch__ = counted
    try:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        mesh = make_production_mesh(multi_pod=world == 512,
                                    torch_device="cpu")
        traced, _, _ = dryrun._lower(cfg, SHAPES[shape], mesh)
    finally:
        op_cost._Record.__torch_dispatch__ = dispatch
    return traced.cost, flops, coll


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    from repro_torch.launch.dryrun import init_fake_world
    world = 512 if args.multi_pod else 256
    init_fake_world(world)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    cost, flops, coll = split(args.arch, args.shape, args.layers, world)
    print(f"{args.arch} x {args.shape}, {args.layers} layers, world "
          f"{world}: {cost.flops:.4e} FLOPs a rank; collective bytes "
          + ", ".join(f"{k} {v:.3e}" for k, v in cost.collectives.items()))
    for (op, node, site, shapes), n in flops.most_common(args.top):
        print(f"{n:.3e}  {op}  {node}  {site}  {shapes}")
    print("collective bytes:")
    for (kind, node, site, shapes), n in coll.most_common(args.top):
        print(f"{n:.3e}  {kind}  {node}  {site}  {shapes}")
    return cost, flops, coll


if __name__ == "__main__":
    main()
