"""A train step's per-rank temp bytes counted three ways on a (1, 2) mesh:
the CPU allocator's peak over the step on a gloo world of two processes,
``op_cost``'s count of the same step there, and ``op_cost``'s count of the
step traced as the dry-run traces it (rank 0 of a ``"fake"`` world on meta
tensors: the dry-run's temp GiB).

    PYTHONPATH=src python scripts/torch/temp_vs_allocator.py \\
        [--arch qwen3-0.6b] [--layers 2] [--seq 64] [--batch 4]

The config is the reduced one (``reduced(n_layers=...)``), its step
``make_train_step``'s with remat as configured. Runs on the CPU, one thread
a process: starts the two gloo ranks (on a free localhost port) and the
fake rank as child processes and prints one JSON line, bytes above what
each process held when the step began:
{"arch", "layers", "seq", "batch", "allocator", "op_cost_gloo",
"op_cost_fake"} (the gloo figures are lists, one a rank).
"""
from __future__ import annotations

import argparse
import gc
import json
import socket
import subprocess
import sys

import torch


def allocator_peak(fn) -> int:
    """The most bytes the CPU allocator held during ``fn()`` above what it
    held when ``fn`` began, from the profiler's allocation records."""
    from torch.profiler import ProfilerActivity, profile
    gc.collect()
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as p:
        fn()
    allocs = []

    def walk(node):
        f = node.extra_fields
        if type(f).__name__ == "_ExtraFields_Allocation":
            allocs.append((node.start_time_ns, f.alloc_size,
                           f.total_allocated))
        for c in node.children:
            walk(c)
    for root in p.profiler.kineto_results.experimental_event_tree():
        walk(root)
    allocs.sort()
    start = allocs[0][2] - allocs[0][1]
    return max(total for _, _, total in allocs) - start


def _cfg(arch: str, layers: int):
    from repro_torch.configs import get_config
    return get_config(arch).reduced(n_layers=layers)


def peaks_on(mesh, arch: str, layers: int, seq: int, batch: int) -> dict:
    """This rank's ``op_cost`` count of one train step on ``mesh``, a mesh
    of processes, and the allocator's peak over the same step run plainly
    (``analyze`` runs an op with a decomposition by its parts, whose
    results a plain run does not allocate), the least of three runs; all
    after a first step, whose one-time allocations are not the step's."""
    from repro_torch.distributed.sharding import (NamedSharding, batch_spec,
                                                  place_tree)
    from repro_torch.launch.dryrun import _state_shardings
    from repro_torch.launch.mesh import activate_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.roofline import analyze
    from repro_torch.training import init_train_state, make_train_step
    cfg = _cfg(arch, layers)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    state = place_tree(state, _state_shardings(mesh, cfg, state))
    g = torch.Generator().manual_seed(1)
    data = {k: NamedSharding(mesh, batch_spec(mesh, 2, batch)).place(
        torch.randint(0, cfg.vocab_size, (batch, seq), generator=g))
        for k in ("tokens", "labels")}
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), 10_000, 5)
    with activate_mesh(mesh):
        step(state, data)
    with activate_mesh(mesh):
        cost = analyze(step, state, data)

    def run():
        with activate_mesh(mesh):
            step(state, data)
    # the least of three: gloo's asynchronous collectives now and then hold
    # a buffer a little longer, which moves one rank's peak by up to 3%
    return {"allocator": min(allocator_peak(run) for _ in range(3)),
            "op_cost": int(cost.peak_bytes)}


def _gloo_rank(rank: int, port: int, a) -> None:
    import torch.distributed as dist

    from repro_torch.distributed import remesh
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    got = peaks_on(remesh([0, 1], 2, torch_device="cpu"), a.arch, a.layers,
                   a.seq, a.batch)
    every = [None, None]
    dist.all_gather_object(every, got)
    if rank == 0:
        print(json.dumps(every))
    dist.destroy_process_group()


def fake_peak(arch: str, layers: int, seq: int, batch: int) -> int:
    """``op_cost``'s count of one train step traced as the dry-run traces
    it, on meta tensors; this process must be rank 0 of a ``"fake"``
    world of two."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import remesh
    from repro_torch.launch.dryrun import _lower
    traced, _, _ = _lower(_cfg(arch, layers),
                          ShapeConfig("t", seq, batch, "train"),
                          remesh([0, 1], 2, torch_device="cpu"))
    return int(traced.cost.peak_bytes)


def _fake_rank(a) -> None:
    from repro_torch.launch.dryrun import init_fake_world
    init_fake_world(2)
    print(json.dumps(fake_peak(a.arch, a.layers, a.seq, a.batch)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--role", choices=("gloo", "fake"), help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.role:
        torch.set_num_threads(1)
        _gloo_rank(a.rank, a.port, a) if a.role == "gloo" else _fake_rank(a)
        return 0
    base = [sys.executable, __file__, "--arch", a.arch, "--layers",
            str(a.layers), "--seq", str(a.seq), "--batch", str(a.batch)]
    port = _free_port()
    procs = [subprocess.Popen(base + ["--role", "gloo", "--rank", str(r),
                                      "--port", str(port)],
                              stdout=subprocess.PIPE, text=True)
             for r in range(2)]
    procs.append(subprocess.Popen(base + ["--role", "fake"],
                                  stdout=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=900)[0] for p in procs]
    if any(p.returncode for p in procs):
        return 1
    gloo = json.loads(outs[0].strip().splitlines()[-1])
    print(json.dumps({"arch": a.arch, "layers": a.layers, "seq": a.seq,
                      "batch": a.batch,
                      "allocator": [r["allocator"] for r in gloo],
                      "op_cost_gloo": [r["op_cost"] for r in gloo],
                      "op_cost_fake": json.loads(
                          outs[2].strip().splitlines()[-1])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
