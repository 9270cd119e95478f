"""Multi-pod dry-run (the reference's ``launch.dryrun``): trace every
(arch x shape x mesh) cell on shape-only inputs (no allocation) and record
the per-rank memory, cost and collectives for the roofline table.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape train_4k [--multi-pod] [--torch-device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --torch-device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --ising chip64 \\
        --torch-device cpu

Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json
(``--out`` names another directory).

The reference forces 512 XLA host devices and lowers and compiles each
cell. Here the process is rank 0 of a ``"fake"`` ``torch.distributed``
world of 256 ranks (512 with ``--multi-pod``), and the mesh is
``make_production_mesh``'s. One process holds one world, so
``--both-meshes`` and ``--all`` run each mesh in child processes, all at
once (``--all`` deals its cells to one child a host core). A cell's
state, parameters, cache and batch are meta tensors
(``pytree.eval_shape``); each rank's shard is a meta tensor of its fitted
spec's local shape, wrapped by ``DTensor.from_local`` (no scatter, so no
collective the reference would not count). One step is traced under the
mesh (whose ``activate_mesh`` counts the models' plain tables as
replicated) and counted per rank by ``roofline.op_cost.analyze``. Eager
torch has no compile step: a record holds ``trace_s``, the wall of
building and tracing the cell, in place of the reference's ``lower_s`` /
``compile_s``. The trace runs on meta tensors whatever ``--torch-device``
says; the device names the mesh's device type and keeps the port's rule
(CUDA unless the CPU is asked for).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import subprocess
import sys
import time
import traceback

import torch

from ..configs import ISING_SHAPES, SHAPES, cells, get_config
from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from ..distributed.sharding import (NamedSharding, batch_axes, batch_spec,
                                    cache_shardings, param_shardings)
from ..models import build, cache_specs, input_specs
from ..pytree import eval_shape, leaves, unflatten
from ..roofline import HW, analyze, model_flops, roofline_report
from ..training.steps import init_train_state, make_train_step
from .mesh import activate_mesh, make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


@dataclasses.dataclass
class Traced:
    """One traced step (the counterpart of the reference's compiled
    executable): its per-rank ``Cost`` and the local bytes of its
    arguments."""
    cost: object
    argument_bytes: int


def _mesh_tag(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def _state_shapes(cfg: ModelConfig):
    """The ``TrainState`` as meta tensors (``eval_shape``: nothing drawn,
    nothing allocated)."""
    return eval_shape(init_train_state, cfg, torch.Generator().manual_seed(0),
                      "cpu")


def _param_shapes(cfg: ModelConfig):
    return eval_shape(build(cfg).init, torch.Generator().manual_seed(0),
                      "cpu")


def _state_shardings(mesh, cfg: ModelConfig, state_shapes):
    """The moments follow their parameters' rule, the steps replicate."""
    return param_shardings(mesh, cfg, state_shapes)


def _batch_shardings(mesh, batch_shapes, global_batch: int) -> dict:
    return {k: NamedSharding(mesh, batch_spec(mesh, v.ndim, global_batch))
            for k, v in batch_shapes.items()}


def _local_shape(shape, sharding) -> tuple:
    local = list(shape)
    for i, entry in enumerate(sharding.spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                local[i] //= sharding.mesh.shape[a]
    return tuple(local)


def _placed(tree, shardings):
    """``tree``'s meta leaves laid out by ``shardings`` without moving a
    byte: on a mesh of processes each becomes a DTensor over this rank's
    meta shard of the spec's local shape; on a virtual mesh it stays
    whole."""
    from torch.distributed.tensor import DTensor
    out = []
    for t, s in zip(leaves(tree), leaves(shardings)):
        if isinstance(t, torch.Tensor) and s.mesh.device_mesh is not None:
            local = torch.empty(_local_shape(t.shape, s), dtype=t.dtype,
                                device="meta")
            t = DTensor.from_local(local, s.mesh.device_mesh, s.placements,
                                   run_check=False, shape=t.shape,
                                   stride=t.stride())
        out.append(t)
    return unflatten(tree, out)


def _local_bytes(*trees) -> int:
    total = 0
    for t in leaves(trees):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if hasattr(t, "to_local") else t
            total += t.numel() * t.element_size()
    return total


def _trace(fn, args, shardings, mesh) -> Traced:
    """``fn(*args)`` traced once under ``mesh`` on ``args`` placed by
    ``shardings``, counted per rank."""
    placed = [_placed(a, s) for a, s in zip(args, shardings)]
    with activate_mesh(mesh):
        cost = analyze(fn, *placed)
    return Traced(cost, _local_bytes(*placed))


def _lower(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """One cell of ``cfg`` at ``shape`` traced on ``mesh``: (Traced, the
    parameter tree's shapes, the trace's wall seconds)."""
    model = build(cfg)
    t0 = time.perf_counter()
    if shape.kind == "train":
        state = _state_shapes(cfg)
        batch = input_specs(cfg, shape)
        traced = _trace(make_train_step(cfg), (state, batch),
                        (_state_shardings(mesh, cfg, state),
                         _batch_shardings(mesh, batch, shape.global_batch)),
                        mesh)
        params = state.params
    elif shape.kind == "prefill":
        params = _param_shapes(cfg)
        batch = input_specs(cfg, shape)
        fn = model.prefill if model.prefill is not None else model.forward
        traced = _trace(fn, (params, batch),
                        (param_shardings(mesh, cfg, params),
                         _batch_shardings(mesh, batch, shape.global_batch)),
                        mesh)
    else:                                              # decode
        params = _param_shapes(cfg)
        cache = cache_specs(cfg, shape)
        toks = input_specs(cfg, shape)
        traced = _trace(
            lambda p, c, t: model.decode_step(p, c, t["tokens"]),
            (params, cache, toks),
            (param_shardings(mesh, cfg, params),
             cache_shardings(mesh, cfg, cache, shape.global_batch),
             _batch_shardings(mesh, toks, shape.global_batch)), mesh)
    return traced, params, time.perf_counter() - t0


def lower_cell(arch: str, shape_name: str, mesh):
    """Trace one cell. Returns (Traced, aux dict). ``trace_s`` stands where
    the reference records ``lower_s`` and ``compile_s``: eager torch
    builds and traces, and compiles nothing. The train step's state is
    not donated (torch has no counterpart); it is a new state."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    traced, params, trace_s = _lower(cfg, shape, mesh)
    return traced, {"arch": arch, "shape": shape_name,
                    "mesh": _mesh_tag(mesh), "kind": shape.kind,
                    "trace_s": trace_s,
                    "model_flops": model_flops(cfg, shape, params),
                    "chips": math.prod(mesh.sizes)}


def _memory_analysis(traced: Traced) -> dict:
    """Per-rank bytes: the arguments' local shards (state or parameters,
    cache, batch) and ``op_cost``'s estimate of the peak of live results,
    XLA's ``temp_size_in_bytes``."""
    return {"argument_size_in_bytes": int(traced.argument_bytes),
            "temp_size_in_bytes": int(traced.cost.peak_bytes)}


def _report(name: str, tag: str, result: dict, out_dir: str | None) -> None:
    rep, mem = result["roofline"], result["memory"]
    print(f"[dryrun] {name} x {result['shape']} x {tag}: "
          f"trace {result['trace_s']:.1f}s "
          f"dominant={rep['dominant']} "
          f"t=(C {rep['t_compute_s']*1e3:.2f} | M {rep['t_memory_s']*1e3:.2f}"
          f" | X {rep['t_collective_s']*1e3:.2f}) ms "
          f"frac={rep.get('roofline_fraction', 0):.3f}", flush=True)
    arg_gb = mem["argument_size_in_bytes"] / 2**30
    tmp_gb = mem["temp_size_in_bytes"] / 2**30
    hbm = HW().hbm_bytes
    print(f"         memory: args {arg_gb:.2f} GiB temp {tmp_gb:.2f} GiB "
          f"(per rank, {'OK' if (arg_gb + tmp_gb) * 2**30 < hbm else 'OVER'}"
          f" vs {hbm / 2**30:.0f} GiB HBM)", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir, f"{name}__{result['shape']}__{tag}.json")
        with open(fn, "w") as f:
            json.dump(result, f, indent=1)


def run_cell(arch: str, shape_name: str, multi_pod: bool, save: bool = True,
             torch_device: str | torch.device = "cuda",
             out_dir: str = OUT_DIR) -> dict:
    """One cell on the production mesh of this process's world."""
    mesh = make_production_mesh(multi_pod=multi_pod,
                                torch_device=torch_device)
    traced, aux = lower_cell(arch, shape_name, mesh)
    result = {**aux, "memory": _memory_analysis(traced),
              "roofline": roofline_report(
                  traced.cost, HW(), chips=aux["chips"],
                  model_flops_total=aux["model_flops"])}
    _report(arch, aux["mesh"], result, out_dir if save else None)
    return result


# --------------------------------------------------------------------------
# Ising solve-step dry-run (the paper's own arch on the production mesh)
# --------------------------------------------------------------------------

def _lower_ising(n: int, problems: int, runs: int, dev, mesh, layout: str):
    """The plain scan ``core.annealer.anneal`` of (problems, runs, n) traced
    on ``mesh`` in ``layout``: 'runs' shards runs over 'model' and
    replicates J within a data shard; 'spins' shards the spin axis. The
    CUDA kernel does not run on meta tensors, nor does the reference's
    dry-run lower its Pallas kernel. Returns (Traced, wall seconds)."""
    from ..core import DEFAULT_PERTURBATION, anneal
    t0 = time.perf_counter()
    bax = batch_axes(mesh) or None
    if layout == "spins":
        j_spec, v_spec = (bax, "model", None), (bax, None, "model")
    else:
        j_spec, v_spec = (bax, None, None), (bax, "model", None)
    J = torch.empty((problems, n, n), dtype=torch.float32, device="meta")
    v0 = torch.empty((problems, runs, n), dtype=torch.float32, device="meta")
    traced = _trace(lambda J, v: anneal(J, v, dev, DEFAULT_PERTURBATION),
                    (J, v0), (NamedSharding(mesh, j_spec),
                              NamedSharding(mesh, v_spec)), mesh)
    return traced, time.perf_counter() - t0


def _ising_model_flops(n: int, problems: int, runs: int, dev) -> float:
    """Useful FLOPs: 2*N^2*R*P per step * n_steps (the coupling matvec)."""
    return 2.0 * n * n * runs * problems * dev.n_steps


def run_ising_cell(shape_key: str, multi_pod: bool, save: bool = True,
                   layout: str | None = None,
                   torch_device: str | torch.device = "cuda",
                   out_dir: str = OUT_DIR) -> dict:
    """Ising solve-step dry-run.

    layout='spins' (the first-cut baseline) shards the spin axis over
    'model': every Euler step all-gathers the quantized spin vector.
    layout='runs' shards RUNS over 'model': J is replicated within a data
    shard and every anneal step is local, with zero inner-loop
    collectives, as each die of the chip owns whole problems. The choice
    is automatic as in the reference: 'runs' while n <= 1024.
    """
    from ..core import DeviceModel
    spec = ISING_SHAPES[shape_key]
    n, problems, runs = spec["n_spins"], spec["problems"], spec["runs"]
    if layout is None:
        layout = "runs" if n <= 1024 else "spins"
    dev = DeviceModel(n_spins=n, compute_dtype="bfloat16")
    mesh = make_production_mesh(multi_pod=multi_pod,
                                torch_device=torch_device)
    traced, trace_s = _lower_ising(n, problems, runs, dev, mesh, layout)
    mf = _ising_model_flops(n, problems, runs, dev)
    chips = math.prod(mesh.sizes)
    result = {"arch": f"ising-{shape_key}", "shape": shape_key,
              "mesh": _mesh_tag(mesh), "kind": "solve", "layout": layout,
              "trace_s": trace_s, "model_flops": mf, "chips": chips,
              "memory": _memory_analysis(traced),
              "roofline": roofline_report(traced.cost, HW(), chips=chips,
                                          model_flops_total=mf)}
    _report(f"ising-{shape_key}", result["mesh"], result,
            out_dir if save else None)
    return result


# --------------------------------------------------------------------------
# Command line
# --------------------------------------------------------------------------

def init_fake_world(size: int) -> None:
    """This process as rank 0 of a ``"fake"`` world of ``size`` ranks: no
    peer exists and no collective moves a byte."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _world_size(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def _all_tasks() -> list:
    """``--all``'s cells: ``configs.cells()`` (its skips are the
    reference's), then every Ising shape."""
    return ([(arch, shape) for arch, shape, _ in cells()] +
            [("ising", key) for key in ISING_SHAPES])


def _run_in_world(args) -> int:
    """This process's one world: every cell asked for, failures listed."""
    init_fake_world(_world_size(args.multi_pod))
    # DTensor warns at every fake all-to-all and two-axis all-reduce
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    logging.getLogger("torch._logging").setLevel(logging.ERROR)
    kw = {"torch_device": args.torch_device, "out_dir": args.out}
    if args.ising:
        run_ising_cell(args.ising, args.multi_pod, **kw)
        return 0
    if not args.all:
        run_cell(args.arch, args.shape, args.multi_pod, **kw)
        return 0
    part, parts = (int(n) for n in args.part.split("/"))
    failures = []
    for arch, key in _all_tasks()[part::parts]:
        try:
            if arch == "ising":
                run_ising_cell(key, args.multi_pod, **kw)
            else:
                run_cell(arch, key, args.multi_pod, **kw)
        except Exception as e:               # listed, and the run exits 1
            traceback.print_exc()
            failures.append((arch, key, args.multi_pod, str(e)))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("\nall dry-run cells traced OK")
    return 0


def _child_argv(args, multi_pod: bool, part: str) -> list:
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--one-world",
            "--torch-device", str(args.torch_device), "--out", args.out,
            "--part", part]
    if args.all:
        argv.append("--all")
    elif args.ising:
        argv += ["--ising", args.ising]
    else:
        argv += ["--arch", args.arch, "--shape", args.shape]
    return argv + (["--multi-pod"] if multi_pod else [])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--ising", choices=list(ISING_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory for the per-cell JSON records")
    ap.add_argument("--torch-device", default="cuda",
                    help="the mesh's device (default cuda; 'cpu' on a host "
                         "without one)")
    ap.add_argument("--one-world", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--part", default="0/1", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not (args.all or args.ising or (args.arch and args.shape)):
        ap.error("give --arch and --shape, --ising, or --all")
    resolve_device(args.torch_device)
    if args.one_world or not (args.all or args.both_meshes):
        return _run_in_world(args)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    # --all's cells are dealt to a child a host core (each is one Python
    # thread tracing, a few hundred MB)
    jobs = max(1, (os.cpu_count() or 1) // len(meshes)) if args.all else 1
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    children = [subprocess.Popen(_child_argv(args, mp, f"{k}/{jobs}"),
                                 env=env)
                for mp in meshes for k in range(jobs)]
    return 1 if any([c.wait() for c in children]) else 0


if __name__ == "__main__":
    sys.exit(main())
