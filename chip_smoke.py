#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits nonzero:
  1. build    — compile the port's CUDA source with nvcc.
  2. compare  — each kernel variant against its plain PyTorch version on the
                card, at the main path's shape and at ragged shapes.
  3. main     — ``repro_torch.api.solve_suite`` on the paper's 64-spin suite
                (perturbation, gd, and perturbation with bf16 operands),
                launch counts read around exactly that run, SR/TTS/ETS.
  4. scan     — the scan path on the card (noise variant, energy trace)
                and the engine's autotuner (block_r only; a cached 'scan'
                entry must not move the plan off the kernel).
  5. timing   — kernels and plain versions at the main path's shape and at
                the fig5-grid shape, bounds, and one end-to-end dispatch of
                the grid.
Then the card's name and power limit, the kernels line, and a last line
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): operations per second
# by operand type, and the HBM rate in bytes per second.
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12

SUITE = dict(n=64, density=0.5, num_problems=8, seed=42)
RUNS, SEED = 1024, 7


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> list[float]:
    """Per-call device times (ms) of ``reps`` calls, CUDA events around each,
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def variants():
    """(j_dtype, device model, schedule) of each kernel variant on the main
    path: perturbation in f32, the gd baseline in int8, perturbation with
    bf16 operands."""
    from repro_torch.core import DEFAULT_PERTURBATION, NOMINAL, DeviceModel
    gd = dataclasses.replace(DeviceModel(), tau_leak_sweeps=float("inf"))
    return {
        "float32": (DeviceModel(), DEFAULT_PERTURBATION),
        "int8": (gd, NOMINAL),
        "bfloat16": (DeviceModel(compute_dtype="bfloat16"),
                     DEFAULT_PERTURBATION),
    }


def main_path_inputs(suite, runs, seed, dev):
    """The J bucket and v0 that ``solve_suite`` hands the kernel."""
    import numpy as np
    import torch

    from repro_torch.core.lfsr import lfsr_voltage_inits
    (bucket,) = suite.buckets()
    P, N = bucket.J.shape[0], bucket.n_pad
    v0 = np.stack([lfsr_voltage_inits(N, runs, seed=seed + 7919 * p,
                                      vdd=dev.vdd, swing=dev.init_swing)
                   for p in range(P)])
    return (torch.as_tensor(bucket.J, device="cuda"),
            torch.as_tensor(v0, device="cuda"))


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.ising_anneal import SOURCE
    t0 = time.perf_counter()
    build.load(SOURCE)
    build_s = time.perf_counter() - t0
    log = build.library_path(SOURCE).with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    emit({"phase": "build", "build_s": build_s, "source": SOURCE,
          "ptxas": ptxas})


def compare_one(J, v0, dev, pert, j_dtype, block_r):
    """Kernel vs plain version on the same inputs. Returns the stats."""
    import numpy as np
    import torch

    from repro_torch.core.hamiltonian import ising_energy
    from repro_torch.kernels.ising_anneal import (fused_anneal_kernel,
                                                  fused_anneal_torch)
    from repro_torch.metrics.success import success_rate
    vk = fused_anneal_kernel(J, v0, dev=dev, pert=pert, block_r=block_r,
                             j_dtype=j_dtype)
    vp = fused_anneal_torch(J, v0, dev, pert, j_dtype)
    torch.cuda.synchronize()
    check(vk.shape == v0.shape and bool(torch.isfinite(vk).all()),
          f"kernel output not finite / wrong shape ({j_dtype})")
    thr = dev.threshold
    sk, sp = vk >= thr, vp >= thr
    run_same = (sk == sp).all(dim=-1)                       # (P, R)
    dv = (vk - vp).abs()
    agree_dv = dv[run_same]
    qk = torch.where(sk, 1.0, -1.0)
    qp = torch.where(sp, 1.0, -1.0)
    ek = ising_energy(J, qk).double().cpu().numpy()
    ep = ising_energy(J, qp).double().cpu().numpy()
    best = ep.min(axis=1)
    sr_k = success_rate(ek, best)
    sr_p = success_rate(ep, best)
    return {
        "j_dtype": j_dtype, "shape": list(v0.shape),
        "bitwise": bool(torch.equal(vk, vp)),
        "max_abs_err": float(dv.max()),
        "max_abs_err_agreeing_runs": float(agree_dv.max())
        if agree_dv.numel() else 0.0,
        "runs_differing": int((~run_same).sum()),
        "spins_differing": int((sk != sp).sum()),
        "runs": int(run_same.numel()),
        "sr_kernel": [float(x) for x in sr_k],
        "sr_plain": [float(x) for x in sr_p],
        "max_sr_gap": float(np.max(np.abs(sr_k - sr_p))),
    }


def phase_compare():
    """Every variant at the main path's shape, plus P=4, R=1000 at N=64
    (R not a multiple of block_r) and N=37 (ragged spins). Unit schedule:
    bitwise, every variant. Under the variant's perturbed schedule (f32 and
    bf16): at most 5% of runs end on other spins, |dv| <= 1e-5 over the runs
    that agree, per-problem SR within 0.03."""
    import torch

    from repro_torch.api import ProblemSuite
    from repro_torch.core.lfsr import lfsr_voltage_inits
    from repro_torch.problems import problem_set
    err_at_main = {}
    for j_dtype, (dev, pert) in variants().items():
        cases = [("main", *main_path_inputs(
            ProblemSuite.random(**SUITE), RUNS, SEED, dev))]
        for n in (64, 37):
            ps = problem_set(n, 0.5, 4, seed=11)
            v0 = torch.stack([torch.as_tensor(lfsr_voltage_inits(
                n, 1000, seed=3 + p)) for p in range(4)])
            cases.append((f"n{n}", torch.as_tensor(ps.J, device="cuda"),
                          v0.to("cuda")))
        unit_dev, unit_pert = variants()["int8"]
        for label, J, v0 in cases:
            # unit schedule: bitwise, every variant
            st = compare_one(J, v0, unit_dev, unit_pert, j_dtype, 128)
            emit({"phase": "compare", "case": label, "schedule": "unit", **st})
            check(st["bitwise"], f"{j_dtype} {label} unit schedule: kernel "
                  f"and plain version differ (max {st['max_abs_err']})")
            if j_dtype == "int8":
                err_at_main.setdefault(j_dtype, st["max_abs_err"])
                continue
            # the variant's own perturbed schedule
            st = compare_one(J, v0, dev, pert, j_dtype, 128)
            emit({"phase": "compare", "case": label,
                  "schedule": "perturbation", **st})
            if label == "main":
                err_at_main[j_dtype] = st["max_abs_err"]
            check(st["runs_differing"] <= 0.05 * st["runs"],
                  f"{j_dtype} {label}: {st['runs_differing']} of {st['runs']} "
                  "runs end on other spins (limit 5%)")
            check(st["max_abs_err_agreeing_runs"] <= 1e-5,
                  f"{j_dtype} {label}: |dv| {st['max_abs_err_agreeing_runs']} "
                  "over agreeing runs (limit 1e-5)")
            check(st["max_sr_gap"] <= 0.03,
                  f"{j_dtype} {label}: SR gap {st['max_sr_gap']} (limit 0.03)")
    return err_at_main


def phase_main(oracle_path):
    from repro_torch.api import ProblemSuite, solve_suite
    from repro_torch.core import DeviceModel, IsingMachine
    from repro_torch.kernels import ising_anneal as ka
    suite = ProblemSuite.random(**SUITE)
    runs = [("perturbation", {"variant": "perturbation"}),
            ("gd", {"variant": "gd"}),
            ("perturbation-bf16", {"machine": IsingMachine(
                DeviceModel(compute_dtype="bfloat16"), torch_device="cuda")})]
    ka.reset_launches()
    reports = {name: solve_suite(suite, solver="engine", runs=RUNS, seed=SEED,
                                 torch_device="cuda", oracle_path=oracle_path,
                                 **opts)
               for name, opts in runs}
    launches = dict(ka.launches)
    expect = {"perturbation": "ising_anneal_f32", "gd": "ising_anneal_int8",
              "perturbation-bf16": "ising_anneal_bf16"}
    summary = {}
    for name, rep in reports.items():
        plan = rep.meta["engine_plan"]
        check(plan["path"] == "fused", f"{name}: plan {plan}")
        check(launches[expect[name]] == rep.dispatches == 1,
              f"{name}: {expect[name]} launched {launches[expect[name]]} "
              f"times for {rep.dispatches} buckets")
        check(len(rep.energies) == SUITE["num_problems"] and
              all(len(e) == RUNS and all(map(math.isfinite, e))
                  for e in rep.energies), f"{name}: energies malformed")
        check(all(rep.best_energy >= rep.best_known - 1e-9),
              f"{name}: a run beat the reconciled best-known")
        m = rep.metrics()
        summary[name] = {
            "j_dtype": plan["j_dtype"], "block_r": plan["block_r"],
            "success_rate": [float(x) for x in m["success_rate"]],
            "mean_success_rate": m["mean_success_rate"],
            "median_tts_s": m["median_tts_s"],
            "normalized_ets_j": [float(x) for x in m["normalized_ets_j"]],
            "best_energy": rep.best_energy.tolist(),
            "best_known": rep.best_known.tolist(),
            "wall_s": rep.wall_s, "anneals_per_s": rep.anneals_per_s}
        emit({"phase": "main", "variant": name, **summary[name]})
    emit({"phase": "main", "launches": launches})
    sr_p = summary["perturbation"]["mean_success_rate"]
    sr_g = summary["gd"]["mean_success_rate"]
    check(sr_p > sr_g, f"mean SR perturbation {sr_p} <= gd {sr_g}")

    # the same gd solve through the scan path (torch ops on the card): on
    # the unit schedule every sum is exact, so the energies are identical
    scan = solve_suite(suite, solver="engine", runs=RUNS, seed=SEED,
                       torch_device="cuda", oracle=False, variant="gd",
                       backend="scan")
    check(scan.meta["engine_plan"]["path"] == "scan", "scan plan")
    same = all((a == b).all() for a, b in zip(scan.energies,
                                              reports["gd"].energies))
    emit({"phase": "main", "check": "gd fused == gd scan energies",
          "equal": bool(same)})
    check(same, "gd energies differ between fused kernel and scan path")
    return launches


def phase_scan(oracle_path):
    import torch

    from repro_torch.api import ProblemSuite, solve_suite
    from repro_torch.core import (DEFAULT_PERTURBATION, AnnealEngine,
                                  DeviceModel, anneal_energy_trace)
    from repro_torch.core.lfsr import lfsr_voltage_inits
    suite = ProblemSuite.random(n=64, density=0.5, num_problems=2, seed=5)
    rep = solve_suite(suite, solver="engine", runs=64, seed=SEED,
                      torch_device="cuda", oracle_path=oracle_path,
                      variant="noise")
    plan = rep.meta["engine_plan"]
    check(plan["path"] == "scan" and plan["reason"].startswith("feature"),
          f"noise plan {plan}")
    check(all(len(e) == 64 for e in rep.energies), "noise energies shape")
    dev = DeviceModel()
    J = torch.as_tensor(suite.buckets()[0].J, device="cuda")
    v0 = torch.stack([torch.as_tensor(lfsr_voltage_inits(64, 64, seed=p))
                      for p in range(2)]).to("cuda")
    traj = anneal_energy_trace(J, v0, dev, DEFAULT_PERTURBATION,
                               record_every=64)
    t_rec = -(-dev.n_steps // 64)
    check(traj.is_cuda and tuple(traj.shape) == (2, 64, t_rec),
          f"trace {traj.device} {tuple(traj.shape)}")
    check(bool(torch.isfinite(traj).all()), "trace not finite")
    emit({"phase": "scan", "noise_mean_sr": rep.metrics()["mean_success_rate"],
          "trace_shape": list(traj.shape), "trace_device": str(traj.device)})

    # the engine's autotuner on the card: times the kernel at each block_r,
    # persists the winner, and the next plan reads it
    tune_path = os.path.join(os.path.dirname(oracle_path), "autotune.json")
    eng = AnnealEngine(dev, DEFAULT_PERTURBATION, autotune=True,
                       cache_path=tune_path, torch_device="cuda")
    res = eng.run(J, v0)
    fresh = AnnealEngine(dev, DEFAULT_PERTURBATION, cache_path=tune_path,
                         torch_device="cuda")
    plan = fresh.plan(2, 64, 64, J=J)
    check(res.v_final.is_cuda and plan.path == "fused" and
          plan.reason == "cache", f"autotune: {plan}")
    # a 'scan' winner in the cache (left by an older run) supplies nothing
    fresh._cache[fresh._key(2, 64, 64, plan.j_dtype)] = {
        "path": "scan", "block_r": 64}
    stale = fresh.plan(2, 64, 64, J=J)
    check(stale.path == "fused" and stale.reason == "auto",
          f"cached scan entry moved the plan: {stale}")
    emit({"phase": "scan", "autotuned_plan": dataclasses.asdict(plan),
          "plan_with_cached_scan": dataclasses.asdict(stale)})


def time_variant(label, suite, runs, j_dtype, dev, pert):
    """Kernel (median of 5, CUDA events, after a warm-up) and plain version
    (median of 3) of one variant on the inputs ``solve_suite`` gives the
    kernel for ``suite``, with the block_r the engine plans, and the bound.
    The bound counts every operation the launch does, padded spins
    included (``operations``), and beside it the work of the problems'
    real spins alone (``real_operations``: sum over problems of
    2·R·n²·T)."""
    import torch

    from repro_torch.core.engine import AnnealEngine
    from repro_torch.kernels.ising_anneal import (KERNEL_NAMES,
                                                  fused_anneal_kernel,
                                                  fused_anneal_torch)
    t0 = time.perf_counter()
    J, v0 = main_path_inputs(suite, runs, SEED, dev)
    torch.cuda.synchronize()
    host_setup_s = time.perf_counter() - t0
    P, R, N = v0.shape
    block_r = AnnealEngine(dev, pert, torch_device="cuda").plan(
        P, R, N, J=J).block_r
    k = cuda_ms(lambda: fused_anneal_kernel(
        J, v0, dev=dev, pert=pert, block_r=block_r, j_dtype=j_dtype), 5)
    p = cuda_ms(lambda: fused_anneal_torch(J, v0, dev, pert, j_dtype), 3)
    ops = 2.0 * P * R * N * N * dev.n_steps
    real_ops = sum(2.0 * R * n * n * dev.n_steps for n in suite.sizes)
    nbytes = J.numel() * J.element_size() + 2 * v0.numel() * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[j_dtype] * 1e3
    t_real = real_ops / PEAK_OPS[j_dtype] * 1e3
    row = {"name": KERNEL_NAMES[j_dtype], "shape": [P, R, N],
           "block_r": block_r, "steps": dev.n_steps,
           "ms": statistics.median(k), "ms_all": k,
           "plain_ms": statistics.median(p), "plain_ms_all": p,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "operations": ops, "bytes": nbytes,
           "real_operations": real_ops,
           "real_bound_ms": max(t_real, t_bytes),
           "library_ms": None, "host_setup_s": host_setup_s}
    emit({"phase": "timing", "shape_of": label, **row})
    return row


def phase_timing():
    """Each variant at the main path's shape (8 problems of 64 spins, 1024
    runs: every spin real) and at the fig5 grid's (400 problems, 16-64
    spins padded to 64, 300 runs, one bucket); then one end-to-end dispatch
    of the grid. Returns the main-shape rows."""
    from repro_torch.api import ProblemSuite, solve_suite
    grid = ProblemSuite.grid()
    runs = 300
    main = {}
    for j_dtype, (dev, pert) in variants().items():
        main[j_dtype] = time_variant("main", ProblemSuite.random(**SUITE),
                                     RUNS, j_dtype, dev, pert)
        time_variant("fig5_grid", grid, runs, j_dtype, dev, pert)
    for variant in ("perturbation", "gd"):
        rep = solve_suite(grid, solver="engine", runs=runs, seed=SEED,
                          torch_device="cuda", oracle=False, variant=variant,
                          warmup=True)
        check(rep.dispatches == 1 and
              rep.meta["engine_plan"]["path"] == "fused", "grid dispatch")
        emit({"phase": "timing", "end_to_end": variant,
              "problems": len(grid), "runs": runs, "wall_s": rep.wall_s,
              "first_call_extra_s": rep.compile_s,
              "anneals_per_s": rep.anneals_per_s,
              "plan": rep.meta["engine_plan"]})
    return main


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    emit({"phase": "start", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0)})
    phase_build()
    err = phase_compare()
    with tempfile.TemporaryDirectory() as tmp:
        oracle_path = os.path.join(tmp, "oracle_cache_torch.json")
        launches = phase_main(oracle_path)
        phase_scan(oracle_path)
    timing = phase_timing()

    kernels = []
    for j_dtype, row in timing.items():
        kernels.append({
            "name": row["name"], "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ising_anneal.cu",
            "replaces": "src/repro/kernels/ising_anneal.py:59",
            "launches": launches[row["name"]],
            "max_abs_err": err[j_dtype], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    for kern in kernels:
        check(kern["launches"] > 0, f"{kern['name']} not launched on the "
              "main path")
    print(nvidia_smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
