#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits nonzero:
  1. build    — compile the port's CUDA source with nvcc.
  2. compare  — each anneal variant against its plain PyTorch version on
                the card, at the main path's shape (8, 1024, 64), at (4,
                1000, 64), ragged (4, 1000, 37), N=160 (J^T in shared
                memory) and N=1024 (streamed): under the card's launch
                plan on two calls and under a second plan (bf16 / int8 at
                N=1024 have one geometry only); bitwise on the unit
                schedule, bf16 bitwise under perturbation too, f32 within
                its limits; a short unit-schedule anneal of 2^20 runs (more
                run blocks than grid.y takes); unrunnable plans refused.
  3. main     — ``repro_torch.api.solve_suite`` on the paper's 64-spin suite
                (perturbation, gd, and perturbation with bf16 operands),
                launch counts read around exactly that run, SR/TTS/ETS
                against the oracle's batched tabu-jax tier, and beside it
                the SR against the host-tabu oracle the port used before.
  4. scan     — the scan path on the card (noise variant, energy trace)
                and the engine's autotuner (block_r only; a cached 'scan'
                entry must not move the plan off the kernel).
  5. timing   — kernels and plain versions at the main path's shape and at
                the fig5-grid shape, with the launch plan, registers and
                spills, bounds and the products-only yardstick
                (library_ms), at the grid also under every runs-per-block
                the plan accepts; one end-to-end dispatch of the grid with
                the kernel's share of its wall.
  6. sb_compare — each simulated-bifurcation variant's kernel against its
                plain version on the card: the c0-scaled dense Max-Cut slice
                (4, 256, 64), the Gset duel graph (1, 256, 2048), ragged
                (3, 100, 37) and (2, 50, 300), a 7000-spin Gset-sized
                graph (1, 32, 7040) at 20 steps and one at the kernel's
                largest N (1, 32, 8192) at 10 steps; bitwise across two
                launch plans and repeated calls; unrunnable plans refused.
  7. sb_main  — ``solve_suite(..., solver="sb-jax")`` on the dense Max-Cut
                slice for bSB, dSB and aSB with the oracle, launch counts
                read around exactly those solves; gate: bSB mean SR >= the
                engine's perturbation mean SR on the same suite and runs.
  8. gset     — the solve CLI at N=2000 in a subprocess; sb-jax on the Gset
                duel graph (gate: best cut >= 4700, cut from energy == cut
                from spins); chip-lns on the same graph with the duel's
                settings, printed beside the reference's recorded cuts.
  9. timing   — each SB variant's kernel and plain version at the dense
                and Gset shapes with the launch plan, its registers and
                spills, and the bounds; the products-only yardstick and the
                card's cluster capacity at the Gset shape; the kernel at
                7000 spins; the plan's pick against plans of other cluster
                sizes at the Gset, (2, 50, 300) and 7000-spin shapes; one
                end-to-end sb-jax solve at the Gset shape.
 10. search   — the classical search tier on the 64-spin suite: sa-jax,
                pt-jax and tabu-jax at 1024 restarts (one batch per bucket,
                per-restart energies recomputed in float64 from their
                spins, SR, the bucket's wall, kernels per flip step),
                sa-numpy and tabu at 16; the same draws on the card and on
                the CPU (tabu-jax bitwise, sa-jax / pt-jax to the tie rule);
                the oracle's tabu-jax tier at or below host tabu on every
                problem; the oracle refresh of the fig5 grid, one tabu-jax
                batch per pad bucket, timed.
 11. zoo      — every workload of the zoo at the reference's sizes through
                every registered solver (the affine identity and a feasible
                decode each; engine and chip-lns launch the anneal kernel,
                sb-jax the SB kernel); every anneal variant against its
                plain version on the zoo's buckets, whose levels pass the
                DAC's 15 (TSP 60, a star encoding 118).
Then the total seconds, the card's name and power limit, the kernels
line, and a last line
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no
result. ``--phases compare,timing`` (say) runs the build and those phases
only, and ends with the card's name and a ``{"phases_run": [...]}`` line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): operations per second
# by operand type, and the HBM rate in bytes per second.
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12

SUITE = dict(n=64, density=0.5, num_problems=8, seed=42)
RUNS, SEED = 1024, 7

# Simulated bifurcation: the reference's dense Max-Cut slice
# (benchmarks/solver_matrix.py) and the N=2000 Gset duel graph
# (benchmarks/fabric_scaling.py: gset_problem(2000, seed=1207 + 2)).
SB_RUNS, SB_STEPS = 256, 400
DUEL_SEED = 1209
# the reference's duel cuts on that graph, recorded in BENCH_fabric.json
# (duel_n2000, a CPU run of the JAX package)
DUEL_RECORDED = {"chip-lns": 3923.0, "fabric-jax": 4144.0}
SB_CUT_GATE = 4700.0


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
    """Compile every CUDA source, one nvcc each, all started together (the
    run's time limit is shared by every phase); an nvcc failure re-raises
    here from its future."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels import ising_anneal, sb_kernel
    sources = (ising_anneal.SOURCE, sb_kernel.SOURCE)

    def timed_build(src):
        t0 = time.perf_counter()
        build.build(src)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(sources)) as pool:
        futures = [pool.submit(timed_build, src) for src in sources]
        build_s = [fut.result() for fut in futures]
    for src, secs in zip(sources, build_s):
        build.load(src)
        log = build.library_path(src).with_suffix(".log")
        ptxas = [ln.strip() for ln in log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln or
                 "Function properties" in ln] if log.exists() else []
        emit({"phase": "build", "build_s": secs, "source": src,
              "ptxas": ptxas})
    # the tensor-core variants run on the tensor cores: every anneal_mma
    # instance holds HMMA (bf16) or IMMA (int8) instructions
    sass = build.sass_opcode_counts(ising_anneal.SOURCE, ("HMMA", "IMMA",
                                                          "FFMA"))
    emit({"phase": "build", "source": ising_anneal.SOURCE,
          "sass_counts": sass})
    mma = {name: c for name, c in sass.items() if "anneal_mma" in name}
    check(len(mma) == 6, f"expected 6 anneal_mma instances, got {mma}")
    for name, c in mma.items():
        op = "HMMA" if "anneal_mmaILi1E" in name else "IMMA"
        check(c[op] > 0, f"{name} holds no {op} instruction: {c}")


def alternative_plan(P, R, N, j_dtype, pick):
    """A second launch plan for the shape, unlike the card's pick: another
    regime where one takes the shape, else another runs-per-block; None
    where the kernel has one geometry only (bf16 / int8 at N=1024: 16
    warps of 64 spins fill a block of 512 threads, and J^T does not fit
    in shared memory)."""
    from repro_torch.kernels import ising_anneal as ka
    sms = ka.card_sm_count()
    options = ([{"regime": r} for r in ka.REGIMES if r != pick.regime] +
               [{"block_r": b} for b in ka.anneal_block_r_candidates(
                   P, R, N, j_dtype, sms) if b != pick.block_r])
    for kw in options:
        try:
            alt = ka.anneal_launch_plan(P, R, N, j_dtype, sms, **kw)
        except ValueError:
            continue
        if alt != pick:
            return alt
    return None


def compare_one(J, v0, dev, pert, j_dtype):
    """Kernel under the card's plan (twice) and a second plan, against the
    plain version on the same inputs. Returns the stats."""
    import numpy as np
    import torch

    from repro_torch.core.hamiltonian import ising_energy
    from repro_torch.kernels.ising_anneal import (card_plan,
                                                  fused_anneal_kernel,
                                                  fused_anneal_torch)
    from repro_torch.metrics.success import success_rate
    P, R, N = v0.shape
    pick = card_plan(P, R, N, j_dtype)
    alt = alternative_plan(P, R, N, j_dtype, pick)
    kw = dict(dev=dev, pert=pert, j_dtype=j_dtype)
    vk = fused_anneal_kernel(J, v0, plan=pick, **kw)
    vk_again = fused_anneal_kernel(J, v0, plan=pick, **kw)
    vk_alt = None if alt is None else fused_anneal_kernel(J, v0, plan=alt,
                                                          **kw)
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
        "plans": {"pick": dataclasses.asdict(pick),
                  "second": alt and dataclasses.asdict(alt)},
        "bitwise": bool(torch.equal(vk, vp)),
        "bitwise_repeat": bool(torch.equal(vk, vk_again)),
        "bitwise_plans": None if alt is None else bool(torch.equal(vk,
                                                                   vk_alt)),
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


#: (label, N, problems, runs) of the compare cases past the main path's
#: shape: N=64 with R not a multiple of any block, ragged N=37, N=160
#: (J^T in shared memory) and N=1024 (J^T streamed, the kernel's MAX_N)
COMPARE_CASES = (("n64", 64, 4, 1000), ("n37", 37, 4, 1000),
                 ("n160", 160, 4, 256), ("n1024", 1024, 2, 64))
#: (problems, runs, sweeps) of a short unit-schedule anneal at N=64 with
#: more run blocks than grid.y's 65535 would take under a one-tile plan
LARGE_R = (1, 1 << 20, 0.25)


def second_plan_ok(st, label):
    """A second plan ran and gave the same bits; where the kernel has one
    geometry only (bf16 / int8 at N=1024), a second call did."""
    if st["bitwise_plans"] is None:
        return label == "n1024" and st["j_dtype"] != "float32"
    return st["bitwise_plans"]


def phase_compare():
    """Every variant at the main path's shape and at ``COMPARE_CASES``,
    under the card's plan (two calls) and a second plan, and at
    ``LARGE_R``. Unit schedule: bitwise equal to the plain version, every
    variant. Under the variant's
    perturbed schedule: bf16 bitwise equal too (its sums are exact in any
    order); f32 the same bits under both plans and across calls, and
    against the plain version (another sum order) at most 5% of runs end
    on other spins, |dv| <= 1e-5 over the runs that agree, per-problem SR
    within 0.03."""
    import torch

    from repro_torch.api import ProblemSuite
    from repro_torch.core.lfsr import lfsr_voltage_inits
    from repro_torch.problems import problem_set
    err_at_main = {}
    for j_dtype, (dev, pert) in variants().items():
        cases = [("main", *main_path_inputs(
            ProblemSuite.random(**SUITE), RUNS, SEED, dev))]
        for label, n, p_count, runs in COMPARE_CASES:
            ps = problem_set(n, 0.5, p_count, seed=11)
            v0 = torch.stack([torch.as_tensor(lfsr_voltage_inits(
                n, runs, seed=3 + p)) for p in range(p_count)])
            cases.append((label, torch.as_tensor(ps.J, device="cuda"),
                          v0.to("cuda")))
        unit_dev, unit_pert = variants()["int8"]
        P, R, sweeps = LARGE_R
        ps = problem_set(64, 0.5, P, seed=13)
        v0 = torch.as_tensor(lfsr_voltage_inits(64, R, seed=5))[None]
        st = compare_one(torch.as_tensor(ps.J, device="cuda"), v0.to("cuda"),
                         dataclasses.replace(unit_dev, anneal_sweeps=sweeps),
                         unit_pert, j_dtype)
        emit({"phase": "compare", "case": "large_r", "schedule": "unit",
              "sweeps": sweeps, **st})
        check(st["plans"]["pick"]["blocks"] > 65535,
              f"{j_dtype} at {R} runs: the plan fits grid.y, nothing tested")
        check(st["bitwise"] and st["bitwise_repeat"] and
              second_plan_ok(st, "large_r"), f"{j_dtype} at {R} runs: "
              f"kernel and plain version differ (max {st['max_abs_err']})")
        for label, J, v0 in cases:
            # unit schedule: bitwise, every variant
            st = compare_one(J, v0, unit_dev, unit_pert, j_dtype)
            emit({"phase": "compare", "case": label, "schedule": "unit", **st})
            check(st["bitwise"] and st["bitwise_repeat"] and
                  second_plan_ok(st, label),
                  f"{j_dtype} {label} unit schedule: kernel and plain "
                  f"version differ (max {st['max_abs_err']}, repeat {st['bitwise_repeat']}, "
                  f"plans {st['bitwise_plans']})")
            if j_dtype == "int8":
                err_at_main.setdefault(j_dtype, st["max_abs_err"])
                continue
            # the variant's own perturbed schedule
            st = compare_one(J, v0, dev, pert, j_dtype)
            emit({"phase": "compare", "case": label,
                  "schedule": "perturbation", **st})
            if label == "main":
                err_at_main[j_dtype] = st["max_abs_err"]
            what = f"{j_dtype} {label} perturbation"
            check(st["bitwise_repeat"] and second_plan_ok(st, label),
                  f"{what}: kernel not the same bits across calls / plans")
            if j_dtype == "bfloat16":
                check(st["bitwise"], f"{what}: kernel and plain version "
                      f"differ (max {st['max_abs_err']}); bf16 sums are "
                      "exact, so they must not")
            check(st["runs_differing"] <= 0.05 * st["runs"],
                  f"{what}: {st['runs_differing']} of {st['runs']} "
                  "runs end on other spins (limit 5%)")
            check(st["max_abs_err_agreeing_runs"] <= 1e-5,
                  f"{what}: |dv| {st['max_abs_err_agreeing_runs']} "
                  "over agreeing runs (limit 1e-5)")
            check(st["max_sr_gap"] <= 0.03,
                  f"{what}: SR gap {st['max_sr_gap']} (limit 0.03)")
    check_anneal_refusals(J, v0)
    return err_at_main


def check_anneal_refusals(J, v0):
    """A plan that does not match the shape or that the kernel cannot run
    is refused by ``ising_anneal`` and the wrapper raises; nothing runs
    another path instead."""
    from repro_torch.kernels import ising_anneal as ka
    dev, pert = variants()["int8"]
    pick = ka.card_plan(*v0.shape, "int8")
    refused = {}
    for field, value in (("smem_bytes", pick.smem_bytes + 16),
                         ("tiles_per_block", 64),
                         ("n_pad", pick.n_pad + 64)):
        try:
            ka.fused_anneal_kernel(J, v0, dev=dev, pert=pert, j_dtype="int8",
                                   plan=dataclasses.replace(
                                       pick, **{field: value}))
            refused[field] = None
        except RuntimeError as err:
            refused[field] = str(err).rsplit(":", 1)[-1].strip()
    emit({"phase": "compare", "refusals": refused})
    check(all(refused.values()), f"an unrunnable plan was launched: "
          f"{refused}")


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
    emit({"phase": "main", **sr_under_host_tabu_oracle(suite, reports)})

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


def sr_under_host_tabu_oracle(suite, reports):
    """Mean SR of each report against the oracle the port used before its
    batched tier: host ``tabu_search`` with ``TABU_JAX_ORACLE_RESTARTS``
    restarts, seed 0, per problem, upgraded by each solve in turn as
    ``reconcile_best_known`` upgrades the cache; beside the SR the reports
    carry (the batched tabu-jax tier, as the reference's)."""
    import numpy as np

    from repro_torch.api.oracle import TABU_JAX_ORACLE_RESTARTS
    from repro_torch.metrics.success import success_rate
    from repro_torch.solvers.tabu import tabu_search
    t0 = time.perf_counter()
    best = np.array([tabu_search(p.J_levels,
                                 n_restarts=TABU_JAX_ORACLE_RESTARTS,
                                 seed=0)[0] for p in suite])
    host_s = time.perf_counter() - t0
    out = {"oracle_host_tabu": best.tolist(), "oracle_host_tabu_s": host_s}
    for name, rep in reports.items():
        best = np.minimum(best, rep.best_energy)
        sr = success_rate(np.stack(rep.energies), best)
        out[name] = {"mean_success_rate_host_tabu_oracle": float(sr.mean()),
                     "mean_success_rate_tabu_jax_oracle":
                         rep.metrics()["mean_success_rate"],
                     "best_known_tabu_jax": rep.best_known.tolist()}
    return out


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


def anneal_plan_row(plan):
    """The plan with the registers and spill bytes of the kernel instance
    that runs it (``-Xptxas -v``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ising_anneal as ka
    fn = ka.kernel_function(plan)
    (usage,) = [u for name, u in build.ptxas_report(ka.SOURCE).items()
                if fn in name]
    return {**dataclasses.asdict(plan), "instance": fn, **usage}


def products_ms(P, R, N, steps, dtype):
    """The products-only yardstick: ``steps`` x torch.matmul (P, R, N) @
    (P, N, N) in ``dtype`` (TF32 off), median of 3 (CUDA events). No
    single PyTorch call runs an anneal; this times its products alone."""
    import torch
    a = torch.randn(P, R, N, device="cuda", dtype=dtype)
    b = torch.randn(P, N, N, device="cuda", dtype=dtype)

    def products():
        for _ in range(steps):
            torch.matmul(a, b)
    t = cuda_ms(products, 3)
    return statistics.median(t), t


def time_variant(label, suite, runs, j_dtype, dev, pert, other_plans=False):
    """Kernel (median of 5, CUDA events around the wrapper call, which
    lays J out and launches once, after a warm-up) and plain version
    (median of 3) of one variant on the inputs ``solve_suite`` gives the
    kernel for ``suite``, with the engine's plan (the launch plan's pick),
    its instance's registers and spills, the bound and the products-only
    yardstick (``library_ms``: f32 TF32 off for f32, bf16 for bf16 and
    int8, which torch's CUDA matmul does not take). The bound counts every
    operation the launch does, padded spins included (``operations``), and
    beside it the work of the problems' real spins alone
    (``real_operations``: sum over problems of 2·R·n²·T). ``other_plans``:
    the kernel also at every runs-per-block the launch plan accepts
    (``block_r_ms``, median of 5 each)."""
    import torch

    from repro_torch.core.engine import AnnealEngine
    from repro_torch.kernels.ising_anneal import (KERNEL_NAMES,
                                                  anneal_block_r_candidates,
                                                  card_plan, card_sm_count,
                                                  fused_anneal_kernel,
                                                  fused_anneal_torch)
    t0 = time.perf_counter()
    J, v0 = main_path_inputs(suite, runs, SEED, dev)
    torch.cuda.synchronize()
    host_setup_s = time.perf_counter() - t0
    P, R, N = v0.shape
    block_r = AnnealEngine(dev, pert, torch_device="cuda").plan(
        P, R, N, J=J).block_r
    plan = anneal_plan_row(card_plan(P, R, N, j_dtype, block_r))
    k = cuda_ms(lambda: fused_anneal_kernel(
        J, v0, dev=dev, pert=pert, block_r=block_r, j_dtype=j_dtype), 5)
    p = cuda_ms(lambda: fused_anneal_torch(J, v0, dev, pert, j_dtype), 3)
    lib_ms, lib_all = products_ms(
        P, R, N, dev.n_steps,
        torch.float32 if j_dtype == "float32" else torch.bfloat16)
    ops = 2.0 * P * R * N * N * dev.n_steps
    real_ops = sum(2.0 * R * n * n * dev.n_steps for n in suite.sizes)
    nbytes = J.numel() * J.element_size() + 2 * v0.numel() * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[j_dtype] * 1e3
    t_real = real_ops / PEAK_OPS[j_dtype] * 1e3
    row = {"name": KERNEL_NAMES[j_dtype], "shape": [P, R, N],
           "plan": plan, "steps": dev.n_steps,
           "ms": statistics.median(k), "ms_all": k,
           "plain_ms": statistics.median(p), "plain_ms_all": p,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "operations": ops, "bytes": nbytes,
           "real_operations": real_ops,
           "real_bound_ms": max(t_real, t_bytes),
           "library_ms": lib_ms, "library_ms_all": lib_all,
           "library_what": f"{dev.n_steps} x torch.matmul ({P}, {R}, {N}) "
                           f"@ ({P}, {N}, {N}) "
                           + ("float32, TF32 off" if j_dtype == "float32"
                              else "bfloat16"),
           "host_setup_s": host_setup_s}
    if other_plans:
        row["block_r_ms"] = {
            br: statistics.median(cuda_ms(lambda br=br: fused_anneal_kernel(
                J, v0, dev=dev, pert=pert, block_r=br, j_dtype=j_dtype), 5))
            for br in anneal_block_r_candidates(P, R, N, j_dtype,
                                                card_sm_count())}
    emit({"phase": "timing", "shape_of": label, **row})
    check(plan["spill_stores"] == 0 and plan["spill_loads"] == 0,
          f"{label} {j_dtype}: the kernel instance spills: {plan}")
    return row


def phase_timing():
    """Each variant at the main path's shape (8 problems of 64 spins, 1024
    runs: every spin real) and at the fig5 grid's (400 problems, 16-64
    spins padded to 64, 300 runs, one bucket; there under every
    runs-per-block the plan accepts too); then one end-to-end dispatch
    of the grid with the kernel's share of its wall. Returns the
    main-shape rows."""
    from repro_torch.api import ProblemSuite, solve_suite
    grid = ProblemSuite.grid()
    runs = 300
    main, at_grid = {}, {}
    for j_dtype, (dev, pert) in variants().items():
        main[j_dtype] = time_variant("main", ProblemSuite.random(**SUITE),
                                     RUNS, j_dtype, dev, pert)
        at_grid[j_dtype] = time_variant("fig5_grid", grid, runs, j_dtype,
                                        dev, pert, other_plans=True)
    for variant, j_dtype in (("perturbation", "float32"), ("gd", "int8")):
        rep = solve_suite(grid, solver="engine", runs=runs, seed=SEED,
                          torch_device="cuda", oracle=False, variant=variant,
                          warmup=True)
        check(rep.dispatches == 1 and
              rep.meta["engine_plan"]["path"] == "fused", "grid dispatch")
        check(rep.meta["engine_plan"]["j_dtype"] == j_dtype,
              f"grid dispatch ran {rep.meta['engine_plan']}")
        kernel_s = at_grid[j_dtype]["ms"] / 1e3
        emit({"phase": "timing", "end_to_end": variant,
              "problems": len(grid), "runs": runs, "wall_s": rep.wall_s,
              "first_call_extra_s": rep.compile_s,
              "anneals_per_s": rep.anneals_per_s,
              "kernel_s": kernel_s, "kernel_share": kernel_s / rep.wall_s,
              "host_s": rep.wall_s - kernel_s,
              "plan": rep.meta["engine_plan"]})
    return main


def sb_slice_problems():
    from repro_torch.api import Problem
    return [Problem.maxcut(48, 0.9, seed=606 + i) for i in range(4)]


def duel_problem():
    from repro_torch.problems import gset_problem
    return gset_problem(2000, seed=DUEL_SEED, degree=6.0)


def sb_cases():
    """(label, problems, runs, pad block, steps) of each compare case: the
    dense Max-Cut slice and the duel graph padded as ``solve_suite`` pads
    them, two ragged shapes left unpadded, a Gset-sized graph of 7000
    spins (the size of G55-G64), past the L2, and one of ``MAX_N`` spins,
    the kernel's largest, at 32 runs and 20 or 10 steps so that the plain
    version stays within seconds."""
    from repro_torch.api import Problem
    from repro_torch.kernels.sb_kernel import MAX_N
    from repro_torch.problems import gset_problem
    return [
        ("maxcut_dense", sb_slice_problems(), SB_RUNS, 64, SB_STEPS),
        ("gset", [duel_problem()], SB_RUNS, 64, SB_STEPS),
        ("ragged_37", [Problem.random_qubo(37, 0.5, seed=37 + i)
                       for i in range(3)], 100, 37, SB_STEPS),
        ("ragged_300", [Problem.maxcut(300, 0.5, seed=300 + i)
                        for i in range(2)], 50, 300, SB_STEPS),
        ("gset_7000", [gset_problem(7000, seed=DUEL_SEED, degree=6.0)], 32,
         64, 20),
        ("gset_max_n", [gset_problem(MAX_N, seed=DUEL_SEED, degree=6.0)], 32,
         64, 10),
    ]


def sb_inputs(problems, runs, block, seed=SEED):
    """Level-space J, c0-scaled Jc, x0, y0 and true sizes that the sb-jax
    solver hands the kernel for one pad bucket of ``problems``."""
    import torch

    from repro_torch.api import ProblemSuite
    from repro_torch.solvers.sb_jax import sb_inits, sb_scaled_couplings
    (bucket,) = ProblemSuite(problems).buckets(block)
    n_true = [p.n for p in problems]
    Jc = sb_scaled_couplings(bucket.J, n_true)
    P, n_pad = bucket.J.shape[0], bucket.n_pad
    x0, y0 = sb_inits(P, runs, n_pad, n_true=n_true, seed=seed,
                      torch_device="cuda")
    return (torch.as_tensor(bucket.J, device="cuda"),
            torch.as_tensor(Jc, device="cuda"), x0, y0, n_true)


def level_energies(J, x):
    """(P, R) float64 energies of the sign readout of x against levels J."""
    import torch

    from repro_torch.core.binarize import sign_pm1
    s = sign_pm1(x).double()
    return -0.5 * torch.sum(s * torch.matmul(s, J.double().transpose(-1, -2)),
                            dim=-1)


#: the two block_r values (runs per cluster) compare_sb holds bitwise
#: equal: the plan's default and one that gives another geometry at every
#: case
SB_BLOCK_R_PAIR = (None, 4)


def compare_sb(J, Jc, x0, y0, n_true, variant, steps=SB_STEPS):
    """SB kernel (the first block_r of ``SB_BLOCK_R_PAIR`` twice, the second
    once) vs its plain version."""
    import dataclasses

    import torch

    from repro_torch.kernels.sb_kernel import (fused_sb_kernel, sb_card_plan,
                                               sb_reference)
    kw = dict(variant=variant, n_steps=steps, dt=0.5, a0=1.0)
    br_a, br_b = SB_BLOCK_R_PAIR
    plans = [sb_card_plan(*x0.shape, br) for br in SB_BLOCK_R_PAIR]
    check(plans[0] != plans[1], f"block_r {br_a} and {br_b} give one plan")
    xk = fused_sb_kernel(Jc, x0, y0, block_r=br_a, **kw)
    xk_again = fused_sb_kernel(Jc, x0, y0, block_r=br_a, **kw)
    xk_b = fused_sb_kernel(Jc, x0, y0, block_r=br_b, **kw)
    xp = sb_reference(Jc, x0, y0, **kw)
    torch.cuda.synchronize()
    check(xk.shape == x0.shape and bool(torch.isfinite(xk).all()),
          f"SB {variant}: kernel output not finite / wrong shape")
    pads_zero = all(bool((xk[p, :, n:] == 0).all())
                    for p, n in enumerate(n_true))
    differ = ((xk >= 0) != (xp >= 0)).any(dim=-1)            # (P, R)
    ek, ep = level_energies(J, xk), level_energies(J, xp)
    mean_gap = ((ek.mean(1) - ep.mean(1)).abs()
                / ep.mean(1).abs().clamp(min=1.0))
    best_gap = ((ek.min(1).values - ep.min(1).values).abs()
                / ep.min(1).values.abs().clamp(min=1.0))
    return {
        "variant": variant, "shape": list(x0.shape), "steps": steps,
        "plans": {str(br): dataclasses.asdict(pl)
                  for br, pl in zip(SB_BLOCK_R_PAIR, plans)},
        "bitwise_repeat": bool(torch.equal(xk, xk_again)),
        "bitwise_block_r_pair": bool(torch.equal(xk, xk_b)),
        "pads_zero": pads_zero,
        "readouts_differ": float(differ.double().mean()),
        "runs_differing": int(differ.sum()), "runs": int(differ.numel()),
        "max_mean_energy_gap": float(mean_gap.max()),
        "max_best_energy_gap": float(best_gap.max()),
        "best_energy_kernel": ek.min(1).values.tolist(),
        "best_energy_plain": ep.min(1).values.tolist(),
        "max_abs_dx": float((xk - xp).abs().max()),
    }


def phase_sb_compare():
    """Every SB variant at every case: readouts differ in <= 2% of runs,
    mean- and best-energy gaps <= 0.5% per problem, bitwise equal to the
    plain version, across the block_r pair and across two calls, zero pads
    exactly 0. Returns the max |dx| of each variant at the Gset shape."""
    from repro_torch.kernels.sb_kernel import SB_VARIANTS
    err_at_gset = {}
    for label, problems, runs, block, steps in sb_cases():
        J, Jc, x0, y0, n_true = sb_inputs(problems, runs, block)
        for variant in SB_VARIANTS:
            st = compare_sb(J, Jc, x0, y0, n_true, variant, steps)
            emit({"phase": "sb_compare", "case": label, **st})
            what = f"SB {variant} {label}"
            check(st["bitwise_repeat"] and st["bitwise_block_r_pair"],
                  f"{what}: kernel not bitwise repeatable / block_r-free")
            check(st["pads_zero"], f"{what}: a zero pad left 0")
            # kernel and plain version sum dv in one order (ordered_matvec)
            check(st["max_abs_dx"] == 0.0,
                  f"{what}: x_final differs from the plain version by "
                  f"{st['max_abs_dx']} (both sum dv in one order, so 0)")
            check(st["readouts_differ"] <= 0.02,
                  f"{what}: {st['readouts_differ']:.4f} of runs read out "
                  "other spins (limit 2%)")
            check(st["max_mean_energy_gap"] <= 0.005,
                  f"{what}: mean-energy gap {st['max_mean_energy_gap']} "
                  "(limit 0.5%)")
            check(st["max_best_energy_gap"] <= 0.005,
                  f"{what}: best-energy gap {st['max_best_energy_gap']} "
                  "(limit 0.5%)")
            if label == "gset":
                err_at_gset[variant] = st["max_abs_dx"]
    check_sb_refusals(Jc, x0, y0)
    return err_at_gset


@contextlib.contextmanager
def sb_forced_plan(make):
    """Within the block, ``fused_sb_kernel`` launches ``make(plan)`` in place
    of the card's plan."""
    from repro_torch.kernels import sb_kernel as sbk
    card_plan = sbk.sb_card_plan
    sbk.sb_card_plan = lambda *a, **k: make(card_plan(*a, **k))
    try:
        yield
    finally:
        sbk.sb_card_plan = card_plan


def check_sb_refusals(Jc, x0, y0):
    """A plan the kernel cannot run is refused by ``sb_integrate`` and the
    wrapper raises; nothing runs another path instead."""
    from repro_torch.kernels import sb_kernel as sbk
    refused = {}
    for field, value in (("cluster", sbk.MAX_CLUSTER + 1),
                         ("smem_bytes", sbk.SMEM_MAX + 16),
                         ("threads", 1)):
        try:
            with sb_forced_plan(lambda pl: dataclasses.replace(
                    pl, **{field: value})):
                sbk.fused_sb_kernel(Jc, x0, y0, n_steps=1)
            refused[field] = None
        except RuntimeError as err:
            refused[field] = str(err).rsplit(":", 1)[-1].strip()
    emit({"phase": "sb_compare", "refusals": refused})
    check(all(refused.values()), f"an unrunnable plan was launched: "
          f"{refused}")


def phase_sb_main(oracle_path):
    """sb-jax through ``solve_suite`` on the dense Max-Cut slice, each
    variant, with the oracle; the engine's perturbation run on the same
    suite and runs is the gate's yardstick. Returns the SB launch counts of
    exactly the three sb-jax solves."""
    import numpy as np

    from repro_torch.api import ProblemSuite, solve_suite
    from repro_torch.kernels import sb_kernel as sbk
    suite = ProblemSuite(sb_slice_problems())
    reports = {"engine": solve_suite(
        suite, solver="engine", runs=SB_RUNS, seed=SEED,
        variant="perturbation", torch_device="cuda", oracle_path=oracle_path)}
    sbk.reset_launches()
    for variant in ("bSB", "dSB", "aSB"):
        reports[variant] = solve_suite(
            suite, solver="sb-jax", runs=SB_RUNS, seed=SEED, variant=variant,
            torch_device="cuda", oracle_path=oracle_path)
    launches = dict(sbk.launches)
    # one best-known for every report: the oracle, improved by any solve
    best_known = np.minimum.reduce([r.best_known for r in reports.values()])
    sr = {}
    for name, rep in reports.items():
        rep.attach_oracle(best_known)
        if name != "engine":
            kname = sbk.KERNEL_NAMES[name]
            check(launches[kname] == rep.dispatches == 1,
                  f"sb-jax {name}: {kname} launched {launches[kname]} times "
                  f"for {rep.dispatches} buckets")
        check(len(rep.energies) == len(suite) and
              all(len(e) == SB_RUNS and all(map(math.isfinite, e))
                  for e in rep.energies), f"{name}: energies malformed")
        for i, p in enumerate(suite):
            s = rep.best_sigma[i].astype(np.float64)
            e = -0.5 * s @ p.J_levels.astype(np.float64) @ s
            check(e == rep.best_energy[i], f"{name} problem {i}: energy "
                  f"{rep.best_energy[i]} is not that of its spins ({e})")
        m = rep.metrics()
        sr[name] = m["mean_success_rate"]
        emit({"phase": "sb_main", "solver": "engine" if name == "engine"
              else "sb-jax", "variant": name,
              "success_rate": [float(x) for x in m["success_rate"]],
              "mean_success_rate": m["mean_success_rate"],
              "best_energy": rep.best_energy.tolist(),
              "best_known": rep.best_known.tolist(),
              "dispatches": rep.dispatches, "wall_s": rep.wall_s,
              "anneals_per_s": rep.anneals_per_s})
    emit({"phase": "sb_main", "launches": launches})
    check(sr["bSB"] >= sr["engine"], f"mean SR bSB {sr['bSB']} < engine "
          f"perturbation {sr['engine']} on the dense Max-Cut slice")
    return launches


def phase_gset():
    """The solve CLI at N=2000 (a subprocess on the card), sb-jax on the
    duel graph, and chip-lns on the same graph with the duel's settings
    (benchmarks/fabric_scaling.py: inner_runs 4, outer_sweeps 2,
    anneal_sweeps 0.5, runs 4, seed 1207), which launches the f32 anneal
    kernel once per outer sweep."""
    import numpy as np
    import torch

    from repro_torch.api import get_solver
    from repro_torch.core.hamiltonian import maxcut_value
    from repro_torch.kernels import ising_anneal as ka
    from repro_torch.kernels import sb_kernel as sbk
    from repro_torch.launch.solve import solve
    from repro_torch.problems import cut_from_energy

    cmd = [sys.executable, "-m", "repro_torch.launch.solve", "--solver",
           "sb-jax", "--workload", "gset", "--spins", "2000", "--problems",
           "1", "--runs", str(SB_RUNS), "--no-oracle", "--torch-device",
           "cuda"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env=env)
    cli_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    cut_line = [ln for ln in lines if ln.startswith("[gset #0] N=2000 cut")]
    emit({"phase": "gset", "cli": " ".join(cmd[1:]), "rc": proc.returncode,
          "cli_s": cli_s, "stdout_tail": lines[-3:],
          "stderr_tail": proc.stderr.strip().splitlines()[-5:]})
    check(proc.returncode == 0 and len(cut_line) == 1,
          f"CLI exited {proc.returncode} without a cut line")

    sbk.reset_launches()
    rep, suite = solve(2000, 0.5, 1, SB_RUNS, seed=DUEL_SEED, solver="sb-jax",
                       workload="gset", oracle=False, degree=6.0,
                       torch_device="cuda")
    p = suite[0]
    W = p.meta["W"]
    e_best = float(rep.best_energy[0])
    cut_e = cut_from_energy(W, e_best)
    cut_s = float(maxcut_value(torch.as_tensor(W, dtype=torch.float64),
                               torch.as_tensor(rep.best_sigma[0])))
    cuts = [cut_from_energy(W, e) for e in rep.energies[0]]
    emit({"phase": "gset", "solver": "sb-jax", "variant": "bSB",
          "n": p.n, "edges": int((W > 0).sum() // 2), "runs": SB_RUNS,
          "best_cut": cut_e, "cut_from_spins": cut_s,
          "mean_cut": float(np.mean(cuts)), "wall_s": rep.wall_s,
          "launches": dict(sbk.launches), "recorded_reference": DUEL_RECORDED})
    check(sbk.launches["sb_bsb"] == 1, "gset: sb_bsb not launched once")
    check(cut_e == cut_s, f"cut from energy {cut_e} != cut from spins {cut_s}")
    check(cut_e >= SB_CUT_GATE, f"sb-jax best cut {cut_e} < {SB_CUT_GATE}")

    ka.reset_launches()
    lns = get_solver("chip-lns", anneal_sweeps=0.5, inner_runs=4,
                     outer_sweeps=2, torch_device="cuda")
    rep_c = lns.solve(p, runs=4, seed=1207)
    launches = dict(ka.launches)
    e_c = float(np.min(rep_c.energies[0]))
    cut_c = cut_from_energy(W, e_c)
    cut_cs = float(maxcut_value(torch.as_tensor(W, dtype=torch.float64),
                                torch.as_tensor(rep_c.best_sigma[0])))
    emit({"phase": "gset", "solver": "chip-lns", "best_cut": cut_c,
          "cut_from_spins": cut_cs, "dispatches": rep_c.dispatches,
          "engine_plan": rep_c.meta.get("engine_plan"),
          "lns_timings": rep_c.meta["lns_timings"], "launches": launches,
          "reference_chip_lns_cut": DUEL_RECORDED["chip-lns"],
          "reference_fabric_jax_cut": DUEL_RECORDED["fabric-jax"]})
    check(rep_c.dispatches == 2 and
          launches["ising_anneal_f32"] == rep_c.dispatches,
          f"chip-lns: {launches} for {rep_c.dispatches} dispatches")
    check(cut_c == cut_cs, f"chip-lns cut from energy {cut_c} != cut from "
          f"spins {cut_cs}")


def sb_plan_row(x0, block_r=None):
    """The card's launch plan for ``x0``'s shape, with the registers and
    spill bytes of the kernel instance that runs it (``-Xptxas -v``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import sb_kernel as sbk
    plan = sbk.sb_card_plan(*x0.shape, block_r)
    fn = sbk.KERNEL_FUNCTION[plan.regime]
    (usage,) = [u for name, u in build.ptxas_report(sbk.SOURCE).items()
                if fn in name]
    return {**dataclasses.asdict(plan), **usage}


#: cluster sizes whose plans phase 9 times against the plan's own pick, by
#: case: the portable 8 everywhere, the largest that fits at 7000 spins
#: (the pick there is 14) and a small one at (2, 50, 300)
SB_PLAN_ALTERNATIVES = {"gset": (8,), "ragged_300": (8, 4),
                        "gset_7000": (16, 8)}


def sb_plan_alternatives(Jc, x0, y0, steps, clusters):
    """bSB kernel times (median of 5, CUDA events) of the card's plan for
    ``x0``'s shape and of the plan ``sb_launch_plan`` makes when only
    clusters of C CTAs fit, for each C in ``clusters``; each result held
    bitwise equal to the pick's."""
    import torch

    from repro_torch.kernels import sb_kernel as sbk
    kw = dict(variant="bSB", n_steps=steps, dt=0.5, a0=1.0)
    card = sbk._card_capacity(sbk._library(), x0.device)
    pick = sbk.sb_card_plan(*x0.shape)
    x_pick = sbk.fused_sb_kernel(Jc, x0, y0, **kw)
    rows = [{"cluster": pick.cluster, "pick": True,
             "ms": statistics.median(cuda_ms(
                 lambda: sbk.fused_sb_kernel(Jc, x0, y0, **kw), 5)),
             "plan": dataclasses.asdict(pick)}]
    for C in clusters:
        alt = sbk.sb_launch_plan(*x0.shape, None, lambda regime, c, t, m, C=C:
                                 card(regime, c, t, m) if c == C else 0)
        with sb_forced_plan(lambda pl: alt):
            x_alt = sbk.fused_sb_kernel(Jc, x0, y0, **kw)
            ms = statistics.median(cuda_ms(
                lambda: sbk.fused_sb_kernel(Jc, x0, y0, **kw), 5))
        check(torch.equal(x_alt, x_pick), f"plan {alt} is not bitwise "
              f"equal to the pick {pick}")
        rows.append({"cluster": C, "pick": False, "ms": ms,
                     "plan": dataclasses.asdict(alt)})
    return {"plan_alternatives": rows, "variant": "bSB", "steps": steps,
            "pick_fastest": rows[0]["ms"] <= min(r["ms"] for r in rows)}


def phase_sb_timing():
    """Each SB variant's kernel (median of 5, CUDA events, after a warm-up;
    the plan's default block_r) and plain version (median of 3 dense, one
    call at Gset) at both
    main shapes, the bound (all operations, and the real spins' alone: sum
    over problems of 2·R·n²·T), the launch plan with its instance's
    registers and spills; at the Gset shape the products-only yardstick
    (400 f32 products (256, 2048) @ (2048, 2048), TF32 off) and the
    card's cluster capacity; the kernel alone on the 7000-spin graph; the
    plan's pick against other cluster sizes (``SB_PLAN_ALTERNATIVES``);
    then one end-to-end sb-jax solve at the Gset shape. Returns the
    Gset-shape rows."""
    import torch

    from repro_torch.api import ProblemSuite, solve_suite
    from repro_torch.kernels import sb_kernel as sbk
    from repro_torch.kernels.sb_kernel import (KERNEL_NAMES, SB_VARIANTS,
                                               fused_sb_kernel, sb_reference)
    rows = {}
    cases = {label: case for label, *case in sb_cases()}
    for label in ("maxcut_dense", "gset", "gset_7000"):
        problems, runs, block, steps = cases[label]
        J, Jc, x0, y0, n_true = sb_inputs(problems, runs, block)
        P, R, N = x0.shape
        ops = 2.0 * P * R * N * N * steps
        real_ops = sum(2.0 * R * n * n * steps for n in n_true)
        nbytes = 4 * (Jc.numel() + 3 * x0.numel())
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = ops / PEAK_OPS["float32"] * 1e3
        plan = sb_plan_row(x0)
        for variant in SB_VARIANTS:
            kw = dict(variant=variant, n_steps=steps, dt=0.5, a0=1.0)
            k = cuda_ms(lambda: fused_sb_kernel(Jc, x0, y0, **kw), 5)
            # the plain version at 7000 spins takes seconds a call; the
            # compare phase has held it against the kernel there
            # (one call after the warm-up at Gset, where a call takes 20-30 s)
            pl = (cuda_ms(lambda: sb_reference(Jc, x0, y0, **kw),
                          3 if label == "maxcut_dense" else 1)
                  if label != "gset_7000" else None)
            row = {"name": KERNEL_NAMES[variant], "shape": [P, R, N],
                   "plan": plan, "steps": steps,
                   "ms": statistics.median(k), "ms_all": k,
                   "plain_ms": statistics.median(pl) if pl else None,
                   "plain_ms_all": pl,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "operations": ops, "bytes": nbytes,
                   "real_operations": real_ops,
                   "real_bound_ms": max(real_ops / PEAK_OPS["float32"] * 1e3,
                                        t_bytes),
                   "library_ms": None}
            emit({"phase": "timing", "shape_of": label, **row})
            if label == "gset":
                rows[variant] = row
        if label == "gset":
            check(plan["spill_stores"] == 0 and plan["spill_loads"] == 0,
                  f"the Gset-shape instance spills: {plan}")
            # a yardstick only: the port never calls it, and no single
            # library call computes an SB integration (library_ms is null)
            a = torch.randn(R, N, device="cuda")
            b = torch.randn(N, N, device="cuda")

            def products():
                for _ in range(steps):
                    torch.matmul(a, b)
            prod = cuda_ms(products, 3)
            lib = sbk._library()
            capacity = {c: lib.sb_cluster_capacity(1, c, plan["threads"],
                                                   plan["smem_bytes"])
                        for c in range(1, sbk.MAX_CLUSTER + 1)}
            emit({"phase": "timing", "shape_of": label,
                  "products_only_ms": statistics.median(prod),
                  "products_only_ms_all": prod,
                  "what": f"{steps} x torch.matmul ({R}, {N}) @ ({N}, {N}) "
                          "float32, TF32 off",
                  "cluster_capacity_at_plan_geometry": capacity})
    for label, clusters in SB_PLAN_ALTERNATIVES.items():
        problems, runs, block, steps = cases[label]
        _, Jc, x0, y0, _ = sb_inputs(problems, runs, block)
        emit({"phase": "timing", "shape_of": label,
              **sb_plan_alternatives(Jc, x0, y0, steps, clusters)})
    rep = solve_suite(ProblemSuite([duel_problem()]), solver="sb-jax",
                      runs=SB_RUNS, seed=SEED, torch_device="cuda",
                      oracle=False, warmup=True)
    emit({"phase": "timing", "end_to_end": "sb-jax bSB", "shape_of": "gset",
          "runs": SB_RUNS, "wall_s": rep.wall_s,
          "first_call_extra_s": rep.compile_s,
          "anneals_per_s": rep.anneals_per_s, "dispatches": rep.dispatches})
    return rows


#: the classical search tier: the batched solvers run on the card at RUNS
#: restarts, the host solvers at HOST_RUNS; the card-vs-CPU comparison of
#: the batched ones runs CROSS_RUNS restarts (the CPU runs it too)
SEARCH_DEVICE = ("sa-jax", "pt-jax", "tabu-jax")
SEARCH_HOST = ("sa-numpy", "tabu")
HOST_RUNS, CROSS_RUNS = 16, 64
#: the registry's defaults, which the direct runs calls repeat
SA_SWEEPS, PT_SWEEPS, PT_RUNGS = 200, 120, 4


def search_runs(name, J, n_true, runs, seed, dev, draws=None, size=None):
    """One bucket of a batched search solver as its registry class runs it
    (numpy results). ``size``: sweeps (SA, PT) or flips (tabu) in place of
    the defaults."""
    from repro_torch.solvers import (parallel_tempering_jax_runs,
                                     simulated_annealing_jax_runs,
                                     tabu_search_jax_runs)
    if name == "sa-jax":
        return simulated_annealing_jax_runs(
            J, n_runs=runs, n_sweeps=size or SA_SWEEPS, seed=seed,
            draws=draws, torch_device=dev)
    if name == "pt-jax":
        return parallel_tempering_jax_runs(
            J, n_runs=runs, n_sweeps=size or PT_SWEEPS, n_rungs=PT_RUNGS,
            seed=seed, draws=draws, torch_device=dev)
    iters = [size or 40 * n for n in n_true]
    return tabu_search_jax_runs(J, n_true=n_true, n_iters=iters,
                                n_restarts=runs, seed=seed, draws=draws,
                                torch_device=dev)


def search_draws(name, P, runs, n, n_true, dev):
    from repro_torch.solvers.pt_jax import pt_draws
    from repro_torch.solvers.sa_jax import sa_draws
    from repro_torch.solvers.tabu_jax import tabu_draws
    if name == "sa-jax":
        return sa_draws(P, runs, n, SA_SWEEPS, SEED, dev)
    if name == "pt-jax":
        return pt_draws(P, runs, PT_RUNGS, n, PT_SWEEPS, SEED, dev)
    return tabu_draws(P, runs, n, 40 * max(n_true), n_true, SEED, dev)


@contextlib.contextmanager
def exp_spy(calls):
    """Within the block, every ``torch.exp`` call appends (argument, value)
    as numpy arrays to ``calls``."""
    import torch
    orig = torch.exp

    def spy(x):
        out = orig(x)
        calls.append((x.detach().cpu().numpy(), out.detach().cpu().numpy()))
        return out
    torch.exp = spy
    try:
        yield
    finally:
        torch.exp = orig


def first_divergences(name, draws, calls_a, calls_b, n, R):
    """{(p, r): ULP distance of the two runs' accept probabilities at the
    restart's first decision (Metropolis flip or PT swap) where the runs
    part}, from their ``exp`` calls in call order and the shared draws."""
    import numpy as np

    def ulps(a, b):
        return np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64))
    u = draws[2].numpy()
    P, K = u.shape[0], PT_RUNGS if name == "pt-jax" else 1
    rung = np.arange(K)
    calls = iter(zip(calls_a, calls_b))
    out = {}
    for t in range(u.shape[2]):
        steps = []
        for i in range(n):
            (_, pa), (_, pb) = next(calls)
            uc = u[:, :, t, ..., i].reshape(pa.shape)
            steps.append((uc < pa, uc < pb, pa, pb))
        if name == "pt-jax":                 # swap_every 1: every sweep
            (_, pa), (_, pb) = next(calls)
            left = (rung % 2 == t % 2) & (rung + 1 < K)
            uc = draws[3].numpy()[:, :, t]
            steps.append((left & (uc < pa), left & (uc < pb), pa, pb))
        for da, db, pa, pb in steps:
            diff = (da != db).reshape(P, R, -1)
            dist = np.where(diff, ulps(pa, pb).reshape(P, R, -1), -1)
            for p, r in zip(*np.nonzero(diff.any(-1))):
                out.setdefault((int(p), int(r)), int(dist[p, r].max()))
    check(next(calls, None) is None, f"{name}: exp calls left over")
    return out


def cross_device(name, J, n_true):
    """The same draws (made on the card) on the card and on the CPU: tabu-jax
    bitwise; sa-jax / pt-jax restarts equal, a differing one only past a
    decision whose two probabilities are within 2 ULP, at most 1% of
    restarts."""
    import numpy as np
    import torch
    P, n = J.shape[0], J.shape[-1]
    draws = search_draws(name, P, CROSS_RUNS, n, n_true, "cuda")
    cpu_draws = tuple(d.cpu() for d in draws)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # small CPU ops: one thread is fastest
    try:
        card = search_runs(name, J, n_true, CROSS_RUNS, SEED, "cuda", draws)
        cpu = search_runs(name, J, n_true, CROSS_RUNS, SEED, "cpu",
                          cpu_draws)
        differ = ((card[0] != cpu[0]) | (card[1] != cpu[1]).any(-1))
        row = {"solver": name, "shape": [P, CROSS_RUNS, n],
               "restarts_differing": int(differ.sum()),
               "all_outputs_equal": all(np.array_equal(a, b)
                                        for a, b in zip(card, cpu))}
        if name == "tabu-jax":
            check(row["all_outputs_equal"], f"tabu-jax: card and CPU differ "
                  f"with the same draws ({row})")
        elif differ.any():
            calls_card, calls_cpu = [], []
            with exp_spy(calls_card):
                search_runs(name, J, n_true, CROSS_RUNS, SEED, "cuda", draws)
            with exp_spy(calls_cpu):
                search_runs(name, J, n_true, CROSS_RUNS, SEED, "cpu",
                            cpu_draws)
            first = first_divergences(name, cpu_draws, calls_card,
                                      calls_cpu, n, CROSS_RUNS)
            row["first_divergence_ulps"] = sorted(first.values())
            unexplained = {(int(p), int(r))
                           for p, r in zip(*np.nonzero(differ))} - set(first)
            check(not unexplained, f"{name}: restarts {sorted(unexplained)} "
                  "differ with no divergent decision")
            check(max(first.values()) <= 2, f"{name}: a first divergence "
                  f"is no tie: {first}")
            check(differ.sum() <= 0.01 * differ.size,
                  f"{name}: {int(differ.sum())} of {differ.size} restarts "
                  "differ (limit 1%)")
    finally:
        torch.set_num_threads(threads)
    if name != "tabu-jax":
        from repro_torch.solvers.pt_jax import beta_ladder
        from repro_torch.solvers.sa_jax import sa_betas
        pairs = ([sa_betas(SA_SWEEPS, torch_device=d) for d in ("cuda", "cpu")]
                 if name == "sa-jax" else
                 [beta_ladder(PT_RUNGS, torch_device=d)
                  for d in ("cuda", "cpu")])
        a, b = (x.cpu().numpy().view(np.int32).astype(np.int64)
                for x in pairs)
        row["beta_table_max_ulps"] = int(np.abs(a - b).max())
        check(row["beta_table_max_ulps"] <= 2, f"{name}: beta tables of "
              "card and CPU more than 2 ULP apart")
    return row


def launches_per_step(name, J, n_true):
    """Device kernels (torch.profiler, CUDA activity) one flip step of the
    solver launches at the suite's (P, RUNS) batch: the difference between
    runs of two lengths (sweeps for SA / PT, over n flips a sweep; tabu
    iterations), so set-up launches cancel. ``ops`` counts the torch ops
    dispatched the same way (a view launches nothing, a reduction may
    launch two)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            OpCount.n += 1
            return func(*args, **(kwargs or {}))

    n = J.shape[-1]
    lengths = (4, 8) if name != "tabu-jax" else (32, 64)
    per = n if name != "tabu-jax" else 1
    kernels, ops = [], []
    for size in lengths:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            search_runs(name, J, n_true, RUNS, SEED, "cuda", size=size)
            torch.cuda.synchronize()
        kernels.append(sum(1 for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA))
        OpCount.n = 0
        with OpCount():
            search_runs(name, J, n_true, RUNS, SEED, "cuda", size=size)
        ops.append(OpCount.n)
    steps = (lengths[1] - lengths[0]) * per
    return {"kernels_per_flip_step": (kernels[1] - kernels[0]) / steps
            if kernels[0] else None,
            "ops_per_flip_step": (ops[1] - ops[0]) / steps,
            "profiled_lengths": list(lengths),
            "kernels_profiled": kernels, "ops_counted": ops}


def phase_search(oracle_path):
    """The classical search tier on the card, on the paper's 64-spin suite:
    sa-jax, pt-jax and tabu-jax at RUNS restarts (one batch per bucket,
    per-restart energies recomputed in float64 from their spins, SR, wall
    of the bucket, launches per flip step), sa-numpy and tabu at HOST_RUNS;
    the same draws on the card and on the CPU; the oracle's tabu-jax tier
    at or below host tabu's best on every problem; and the oracle refresh
    of ``ProblemSuite.grid()`` into an empty cache, one ``_tabu_jax_batch``
    per pad bucket, timed."""
    import numpy as np

    from repro_torch.api import ProblemSuite, best_known_energies, solve_suite
    from repro_torch.api import oracle as oracle_mod
    from repro_torch.api.batching import plan_buckets
    from repro_torch.solvers.tabu import tabu_search
    suite = ProblemSuite.random(**SUITE)
    (bucket,) = suite.buckets()
    J, n_true = bucket.J, list(suite.sizes)
    J64 = J.astype(np.float64)
    out = {}
    for name in SEARCH_DEVICE + SEARCH_HOST:
        on_card = name in SEARCH_DEVICE
        runs = RUNS if on_card else HOST_RUNS
        rep = solve_suite(suite, solver=name, runs=runs, seed=SEED,
                          torch_device="cuda", oracle_path=oracle_path,
                          **({"warmup": True} if on_card else {}))
        check(rep.dispatches == (1 if on_card else 0),
              f"{name}: {rep.dispatches} dispatches for one bucket")
        check(all(len(e) == runs and np.isfinite(e).all()
                  for e in rep.energies), f"{name}: energies malformed")
        for i, p in enumerate(suite):
            s = rep.best_sigma[i].astype(np.float64)
            check(-0.5 * s @ J64[i] @ s == rep.best_energy[i],
                  f"{name} problem {i}: best energy is not its spins'")
        row = {"solver": name, "runs": runs, "wall_s": rep.wall_s,
               "first_call_extra_s": rep.compile_s,
               "anneals_per_s": rep.anneals_per_s}
        if on_card:
            e, s = search_runs(name, J, n_true, RUNS, SEED, "cuda")[:2]
            check(np.array_equal(e, np.stack(rep.energies)),
                  f"{name}: the direct call differs from the solve")
            s64 = s.astype(np.float64)
            e64 = -0.5 * np.einsum("pri,pij,prj->pr", s64, J64, s64)
            check(np.array_equal(e64, e), f"{name}: a per-restart energy "
                  "is not that of its spins (float64)")
            row.update(launches_per_step(name, J, n_true))
            row["same_draws_card_vs_cpu"] = cross_device(name, J, n_true)
        m = rep.metrics()
        row.update(success_rate=[float(x) for x in m["success_rate"]],
                   mean_success_rate=m["mean_success_rate"],
                   best_energy=rep.best_energy.tolist(),
                   best_known=rep.best_known.tolist())
        emit({"phase": "search", **row})
        out[name] = row

    # the oracle's batched tier against the host tabu it replaced
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        bk = best_known_energies(suite, path=os.path.join(tmp, "o.json"),
                                 torch_device="cuda")
        tier_s = time.perf_counter() - t0
        host = np.array([tabu_search(p.J_levels,
                                     n_restarts=oracle_mod.TABU_JAX_ORACLE_RESTARTS,
                                     seed=0)[0] for p in suite])
        emit({"phase": "search", "oracle_tabu_jax": bk.tolist(),
              "oracle_host_tabu": host.tolist(), "tabu_jax_tier_s": tier_s,
              "at_or_below_host": bool(np.all(bk <= host))})
        check(np.all(bk <= host), f"tabu-jax oracle above host tabu: "
              f"{bk} vs {host}")

        grid = ProblemSuite.grid()
        batches = []
        orig = oracle_mod._tabu_jax_batch

        def timed_batch(J, n_true, seed, torch_device):
            t = time.perf_counter()
            e = orig(J, n_true, seed, torch_device)
            batches.append({"shape": list(np.shape(J)),
                            "s": time.perf_counter() - t})
            return e
        oracle_mod._tabu_jax_batch = timed_batch
        try:
            t0 = time.perf_counter()
            bk = best_known_energies(grid, path=os.path.join(tmp, "g.json"),
                                     torch_device="cuda")
            refresh_s = time.perf_counter() - t0
        finally:
            oracle_mod._tabu_jax_batch = orig
        large = [n for n in grid.sizes if n > oracle_mod.BRUTE_FORCE_MAX_N]
        expect = plan_buckets(large).num_buckets
        emit({"phase": "search", "grid_refresh": {
            "problems": len(grid), "tabu_jax_problems": len(large),
            "brute_force_problems": len(grid) - len(large),
            "batches": batches, "expected_batches": expect,
            "refresh_s": refresh_s, "finite": bool(np.isfinite(bk).all())}})
        check(len(batches) == expect >= 1 and np.isfinite(bk).all(),
              f"grid refresh: {len(batches)} batches, {expect} buckets")
    return out


#: the reference's native sizes of the zoo round trip (tests/test_workloads.py)
ZOO_SIZES = {"mis": 9, "vertex-cover": 9, "coloring": 5, "3sat": 5, "tsp": 4}
ZOO_RUNS, ZOO_BLOCK = 48, 32


def zoo_star():
    """A MIS encoding with a hub of 60 leaves: levels up to 118, the
    largest that one 64-spin die's bucket carries."""
    from repro_torch.workloads import get_workload
    edges = [[0, i] for i in range(1, 61)] + [[i, i + 1]
                                             for i in range(1, 60, 2)]
    return get_workload("mis").encode({"n": 61, "edges": edges})


def phase_zoo():
    """Every workload at the reference's sizes through every registered
    solver on the card (engine and chip-lns on the anneal kernel, sb-jax on
    the SB kernel at dt 0.25, as the reference tunes it); gates: the affine
    identity and a feasible decode for every solver, and the kernels
    launched. Then the anneal variants the engine picks (f32 under
    perturbation; int8 for gd, bf16 on request) against their plain
    versions on the zoo's buckets, whose levels pass the DAC's 15 (TSP,
    and a star of level 118)."""
    import numpy as np
    import torch

    from repro_torch.api import ProblemSuite, get_solver, list_solvers
    from repro_torch.core.lfsr import lfsr_voltage_inits
    from repro_torch.kernels import ising_anneal as ka
    from repro_torch.kernels import sb_kernel as sbk
    from repro_torch.workloads import get_workload, model_energy, spins_to_bits
    problems = {name: get_workload(name).random_problem(size, seed=2)
                for name, size in ZOO_SIZES.items()}
    tuned = {"sb-jax": {"dt": 0.25}}
    ka.reset_launches()
    sbk.reset_launches()
    for name, p in problems.items():
        wl = get_workload(name)
        solved = {}
        for sname, caps in list_solvers().items():
            if caps.max_n is not None and p.n > caps.max_n:
                continue
            rep = get_solver(sname, torch_device="cuda",
                             **tuned.get(sname, {})).solve(
                ProblemSuite([p]), runs=ZOO_RUNS, seed=5, block=ZOO_BLOCK)
            sigma = rep.best_sigma[0]
            mv = wl.model_value(p, spins_to_bits(sigma))
            res = wl.roundtrip(p, sigma)
            solved[sname] = {"feasible": bool(res.feasible),
                             "objective": float(res.objective),
                             "identity": bool(mv == model_energy(p, sigma)),
                             "wall_s": rep.wall_s}
            check(solved[sname]["identity"], f"zoo {name} {sname}: "
                  "4 f(bits) != energy + offset")
            check(res.feasible, f"zoo {name} {sname}: infeasible decode "
                  f"{res}")
        emit({"phase": "zoo", "workload": name, "n": p.n,
              "max_level": int(np.abs(p.levels).max()),
              "fits_dac": bool(p.meta["fits_dac"]), "solvers": solved})
        check(set(solved) == set(list_solvers()), f"zoo {name}: solvers "
              f"{sorted(solved)} took part")
    launches = {**ka.launches, **sbk.launches}
    emit({"phase": "zoo", "launches": launches})
    check(launches["ising_anneal_f32"] >= 2 * len(problems) and
          launches["sb_bsb"] >= len(problems),
          f"zoo: the engine / chip-lns / sb-jax solves launched {launches}")

    cases = [(name, p, ZOO_BLOCK) for name, p in problems.items()]
    cases.append(("star", zoo_star(), 64))
    for label, p, block in cases:
        (bucket,) = ProblemSuite([p]).buckets(block)
        J = torch.as_tensor(bucket.J, device="cuda")
        v0 = torch.as_tensor(lfsr_voltage_inits(bucket.n_pad, ZOO_RUNS,
                                                seed=3))[None].to("cuda")
        unit_dev, unit_pert = variants()["int8"]
        keys = ("j_dtype", "shape", "bitwise", "bitwise_repeat",
                "bitwise_plans", "max_abs_err", "runs_differing", "runs")
        for j_dtype, (dev, pert) in variants().items():
            st = compare_one(J, v0, unit_dev, unit_pert, j_dtype)
            emit({"phase": "zoo", "case": label, "schedule": "unit",
                  "max_level": int(np.abs(p.levels).max()),
                  **{k: st[k] for k in keys}})
            check(st["bitwise"] and st["bitwise_repeat"],
                  f"zoo {label} {j_dtype} unit: kernel and plain differ")
            if j_dtype == "int8":
                continue
            st = compare_one(J, v0, dev, pert, j_dtype)
            emit({"phase": "zoo", "case": label, "schedule": "perturbation",
                  **{k: st[k] for k in keys}})
            what = f"zoo {label} {j_dtype} perturbation"
            check(st["bitwise_repeat"], f"{what}: not repeatable")
            if j_dtype == "bfloat16":
                check(st["bitwise"], f"{what}: kernel and plain differ")
            check(st["runs_differing"] <= 0.05 * st["runs"] and
                  st["max_abs_err_agreeing_runs"] <= 1e-5 and
                  st["max_sr_gap"] <= 0.03, f"{what}: {st}")


PHASES = ("compare", "main", "scan", "timing", "sb_compare", "sb_main",
          "gset", "sb_timing", "search", "zoo")


def main(argv=None) -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run after the build "
                         "(default: all; the kernels line and the last "
                         "line are printed only when all ran)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; choose from {PHASES}")
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
    with tempfile.TemporaryDirectory() as tmp:
        oracle_path = os.path.join(tmp, "oracle_cache_torch.json")
        run = {
            "compare": phase_compare,
            "main": lambda: phase_main(oracle_path),
            "scan": lambda: phase_scan(oracle_path),
            "timing": phase_timing,
            "sb_compare": phase_sb_compare,
            "sb_main": lambda: phase_sb_main(oracle_path),
            "gset": phase_gset,
            "sb_timing": phase_sb_timing,
            "search": lambda: phase_search(oracle_path),
            "zoo": phase_zoo,
        }
        out = {name: run[name]() for name in PHASES if name in phases}
    emit({"phase": "end", "total_s": time.perf_counter() - START})
    if set(out) != set(PHASES):
        print(nvidia_smi(), flush=True)
        emit({"phases_run": list(out)})
        return 0
    err, launches, timing = out["compare"], out["main"], out["timing"]
    sb_err, sb_launches = out["sb_compare"], out["sb_main"]
    sb_timing = out["sb_timing"]

    kernels = []
    for j_dtype, row in timing.items():
        kernels.append({
            "name": row["name"], "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ising_anneal.cu",
            "replaces": "src/repro/kernels/ising_anneal.py:59",
            "launches": launches[row["name"]],
            "max_abs_err": err[j_dtype], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    for variant, row in sb_timing.items():
        kernels.append({
            "name": row["name"], "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sb_kernel.cu",
            "replaces": "src/repro/kernels/sb_kernel.py:79",
            "launches": sb_launches[row["name"]],
            "max_abs_err": sb_err[variant], "ms": row["ms"],
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
