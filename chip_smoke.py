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
                spills, the bounds and the products-only yardstick
                (library_ms); the card's cluster capacity at the Gset
                shape; the kernel at
                7000 spins; the plan's pick against plans of other cluster
                sizes at the Gset, (2, 50, 300) and 7000-spin shapes; one
                end-to-end sb-jax solve at the Gset shape.
 10. search   — the classical search tier on the 64-spin suite: sa-jax,
                pt-jax and tabu-jax at 1024 restarts (one batch per bucket,
                per-restart energies recomputed in float64 from their
                spins, SR, the bucket's wall, kernels per flip step),
                sa-numpy and tabu at 16; the same draws on the card and on
                the CPU (tabu-jax bitwise, sa-jax / pt-jax to the tie rule),
                and a seeded solve with nothing injected on both (the same
                rule; sb-jax bitwise); pt-jax on the fig5 grid at 1024
                restarts (its wall and peak allocated memory);
                the oracle's tabu-jax tier at or below host tabu on every
                problem; the oracle refresh of the fig5 grid, one tabu-jax
                batch per pad bucket, timed.
 11. zoo      — every workload of the zoo at the reference's sizes through
                every registered solver (the affine identity and a feasible
                decode each; engine and chip-lns launch the anneal kernel,
                sb-jax the SB kernel); every anneal variant against its
                plain version on the zoo's buckets, whose levels pass the
                DAC's 15 (TSP 60, a star encoding 118).
 12. physics  — ode-jax through solve_suite on the 64-spin suite at 1024
                restarts (perturbation vs gd, SR against the oracle, one
                dispatch each, kernels an Euler step from torch.profiler);
                the discrete limit bitwise against the port's scan path on
                the card; the reference's robustness surface (1032 virtual
                chips, 4 restarts, noise 0.1) in exactly two dispatches,
                gates SR(perturbation) > 0 and >= SR(baseline) at the
                nominal corner, the reference's recorded SR beside it;
                counter-based normals on the card against the CPU.
 13. serve    — an IsingService over engine (the anneal kernel) at the
                serve CLI's sizes 16/32/64, runs 32, max batch 64: a burst
                of 128 requests, one dispatch per coalesced bucket, every
                result revalidated in float64; a chaos run whose seeded
                plan crashes every primary dispatch, answered by the
                fallback chain's sb-jax rung (the SB kernel); a 2-worker
                IsingFleet with one worker killed (zero lost tickets);
                launch/serve_ising.py in a subprocess.
 14. fabric   — the mega-fabric (fabric-jax) on virtual dies of the card,
                with the reference benchmark's settings
                (benchmarks/fabric_scaling.py): FieldExchange at N=2000
                bitwise against the float64 host product for K = 1, 3, 8,
                with each call's host time; both mesh-invariance rows
                bit-identical (N=252 K 1 vs 8, N=378 K 1 vs 2); fabric-jax
                bitwise equal to engine at N=48; the N=2000 duel at K=8
                (dispatches == colors x sweeps == anneal launches, cut from
                energy == cut from spins, best energy within 2% of
                chip-lns's and cut within 2% of the reference's recorded
                4144, the ledger's per-sweep split); the anneal kernel
                against its plain version on the first color phase's batch
                (tiles plus the boundary-field ancilla) of the duel
                (64, 4, 64) and of the CLI's solve (4096, 8, 64), unit
                schedule bitwise and the fabric's perturbed schedule within
                the compare phase's limits; the solve CLI on one N=2000 Gset problem with --mesh-devices 8
                in a subprocess.
 15. lm       — the LM serving path: qwen3-0.6b reduced() in float32 on
                the card against the CPU with the same weights (prefill
                logits within 1e-4, 8 greedy tokens equal); serve_lm.serve
                at full size (28 layers, d_model 1024, vocab 151936,
                bfloat16) at batch 4, prompt 64, gen 32 with its times and
                peak memory; finite logits and the top-1 agreement of
                bfloat16 with float32 on the same weights; the serve_lm CLI
                at full size in a subprocess.
 16. lm_families — the other model families: each one's reduced() config
                in float32 on the card against the CPU with the same
                weights (granite-moe-3b, olmoe-1b-7b, llava-next-mistral-7b,
                hubert-xlarge, zamba2-7b at 5 layers, rwkv6-3b; outputs
                within 1e-4, 8 greedy tokens equal where the family
                decodes, MoE's first-layer routing equal); olmoe-1b-7b at
                full width cut to 4 of its 16 layers (d_model 2048, 64
                experts, top-8, bfloat16) through serve_lm.serve at batch
                4, prompt 64, gen 32 with its times and peak memory, bf16's
                top-1 agreement with f32 on the same weights, the serve_lm
                CLI at that size in a subprocess; one full-width pass,
                cut in depth (FULL_PASS_LAYERS), of zamba2-7b
                and rwkv6-3b (serve_lm.serve), llava-next-mistral-7b
                (576 vision embeddings over a 640-token prompt, batch 2,
                8 decode steps) and hubert-xlarge ((2, 500, 1280) frames, bf16 and
                f32, whole), each with its wall and peak memory. Every model is
                drawn from seed 0 on a CPU generator; the bf16-vs-f32
                checks reuse the weights serve drew (a spy on its init).
 17. mesh     — seeded weights and the sharding layer: the weights that
                train's own init (each family's reduced() config, and
                qwen3-0.6b at full width) and serve's own init (each
                decoding family's reduced() config) give on the card equal
                the CPU's for seed 0, bitwise, leaf by leaf (the count of
                leaves that differ must be 0); the first MoE layer of
                olmoe-1b-7b at full width (64 experts, top-8, F = 1024) on
                a (2, 16) prompt in f32 under virtual_mesh((1, tp)) for tp
                = 1, 2, 4: tp = 1 bitwise equal to the path with no mesh,
                tp = 2, 4 within rtol 1e-4 / atol 1e-5 of it, routing bitwise at
                every tp, each tp's ms (CUDA events, median of 5).
 18. train    — the LM trainer: one train step of each family's reduced()
                config in float32 on the card against the CPU from the
                same state (qwen3-0.6b, olmoe-1b-7b, llava-next-mistral-7b,
                hubert-xlarge, zamba2-7b at 5 layers, rwkv6-3b; loss,
                grad_norm, lr_scale and every gradient leaf within
                TRAIN_TOL), the card's step repeated bitwise or not;
                whether one Mamba-2 layer's gradient at zamba2-7b's full
                width is finite (normed inputs and x 4; reported); the
                reference's restart protocol on the card (reduced
                qwen3-0.6b: 20 straight steps against 10, a restore and 10
                more; losses at rtol 1e-5, run twice, bitwise or not);
                qwen3-0.6b at full width and depth through
                launch.train.train (bfloat16, batch 8, seq 512, 20 steps,
                one checkpoint at step 20) under make_host_mesh("cuda"):
                finite losses whose last-5 mean is below the first-5 mean,
                one step from the trained state with no mesh active
                bitwise equal to the same step under the mesh (loss and
                every leaf of the new state), step ms, tokens/s, model_flops over the step as a share of
                HW()'s bf16 peak (beside the old 6 x params x tokens), peak
                memory, the checkpoint's save and restore seconds and
                bytes, the restore with shardings= bitwise; one full step
                under roofline.op_cost.analyze (FLOPs, bytes, the report's
                terms against HW()'s H100 constants, useful FLOPs ratio,
                the measured step over the bound); MoE at top-8 (reduced
                olmoe-1b-7b, top_k = 8): two steps from one state and the
                gradient repeated on the card, bitwise or not, beside the
                same check with the token gather as torch.gather.
 19. dryrun   — the multi-pod dry-run (launch.dryrun) on the card's
                torch: in a child Python, rank 0 of a fake world of 256
                ranks with torch_device="cuda" traces qwen2-7b x decode_32k,
                olmoe-1b-7b x train_4k and ising-chip64 on the (16, 16)
                production mesh (per-rank GiB, its three terms, trace
                seconds; a cell that fails fails the phase); then, with no
                process group, qwen3-0.6b at full width with train's batch
                (8 x 512) traced on make_host_mesh("cuda") against the real
                step from train's state: counted FLOPs and bytes equal
                op_cost.analyze of the real step exactly, the argument
                bytes equal the state's and batch's bytes (printed beside
                the allocation a copy of them takes), the temp estimate
                held within 0.8-1.25x of the real step's peak allocation
                above its arguments (reset_peak_memory_stats before it);
                the phase's wall.
 20. examples — the port's examples and paper scripts
                (examples/torch/quickstart.py, maxcut_demo.py,
                serve_lm.py, train_lm.py; scripts/torch/
                calibrate_perturbation.py, baseline_vs_optimized.py), each
                through main([..., "--torch-device", "cuda"]) in-process
                at the reference's sizes (train_lm --small 100 steps and
                its ~100M path 20, not 300), the anneal kernel's launches
                counted around the phase; gates: quickstart SR(perturbation) > SR(gd),
                maxcut_demo's assert, serve_lm's tokens equal to the CPU's,
                train_lm --small finite with its last-5 mean loss below
                its first-5, calibrate's default row SR(perturbation) >
                SR(gd), baseline_vs_optimized's mean SR improvement > 1;
                each file's wall and the card's name and power limit.
Each phase ends with a ``{"phase": ..., "phase_s": ...}`` line, its wall.
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
        except ValueError as err:          # a refusal, not a launch failure
            refused[field] = str(err).split(" the launch plan")[0]
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
#: (case, variant) -> ms of compare_sb's one call of the plain version
#: (CUDA events), which phase sb_timing reports at the Gset shape in place
#: of calling it again (20-30 s a call there)
SB_PLAIN_MS: dict = {}


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
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    xp = sb_reference(Jc, x0, y0, **kw)
    b.record()
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
        "plain_ms": a.elapsed_time(b),
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
            SB_PLAIN_MS[label, variant] = st["plain_ms"]
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
        except ValueError as err:          # a refusal, not a launch failure
            refused[field] = str(err).split(" the launch plan")[0]
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
    the plan's default block_r) and plain version (median of 3 dense; at
    Gset phase sb_compare's one call on the same inputs, ``SB_PLAIN_MS``,
    or one call after a warm-up where that phase did not run) at both main
    shapes, the bound (all operations, and the
    real spins' alone: sum over problems of 2·R·n²·T), the launch plan with
    its instance's registers and spills, and the products-only yardstick
    (``library_ms``: T f32 products (P, R, N) @ (P, N, N), TF32 off, by
    ``products_ms``); at the Gset shape the card's cluster capacity; the
    kernel alone on the 7000-spin graph; the
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
        # a yardstick only: the port never calls it, and no single library
        # call computes an SB integration
        lib_ms, lib_all = products_ms(P, R, N, steps, torch.float32)
        for variant in SB_VARIANTS:
            kw = dict(variant=variant, n_steps=steps, dt=0.5, a0=1.0)
            k = cuda_ms(lambda: fused_sb_kernel(Jc, x0, y0, **kw), 5)
            # the plain version at 7000 spins takes seconds a call; the
            # compare phase has held it against the kernel there. At Gset,
            # where a call takes 20-30 s, the compare phase's one call on
            # the same inputs (after the plain version ran at other shapes)
            if label == "gset_7000":
                pl = None
            elif label == "gset" and (label, variant) in SB_PLAIN_MS:
                pl = [SB_PLAIN_MS[label, variant]]
            else:
                pl = cuda_ms(lambda: sb_reference(Jc, x0, y0, **kw),
                             3 if label == "maxcut_dense" else 1)
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
                   "library_ms": lib_ms, "library_ms_all": lib_all,
                   "library_what": f"{steps} x torch.matmul ({P}, {R}, {N}) "
                                   f"@ ({P}, {N}, {N}) float32, TF32 off"}
            emit({"phase": "timing", "shape_of": label, **row})
            if label == "gset":
                rows[variant] = row
        if label == "gset":
            check(plan["spill_stores"] == 0 and plan["spill_loads"] == 0,
                  f"the Gset-shape instance spills: {plan}")
            lib = sbk._library()
            capacity = {c: lib.sb_cluster_capacity(1, c, plan["threads"],
                                                   plan["smem_bytes"])
                        for c in range(1, sbk.MAX_CLUSTER + 1)}
            emit({"phase": "timing", "shape_of": label,
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


def cross_device(name, J, n_true, injected=True):
    """One solve on the card and on the CPU: tabu-jax bitwise; sa-jax /
    pt-jax restarts equal, a differing one only past a decision whose two
    probabilities are within 2 ULP, at most 1% of restarts. ``injected``:
    the same whole-stream draws, made on the card, handed to both; else a
    seeded solve with nothing injected, each device drawing its own
    counter-based draws a sweep at a time."""
    import numpy as np
    import torch
    P, n = J.shape[0], J.shape[-1]
    if injected:
        draws = search_draws(name, P, CROSS_RUNS, n, n_true, "cuda")
        cpu_draws = tuple(d.cpu() for d in draws)
    else:
        draws = cpu_draws = None
    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # small CPU ops: one thread is fastest
    try:
        card = search_runs(name, J, n_true, CROSS_RUNS, SEED, "cuda", draws)
        cpu = search_runs(name, J, n_true, CROSS_RUNS, SEED, "cpu",
                          cpu_draws)
        differ = ((card[0] != cpu[0]) | (card[1] != cpu[1]).any(-1))
        row = {"solver": name, "shape": [P, CROSS_RUNS, n],
               "draws": "injected" if injected else "seeded",
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
            # a seeded solve's draws, materialised for the analysis: the
            # whole stream equals the per-sweep draws (tests/test_torch_rng)
            seen = cpu_draws if injected else search_draws(
                name, P, CROSS_RUNS, n, n_true, "cpu")
            first = first_divergences(name, seen, calls_card, calls_cpu, n,
                                      CROSS_RUNS)
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
            row["seeded_card_vs_cpu"] = cross_device(name, J, n_true,
                                                     injected=False)
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
    emit({"phase": "search", "sb_seeded_card_vs_cpu":
          sb_cross_device(J, n_true)})
    emit({"phase": "search", "pt_grid": pt_on_the_grid()})
    return out


def sb_cross_device(J, n_true):
    """A seeded sb-jax solve (no injected inits) on the card and on the
    CPU: energies and spins bitwise equal (the inits are counter-based, the
    kernel is bitwise its plain version, and the plain version rounds each
    op once on either device)."""
    import numpy as np
    import torch

    from repro_torch.solvers.sb_jax import simulated_bifurcation_jax_runs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {dev: simulated_bifurcation_jax_runs(
            J, n_true=n_true, n_restarts=CROSS_RUNS, seed=SEED,
            torch_device=dev) for dev in ("cuda", "cpu")}
    finally:
        torch.set_num_threads(threads)
    equal = all(np.array_equal(a, b) for a, b in zip(out["cuda"],
                                                     out["cpu"]))
    row = {"shape": [J.shape[0], CROSS_RUNS, J.shape[-1]],
           "all_outputs_equal": equal}
    check(equal, f"sb-jax: seeded card and CPU solves differ ({row})")
    return row


#: the whole-stream PT draws the fig5 grid at RUNS restarts would hold:
#: int32 orders + float32 uniforms over (P, R, T, K, n)
def pt_grid_whole_stream_bytes(P, n):
    return P * RUNS * PT_SWEEPS * PT_RUNGS * n * 8


def pt_on_the_grid():
    """pt-jax on ``ProblemSuite.grid()`` (one (400, 64, 64) bucket) at RUNS
    restarts, its draws made a sweep at a time: the wall and the peak of
    ``torch.cuda.max_memory_allocated`` over the solve."""
    import numpy as np
    import torch

    from repro_torch.api import ProblemSuite, solve_suite
    grid = ProblemSuite.grid()
    (bucket,) = grid.buckets()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rep = solve_suite(grid, solver="pt-jax", runs=RUNS, seed=SEED,
                      torch_device="cuda", oracle=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    whole = pt_grid_whole_stream_bytes(*bucket.J.shape[:2])
    row = {"shape": [bucket.J.shape[0], RUNS, PT_RUNGS, bucket.n_pad],
           "sweeps": PT_SWEEPS, "wall_s": wall, "solve_wall_s": rep.wall_s,
           "peak_allocated_gib": peak / 2**30,
           "allocated_before_gib": before / 2**30,
           "whole_stream_draws_gib": whole / 2**30,
           "dispatches": rep.dispatches,
           "mean_swap_acceptances": float(np.mean(
               rep.meta["swap_acceptances"]))}
    check(rep.dispatches == 1 and all(len(e) == RUNS and np.isfinite(e).all()
                                      for e in rep.energies),
          f"pt-jax on the grid: {row}")
    check(peak < whole, f"pt-jax on the grid peaked at {peak} bytes, more "
          f"than its whole-stream draws ({whole})")
    return row


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


#: the reference's robustness surface (benchmarks/device_robustness.py at
#: its quick size): instance seed 77, 3 mismatch x 2 leakage-spread corners
#: of 172 chips each, 4 restarts, thermal noise 0.1, 2 Euler substeps a slot
ROBUST_SEED, ROBUST_CHIPS, ROBUST_RESTARTS = 77, 172, 4
ROBUST_SIGMAS, ROBUST_SPREADS = (0.0, 0.05, 0.15), (0.0, 0.3)
ROBUST_NOISE, ROBUST_VARIATION_SEED, ROBUST_NOISE_KEY = 0.1, 100, 7
#: the reference's nominal corner, recorded in BENCH_device.json (a CPU run
#: of the JAX package: quality, not speed)
ROBUST_RECORDED = {"sr_perturbation": 0.34738372093023256,
                   "sr_baseline": 0.0}


def ode_kernels_per_step(params, chips, dev, pert, J, v0):
    """Device kernels (torch.profiler, CUDA activity) one Euler step of
    ``fleet_anneal`` launches: the difference between anneals of 32 and 64
    steps, so set-up launches cancel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.physics import fleet_anneal
    counts = []
    for steps in (32, 64):
        d = dataclasses.replace(dev, anneal_sweeps=steps / (
            dev.slots_per_sweep * dev.substeps))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fleet_anneal(J, v0, d, pert, params=params, chips=chips,
                         key=ROBUST_NOISE_KEY, torch_device="cuda")
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    return {"kernels_per_step": (counts[1] - counts[0]) / 32
            if counts[0] else None, "kernels_profiled": counts}


def normals_card_vs_cpu():
    """Counter-based normals of one (8, 1024, 64) step drawn on the card
    and on the CPU: the largest difference in float32 ULP of the larger
    magnitude, held to ``rng.NORMAL_ULP_BOUND``."""
    import numpy as np

    from repro_torch import rng
    k = rng.key(SEED, 1)
    z = [rng.normal(*rng.bits(k, 3, rng.counters((8, RUNS, 64), dev)))
         .cpu().numpy() for dev in ("cuda", "cpu")]
    ulp = np.spacing(np.maximum(np.abs(z[0]), np.abs(z[1])))
    worst = float(np.max(np.abs(z[0] - z[1]) / ulp))
    row = {"elements": int(z[0].size), "max_ulps": worst,
           "differing": int((z[0] != z[1]).sum()),
           "bound_ulps": rng.NORMAL_ULP_BOUND}
    check(worst <= rng.NORMAL_ULP_BOUND, f"normals card vs CPU: {row}")
    return row


def phase_physics(oracle_path):
    """The physics tier on the card: ode-jax through ``solve_suite`` on the
    64-spin suite at RUNS restarts (perturbation and gd, SR against the
    oracle, one dispatch each, kernels an Euler step); the discrete limit
    bitwise against the port's scan path on the card; the reference's
    robustness surface (1032 chips in two dispatches) with its gates and
    its recorded SR beside; counter-based normals card vs CPU."""
    import numpy as np
    import torch

    from repro_torch.api import ProblemSuite, best_known_energies, solve_suite
    from repro_torch.core import (DEFAULT_PERTURBATION, NOMINAL, DeviceModel,
                                  anneal)
    from repro_torch.core.lfsr import lfsr_voltage_inits
    from repro_torch.metrics.success import success_rate
    from repro_torch.physics import (DEFAULT_PHYSICS, DISCRETE_LIMIT,
                                     ChipVariation, PhysicsParams,
                                     VariationModel, dispatch_count,
                                     fleet_anneal, reset_dispatch_count)
    suite = ProblemSuite.random(**SUITE)
    out = {}
    for variant in ("perturbation", "gd"):
        reset_dispatch_count()
        rep = solve_suite(suite, solver="ode-jax", runs=RUNS, seed=SEED,
                          torch_device="cuda", oracle_path=oracle_path,
                          variant=variant)
        check(rep.dispatches == dispatch_count() == 1,
              f"ode-jax {variant}: {rep.dispatches} dispatches")
        check(all(len(e) == RUNS and np.isfinite(e).all()
                  for e in rep.energies), f"ode-jax {variant}: energies")
        for i, p in enumerate(suite):
            s = rep.best_sigma[i].astype(np.float64)
            check(-0.5 * s @ p.J_levels.astype(np.float64) @ s ==
                  rep.best_energy[i], f"ode-jax {variant} problem {i}: "
                  "best energy is not its spins'")
        m = rep.metrics()
        out[variant] = {"mean_success_rate": m["mean_success_rate"],
                        "success_rate": [float(x) for x in
                                         m["success_rate"]],
                        "wall_s": rep.wall_s}
        emit({"phase": "physics", "solver": "ode-jax", "variant": variant,
              **out[variant], "best_energy": rep.best_energy.tolist(),
              "best_known": rep.best_known.tolist()})

    # the discrete limit against the port's scan path, on the card
    dev = DeviceModel()
    J, v0 = main_path_inputs(suite, RUNS, SEED, dev)
    for label, d, pert in (("perturbation", dev, DEFAULT_PERTURBATION),
                           ("gd", variants()["int8"][0], NOMINAL)):
        ref = anneal(J, v0, d, pert)
        ode = fleet_anneal(J, v0, d, pert, params=DISCRETE_LIMIT,
                           torch_device="cuda")
        same = (torch.equal(ode.v_final[0], ref.v_final) and
                torch.equal(ode.sigma[0], ref.sigma))
        emit({"phase": "physics", "discrete_limit": label,
              "shape": list(v0.shape), "bitwise_vs_scan": same})
        check(same, f"discrete limit ({label}) differs from the scan path")
    out["kernels_per_step_nominal"] = ode_kernels_per_step(
        DEFAULT_PHYSICS, None, dev, DEFAULT_PERTURBATION, J, v0)

    # the robustness surface: every corner's chips in one fleet
    rsuite = ProblemSuite.random(64, 0.5, 1, seed=ROBUST_SEED)
    bk = best_known_energies(rsuite, seed=2, path=oracle_path,
                             torch_device="cuda")
    (bucket,) = rsuite.buckets(64)
    rdev = dataclasses.replace(DeviceModel(), substeps=2)
    rv0 = np.stack([lfsr_voltage_inits(64, ROBUST_RESTARTS,
                                       seed=1 + 7919 * p, vdd=rdev.vdd,
                                       swing=rdev.init_swing)
                    for p in range(bucket.J.shape[0])])
    corners = [(m, t) for m in ROBUST_SIGMAS for t in ROBUST_SPREADS]
    chips = ChipVariation.concat([
        VariationModel(j_mismatch_sigma=m, tau_leak_spread=t).sample(
            ROBUST_VARIATION_SEED + i, ROBUST_CHIPS, 64)
        for i, (m, t) in enumerate(corners)])
    params = PhysicsParams(noise_sigma=ROBUST_NOISE)
    reset_dispatch_count()
    res, walls = {}, {}
    for label, pert in (("perturbation", DEFAULT_PERTURBATION),
                        ("baseline", NOMINAL)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[label] = fleet_anneal(bucket.J, rv0, rdev, pert, params=params,
                                  chips=chips, key=ROBUST_NOISE_KEY,
                                  torch_device="cuda").energy.cpu().numpy()
        walls[label] = time.perf_counter() - t0
    dispatches = dispatch_count()
    surface = []
    for i, (m, t) in enumerate(corners):
        sl = slice(i * ROBUST_CHIPS, (i + 1) * ROBUST_CHIPS)
        sr = {k: float(success_rate(v[sl].reshape(1, -1), bk)[0])
              for k, v in res.items()}
        surface.append({"mismatch_sigma": m, "tau_leak_spread": t,
                        "sr_perturbation": sr["perturbation"],
                        "sr_baseline": sr["baseline"],
                        "best_perturbation": float(
                            res["perturbation"][sl].min()),
                        "best_baseline": float(res["baseline"][sl].min())})
    nominal = surface[0]
    row = {"chips": chips.n_chips, "restarts": ROBUST_RESTARTS,
           "best_known": float(bk[0]), "dispatches": dispatches,
           "dispatch_wall_s": walls, "surface": surface,
           "nominal_corner": nominal,
           "reference_recorded_nominal": ROBUST_RECORDED,
           **ode_kernels_per_step(params, chips, rdev, DEFAULT_PERTURBATION,
                                  bucket.J, rv0)}
    emit({"phase": "physics", "robustness": row})
    check(dispatches == 2, f"robustness surface: {dispatches} dispatches")
    check(nominal["sr_perturbation"] > 0 and
          nominal["sr_perturbation"] >= nominal["sr_baseline"],
          f"robustness gates at the nominal corner: {nominal}")
    out["robustness"] = row
    out["normals"] = normals_card_vs_cpu()
    emit({"phase": "physics", "normals_card_vs_cpu": out["normals"],
          "kernels_per_step_nominal": out["kernels_per_step_nominal"]})
    return out


#: the serve CLI's problem mix and sizes (launch/serve_ising.py defaults)
SERVE_SIZES, SERVE_RUNS, SERVE_MAX_BATCH, SERVE_BURST = (16, 32, 64), 32, 64, 128


def serve_pool(count, seed=0):
    from repro_torch.api import Problem
    return [Problem.random_qubo(SERVE_SIZES[i % len(SERVE_SIZES)], 0.5,
                                seed=seed + i) for i in range(count)]


def phase_serve():
    """The serving stack on the card: an ``IsingService`` over ``engine``
    (the anneal kernel) takes a burst of SERVE_BURST distinct problems at
    the serve CLI's sizes (one dispatch per coalesced bucket, every result
    revalidated in float64); a chaos run whose seeded plan crashes every
    primary dispatch, answered down ``DEFAULT_FALLBACK_CHAIN`` (sb-jax: the
    SB kernel); a 2-worker ``IsingFleet`` with one worker killed on its
    first flush (zero lost tickets); ``launch/serve_ising.py`` in a
    subprocess."""
    from types import MappingProxyType

    import numpy as np

    from repro_torch.kernels import ising_anneal as ka
    from repro_torch.kernels import sb_kernel as sbk
    from repro_torch.serve import (DEFAULT_FALLBACK_CHAIN, FaultPlan,
                                   IsingFleet, IsingService,
                                   ResiliencePolicy, validate_row)
    pool = serve_pool(SERVE_BURST)
    ka.reset_launches()
    sbk.reset_launches()
    common = dict(solver="engine", runs=SERVE_RUNS, seed=SEED,
                  max_batch=SERVE_MAX_BATCH, max_wait_s=0.05, cache=False,
                  torch_device="cuda")
    with IsingService(**common) as svc:
        svc.submit(pool[0]).result(timeout=300)        # kernel build, warm
        t0 = time.perf_counter()
        tickets = svc.submit_many(pool)
        results = [t.result(timeout=300) for t in tickets]
        burst_s = time.perf_counter() - t0
        stats = svc.stats()
    valid = [validate_row(p, r.energies, r.sigma) for p, r in
             zip(pool, results)]
    burst = {"requests": len(pool), "sizes": list(SERVE_SIZES),
             "runs": SERVE_RUNS, "max_batch": SERVE_MAX_BATCH,
             "flushes": stats["flushes"], "dispatches": stats["dispatches"],
             "mean_batch": stats["mean_batch"], "wall_s": burst_s,
             "problems_per_s": len(pool) / burst_s,
             "p50_latency_s": stats["p50_latency_s"],
             "p95_latency_s": stats["p95_latency_s"],
             "revalidated": sum(valid),
             "validation_failures": stats["resilience"][
                 "validation_failures"],
             "anneal_launches": dict(ka.launches)}
    emit({"phase": "serve", "burst": burst})
    check(stats["dispatches"] == stats["flushes"] and stats["errors"] == 0,
          f"serve burst: {stats['flushes']} flushes, "
          f"{stats['dispatches']} dispatches, {stats['errors']} errors")
    check(stats["flushes"] <= 1 + -(-len(pool) // SERVE_MAX_BATCH),
          f"serve burst did not coalesce: {stats['flushes']} flushes")
    check(all(valid) and burst["validation_failures"] == 0,
          "serve burst: a result failed float64 revalidation")
    check(sum(ka.launches.values()) >= stats["dispatches"],
          f"serve burst: anneal kernel launches {dict(ka.launches)}")

    # chaos: every primary dispatch crashes; the fallback chain answers
    crash = FaultPlan.from_rates(seed=11, rate=1.0, kinds=("worker_crash",),
                                 horizon=64)
    chaos_pool = serve_pool(24, seed=1000)
    policy = ResiliencePolicy(fallback=DEFAULT_FALLBACK_CHAIN,
                              breaker_cooldown_s=60.0)
    sbk.reset_launches()
    with IsingService(**{**common, "max_wait_s": 0.5}, resilience=policy,
                      fault_plan=crash) as svc:
        results = [t.result(timeout=300)
                   for t in svc.submit_many(chaos_pool)]
        stats = svc.stats()
    chaos = {"requests": len(chaos_pool),
             "answered": sum(r is not None for r in results),
             "degraded": sum(r.degraded for r in results),
             "solvers": sorted({r.solver for r in results}),
             "revalidated": sum(validate_row(p, r.energies, r.sigma)
                                for p, r in zip(chaos_pool, results)),
             "injected": stats["faults"]["injected"],
             "resilience": {k: stats["resilience"][k] for k in
                            ("breaker_trips", "fallback_solves",
                             "failed_requests")},
             "sb_launches": dict(sbk.launches)}
    emit({"phase": "serve", "chaos": chaos})
    check(chaos["answered"] == chaos["revalidated"] == len(chaos_pool) and
          stats["errors"] == 0, f"serve chaos lost or spoiled tickets: "
          f"{chaos}")
    check(chaos["solvers"] == ["sb-jax"] and sum(sbk.launches.values()) > 0,
          f"serve chaos: the sb-jax rung did not answer on its kernel "
          f"({chaos})")

    # a 2-worker fleet; the worker that owns the first problem's batch key
    # is killed on its first flush
    from repro_torch.distributed.elastic import rendezvous_route
    from repro_torch.serve.service import batch_key
    fleet_pool = serve_pool(48, seed=2000)
    owners = [rendezvous_route(repr(batch_key(p, 1.0, 16)), ["w0", "w1"])
              for p in fleet_pool]
    plan = FaultPlan(seed=SEED, schedule=MappingProxyType(
        {(f"worker:{owners[0]}", 0): "worker_crash"}))
    with IsingFleet(workers=2, fault_plan=plan, block=16,
                    **{**common, "max_wait_s": 0.25}) as fleet:
        tickets = [fleet.submit(p, budget=1.0) for p in fleet_pool]
        results = [t.result(timeout=300) for t in tickets]
        fstats = fleet.stats()["fleet"]
    fl = {"workers": 2, "requests": len(fleet_pool),
          "killed": owners[0], "key_owners": sorted(set(owners)),
          "worker_crashes": fstats["worker_crashes"], "lost": fstats["lost"],
          "errors": fstats["errors"],
          "reclaimed": fstats["ledger"]["reclaimed"],
          "resolved_ok": fstats["ledger"]["resolved_ok"],
          "revalidated": sum(validate_row(p, r.energies, r.sigma)
                             for p, r in zip(fleet_pool, results))}
    emit({"phase": "serve", "fleet": fl})
    check(fl["worker_crashes"] == 1 and fl["lost"] == 0 and
          fl["errors"] == 0 and fl["resolved_ok"] == len(fleet_pool) ==
          fl["revalidated"], f"serve fleet: {fl}")

    # the serve CLI, a few seconds, as a user runs it
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_ising",
           "--solver", "engine", "--duration", "4", "--clients", "4",
           "--pool", "16"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=dict(os.environ,
                                             PYTHONPATH=os.path.join(ROOT,
                                                                     "src")))
    final = [line for line in proc.stdout.splitlines()
             if line.startswith("-- final:")]
    emit({"phase": "serve", "cli_rc": proc.returncode,
          "cli_final": final[0] if final else None})
    check(proc.returncode == 0 and final, f"serve_ising: rc "
          f"{proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return {"burst": burst, "chaos": chaos, "fleet": fl}


#: the reference fabric benchmark's settings (benchmarks/fabric_scaling.py):
#: the fabric's and chip-lns's solver options, restarts and seed, the duel's
#: quality tolerance, and its mesh-invariance rows (N, (K, K'))
FABRIC_OPTS = dict(anneal_sweeps=0.5, inner_runs=4, outer_sweeps=2)
FABRIC_RESTARTS, FABRIC_SEED = 4, 1207
DUEL_QUALITY_RTOL = 0.02
FABRIC_INVARIANCE = ((252, (1, 8)), (378, (1, 2)))


class PhaseCaptured(Exception):
    """Ends a solve once its first color phase's batch is captured."""


@contextlib.contextmanager
def first_engine_batch(stop: bool):
    """Spy on ``AnnealEngine.run``: the first call's engine, J and v0 (as
    float32 copies on the engine's device, as the run takes them, before
    the call). With ``stop`` that call raises ``PhaseCaptured`` instead of
    running; the spy launches nothing."""
    import torch

    from repro_torch.core.engine import AnnealEngine
    run, seen = AnnealEngine.run, {}

    def spy(self, J, v0, *args, **kw):
        if not seen:
            seen.update(engine=self, **{
                name: torch.as_tensor(x).to(self.torch_device,
                                            torch.float32).contiguous().clone()
                for name, x in (("J", J), ("v0", v0))})
            if stop:
                raise PhaseCaptured
        return run(self, J, v0, *args, **kw)
    AnnealEngine.run = spy
    try:
        yield seen
    finally:
        AnnealEngine.run = run


def fabric_phase_compare(label, seen):
    """One color phase's die-aligned batch (tiles plus the boundary-field
    ancilla) and v0, as the fabric handed them to the engine: the kernel
    against its plain version in the variant the engine picks, under the
    unit schedule (bitwise) and under the fabric's own perturbed schedule
    (the limits of ``phase_compare``)."""
    eng, J, v0 = seen["engine"], seen["J"], seen["v0"]
    j_dtype = eng.plan(*v0.shape, J=J).j_dtype
    unit_dev, unit_pert = variants()["int8"]
    unit_dev = dataclasses.replace(unit_dev,
                                   anneal_sweeps=eng.device.anneal_sweeps)
    for sched, dev, pert in (("unit", unit_dev, unit_pert),
                             ("perturbation", eng.device, eng.perturbation)):
        st = compare_one(J, v0, dev, pert, j_dtype)
        emit({"phase": "fabric", "kernel_compare": label, "schedule": sched,
              "anneal_sweeps": dev.anneal_sweeps,
              "max_abs_J": float(J.abs().max()), **st})
        what = f"fabric {label} {sched} ({j_dtype} {st['shape']})"
        check(st["bitwise_repeat"] and st["bitwise_plans"] is not False,
              f"{what}: kernel not the same bits across calls / plans")
        if sched == "unit":
            check(st["bitwise"], f"{what}: kernel and plain version differ "
                  f"(max {st['max_abs_err']})")
        check(st["runs_differing"] <= 0.05 * st["runs"],
              f"{what}: {st['runs_differing']} of {st['runs']} runs end on "
              "other spins (limit 5%)")
        check(st["max_abs_err_agreeing_runs"] <= 1e-5,
              f"{what}: |dv| {st['max_abs_err_agreeing_runs']} over agreeing "
              "runs (limit 1e-5)")
        check(st["max_sr_gap"] <= 0.03,
              f"{what}: SR gap {st['max_sr_gap']} (limit 0.03)")


def fabric_solve(problem, mesh_devices):
    from repro_torch.api import get_solver
    return get_solver("fabric-jax", mesh_devices=mesh_devices,
                      torch_device="cuda", **FABRIC_OPTS).solve(
        problem, runs=FABRIC_RESTARTS, seed=FABRIC_SEED)


def phase_fabric():
    """The mega-fabric on virtual dies of the card: the field exchange
    bitwise at N=2000, the mesh-invariance rows, N=48 parity with the
    engine, the N=2000 duel against chip-lns (launch counts read around
    exactly the duel's fabric solve, which is this path's run), the anneal
    kernel against its plain version on the duel's and the CLI's fabric
    batches, and the CLI with --mesh-devices 8. Returns the duel's launch
    counts."""
    import numpy as np
    import torch

    from repro_torch.api import Problem, get_solver
    from repro_torch.core.hamiltonian import maxcut_value
    from repro_torch.distributed import FieldExchange, fabric_mesh
    from repro_torch.kernels import ising_anneal as ka
    from repro_torch.problems import cut_from_energy, gset_problem

    duel = duel_problem()
    J = duel.J_levels.astype(np.float64)
    s = np.random.default_rng(FABRIC_SEED).choice([-1.0, 1.0],
                                                  size=(256, duel.n))
    want = s @ J
    for k in (1, 3, 8):
        ex = FieldExchange(J, fabric_mesh(k, torch_device="cuda"))
        h = ex.fields(s)
        same = bool(np.array_equal(h.astype(np.float64), want))
        # one call as the fabric makes it: the states to the card, K
        # products summed in die order, the fields back to the host
        host_ms = []
        for _ in range(20):
            t0 = time.perf_counter()
            ex.fields(s)
            host_ms.append(1e3 * (time.perf_counter() - t0))
        emit({"phase": "fabric", "exchange": {"n": duel.n, "dies": k,
              "n_pad": ex.n_pad, "restarts": s.shape[0],
              "bitwise_equal_float64_host": same,
              "call_ms_median": statistics.median(host_ms),
              "call_ms_min": min(host_ms)}})
        check(same, f"FieldExchange K={k} differs from the host product")

    for n, pair in FABRIC_INVARIANCE:
        p = gset_problem(n, seed=FABRIC_SEED + 1, degree=6.0)
        a, b = (fabric_solve(p, k) for k in pair)
        same = bool(np.array_equal(a.energies[0], b.energies[0]) and
                    np.array_equal(a.best_sigma[0], b.best_sigma[0]))
        emit({"phase": "fabric", "mesh_invariance": {
            "n": n, "mesh_devices": list(pair),
            "n_tiles": a.meta["fabric"]["n_tiles"][0],
            "color_peaks": [a.meta["fabric"]["color_peaks"],
                            b.meta["fabric"]["color_peaks"]],
            "best_energy": float(np.min(a.energies[0])),
            "bit_identical": same}})
        check(same, f"fabric output differs between {pair} dies at N={n}")

    p48 = Problem.maxcut(48, density=0.5, seed=FABRIC_SEED)
    rep_f = get_solver("fabric-jax", torch_device="cuda").solve(
        p48, runs=8, seed=FABRIC_SEED)
    rep_e = get_solver("engine", torch_device="cuda").solve(
        p48, runs=8, seed=FABRIC_SEED)
    same = bool(np.array_equal(rep_f.energies[0], rep_e.energies[0]) and
                np.array_equal(rep_f.best_sigma[0], rep_e.best_sigma[0]))
    emit({"phase": "fabric", "engine_parity": {"n": 48, "runs": 8,
                                               "bit_identical": same}})
    check(same, "N=48 fabric-jax differs from the engine")

    W = duel.meta["W"]
    with first_engine_batch(stop=False) as duel_batch:
        ka.reset_launches()
        rep = fabric_solve(duel, 8)
        launches = dict(ka.launches)
    fab = rep.meta["fabric"]
    sweeps = FABRIC_OPTS["outer_sweeps"]
    e_fab = float(np.min(rep.energies[0]))
    cut_e = cut_from_energy(W, e_fab)
    cut_s = float(maxcut_value(torch.as_tensor(W, dtype=torch.float64),
                               torch.as_tensor(rep.best_sigma[0])))
    rep_c = get_solver("chip-lns", torch_device="cuda", **FABRIC_OPTS).solve(
        duel, runs=FABRIC_RESTARTS, seed=FABRIC_SEED)
    e_chip = float(np.min(rep_c.energies[0]))
    j_dtypes = [d for rec in fab["per_sweep"] for d in rec["j_dtypes"]]
    emit({"phase": "fabric", "duel": {
        "n": duel.n, "mesh_devices": fab["mesh_devices"],
        "restarts": FABRIC_RESTARTS, "outer_sweeps": sweeps,
        "best_energy": e_fab, "best_cut": cut_e, "cut_from_spins": cut_s,
        "recorded_reference_cut": DUEL_RECORDED["fabric-jax"],
        "chip_lns_best_energy": e_chip,
        "chip_lns_cut": cut_from_energy(W, e_chip),
        "dispatches": rep.dispatches, "n_colors": fab["n_colors"],
        "n_tiles": fab["n_tiles"], "color_peaks": fab["color_peaks"],
        "field_exchanges": fab["field_exchanges"], "launches": launches,
        "j_dtypes": j_dtypes, "wall_s": rep.wall_s,
        "chip_lns_wall_s": rep_c.wall_s, "plan_s": fab["plan_s"],
        "per_sweep": fab["per_sweep"]}})
    check(rep.dispatches == fab["n_colors"] * sweeps,
          f"duel: {rep.dispatches} dispatches for {fab['n_colors']} colors "
          f"x {sweeps} sweeps")
    check(sum(launches.values()) == rep.dispatches and all(
        launches[ka.KERNEL_NAMES[d]] == j_dtypes.count(d)
        for d in set(j_dtypes)),
        f"duel: anneal launches {launches} for {rep.dispatches} dispatches "
        f"of {j_dtypes}")
    check(cut_e == cut_s, f"duel: cut from energy {cut_e} != cut from "
          f"spins {cut_s}")
    check(e_fab <= e_chip + DUEL_QUALITY_RTOL * abs(e_chip),
          f"duel: fabric best energy {e_fab} worse than chip-lns {e_chip} "
          f"beyond {DUEL_QUALITY_RTOL:.0%}")
    ref_cut = DUEL_RECORDED["fabric-jax"]
    check(cut_e >= (1 - DUEL_QUALITY_RTOL) * ref_cut,
          f"duel: cut {cut_e} below the reference's {ref_cut} by more than "
          f"{DUEL_QUALITY_RTOL:.0%}")

    # the kernel against its plain version on the fabric's own batches: the
    # duel's first color phase, and the CLI's (below) first color phase,
    # captured from the CLI's solve in this process and stopped there
    fabric_phase_compare("duel", duel_batch)
    from repro_torch.launch.solve import solve
    with first_engine_batch(stop=True) as cli_batch:
        try:
            solve(2000, 0.5, 1, 256, solver="fabric-jax", workload="gset",
                  oracle=False, torch_device="cuda", mesh_devices=8)
        except PhaseCaptured:
            pass
    check(bool(cli_batch), "the CLI's fabric solve made no engine call")
    fabric_phase_compare("cli", cli_batch)

    # one problem (the CLI's default is 4, whose 64 outer sweeps of host
    # acceptance at 256 restarts would take minutes of the run's limit)
    cmd = [sys.executable, "-m", "repro_torch.launch.solve", "--solver",
           "fabric-jax", "--workload", "gset", "--spins", "2000",
           "--problems", "1", "--mesh-devices", "8", "--no-oracle"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env=env)
    lines = proc.stdout.strip().splitlines()
    fabric_lines = [ln for ln in lines if ln.startswith("[fabric]")]
    emit({"phase": "fabric", "cli": " ".join(cmd[1:]), "rc": proc.returncode,
          "cli_s": time.perf_counter() - t0, "fabric_lines": fabric_lines,
          "stdout_tail": lines[-6:],
          "stderr_tail": proc.stderr.strip().splitlines()[-5:]})
    check(proc.returncode == 0 and fabric_lines and
          fabric_lines[0].startswith("[fabric] 8 dies"),
          f"fabric CLI exited {proc.returncode} without its [fabric] lines")
    return launches


LM_ARCH = "qwen3-0.6b"
LM_SERVE = dict(batch=4, prompt_len=64, gen=32)


def lm_run(model, params, batch, gen):
    """What the family serves: prefill logits (dense / moe / vlm), the last
    warm-up logits after the prompt went through ``decode_step`` token by
    token (hybrid / rwkv), or the hiddens (encoder); then ``gen`` greedy
    tokens (None for the encoder)."""
    import torch
    tokens = batch.get("tokens")
    if model.decode_step is None:
        return model.forward(params, batch), None
    max_len = tokens.shape[1] + gen
    if model.prefill is not None:
        logits, cache = model.prefill(params, batch, max_len=max_len)
    else:
        cache = model.init_cache(tokens.shape[0], max_len,
                                 torch_device=tokens.device)
        for t in range(tokens.shape[1]):
            logits, cache = model.decode_step(params, cache, tokens[:, t])
    first, toks = logits, []
    for _ in range(gen):
        toks.append(torch.argmax(logits, -1))
        logits, cache = model.decode_step(params, cache, toks[-1])
    return first, torch.stack(toks, dim=1)


def arrays(tree):
    """A parameter tree of CPU tensors as numpy arrays."""
    return {k: arrays(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def top2_gap(logits):
    top2 = logits.float().topk(2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


def phase_lm():
    """The LM serving path (no kernel of its own: the reference's attention
    is plain jnp). qwen3-0.6b reduced() in float32 on the card against the
    CPU with the same weights (carried by ``convert``, TF32 off); the full
    model served by ``serve_lm.serve`` (its times, peak allocated memory);
    on the same weights, finite logits and the top-1 agreement of bfloat16
    with float32 over the prompts' positions; the serve_lm CLI."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import serve_lm
    from repro_torch.models import build

    cfg = get_config(LM_ARCH).reduced()
    model = build(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), "cpu")

    card = lm_params_from_arrays(arrays(cpu), cfg, torch_device="cuda")
    prompts, _ = SyntheticLM(cfg.vocab_size, 16, 2).batch_at(0)
    prompts = torch.as_tensor(prompts)
    with torch.inference_mode():
        lg_cpu, tok_cpu = lm_run(model, cpu, {"tokens": prompts}, 8)
        lg_card, tok_card = lm_run(model, card, {"tokens": prompts.cuda()}, 8)
    err = float((lg_card.cpu() - lg_cpu).abs().max())
    same = bool(torch.equal(tok_card.cpu(), tok_cpu))
    emit({"phase": "lm", "card_vs_cpu": {
        "arch": LM_ARCH, "config": "reduced, float32", "prompt": [2, 16],
        "prefill_max_abs_err": err, "greedy_tokens_equal": same,
        "min_top2_gap": top2_gap(lg_cpu)}})
    check(err <= 1e-4, f"reduced {LM_ARCH}: card prefill logits off by {err}")
    check(same, f"reduced {LM_ARCH}: greedy tokens differ card vs CPU")

    full = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    with served_params() as drawn:
        out = serve_lm.serve(LM_ARCH, reduced=False, torch_device="cuda",
                             **LM_SERVE)
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "lm", "serve": {
        "arch": LM_ARCH, "n_layers": full.n_layers, "d_model": full.d_model,
        "vocab": full.vocab_size, "dtype": full.dtype, **LM_SERVE,
        "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
        "tok_per_s": out["tok_per_s"], "peak_allocated_gib": peak / 2**30,
        "generated_shape": list(out["generated"].shape),
        "sample": out["generated"][0][:16].tolist()}})
    check(out["generated"].shape == (LM_SERVE["batch"], LM_SERVE["gen"]),
          f"serve returned {out['generated'].shape}")

    # the served weights (serve drew them from seed 0), run in bfloat16
    # and in float32 over the same prompts
    params = drawn.pop()
    prompts, _ = SyntheticLM(full.vocab_size, LM_SERVE["prompt_len"],
                             LM_SERVE["batch"]).batch_at(0)
    prompts = torch.as_tensor(prompts, device="cuda")
    logits = {}
    with torch.inference_mode():
        for dtype in ("bfloat16", "float32"):
            c = dataclasses.replace(full, dtype=dtype)
            h = build(c).forward(params, {"tokens": prompts})
            head = params["head"].to(h.dtype)
            logits[dtype] = (h @ head).float()[..., :full.vocab_size]
        _, toks32 = lm_run(build(dataclasses.replace(
            full, dtype="float32")), params, {"tokens": prompts},
            LM_SERVE["gen"])
    finite = bool(torch.isfinite(logits["bfloat16"]).all())
    agree = float((logits["bfloat16"].argmax(-1) ==
                   logits["float32"].argmax(-1)).float().mean())
    same_gen = (toks32.cpu().numpy() == out["generated"])
    emit({"phase": "lm", "bf16_vs_f32": {
        "positions": int(logits["float32"].shape[0] *
                         logits["float32"].shape[1]),
        "logits_finite": finite, "top1_agreement": agree,
        "max_abs_logit_diff": float((logits["bfloat16"] -
                                     logits["float32"]).abs().max()),
        "greedy_tokens_equal_f32": float(same_gen.mean()),
        "greedy_first_divergence": [
            int(np.argmin(row)) if not row.all() else None
            for row in same_gen]}})
    check(finite, f"{LM_ARCH} full size: non-finite bfloat16 logits")

    cmd = [sys.executable, "-m", "repro_torch.launch.serve_lm", "--arch",
           LM_ARCH, "--full-size"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env=env)
    emit({"phase": "lm", "cli": " ".join(cmd[1:]), "rc": proc.returncode,
          "cli_s": time.perf_counter() - t0,
          "stdout_tail": proc.stdout.strip().splitlines()[-2:],
          "stderr_tail": proc.stderr.strip().splitlines()[-5:]})
    check(proc.returncode == 0 and "tok/s" in proc.stdout,
          f"serve_lm CLI exited {proc.returncode}")


#: the families past the dense one; zamba2 reduced to 5 layers, so its
#: reduced model has two groups and a tail layer
LM_FAMILIES = ("granite-moe-3b-a800m", "olmoe-1b-7b",
               "llava-next-mistral-7b", "hubert-xlarge", "zamba2-7b",
               "rwkv6-3b")
LM_MOE_ARCH = "olmoe-1b-7b"
LLAVA_PASS = dict(batch=2, prompt_len=640, gen=8)
HUBERT_FRAMES = (2, 500)
#: the full-width passes of phase lm_families cut in depth (their weights
#: are drawn on the host, which took most of the run's time limit at full
#: depth); hubert-xlarge runs whole. zamba2-7b keeps two attn_every groups
#: and a tail of 3 Mamba layers, as its 81 layers end.
FULL_PASS_LAYERS = {"olmoe-1b-7b": 4, "zamba2-7b": 15, "rwkv6-3b": 8,
                    "llava-next-mistral-7b": 8}


def family_cfg(arch, full=False, cut=False):
    """``arch``'s reduced config; with ``full`` its own, and with ``cut``
    as well that one at ``FULL_PASS_LAYERS``' depth."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if full:
        return (dataclasses.replace(cfg, n_layers=FULL_PASS_LAYERS[arch])
                if cut else cfg)
    return cfg.reduced(n_layers=5) if cfg.family == "hybrid" else \
        cfg.reduced()


def family_batch(cfg, B, S, dev, seed=0):
    """Seeded inputs on ``dev``: tokens; frame embeddings for the encoder;
    vision embeddings at the token embeddings' scale for the vlm."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    if cfg.family == "encoder":
        return {"embeds": torch.randn((B, S, cfg.d_model),
                                      generator=gen).to(dev)}
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen).to(dev)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = (torch.randn(
            (B, cfg.n_vision_tokens, cfg.d_model), generator=gen)
            * 0.02).to(dev)
    return batch


@contextlib.contextmanager
def first_routing(seen):
    """Record the first MoE layer's routing (``moe.route``'s first call)."""
    from repro_torch.models import moe
    real = moe.route

    def spy(*args, **kw):
        out = real(*args, **kw)
        if not seen:
            seen.append({k: out[k].cpu() for k in ("keep", "idx", "dest")})
        return out
    moe.route = spy
    try:
        yield seen
    finally:
        moe.route = real


@contextlib.contextmanager
def served_params():
    """Within the block, every model that ``serve_lm.serve`` builds appends
    the parameters its ``init`` drew to the yielded list."""
    from repro_torch.launch import serve_lm
    real, drawn = serve_lm.build, []

    def build(cfg):
        model = real(cfg)

        def init(gen, torch_device):
            drawn.append(model.init(gen, torch_device))
            return drawn[-1]
        return dataclasses.replace(model, init=init)
    serve_lm.build = build
    try:
        yield drawn
    finally:
        serve_lm.build = real


@contextlib.contextmanager
def trained_states():
    """Within the block, every state ``launch.train.train`` initialises is
    appended to the yielded list."""
    from repro_torch.launch import train as train_mod
    real, made = train_mod.init_train_state, []

    def init_train_state(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]
    train_mod.init_train_state = init_train_state
    try:
        yield made
    finally:
        train_mod.init_train_state = real


def free_cuda():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def phase_lm_families():
    """The other model families of the LM path (no kernel of their own:
    the reference computes them in plain jnp). (1) Each family's reduced
    config in float32 on the card against the CPU with the same weights
    (carried by ``convert``; TF32 off for matmuls and cuDNN): outputs
    within 1e-4, 8 greedy tokens equal where the family decodes, and for
    MoE the first layer's keep mask, expert assignment and slots equal.
    (2) olmoe-1b-7b at full width, cut in depth (``FULL_PASS_LAYERS``),
    through ``serve_lm.serve`` (bf16 over f32 weights, batch 4, prompt 64,
    gen 32): times, peak memory, finite logits; on the same weights bf16's
    top-1 agreement with f32; the serve_lm CLI at the same size. (3) One
    full-width pass of each other family, cut in depth but for hubert:
    zamba2-7b and rwkv6-3b through ``serve_lm.serve`` (the prompt warmed
    token by token), llava-next-mistral-7b's prefill of 576
    vision embeddings spliced over a 640-token prompt at batch 2 and 8
    decode steps, hubert-xlarge's forward on (2, 500, 1280) frames in bf16
    and f32; each with its wall and peak memory."""
    import torch

    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import serve_lm
    from repro_torch.models import build
    from repro_torch.pytree import leaves

    check(not torch.backends.cuda.matmul.allow_tf32 and
          not torch.backends.cudnn.allow_tf32, "TF32 must be off here")
    for arch in LM_FAMILIES:
        cfg = family_cfg(arch)
        model = build(cfg)
        cpu = model.init(torch.Generator().manual_seed(0), "cpu")
        card = lm_params_from_arrays(arrays(cpu), cfg, torch_device="cuda")
        B, S = 2, 16
        seen_cpu, seen_card = [], []
        with torch.inference_mode():
            with first_routing(seen_cpu):
                out_cpu, tok_cpu = lm_run(
                    model, cpu, family_batch(cfg, B, S, "cpu"), 8)
            with first_routing(seen_card):
                out_card, tok_card = lm_run(
                    model, card, family_batch(cfg, B, S, "cuda"), 8)
        err = float((out_card.float().cpu() - out_cpu.float()).abs().max())
        row = {"arch": arch, "family": cfg.family, "config":
               f"reduced(n_layers={cfg.n_layers}), float32",
               "input": [B, S], "max_abs_err": err,
               "greedy_tokens_equal": (None if tok_cpu is None else bool(
                   torch.equal(tok_card.cpu(), tok_cpu)))}
        if tok_cpu is not None:
            row["min_top2_gap"] = top2_gap(out_cpu)
        if cfg.n_experts:
            row["first_layer_routing_equal"] = {
                k: bool(torch.equal(seen_card[0][k], seen_cpu[0][k]))
                for k in ("keep", "idx", "dest")}
            row["first_layer_dropped"] = int((~seen_cpu[0]["keep"]).sum())
        emit({"phase": "lm_families", "card_vs_cpu": row})
        check(err <= 1e-4, f"reduced {arch}: card output off by {err}")
        check(tok_cpu is None or row["greedy_tokens_equal"],
              f"reduced {arch}: greedy tokens differ card vs CPU")
        check(not cfg.n_experts or all(
            row["first_layer_routing_equal"].values()),
            f"reduced {arch}: first-layer routing differs card vs CPU")
    del cpu, card
    free_cuda()

    # olmoe-1b-7b at full width, cut in depth, served
    full = family_cfg(LM_MOE_ARCH, full=True, cut=True)
    torch.cuda.reset_peak_memory_stats()
    with served_params() as drawn:
        out = serve_lm.serve(LM_MOE_ARCH, reduced=False, torch_device="cuda",
                             n_layers=full.n_layers, **LM_SERVE)
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "lm_families", "serve": {
        "arch": LM_MOE_ARCH, "n_layers": full.n_layers,
        "d_model": full.d_model, "n_experts": full.n_experts,
        "top_k": full.top_k, "vocab": full.vocab_size, "dtype": full.dtype,
        **LM_SERVE, "prefill_s": out["prefill_s"],
        "decode_s": out["decode_s"], "tok_per_s": out["tok_per_s"],
        "peak_allocated_gib": peak / 2**30,
        "logits_finite": out["logits_finite"],
        "sample": out["generated"][0][:16].tolist()}})
    check(out["generated"].shape == (LM_SERVE["batch"], LM_SERVE["gen"]),
          f"serve returned {out['generated'].shape}")
    check(out["logits_finite"], f"{LM_MOE_ARCH}: non-finite logits served")

    # the served weights (serve drew them from seed 0), run in bfloat16
    # and in float32 over the same prompts
    params = drawn.pop()
    n_params = sum(t.numel() for t in leaves(params))
    prompts, _ = SyntheticLM(full.vocab_size, LM_SERVE["prompt_len"],
                             LM_SERVE["batch"]).batch_at(0)
    prompts = torch.as_tensor(prompts, device="cuda")
    logits = {}
    with torch.inference_mode():
        for dtype in ("bfloat16", "float32"):
            c = dataclasses.replace(full, dtype=dtype)
            h = build(c).forward(params, {"tokens": prompts})
            logits[dtype] = (h @ params["head"].to(h.dtype)).float()[
                ..., :full.vocab_size]
    finite = bool(torch.isfinite(logits["bfloat16"]).all())
    agree = float((logits["bfloat16"].argmax(-1) ==
                   logits["float32"].argmax(-1)).float().mean())
    emit({"phase": "lm_families", "bf16_vs_f32": {
        "arch": LM_MOE_ARCH, "params": n_params,
        "param_gib": 4 * n_params / 2**30,
        "positions": int(logits["float32"].shape[0] *
                         logits["float32"].shape[1]),
        "logits_finite": finite, "top1_agreement": agree,
        "max_abs_logit_diff": float((logits["bfloat16"] -
                                     logits["float32"]).abs().max())}})
    check(finite, f"{LM_MOE_ARCH} full size: non-finite bfloat16 logits")
    del params, logits, h
    free_cuda()

    cmd = [sys.executable, "-m", "repro_torch.launch.serve_lm", "--arch",
           LM_MOE_ARCH, "--full-size", "--layers", str(full.n_layers)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env=env)
    emit({"phase": "lm_families", "cli": " ".join(cmd[1:]),
          "rc": proc.returncode, "cli_s": time.perf_counter() - t0,
          "stdout_tail": proc.stdout.strip().splitlines()[-2:],
          "stderr_tail": proc.stderr.strip().splitlines()[-5:]})
    check(proc.returncode == 0 and "tok/s" in proc.stdout,
          f"serve_lm CLI for {LM_MOE_ARCH} exited {proc.returncode}")

    # one full-width pass of every other family
    for arch in ("zamba2-7b", "rwkv6-3b"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = serve_lm.serve(arch, reduced=False, torch_device="cuda",
                             n_layers=FULL_PASS_LAYERS[arch], **LM_SERVE)
        wall = time.perf_counter() - t0
        emit({"phase": "lm_families", "full_pass": {
            "arch": arch, "path": "serve_lm.serve",
            "n_layers": FULL_PASS_LAYERS[arch], **LM_SERVE,
            "wall_s": wall, "warmup_s": out["prefill_s"],
            "decode_s": out["decode_s"], "tok_per_s": out["tok_per_s"],
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "logits_finite": out["logits_finite"]}})
        check(out["logits_finite"], f"{arch} full size: non-finite logits")
        free_cuda()

    cfg = family_cfg("llava-next-mistral-7b", full=True, cut=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cuda")
    batch = family_batch(cfg, LLAVA_PASS["batch"], LLAVA_PASS["prompt_len"],
                         "cuda")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = model.prefill(
            params, batch,
            max_len=LLAVA_PASS["prompt_len"] + LLAVA_PASS["gen"])
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t1
        finite = torch.isfinite(logits).all()
        tok = torch.argmax(logits, -1)
        for _ in range(LLAVA_PASS["gen"]):
            logits, cache = model.decode_step(params, cache, tok)
            tok = torch.argmax(logits, -1)
            finite &= torch.isfinite(logits).all()
        torch.cuda.synchronize()
    emit({"phase": "lm_families", "full_pass": {
        "arch": cfg.name, "path": "prefill + decode_step",
        "n_layers": cfg.n_layers, **LLAVA_PASS,
        "n_vision_tokens": cfg.n_vision_tokens,
        "wall_s": time.perf_counter() - t0, "prefill_s": t_prefill,
        "cache_pos": int(cache["pos"]),
        "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "logits_finite": bool(finite)}})
    check(bool(finite), "llava full size: non-finite logits")
    check(int(cache["pos"]) == LLAVA_PASS["prompt_len"] + LLAVA_PASS["gen"],
          "llava: decode positions do not continue from the prompt")
    del params, cache, model
    free_cuda()

    cfg = family_cfg("hubert-xlarge", full=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build(cfg).init(torch.Generator().manual_seed(0), "cuda")
    batch = family_batch(cfg, *HUBERT_FRAMES, "cuda")
    hid, walls = {}, {}
    with torch.inference_mode():
        for dtype in ("bfloat16", "float32"):
            c = dataclasses.replace(cfg, dtype=dtype)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            hid[dtype] = build(c).forward(params, batch).float()
            torch.cuda.synchronize()
            walls[dtype] = time.perf_counter() - t1
    finite = all(bool(torch.isfinite(h).all()) for h in hid.values())
    rel = float((hid["bfloat16"] - hid["float32"]).abs().max()
                / hid["float32"].abs().max())
    emit({"phase": "lm_families", "full_pass": {
        "arch": cfg.name, "path": "forward", "frames": list(HUBERT_FRAMES),
        "d_model": cfg.d_model, "wall_s": time.perf_counter() - t0,
        "forward_s": walls, "hiddens_finite": finite,
        "bf16_vs_f32_max_rel_diff": rel,
        "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}})
    check(finite, "hubert full size: non-finite hiddens")
    del params, hid
    free_cuda()


#: the MoE slices: olmoe-1b-7b's first layer at full width, a (2, 16)
#: prompt, float32, tp = 1, 2, 4 (tolerances: tests/test_torch_moe.py's)
MOE_SLICE_INPUT, MOE_SLICE_TPS, MOE_TOL = (2, 16), (1, 2, 4), (1e-4, 1e-5)


def leaves_differ(card, cpu):
    """(leaves, leaves whose card bytes differ from the CPU's) of two trees
    of one structure."""
    import torch

    from repro_torch.pytree import leaves
    pairs = list(zip(leaves(card), leaves(cpu)))
    return len(pairs), sum(not torch.equal(a.cpu(), b) for a, b in pairs)


def phase_mesh():
    """Seeded weights on every device and the sharding layer on the card
    (no kernel of its own: the reference's sharding is plain JAX). (1) The
    weights train's own init (a spy on ``launch.train.init_train_state``)
    and serve's own init (a spy on the model ``serve_lm.serve`` builds)
    draw for seed 0 on the card, against the same calls on the CPU, leaf
    by leaf: every family's reduced() config, qwen3-0.6b at full width
    (train's init, whose wall on each device is printed: the host's draw
    rate). (2) olmoe-1b-7b's first MoE layer at full width under
    virtual meshes (1, tp): tp = 1 bitwise equal to the path with no mesh, tp
    = 2, 4 within MOE_TOL, routing bitwise (a spy on ``moe.route``), each
    tp's ms (CUDA events, median of 5)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.launch.mesh import activate_mesh, virtual_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import moe
    from repro_torch.pytree import leaves

    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for arch, full in ([(a, False) for a in TRAIN_FAMILIES]
                           + [(LM_ARCH, True)]):
            states, walls = {}, {}
            for dev in ("cuda", "cpu"):
                t0 = time.perf_counter()
                with trained_states() as made:
                    train(arch, steps=0, batch=1, seq=8, reduced=not full,
                          ckpt_dir=os.path.join(tmp, f"{arch}-{dev}"),
                          torch_device=dev)
                torch.cuda.synchronize()
                walls[dev] = time.perf_counter() - t0
                states[dev] = made.pop().params
            n, bad = leaves_differ(states["cuda"], states["cpu"])
            rows.append({"arch": arch, "entry": "train",
                         "config": "full width" if full else "reduced",
                         "params": sum(t.numel() for t in
                                       leaves(states["cpu"])),
                         "init_s": walls, "leaves": n, "leaves_differ": bad})
            del states
            free_cuda()
        for arch in TRAIN_FAMILIES:
            if not get_config(arch).has_decode:
                continue
            drawn = {}
            for dev in ("cuda", "cpu"):
                with served_params() as got:
                    serve_lm.serve(arch, batch=1, prompt_len=2, gen=1,
                                   torch_device=dev)
                drawn[dev] = got.pop()
            n, bad = leaves_differ(drawn["cuda"], drawn["cpu"])
            rows.append({"arch": arch, "entry": "serve", "config": "reduced",
                         "leaves": n, "leaves_differ": bad})
    emit({"phase": "mesh", "weights_card_vs_cpu": rows,
          "leaves_differ_total": sum(r["leaves_differ"] for r in rows)})
    for r in rows:
        check(r["leaves_differ"] == 0, f"seed-0 weights differ card vs CPU: "
              f"{r}")
    free_cuda()

    cfg = get_config(LM_MOE_ARCH)
    gen = torch.Generator().manual_seed(0)
    p = {k: v.cuda() for k, v in moe.init_moe(
        gen, cfg.d_model, cfg.d_ff, cfg.n_experts).items()}
    x = torch.randn((*MOE_SLICE_INPUT, cfg.d_model), generator=gen).cuda()

    def run():
        return moe.apply_moe(p, x, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor)
    with torch.inference_mode():
        with first_routing([]) as seen:
            whole = run()
        row = {"arch": LM_MOE_ARCH, "layer": "blocks.ffn[0]",
               "n_experts": cfg.n_experts, "top_k": cfg.top_k,
               "d_ff": cfg.d_ff, "input": list(MOE_SLICE_INPUT),
               "dtype": "float32",
               "unsliced_ms": statistics.median(cuda_ms(run, 5)), "tp": {}}
        for tp in MOE_SLICE_TPS:
            with activate_mesh(virtual_mesh((1, tp), ("data", "model"),
                                            "cuda")):
                with first_routing([]) as seen_tp:
                    out = run()
                ms = statistics.median(cuda_ms(run, 5))
            err = float((out - whole).abs().max())
            row["tp"][tp] = {
                "ms": ms, "max_abs_err": err,
                "bitwise": bool(torch.equal(out, whole)),
                "within_tol": bool(torch.allclose(out, whole,
                                                  rtol=MOE_TOL[0],
                                                  atol=MOE_TOL[1])),
                "routing_bitwise": all(
                    torch.equal(seen_tp[0][k], seen[0][k])
                    for k in ("keep", "idx", "dest"))}
    emit({"phase": "mesh", "moe_slices": row})
    check(row["tp"][1]["bitwise"], "MoE slices at tp = 1 not bitwise")
    for tp, r in row["tp"].items():
        check(r["within_tol"] and r["routing_bitwise"],
              f"MoE slices at tp = {tp}: {r}")
    del p, x, whole, out
    free_cuda()


#: one reduced train step of each family in float32, card against CPU
#: from the same state; tolerances fixed before the first chip run: the
#: port tests' bounds against the reference (tests/test_torch_train.py)
TRAIN_FAMILIES = ("qwen3-0.6b", "olmoe-1b-7b", "llava-next-mistral-7b",
                  "hubert-xlarge", "zamba2-7b", "rwkv6-3b")
TRAIN_TOL = dict(loss_rtol=1e-4, loss_atol=1e-5, grad_norm_rtol=1e-4,
                 grad_rtol=1e-3, grad_atol_of_max=1e-4)
#: the reference's restart protocol (tests/test_train_integration.py)
RESTART = dict(batch=4, seq=64, ckpt_every=10)
#: qwen3-0.6b at full width and depth
TRAIN_FULL = dict(steps=20, batch=8, seq=512)
#: qwen3-0.6b's parameter count (checked against the trained state)
TRAIN_FULL_PARAMS = 751_894_528
#: the dry-run's cells on the card's torch: (arch, shape), then an Ising key
DRYRUN_CELLS = (("qwen2-7b", "decode_32k"), ("olmoe-1b-7b", "train_4k"))
DRYRUN_ISING = "chip64"
#: the reference's per-rank counts of the two LM cells on (16, 16):
#: {(arch, shape): [``hlo_flops_per_device``, ``collective_bytes_per_device``]}
#: of ``repro.launch.dryrun.lower_cell``, compiled on 512 forced host
#: devices (tests/test_torch_dryrun.py measures them)
DRYRUN_REFERENCE = {
    ("qwen2-7b", "decode_32k"): [16_345_010_682.0, 32_456_704],
    ("olmoe-1b-7b", "train_4k"): [51_570_486_736_305.0, 143_426_601_160]}
#: full-width cells cut in depth, traced in the same world, each with the
#: reference's per-rank FLOPs and collective bytes on (16, 16) (of
#: ``lower_cell`` with the cut config; tests/test_torch_dryrun.py measures
#: them): (arch, layers, shape, reference FLOPs a rank, reference
#: collective bytes a rank). The port's FLOPs must stay within
#: DRYRUN_CUT_MIN-DRYRUN_CUT_MAX of the reference's. A pair of depths (lo,
#: hi) counts the layers between them, count(hi) - count(lo): one
#: sequence's decode, whose count the head decides at any depth (XLA runs
#: the reference's head whole on every rank).
DRYRUN_DEPTH_CUT = (("rwkv6-3b", 1, "prefill_32k", 719_250_195_496.0,
                     4_966_055_936),
                    ("zamba2-7b", 6, "train_4k", 25_253_469_056_684.0,
                     56_836_510_840),
                    ("rwkv6-3b", (1, 2), "long_500k", 884_194.0,
                     23_360))
DRYRUN_CUT_MIN, DRYRUN_CUT_MAX = 0.5, 1.5
#: the most collective bytes a rank (an all-gather charged its result, an
#: all-reduce twice, as both packages count them) the port may move in a
#: held cell, over the reference's
DRYRUN_COLL_MAX = 1.25
#: the full-width step phase train measured, for phase dryrun's count
REAL_STEP = {}


def train_batch(cfg, B, S, dev, seed=0):
    """``family_batch`` with seeded next-token labels; the vlm's vision
    prefix carries no loss (labels -1)."""
    import torch
    batch = family_batch(cfg, B, S, dev, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    if cfg.family == "vlm":
        labels[:, :cfg.n_vision_tokens] = -1
    batch["labels"] = labels.to(dev)
    return batch


def grads_of(model, params, batch):
    """{path: gradient} of ``model.loss`` over every leaf."""
    import torch

    from repro_torch.pytree import flatten_with_paths, leaves, tree_map
    tp = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = model.loss(tp, batch)
    grads = torch.autograd.grad(loss, leaves(tp), allow_unused=True,
                                materialize_grads=True)
    return {k: g for (k, _), g in zip(flatten_with_paths(tp), grads)}


def grads_close(card, cpu):
    """Largest |card - cpu| over the allowed error, over every leaf (<= 1
    passes)."""
    worst = 0.0
    for k, ref in cpu.items():
        got = card[k].cpu()
        allowed = (TRAIN_TOL["grad_atol_of_max"] * float(ref.abs().max())
                   + 1e-12 + TRAIN_TOL["grad_rtol"] * ref.abs())
        worst = max(worst, float(((got - ref).abs() / allowed).max()))
    return worst


@contextlib.contextmanager
def train_spies(record):
    """Within the block, ``launch.train.train`` times every step into
    ``record["step_s"]`` (what its ``StragglerDetector`` observes: a host
    clock around the step, which ends in the loss's read-back) and every
    save into ``record["save_s"]``, and keeps the saved state in
    ``record["saved"]``."""
    from repro_torch.launch import train as train_mod
    real_det, real_ck = train_mod.StragglerDetector, train_mod.Checkpointer

    class Detector(real_det):
        def observe(self, dt):
            record["step_s"].append(dt)
            return super().observe(dt)

    class Timed(real_ck):
        def save(self, step, tree, metadata=None):
            t0 = time.perf_counter()
            super().save(step, tree, metadata)
            record["save_s"].append(time.perf_counter() - t0)
            record["saved"] = tree
            record["path"] = self._path(step)

    train_mod.StragglerDetector, train_mod.Checkpointer = Detector, Timed
    try:
        yield record
    finally:
        train_mod.StragglerDetector, train_mod.Checkpointer = \
            real_det, real_ck


def optimizer_ms(state):
    """Median CUDA-event time (ms, 3 calls after a warm-up) of the step's
    optimizer part alone on ``state``: clipping, the schedule, AdamW and
    the update, with the first moments standing in for the gradients."""
    import torch

    from repro_torch.optim import (AdamWConfig, adamw, apply_updates,
                                   clip_by_global_norm, linear_warmup_cosine)

    def run():
        with torch.no_grad():
            grads, _ = clip_by_global_norm(state.opt["m"], 1.0)
            lr = linear_warmup_cosine(state.step + 1, 5, 10_000)
            upd, _ = adamw(grads, state.opt, state.params,
                           AdamWConfig(lr=1e-3), lr)
            apply_updates(state.params, upd)
    return statistics.median(cuda_ms(run, 3))


def profile_train_steps(step_fn, state, batch, n=2):
    """``n`` train steps from ``state`` under torch.profiler (CUDA
    activity), after one warm-up step: device kernels a step, their summed
    time against the steps' host wall (the device's busy share), the time
    in matrix-multiply kernels (cuBLAS / CUTLASS names) and the kernels
    that take the most time; beside them the optimizer part timed alone
    (``optimizer_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            _, m = step_fn(state, batch)
            float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    count = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            count += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    gemm = sum(v for k, v in by_name.items()
               if any(t in k.lower() for t in ("gemm", "xmma", "cutlass")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": n, "wall_ms_per_step": 1e3 * wall / n,
            "optimizer_ms": optimizer_ms(state),
            "kernels_per_step": count / n,
            "device_busy_ms_per_step": busy / n,
            "device_busy_share": busy / (1e3 * wall),
            "matmul_kernel_ms_per_step": gemm / n,
            "top_kernels_ms_per_step": [[k[:100], v / n] for k, v in top]}


def mamba2_full_width_grads():
    """One Mamba-2 layer at zamba2-7b's full width on the card (d_model
    3584, 112 heads, 256 tokens, weights and inputs from seed 0): whether
    its gradient is finite on rms-normed inputs and on the same inputs
    x 4, in float32 and bfloat16. Above a chunk's diagonal the decay's
    exp overflows and is selected away; backward then multiplies a zero
    by inf (the reference's behaviour, which the port mirrors)."""
    import torch

    from repro_torch.models.common import rms_norm
    from repro_torch.models.mamba2 import apply_mamba2, init_mamba2
    cfg = family_cfg("zamba2-7b", full=True)
    gen = torch.Generator().manual_seed(0)
    p = {k: v.cuda() for k, v in init_mamba2(
        gen, cfg.d_model, expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
        d_state=cfg.ssm_state, conv_kernel=cfg.conv_kernel).items()}
    x = rms_norm(torch.randn((1, 256, cfg.d_model), generator=gen).cuda(),
                 torch.ones(cfg.d_model, device="cuda"))
    out = {}
    for dtype in ("float32", "bfloat16"):
        for scale in (1, 4):
            tp = {k: v.detach().requires_grad_() for k, v in p.items()}
            y, _ = apply_mamba2(tp, (x * scale).to(getattr(torch, dtype)),
                                head_dim=cfg.ssm_head_dim,
                                d_state=cfg.ssm_state)
            grads = torch.autograd.grad(torch.sum(y.float() ** 2),
                                        list(tp.values()))
            out[f"{dtype}_x{scale}"] = {
                "forward_finite": bool(torch.isfinite(y).all()),
                "grad_finite": all(bool(torch.isfinite(g).all())
                                   for g in grads)}
    return out


def gather_dispatch(x, r, n_experts, cap):
    """``models.moe._dispatch`` with the token gather as ``torch.gather``,
    whose backward adds a token's k repeats atomically on CUDA."""
    import torch
    b, _, d = x.shape
    xg = torch.gather(x, 1, r["st"][..., None].expand(-1, -1, d))
    buf = torch.zeros((b, n_experts * cap, d), dtype=x.dtype,
                      device=x.device)
    buf.scatter_add_(1, r["dest"][..., None].expand(-1, -1, d),
                     torch.where(r["keep"][..., None], xg,
                                 torch.zeros((), dtype=x.dtype,
                                             device=x.device)))
    return buf.reshape(b, n_experts, cap, d)


def moe_top8_determinism():
    """olmoe-1b-7b reduced() with top_k = 8 (8 experts) in float32 on the
    card: two train steps from one state and the gradient computed twice,
    bitwise or not (loss, every updated leaf, every gradient leaf); then
    the same with the token gather as ``torch.gather`` (the dispatch
    before ``F.embedding``), for contrast."""
    import torch

    from repro_torch.models import build, moe
    from repro_torch.optim import AdamWConfig
    from repro_torch.pytree import leaves
    from repro_torch.training import init_train_state, make_train_step
    cfg = dataclasses.replace(family_cfg(LM_MOE_ARCH), top_k=8)
    check(cfg.n_experts >= 8, "the top-8 check needs 8 experts or more")
    model = build(cfg)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cuda")
    batch = train_batch(cfg, 4, 64, "cuda")
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), 10_000, 5)
    out = {"arch": LM_MOE_ARCH, "config": "reduced, top_k=8, float32",
           "n_experts": cfg.n_experts, "batch": [4, 64]}
    real = moe._dispatch
    try:
        for name, dispatch in (("embedding", real),
                               ("gather", gather_dispatch)):
            moe._dispatch = dispatch
            (s1, m1), (s2, m2) = step(state, batch), step(state, batch)
            g1, g2 = (grads_of(model, state.params, batch) for _ in range(2))
            out[name] = {
                "step_loss_bitwise": bool(torch.equal(m1["loss"],
                                                      m2["loss"])),
                "step_leaves_differ": sum(not torch.equal(a, b) for a, b in
                                          zip(leaves(s1), leaves(s2))),
                "grad_leaves": len(g1),
                "grad_leaves_differ": sum(not torch.equal(g1[k], g2[k])
                                          for k in g1)}
            out[name]["bitwise"] = (out[name]["step_loss_bitwise"] and
                                    out[name]["step_leaves_differ"] == 0 and
                                    out[name]["grad_leaves_differ"] == 0)
    finally:
        moe._dispatch = real
    check(out["embedding"]["bitwise"],
          f"top-8 MoE step not bitwise on the card: {out['embedding']}")
    return out


def phase_train():
    """The LM trainer (no kernel of its own: the reference's training path
    is plain jnp). (1) One train step of each family's reduced config in
    float32 on the card against the CPU from the same state (TF32 off):
    loss, grad_norm, lr_scale and every gradient leaf within
    ``TRAIN_TOL``; the card's step repeated, bitwise or not; whether a
    Mamba-2 layer's gradient at zamba2's full width is finite. (2) The
    reference's restart protocol on the card, reduced qwen3-0.6b: 20
    straight steps against 10, a restore and 10 more, losses at rtol 1e-5,
    run twice; bitwise or not. (3) qwen3-0.6b at full width and depth
    through ``launch.train.train`` (bf16 over f32 weights, batch 8, seq
    512, 20 steps, one checkpoint at step 20): finite losses falling,
    step time, tokens per second, the share of the bf16 peak, peak
    memory, the checkpoint's save and restore seconds and bytes, and the
    restore bitwise into a fresh state; two more steps from the saved
    state under torch.profiler (kernels a step, the device's busy
    share); one step from the saved state with no mesh active against
    the same step under the run's mesh, bitwise."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import param_shardings
    from repro_torch.launch.mesh import activate_mesh, make_host_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.roofline import (HW, analyze, count_params, model_flops,
                                      roofline_report)
    from repro_torch.training import init_train_state, make_train_step

    check(not torch.backends.cuda.matmul.allow_tf32 and
          not torch.backends.cudnn.allow_tf32, "TF32 must be off here")
    for arch in TRAIN_FAMILIES:
        cfg = family_cfg(arch)
        model = build(cfg)
        cpu = init_train_state(cfg, torch.Generator().manual_seed(0),
                               "cpu")
        card = tree_map(lambda t: t.cuda(), cpu)
        B, S = 2, 32
        b_cpu, b_card = (train_batch(cfg, B, S, d) for d in ("cpu", "cuda"))
        step = make_train_step(cfg, AdamWConfig(lr=1e-3), 10_000, 5)
        _, m_cpu = step(cpu, b_cpu)
        _, m_card = step(card, b_card)
        _, m_again = step(card, b_card)
        g_cpu = grads_of(model, cpu.params, b_cpu)
        g_card = grads_of(model, card.params, b_card)
        g_again = grads_of(model, card.params, b_card)
        m_cpu, m_card = ({k: float(v) for k, v in m.items()}
                         for m in (m_cpu, m_card))
        worst = grads_close(g_card, g_cpu)
        row = {"arch": arch, "family": cfg.family,
               "config": f"reduced(n_layers={cfg.n_layers}), float32",
               "batch": [B, S], "cpu": m_cpu, "card": m_card,
               "loss_rel_err": abs(m_card["loss"] - m_cpu["loss"])
               / abs(m_cpu["loss"]),
               "grad_norm_rel_err": abs(m_card["grad_norm"] -
                                        m_cpu["grad_norm"])
               / m_cpu["grad_norm"],
               "grad_leaves": len(g_cpu),
               "grad_worst_over_allowed": worst,
               "card_repeat_bitwise": bool(
                   float(m_again["loss"]) == m_card["loss"] and
                   all(torch.equal(g_again[k], g_card[k]) for k in g_card))}
        emit({"phase": "train", "card_vs_cpu": row})
        check(abs(m_card["loss"] - m_cpu["loss"]) <=
              TRAIN_TOL["loss_atol"] + TRAIN_TOL["loss_rtol"] *
              abs(m_cpu["loss"]), f"reduced {arch}: step loss card vs CPU")
        check(row["grad_norm_rel_err"] <= TRAIN_TOL["grad_norm_rtol"],
              f"reduced {arch}: grad_norm card vs CPU")
        check(m_card["lr_scale"] == m_cpu["lr_scale"],
              f"reduced {arch}: lr_scale card vs CPU")
        check(worst <= 1.0, f"reduced {arch}: a gradient leaf card vs CPU "
              f"at {worst} x its allowed error")
    del cpu, card, g_cpu, g_card, g_again
    emit({"phase": "train", "mamba2_full_width": mamba2_full_width_grads()})
    emit({"phase": "train", "moe_top8_determinism": moe_top8_determinism()})
    free_cuda()

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(2):
            d1 = os.path.join(tmp, f"straight{rep}")
            d2 = os.path.join(tmp, f"restarted{rep}")
            t0 = time.perf_counter()
            straight = train(LM_ARCH, steps=20, ckpt_dir=d1,
                             torch_device="cuda", **RESTART)
            train(LM_ARCH, steps=10, ckpt_dir=d2, torch_device="cuda",
                  **RESTART)
            resumed = train(LM_ARCH, steps=20, ckpt_dir=d2,
                            torch_device="cuda", **RESTART)
            close = bool(np.allclose(resumed[-5:], straight[-5:], rtol=1e-5,
                                     atol=0))
            emit({"phase": "train", "restart": {
                "arch": LM_ARCH, "config": "reduced, float32", **RESTART,
                "run": rep, "wall_s": time.perf_counter() - t0,
                "losses_straight_11_20": straight[10:],
                "losses_resumed_11_20": resumed,
                "max_rel_diff": float(np.max(
                    np.abs(np.subtract(resumed, straight[10:]))
                    / np.abs(straight[10:]))),
                "within_rtol_1e-5": close,
                "bitwise": resumed == straight[10:]}})
            check(len(resumed) == 10 and close,
                  f"restart on the card, run {rep}: losses off the straight "
                  "run's beyond rtol 1e-5")
            runs.append(straight)
    emit({"phase": "train", "restart_repeat": {
        "straight_runs_bitwise": runs[0] == runs[1]}})

    full = family_cfg(LM_ARCH, full=True)
    need = 3 * 4 * TRAIN_FULL_PARAMS            # params, m and v in f32
    record = {"step_s": [], "save_s": []}
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        emit({"phase": "train", "disk": {"dir": tmp, "free_bytes": free,
                                         "checkpoint_bytes_needed": need}})
        check(free >= 1.2 * need,
              f"{tmp} has {free / 2**30:.1f} GiB free; the full-size "
              f"checkpoint needs {need / 2**30:.1f} GiB")
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mesh = make_host_mesh("cuda")
        with train_spies(record):
            losses = train(LM_ARCH, ckpt_dir=tmp, reduced=False, mesh=mesh,
                           torch_device="cuda", **TRAIN_FULL)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        saved, path = record.pop("saved"), record.pop("path")
        ckpt_bytes = os.path.getsize(path)
        tokens, labels = SyntheticLM(full.vocab_size, TRAIN_FULL["seq"],
                                     TRAIN_FULL["batch"]).batch_at(0)
        batch = {"tokens": torch.as_tensor(tokens, device="cuda"),
                 "labels": torch.as_tensor(labels, device="cuda")}
        step_fn = make_train_step(full, AdamWConfig(lr=1e-3), 10_000, 5)
        prof = profile_train_steps(step_fn, saved, batch)
        emit({"phase": "train", "profile": {
            "arch": LM_ARCH, **TRAIN_FULL, **prof}})
        cost = analyze(step_fn, saved, batch)
        REAL_STEP.update(real_step(step_fn, saved, batch, cost))
        train_shape = ShapeConfig("train_8x512", TRAIN_FULL["seq"],
                                  TRAIN_FULL["batch"], "train")
        useful = model_flops(full, train_shape, saved.params)
        n_params = count_params(saved.params)
        # one step from the trained state with no mesh active against the
        # same step under the mesh: loss, every leaf
        plain, m_plain = step_fn(saved, batch)
        with activate_mesh(mesh):
            meshed, m_mesh = step_fn(saved, batch)
        mesh_step = {
            "loss_no_mesh": float(m_plain["loss"]),
            "loss_mesh": float(m_mesh["loss"]),
            "leaves": len(leaves(plain)),
            "leaves_differ": sum(not torch.equal(a, b) for a, b in
                                 zip(leaves(meshed), leaves(plain)))}
        del plain, meshed
        free_cuda()
        template = tree_map(torch.empty_like, saved)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        restored, meta = Checkpointer(tmp).restore(
            template, shardings=param_shardings(mesh, full, template))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        same = all(torch.equal(a, b) for a, b in
                   zip(leaves(restored), leaves(saved)))
        n_leaves = len(leaves(saved))
        del saved, restored, template
    free_cuda()
    step_s = record["step_s"]
    med = statistics.median(step_s[5:])
    tokens = TRAIN_FULL["batch"] * TRAIN_FULL["seq"]
    finite = bool(np.all(np.isfinite(losses)))
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    hw = HW()
    report = roofline_report(cost, hw, chips=1, model_flops_total=useful)
    emit({"phase": "train", "roofline": {
        "arch": LM_ARCH, "shape": dataclasses.asdict(train_shape),
        "hw": dataclasses.asdict(hw), "flops": report["hlo_flops_per_device"],
        "bytes": report["hlo_bytes_per_device"],
        "t_compute_s": report["t_compute_s"],
        "t_memory_s": report["t_memory_s"],
        "t_collective_s": report["t_collective_s"],
        "dominant": report["dominant"],
        "bound_step_s": report["bound_step_s"],
        "model_flops": useful,
        "useful_flops_ratio": report["useful_flops_ratio"],
        "roofline_fraction": report["roofline_fraction"],
        "step_s_median": med,
        "step_over_bound": med / report["bound_step_s"]}})
    emit({"phase": "train", "full_size": {
        "arch": LM_ARCH, "n_layers": full.n_layers, "d_model": full.d_model,
        "vocab": full.vocab_size, "dtype": full.dtype, "params": n_params,
        **TRAIN_FULL, "wall_s": wall,
        "losses_1_5": losses[:5], "losses_16_20": losses[-5:],
        "mean_first_5": first, "mean_last_5": last, "losses_finite": finite,
        "step_ms_median_6_20": 1e3 * med, "step_ms_first": 1e3 * step_s[0],
        "tokens_per_s": tokens / med,
        "bf16_peak_share": useful / med / hw.peak_flops,
        "bf16_peak_share_formula": "roofline.model_flops (6 x active "
                                   "params x tokens) / median step s / "
                                   "HW().peak_flops",
        "bf16_peak_share_6nt": 6 * n_params * tokens / med / hw.peak_flops,
        "mesh": dict(mesh.shape),
        "mesh_step_vs_no_mesh": mesh_step,
        "peak_allocated_gib": peak / 2**30,
        "checkpoint_bytes": ckpt_bytes, "save_s": record["save_s"],
        "restore_s": restore_s, "restored_leaves": n_leaves,
        "restore_bitwise": same, "restored_step": meta["step"]}})
    check(len(losses) == TRAIN_FULL["steps"] and finite,
          f"{LM_ARCH} full size: non-finite losses {losses}")
    check(last < first, f"{LM_ARCH} full size: loss did not fall "
          f"({first} -> {last})")
    check(len(record["save_s"]) == 1 and meta["step"] == TRAIN_FULL["steps"],
          f"{LM_ARCH} full size: expected one checkpoint at step "
          f"{TRAIN_FULL['steps']}")
    check(same, f"{LM_ARCH} full size: the restored state differs")
    check(n_params == TRAIN_FULL_PARAMS,
          f"{LM_ARCH}: {n_params} parameters, not {TRAIN_FULL_PARAMS}")
    check(mesh_step["loss_mesh"] == mesh_step["loss_no_mesh"] and
          mesh_step["leaves_differ"] == 0,
          f"{LM_ARCH} full size: the step under make_host_mesh differs from "
          f"the step with no mesh: {mesh_step}")
    check(report["useful_flops_ratio"] < 1.0,
          f"{LM_ARCH}: model_flops above the counted FLOPs")


def real_step(step_fn, state, batch, cost) -> dict:
    """What phase dryrun holds its trace against: the real step's
    ``op_cost`` count, its arguments' bytes, the allocation a copy of
    them takes, and the step's peak allocation above its arguments."""
    import torch
    from repro_torch.pytree import leaves, tree_map
    free_cuda()
    before = torch.cuda.memory_allocated()
    copy = tree_map(torch.clone, (state, batch))
    grown = torch.cuda.memory_allocated() - before
    del copy
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step_fn(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    free_cuda()
    return {"cost": cost, "allocated_growth": grown, "step_peak": peak,
            "argument_bytes": sum(t.numel() * t.element_size()
                                  for t in leaves((state, batch)))}


def dryrun_world_cells() -> list:
    """``run_cell`` / ``run_ising_cell`` as rank 0 of a fake world of 256
    ranks on the card, in a child Python (one process holds one world):
    one record a cell; then one a ``DRYRUN_DEPTH_CUT`` cell (its per-rank
    FLOPs and collective bytes as ``roofline_report`` totals them, keyed
    ``depth_cut``; for a pair of depths the layers' between them)."""
    code = "\n".join([
        "import dataclasses, json, logging, sys, time",
        f"sys.path.insert(0, {os.path.join(ROOT, 'src')!r})",
        "from repro_torch.launch import dryrun",
        "dryrun.init_fake_world(256)",
        "logging.getLogger('torch.distributed.tensor').setLevel(40)",
        "logging.getLogger('torch._logging').setLevel(40)",
        "import traceback",
        "from repro_torch.configs import SHAPES, get_config",
        "from repro_torch.launch.mesh import make_production_mesh",
        "failed = 0",
        f"for arch, shape in {DRYRUN_CELLS + (('ising', DRYRUN_ISING),)!r}:",
        "    try:",
        "        rec = (dryrun.run_ising_cell(shape, False, save=False,"
        " torch_device='cuda') if arch == 'ising' else dryrun.run_cell("
        "arch, shape, False, save=False, torch_device='cuda'))",
        "    except Exception as e:",
        "        traceback.print_exc()",
        "        failed, rec = 1, {'arch': arch, 'shape': shape,"
        " 'error': repr(e)[:500]}",
        "    print(json.dumps(rec), flush=True)",
        "from repro_torch.roofline import roofline_report",
        f"for arch, layers, shape, _, _ in {DRYRUN_DEPTH_CUT!r}:",
        "    t0 = time.perf_counter()",
        "    rec = {'depth_cut': arch, 'layers': layers, 'shape': shape}",
        "    try:",
        "        depths = layers if isinstance(layers, tuple) else (layers,)",
        "        flops = coll = 0",
        "        for sign, n in zip((-1, 1)[-len(depths):], depths):",
        "            traced, _, _ = dryrun._lower(dataclasses.replace("
        "get_config(arch), n_layers=n), SHAPES[shape], make_production_mesh("
        "torch_device='cuda'))",
        "            flops += sign * traced.cost.flops",
        "            coll += sign * roofline_report(traced.cost)["
        "'collective_bytes_per_device']",
        "        rec.update(flops=flops, collective_bytes=coll,"
        " trace_s=time.perf_counter() - t0)",
        "    except Exception as e:",
        "        traceback.print_exc()",
        "        failed = 1",
        "        rec['error'] = repr(e)[:500]",
        "    print(json.dumps(rec), flush=True)",
        "sys.exit(failed)"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    print(out.stderr[-6000:], file=sys.stderr, flush=True)
    records = [json.loads(line) for line in out.stdout.splitlines()
               if line.startswith("{")]
    for rec in records:
        if "error" in rec:
            emit({"phase": "dryrun", "cell_failed": rec})
    check(out.returncode == 0, f"the dry-run's world exited "
          f"{out.returncode}")
    return records


def phase_dryrun():
    """The multi-pod dry-run on the card's torch (no kernel: the
    reference's dry-run lowers plain JAX). (1) Three cells traced in a
    fake world of 256 ranks on the card's device type, and three full-width
    cells cut in depth (``DRYRUN_DEPTH_CUT``; one counts the layers
    between two depths), whose per-rank FLOPs must
    stay within ``DRYRUN_CUT_MIN``-``DRYRUN_CUT_MAX`` of the reference's;
    the collective bytes a rank of the LM cells and the cut cells at most
    ``DRYRUN_COLL_MAX`` of the reference's.
    (2) qwen3-0.6b at
    full width with phase train's batch traced on the card's (1, 1) host
    mesh against the real step: FLOPs, bytes and argument bytes
    exactly."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.roofline import analyze
    from repro_torch.training import init_train_state, make_train_step

    t0 = time.perf_counter()
    records = dryrun_world_cells()
    world_s = time.perf_counter() - t0
    cuts = [rec for rec in records if "depth_cut" in rec]
    records = [rec for rec in records if "depth_cut" not in rec]
    for rec, (arch, layers, shape, ref, ref_coll) in zip(cuts,
                                                         DRYRUN_DEPTH_CUT):
        rec.update(reference_flops=ref, over_reference=rec["flops"] / ref,
                   reference_collective_bytes=ref_coll,
                   coll_over_reference=rec["collective_bytes"] / ref_coll)
        emit({"phase": "dryrun", "depth_cut": rec})
        check(DRYRUN_CUT_MIN <= rec["over_reference"] <= DRYRUN_CUT_MAX,
              f"dry-run {arch} at {layers} layers x {shape}: "
              f"{rec['flops']:.4g} FLOPs a rank, "
              f"{rec['over_reference']:.3f}x the reference's {ref:.4g} "
              f"(limits {DRYRUN_CUT_MIN}-{DRYRUN_CUT_MAX})")
        check(0 < rec["coll_over_reference"] <= DRYRUN_COLL_MAX,
              f"dry-run {arch} at {layers} layers x {shape}: "
              f"{rec['collective_bytes']:.4g} collective bytes a rank, "
              f"{rec['coll_over_reference']:.3f}x the reference's "
              f"{ref_coll:.4g} (limit {DRYRUN_COLL_MAX})")
    check(len(cuts) == len(DRYRUN_DEPTH_CUT),
          f"the dry-run's world gave {len(cuts)} depth-cut records")
    for rec in records:
        rep, mem = rec["roofline"], rec["memory"]
        ref_flops, ref_coll = DRYRUN_REFERENCE.get(
            (rec["arch"], rec["shape"]), (None, None))
        coll = rep["collective_bytes_per_device"]
        emit({"phase": "dryrun", "cell": {
            "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "kind": rec["kind"], "trace_s": rec["trace_s"],
            "argument_gib": mem["argument_size_in_bytes"] / 2**30,
            "temp_gib": mem["temp_size_in_bytes"] / 2**30,
            "t_compute_s": rep["t_compute_s"],
            "t_memory_s": rep["t_memory_s"],
            "t_collective_s": rep["t_collective_s"],
            "dominant": rep["dominant"],
            "collective_breakdown": rep["collective_breakdown"],
            "collective_bytes_per_device": coll,
            "reference_collective_bytes": ref_coll,
            "roofline_fraction": rep["roofline_fraction"],
            "model_flops": rec["model_flops"],
            "flops_over_reference": (rep["hlo_flops_per_device"] / ref_flops
                                     if ref_flops else None),
            "coll_over_reference": coll / ref_coll if ref_coll else None}})
        check(rep["hlo_flops_per_device"] > 0,
              f"dry-run {rec['arch']} x {rec['shape']}: no FLOPs counted")
        if ref_coll:
            check(0 < coll <= DRYRUN_COLL_MAX * ref_coll,
                  f"dry-run {rec['arch']} x {rec['shape']}: {coll:.4g} "
                  f"collective bytes a rank, {coll / ref_coll:.3f}x the "
                  f"reference's {ref_coll:.4g} (limit {DRYRUN_COLL_MAX})")
    check(len(records) == len(DRYRUN_CELLS) + 1,
          f"the dry-run's world gave {len(records)} records")

    full = family_cfg(LM_ARCH, full=True)
    shape = ShapeConfig("train_8x512", TRAIN_FULL["seq"],
                        TRAIN_FULL["batch"], "train")
    real = dict(REAL_STEP)
    if not real:                     # phase train did not run: draw its state
        state = init_train_state(full, torch.Generator().manual_seed(0),
                                 "cuda")
        tokens, labels = SyntheticLM(full.vocab_size, TRAIN_FULL["seq"],
                                     TRAIN_FULL["batch"]).batch_at(0)
        batch = {"tokens": torch.as_tensor(tokens, device="cuda"),
                 "labels": torch.as_tensor(labels, device="cuda")}
        step_fn = make_train_step(full, AdamWConfig(lr=1e-3), 10_000, 5)
        real = real_step(step_fn, state, batch,
                         analyze(step_fn, state, batch))
        del state, batch
        free_cuda()
    traced, _, trace_s = dryrun._lower(full, shape, make_host_mesh("cuda"))
    row = {"arch": LM_ARCH, "batch": [TRAIN_FULL["batch"], TRAIN_FULL["seq"]],
           "trace_s": trace_s,
           "flops_traced": traced.cost.flops,
           "flops_real": real["cost"].flops,
           "bytes_traced": traced.cost.bytes,
           "bytes_real": real["cost"].bytes,
           "argument_bytes_traced": traced.argument_bytes,
           "argument_bytes_real": real["argument_bytes"],
           "allocated_growth_of_a_copy": real["allocated_growth"],
           "temp_bytes_traced": traced.cost.peak_bytes,
           "temp_bytes_real_op_cost": real["cost"].peak_bytes,
           "step_peak_allocated_above_args": real["step_peak"],
           "temp_over_peak_allocated": traced.cost.peak_bytes
           / real["step_peak"]}
    wall = time.perf_counter() - t0
    emit({"phase": "dryrun", "count_vs_card": row})
    emit({"phase": "dryrun", "wall_s": wall, "world_s": world_s})
    check(row["flops_traced"] == row["flops_real"] > 0,
          f"dry-run FLOPs {row['flops_traced']} != the real step's "
          f"{row['flops_real']}")
    check(row["bytes_traced"] == row["bytes_real"] > 0,
          f"dry-run bytes {row['bytes_traced']} != the real step's "
          f"{row['bytes_real']}")
    check(row["argument_bytes_traced"] == row["argument_bytes_real"],
          f"dry-run argument bytes {row['argument_bytes_traced']} != "
          f"{row['argument_bytes_real']}")
    check(0.8 <= row["temp_over_peak_allocated"] <= 1.25,
          f"dry-run temp bytes {row['temp_bytes_traced']} are "
          f"{row['temp_over_peak_allocated']:.3f}x the step's peak "
          f"allocation above its arguments, {row['step_peak_allocated_above_args']}"
          " (limits 0.8-1.25)")


def entry_point(rel: str):
    """The port's entry point at ``rel`` (a file outside ``src/``) as a
    module; its ``main`` does not run on import."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "entry_" + os.path.splitext(os.path.basename(rel))[0],
        os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(oracle_path):
    """The port's examples and paper scripts (``examples/torch/``,
    ``scripts/torch/``), each through ``main([..., "--torch-device",
    "cuda"])`` in this process at the reference's sizes (train_lm --small
    100 steps and its ~100M path 20, not 300), with the anneal kernel's launches counted
    around the phase. Gates: the quickstart's mean SR with perturbation
    above gd's; maxcut_demo's assert; serve_lm's tokens equal to the same
    call's on the CPU; train_lm --small finite, its last-5 mean loss below
    its first-5; calibrate's default row (drive 1.0, period 48, off 8)
    perturbation SR above gd's; baseline_vs_optimized's mean SR
    improvement above 1. Each file's wall."""
    import numpy as np

    from repro_torch.kernels import ising_anneal as ka
    cuda = ["--torch-device", "cuda"]
    env = os.environ.get("REPRO_TORCH_ORACLE_CACHE")
    os.environ["REPRO_TORCH_ORACLE_CACHE"] = oracle_path
    walls, rows = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        walls[name] = time.perf_counter() - t0
        return out

    ka.reset_launches()
    try:
        quick = timed("quickstart", lambda: entry_point(
            "examples/torch/quickstart.py").main(cuda))
        rows["quickstart"] = {"sr_pert": float(quick["sr"].mean()),
                              "sr_gd": float(quick["sr_gd"].mean()),
                              "ratio": float(quick["ratio"])}
        cuts = timed("maxcut_demo", lambda: entry_point(
            "examples/torch/maxcut_demo.py").main(cuda))
        rows["maxcut_demo"] = cuts
        serve_mod = entry_point("examples/torch/serve_lm.py")
        served = timed("serve_lm", lambda: serve_mod.main(cuda))
        host = serve_mod.main(["--torch-device", "cpu"])
        rows["serve_lm"] = {
            "tokens": int(served["generated"].size),
            "equal_to_cpu": bool(np.array_equal(served["generated"],
                                                host["generated"])),
            "tok_per_s": served["tok_per_s"]}
        train_mod = entry_point("examples/torch/train_lm.py")
        with tempfile.TemporaryDirectory() as tmp:
            small = timed("train_lm --small", lambda: train_mod.main(
                ["--small", "--steps", "100", "--ckpt-dir",
                 os.path.join(tmp, "small")]
                + cuda))
            big = timed("train_lm 100M", lambda: train_mod.main(
                ["--steps", "20", "--ckpt-dir", os.path.join(tmp, "100m")]
                + cuda))
        rows["train_lm"] = {
            "small_steps": len(small), "small_first5": float(
                np.mean(small[:5])), "small_last5": float(np.mean(small[-5:])),
            "m100_steps": len(big), "m100_first": big[0], "m100_last": big[-1]}
        free_cuda()
        calib = timed("calibrate_perturbation", lambda: entry_point(
            "scripts/torch/calibrate_perturbation.py").main(cuda))
        rows["calibrate_perturbation"] = [
            {"drive": r["drive"], "period": r["period"], "off": r["off"],
             "sr_gd": float(r["sr_gd"].mean()),
             "sr_pert": float(r["sr_pert"].mean())} for r in calib]
        delta = timed("baseline_vs_optimized", lambda: entry_point(
            "scripts/torch/baseline_vs_optimized.py").main(cuda))
        rows["baseline_vs_optimized"] = {
            "mean_ratio": delta["mean_ratio"],
            "cells": [{"n": c["n"], "sr_gd": float(c["sr_gd"].mean()),
                       "sr_pert": float(c["sr_pert"].mean())}
                      for c in delta["cells"]]}
    finally:
        if env is None:
            os.environ.pop("REPRO_TORCH_ORACLE_CACHE", None)
        else:
            os.environ["REPRO_TORCH_ORACLE_CACHE"] = env
    launches = dict(ka.launches)
    emit({"phase": "examples", "rows": rows, "walls_s": walls,
          "anneal_launches": launches, "card": nvidia_smi()})
    q = rows["quickstart"]
    check(q["sr_pert"] > q["sr_gd"], f"quickstart: perturbation SR "
          f"{q['sr_pert']} not above gd's {q['sr_gd']}")
    check(rows["serve_lm"]["equal_to_cpu"],
          "serve_lm: the card's tokens differ from the CPU's")
    check(all(map(math.isfinite, small + big)), "train_lm: a loss is not "
          "finite")
    t = rows["train_lm"]
    check(t["small_last5"] < t["small_first5"], f"train_lm --small: last-5 "
          f"mean {t['small_last5']} not below first-5 {t['small_first5']}")
    (default,) = [r for r in rows["calibrate_perturbation"]
                  if (r["drive"], r["period"], r["off"]) == (1.0, 48, 8)]
    check(default["sr_pert"] > default["sr_gd"], f"calibrate: the default "
          f"row's perturbation SR {default['sr_pert']} not above gd's "
          f"{default['sr_gd']}")
    check(rows["baseline_vs_optimized"]["mean_ratio"] > 1,
          "baseline_vs_optimized: mean SR improvement "
          f"{rows['baseline_vs_optimized']['mean_ratio']} not above 1")
    check(sum(launches.values()) > 0, "examples: the anneal kernel was not "
          "launched")
    return launches


PHASES = ("compare", "main", "scan", "timing", "sb_compare", "sb_main",
          "gset", "sb_timing", "search", "zoo", "physics", "serve",
          "fabric", "lm", "lm_families", "mesh", "train", "dryrun",
          "examples")


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
            "physics": lambda: phase_physics(oracle_path),
            "serve": phase_serve,
            "fabric": phase_fabric,
            "lm": phase_lm,
            "lm_families": phase_lm_families,
            "mesh": phase_mesh,
            "train": phase_train,
            "dryrun": phase_dryrun,
            "examples": lambda: phase_examples(oracle_path),
        }
        out = {}
        for name in (p for p in PHASES if p in phases):
            t0 = time.perf_counter()
            out[name] = run[name]()
            emit({"phase": name, "phase_s": time.perf_counter() - t0})
    emit({"phase": "end", "total_s": time.perf_counter() - START})
    if set(out) != set(PHASES):
        print(nvidia_smi(), flush=True)
        emit({"phases_run": list(out)})
        return 0
    err, launches, timing = out["compare"], out["main"], out["timing"]
    sb_err, sb_launches = out["sb_compare"], out["sb_main"]
    sb_timing = out["sb_timing"]
    fabric_launches = out["fabric"]
    example_launches = out["examples"]

    kernels = []
    for j_dtype, row in timing.items():
        kernels.append({
            "name": row["name"], "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ising_anneal.cu",
            "replaces": "src/repro/kernels/ising_anneal.py:59",
            "launches": launches[row["name"]] + fabric_launches[row["name"]]
            + example_launches[row["name"]],
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
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
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
