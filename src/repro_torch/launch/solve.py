"""Ising-solve CLI of the port, the counterpart of ``repro.launch.solve``.

    # 2000-spin Gset Max-Cut by simulated bifurcation on the card
    PYTHONPATH=src python -m repro_torch.launch.solve --solver sb-jax \
        --workload gset --spins 2000 --problems 1 --runs 256 --no-oracle

    # the paper's 64-spin suite on the engine (perturbation, or the
    # gradient-descent baseline with --no-perturbation)
    PYTHONPATH=src python -m repro_torch.launch.solve --solver engine \
        --spins 64 --density 0.5 --problems 4 --runs 256

    # 128-spin Max-Cut on the multi-chip decomposition solver
    PYTHONPATH=src python -m repro_torch.launch.solve --solver chip-lns \
        --workload maxcut --spins 128 --problems 1 --runs 16

    # the mega-fabric: a 2000-spin Gset graph checkerboarded over 8 virtual
    # dies, one engine dispatch per color phase
    PYTHONPATH=src python -m repro_torch.launch.solve --solver fabric-jax \
        --workload gset --spins 2000 --mesh-devices 8 --no-oracle

    # NP-hard zoo (coloring / mis / vertex-cover / 3sat / tsp): the best
    # configuration is decoded back to native form and verified
    PYTHONPATH=src python -m repro_torch.launch.solve --solver tabu-jax \
        --workload mis --spins 12 --runs 32

    # the analog physics tier: a 256-chip virtual fleet with per-chip
    # coupling mismatch and leakage spread, one batched call
    PYTHONPATH=src python -m repro_torch.launch.solve --solver ode-jax \
        --spins 64 --problems 2 --runs 8 --chips 256 \
        --mismatch-sigma 0.1 --tau-leak-spread 0.3

    # the classical search tier at machine batch scale: tabu-jax (the
    # best-known oracle over restarts x problems), pt-jax (parallel
    # tempering), sa-jax; sa-numpy and tabu run on the host
    PYTHONPATH=src python -m repro_torch.launch.solve --solver pt-jax \
        --spins 48 --problems 8 --runs 64

Any registered solver (``--list-solvers``) runs behind the same
Problem/Suite/Report surface. The best-known oracle is disk-cached by
problem content hash (``--no-cache`` bypasses it, ``--no-oracle`` skips
it: the only sane setting at Gset scale) and refreshed by the batched
tabu-jax tier above the brute-force range. Everything runs on
``--torch-device`` (default ``cuda``; without CUDA the CLI raises unless
given ``--torch-device cpu``). Workloads: ``random-qubo``, ``maxcut``,
``gset`` and the zoo. ``--mesh-devices K`` gives fabric-jax K virtual dies
on that one device (no forced-device flag, unlike the reference).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..api import ProblemSuite, get_solver, list_solvers, solve_suite

#: --workload values that are plain Problem constructors, not zoo entries.
_BUILTIN = ("random-qubo", "maxcut", "gset")


def build_suite(workload: str, n: int, density: float, problems: int,
                seed: int, degree: float | None = None) -> ProblemSuite:
    """One suite for any workload name: the built-ins keep the paper's
    problem families; everything else resolves through the
    ``repro_torch.workloads`` registry (``n`` is the native size: nodes /
    variables / cities), and ``density`` reaches the generators that take
    one. ``gset`` is parameterized by the expected vertex ``degree``
    (default 6, the G1 class) instead of ``density``."""
    import inspect

    from ..api import Problem
    if workload == "random-qubo":
        return ProblemSuite.random(n, density, problems, seed=seed)
    if workload == "maxcut":
        return ProblemSuite([Problem.maxcut(n, density, seed=seed + i)
                             for i in range(problems)])
    if workload == "gset":
        from ..problems.gset import gset_problem
        deg = 6.0 if degree is None else float(degree)
        return ProblemSuite([gset_problem(n, seed=seed + i, degree=deg)
                             for i in range(problems)])
    from ..workloads import get_workload
    gen = get_workload(workload).random_instance
    kw = {"density": density} \
        if "density" in inspect.signature(gen).parameters else {}
    return ProblemSuite.workload(workload, size=n, num_problems=problems,
                                 seed=seed, **kw)


def solve(n_spins: int, density: float, problems: int, runs: int,
          seed: int = 0, solver: str = "engine", backend: str = "auto",
          perturbation: bool = True, autotune: bool = False,
          budget: float | None = None, use_cache: bool = True,
          workload: str = "random-qubo", oracle: bool = True,
          degree: float | None = None,
          torch_device: str | torch.device = "cuda",
          chips: int = 1, mismatch_sigma: float = 0.0,
          tau_leak_spread: float = 0.0, mesh_devices: int | None = None):
    """Solve one workload cell through the registry; returns
    ``(report, suite)`` — the oracle-attached
    :class:`repro_torch.api.SolveReport` plus the suite it solved.
    ``chips`` / ``mismatch_sigma`` / ``tau_leak_spread`` size the ode-jax
    virtual-chip fleet; ``mesh_devices`` the fabric-jax virtual dies."""
    suite = build_suite(workload, n_spins, density, problems, seed,
                        degree=degree)
    opts = {}
    if solver == "engine":
        opts = dict(backend=backend, autotune=autotune,
                    variant="perturbation" if perturbation else "gd")
    elif solver == "chip-lns":
        opts = dict(backend=backend)
    elif solver == "fabric-jax":
        opts = dict(backend=backend, mesh_devices=mesh_devices)
    elif solver == "ode-jax":
        from ..physics import VariationModel
        opts = dict(variant="perturbation" if perturbation else "gd",
                    n_chips=chips,
                    variation=VariationModel(
                        j_mismatch_sigma=mismatch_sigma,
                        tau_leak_spread=tau_leak_spread))
    return solve_suite(suite, solver=solver, runs=runs, seed=seed + 1,
                       budget=budget, use_cache=use_cache, oracle=oracle,
                       torch_device=torch_device, **opts), suite


def cut_lines(workload: str, suite: ProblemSuite, report) -> list[str]:
    """One line per problem with the cut weight of its best spins."""
    from ..core.hamiltonian import maxcut_value
    out = []
    for i, p in enumerate(suite):
        cut = float(maxcut_value(
            torch.as_tensor(np.asarray(p.meta["W"], np.float64)),
            torch.as_tensor(report.best_sigma[i])))
        out.append(f"[{workload} #{i}] N={p.n} cut weight={cut:g}")
    return out


def native_lines(workload: str, suite: ProblemSuite, report) -> list[str]:
    """One line per problem: its best configuration decoded back to native
    form and verified."""
    from ..workloads import get_workload
    wl = get_workload(workload)
    out = []
    for i, p in enumerate(suite):
        res = wl.verify(p, wl.decode(p, report.best_sigma[i]))
        out.append(f"[{workload} #{i}] feasible={res.feasible} "
                   f"objective={res.objective:g} ({wl.sense})")
    return out


def fabric_lines(report) -> list[str]:
    """The fabric ledger of a fabric-jax solve: dies, colors, dispatches
    and field exchanges, then each color phase's occupancy per problem
    (none for other solvers)."""
    fab = report.meta.get("fabric")
    if not fab:
        return []
    out = [f"[fabric] {fab['mesh_devices']} dies, {fab['n_colors']} colors "
           f"x {report.meta['outer_sweeps']} sweeps = {fab['dispatches']} "
           f"dispatches, {fab['field_exchanges']} field exchanges"]
    for occ in fab["occupancy"]:
        per_p = [f"p{k[1:]}:{v['tiles']}t/{v['dies_busy']}d"
                 f"(+{v['pad_tiles']}pad)"
                 for k, v in occ.items() if k != "color"]
        out.append(f"[fabric]   color {occ['color']}: peak "
                   f"{fab['color_peaks'][occ['color']]} tiles/die — "
                   + " ".join(per_p))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", default="engine",
                    help="registered solver name (see --list-solvers)")
    ap.add_argument("--list-solvers", action="store_true",
                    help="print the solver registry and exit")
    ap.add_argument("--workload", default="random-qubo",
                    help="problem family: random-qubo, maxcut, gset, or "
                         "any registered zoo workload (coloring, mis, "
                         "vertex-cover, 3sat, tsp)")
    ap.add_argument("--spins", type=int, default=64,
                    help="native size: spins for random-qubo / maxcut / "
                         "gset, nodes / variables / cities for zoo "
                         "workloads")
    ap.add_argument("--density", type=float, default=0.5,
                    help="edge/coupling density for random-qubo, maxcut "
                         "and the density-taking zoo workloads (not gset — "
                         "see --degree)")
    ap.add_argument("--degree", type=float, default=None,
                    help="[gset] expected vertex degree of the sparse "
                         "Max-Cut graph (default 6.0, the G1-class "
                         "regime); gset ignores --density")
    ap.add_argument("--problems", type=int, default=4)
    ap.add_argument("--runs", type=int, default=256)
    ap.add_argument("--budget", type=float, default=None,
                    help="effort multiplier, mapped uniformly by "
                         "api.budget.search_effort: scales per-restart "
                         "iterations (anneal length for engine, outer "
                         "sweeps for chip-lns, integration steps for "
                         "sb-jax, sweeps for SA/PT, flips for tabu), never "
                         "the restart count")
    ap.add_argument("--backend", choices=["scan", "fused", "auto"],
                    default="auto",
                    help="[engine/chip-lns] AnnealEngine path: scan (torch "
                         "ops), fused (the CUDA kernel), auto (engine "
                         "decides)")
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device to run on (default cuda; pass cpu "
                         "to run the plain versions on the host)")
    ap.add_argument("--no-perturbation", action="store_true",
                    help="[engine/ode-jax] gradient-descent baseline "
                         "variant")
    ap.add_argument("--autotune", action="store_true",
                    help="[engine] time block_r candidates for this "
                         "workload and persist the winner")
    ap.add_argument("--no-cache", action="store_true",
                    help="bypass the disk-backed best-known oracle cache")
    ap.add_argument("--no-oracle", action="store_true",
                    help="skip the best-known oracle entirely (success "
                         "metrics unavailable)")
    ap.add_argument("--chips", type=int, default=1,
                    help="[ode-jax] virtual-chip fleet size: every chip "
                         "anneals every problem with its own variation "
                         "draws; chips x runs ride ONE batched call per "
                         "pad bucket")
    ap.add_argument("--mismatch-sigma", type=float, default=0.0,
                    help="[ode-jax] per-cell multiplicative coupling "
                         "mismatch sigma (J_eff = J * (1 + sigma*z))")
    ap.add_argument("--tau-leak-spread", type=float, default=0.0,
                    help="[ode-jax] lognormal spread of the gate-leak "
                         "time constant across chips")
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="[fabric-jax] virtual dies in the fabric (default "
                         "1), all on --torch-device")
    args = ap.parse_args(argv)

    if args.list_solvers:
        for name, caps in list_solvers().items():
            lim = f" N<={caps.max_n}" if caps.max_n else ""
            print(f"{name:12s} device={caps.device:5s} "
                  f"exact={caps.exact} needs_oracle={caps.needs_oracle}{lim}")
        return
    # fail fast on unknown names and on a missing CUDA device
    get_solver(args.solver, torch_device=args.torch_device)
    report, suite = solve(
        args.spins, args.density, args.problems, args.runs,
        solver=args.solver, backend=args.backend,
        perturbation=not args.no_perturbation, autotune=args.autotune,
        budget=args.budget, use_cache=not args.no_cache,
        workload=args.workload, oracle=not args.no_oracle,
        degree=args.degree, torch_device=args.torch_device,
        chips=args.chips, mismatch_sigma=args.mismatch_sigma,
        tau_leak_spread=args.tau_leak_spread,
        mesh_devices=args.mesh_devices)
    plan = report.meta.get("engine_plan")
    if plan:
        print(f"[engine] path={plan['path']} block_r={plan['block_r']} "
              f"j_dtype={plan['j_dtype']} ({plan['reason']})")
    for line in fabric_lines(report):
        print(line)
    print(report.summary())
    if args.workload not in _BUILTIN:
        for line in native_lines(args.workload, suite, report):
            print(line)
    elif args.workload in ("maxcut", "gset"):
        for line in cut_lines(args.workload, suite, report):
            print(line)


if __name__ == "__main__":
    main()
