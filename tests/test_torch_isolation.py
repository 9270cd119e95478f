"""The port stands alone: no JAX and no ``repro`` import, and no quiet CPU
fallback when the caller asked for CUDA."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s+import\b))",
    re.MULTILINE)


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    return env


def test_import_loads_no_jax_and_no_reference_package():
    code = ("import sys, repro_torch, repro_torch.api, repro_torch.core, "
            "repro_torch.kernels, repro_torch.convert, repro_torch.problems, "
            "repro_torch.solvers, repro_torch.workloads, "
            "repro_torch.launch.solve; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_sources_import_neither_jax_nor_repro(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), FORBIDDEN.search(text).group(0)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.api import ProblemSuite, get_solver, solve_suite
    from repro_torch.core import AnnealEngine, IsingMachine
    from repro_torch.api import best_known_energies
    from repro_torch.launch.solve import solve
    from repro_torch.solvers import (parallel_tempering_jax_runs,
                                     simulated_annealing_jax_runs,
                                     tabu_search_jax_runs)
    from repro_torch.solvers.pt_jax import pt_draws
    from repro_torch.solvers.sa_jax import sa_draws
    from repro_torch.solvers.sb_jax import simulated_bifurcation_jax_runs
    from repro_torch.solvers.tabu_jax import tabu_draws
    _no_cuda(monkeypatch)
    suite = ProblemSuite.random(n=8, density=0.5, num_problems=1, seed=0)
    J = suite[0].J_levels
    for call in (lambda: solve_suite(suite, runs=2),
                 lambda: solve_suite(suite, solver="brute-force"),
                 lambda: solve_suite(suite, solver="sb-jax", runs=2),
                 lambda: solve_suite(suite, solver="tabu-jax", runs=2),
                 lambda: get_solver("engine"),
                 lambda: get_solver("brute-force"),
                 lambda: get_solver("sb-jax"),
                 lambda: get_solver("chip-lns"),
                 lambda: get_solver("sa-jax"),
                 lambda: get_solver("pt-jax"),
                 lambda: get_solver("tabu-jax"),
                 lambda: get_solver("sa-numpy"),
                 lambda: get_solver("tabu"),
                 lambda: best_known_energies(suite),
                 lambda: simulated_bifurcation_jax_runs(J),
                 lambda: simulated_annealing_jax_runs(J),
                 lambda: parallel_tempering_jax_runs(J),
                 lambda: tabu_search_jax_runs(J),
                 lambda: sa_draws(1, 2, 8, 3),
                 lambda: pt_draws(1, 2, 4, 8, 3),
                 lambda: tabu_draws(1, 2, 8, 3),
                 lambda: solve(12, 0.5, 1, 2, solver="tabu-jax",
                               workload="mis", oracle=False),
                 lambda: solve(8, 0.5, 1, 2, solver="sb-jax", oracle=False),
                 lambda: IsingMachine(),
                 lambda: AnnealEngine(),
                 lambda: IsingMachine(torch_device="cuda:0")):
        with pytest.raises(RuntimeError, match="torch_device='cpu'"):
            call()
    # asked for by name, the CPU works
    rep = solve_suite(suite, runs=2, budget=0.05, torch_device="cpu",
                      oracle=False)
    assert rep.meta["torch_device"] == "cpu"
    rep = solve_suite(suite, solver="sb-jax", runs=2, budget=0.05,
                      torch_device="cpu", oracle=False)
    assert rep.meta["torch_device"] == "cpu"
    for name in ("sa-jax", "pt-jax", "tabu-jax"):
        rep = solve_suite(suite, solver=name, runs=2, budget=0.05,
                          torch_device="cpu", oracle=False)
        assert rep.meta["torch_device"] == "cpu", name


def test_solve_cli_raises_without_cuda_unless_asked_for_the_cpu():
    env = _env(CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.solve", "--solver",
           "sb-jax", "--workload", "maxcut", "--spins", "12", "--problems",
           "1", "--runs", "4", "--no-oracle", "--budget", "0.05"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "torch_device='cpu'" in out.stderr
    out = subprocess.run(cmd + ["--torch-device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "[maxcut #0] N=12 cut weight=" in out.stdout


def test_chip_smoke_fails_without_cuda(tmp_path):
    env = _env(CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(lone)], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
