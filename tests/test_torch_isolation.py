"""The port stands alone: no JAX and no ``repro`` import (in the package,
``chip_smoke.py``, ``examples/torch/`` and ``scripts/torch/``), and no quiet
CPU fallback when the caller asked for CUDA."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
#: the port's entry points outside src/: examples, paper scripts, the
#: dry-run's tools (dryrun_split, dryrun_vs_reference, temp_vs_allocator)
#: and plain_outputs
ENTRY_POINTS = sorted([*(ROOT / "examples" / "torch").glob("*.py"),
                       *(ROOT / "scripts" / "torch").glob("*.py")])
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
            "repro_torch.launch.solve, repro_torch.rng, repro_torch.physics, "
            "repro_torch.serve, repro_torch.distributed.fault_tolerance, "
            "repro_torch.distributed.elastic, repro_torch.launch.serve_ising, "
            "repro_torch.distributed, repro_torch.configs, repro_torch.models, "
            "repro_torch.data, repro_torch.launch.serve_lm, "
            "repro_torch.models.moe, repro_torch.models.mamba2, "
            "repro_torch.models.zamba, repro_torch.models.rwkv6, "
            "repro_torch.models.rwkv_model, repro_torch.optim, "
            "repro_torch.training, repro_torch.checkpoint, "
            "repro_torch.launch.train, repro_torch.pytree, "
            "repro_torch.distributed.sharding, repro_torch.launch.mesh, "
            "repro_torch.roofline, repro_torch.roofline.analysis, "
            "repro_torch.roofline.op_cost, repro_torch.launch.dryrun; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_load_no_jax_and_no_reference_package():
    """Loading every file of examples/torch/ and scripts/torch/ (their
    imports run, their main does not) brings in neither JAX nor repro."""
    assert len(ENTRY_POINTS) == 10
    code = ("import importlib.util, sys\n"
            f"for i, path in enumerate({[str(p) for p in ENTRY_POINTS]!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f'e{i}', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                       ROOT / "chip_smoke.py",
                                       *ENTRY_POINTS]))
def test_sources_import_neither_jax_nor_repro(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), FORBIDDEN.search(text).group(0)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
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
    from repro_torch.physics import fleet_anneal
    from repro_torch.serve import (FlushExecutor, IsingFleet, IsingService,
                                   ResiliencePolicy)
    from repro_torch.core import DeviceModel
    from repro_torch.core.perturbation import DEFAULT_PERTURBATION
    from repro_torch.distributed import fabric_mesh
    from repro_torch.launch import serve_lm
    from repro_torch.launch.train import train
    from repro_torch.launch.mesh import make_host_mesh, virtual_mesh
    from repro_torch.distributed import remesh
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
                 lambda: IsingMachine(torch_device="cuda:0"),
                 lambda: get_solver("ode-jax"),
                 lambda: solve_suite(suite, solver="ode-jax", runs=2),
                 lambda: fleet_anneal(J, np.zeros((1, 2, 8), np.float32),
                                      DeviceModel(), DEFAULT_PERTURBATION),
                 lambda: solve(8, 0.5, 1, 2, solver="ode-jax", chips=2,
                               oracle=False),
                 lambda: IsingService(solver="sa-numpy"),
                 lambda: IsingFleet(solver="sa-numpy"),
                 lambda: FlushExecutor(ResiliencePolicy(), primary=None,
                                       solver_name="x", runs=1, seed=0,
                                       block=16),
                 lambda: fabric_mesh(8),
                 lambda: get_solver("fabric-jax"),
                 lambda: solve_suite(suite, solver="fabric-jax", runs=2),
                 lambda: solve(130, 0.5, 1, 2, solver="fabric-jax",
                               workload="gset", mesh_devices=8,
                               oracle=False),
                 lambda: serve_lm.serve("qwen3-0.6b", 1, 4, 2),
                 lambda: serve_lm.serve("olmoe-1b-7b", 1, 4, 2),
                 lambda: serve_lm.serve("zamba2-7b", 1, 4, 2),
                 lambda: serve_lm.serve("hubert-xlarge", 1, 4, 2),
                 lambda: train("qwen3-0.6b", 1, 2, 8, str(tmp_path)),
                 lambda: make_host_mesh(),
                 lambda: virtual_mesh((1, 2), ("data", "model")),
                 lambda: remesh([0, 1], 2)):
        with pytest.raises(RuntimeError, match="torch_device='cpu'"):
            call()
    # asked for by name, the CPU works
    rep = solve_suite(suite, runs=2, budget=0.05, torch_device="cpu",
                      oracle=False)
    assert rep.meta["torch_device"] == "cpu"
    rep = solve_suite(suite, solver="sb-jax", runs=2, budget=0.05,
                      torch_device="cpu", oracle=False)
    assert rep.meta["torch_device"] == "cpu"
    for name in ("sa-jax", "pt-jax", "tabu-jax", "fabric-jax"):
        rep = solve_suite(suite, solver=name, runs=2, budget=0.05,
                          torch_device="cpu", oracle=False)
        assert rep.meta["torch_device"] == "cpu", name
    assert fabric_mesh(8, torch_device="cpu").torch_device.type == "cpu"


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


def test_serve_cli_raises_without_cuda_unless_asked_for_the_cpu():
    env = _env(CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_ising",
           "--solver", "sa-numpy", "--sizes", "12", "--pool", "2",
           "--clients", "1", "--runs", "2", "--duration", "1"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "torch_device='cpu'" in out.stderr
    out = subprocess.run(cmd + ["--torch-device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "-- final:" in out.stdout and "[sa-numpy]" in out.stdout


def test_serve_lm_cli_raises_without_cuda_unless_asked_for_the_cpu():
    env = _env(CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_lm", "--arch",
           "olmoe-1b-7b", "--batch", "1", "--prompt-len", "4", "--gen", "2"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "torch_device='cpu'" in out.stderr
    out = subprocess.run(cmd + ["--torch-device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "tok/s), sample:" in out.stdout


def test_train_cli_raises_without_cuda_unless_asked_for_the_cpu(tmp_path):
    env = _env(CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen3-0.6b", "--steps", "2", "--batch", "2", "--seq", "16",
           "--ckpt-dir", str(tmp_path / "ckpt")]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "torch_device='cpu'" in out.stderr
    assert not (tmp_path / "ckpt").exists()
    out = subprocess.run(cmd + ["--torch-device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout


def test_dryrun_cli_raises_without_cuda_unless_asked_for_the_cpu(tmp_path):
    env = _env(CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "qwen3-0.6b", "--shape", "decode_32k", "--out",
           str(tmp_path / "out")]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "torch_device='cpu'" in out.stderr
    assert not (tmp_path / "out").exists()
    out = subprocess.run(cmd + ["--torch-device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "[dryrun] qwen3-0.6b x decode_32k x 16x16" in out.stdout
    assert (tmp_path / "out" / "qwen3-0.6b__decode_32k__16x16.json").exists()


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
