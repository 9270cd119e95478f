"""The port's entry points outside ``src/`` (``examples/torch/*.py``,
``scripts/torch/*.py``) against the reference's own API calls with the same
arguments, at a small size on the CPU.

Tolerances, fixed before the files were written:
  * quickstart, 2 problems x 20 runs: the best-known energies equal, the
    gd success counts equal, the perturbation success count of each
    problem within 1 run (the schedule's ``exp`` is 1 ULP apart; the
    mismatch count is printed);
  * maxcut_demo at 16 nodes and 200 runs: the engine's and the exact cut
    equal;
  * serve_lm, reduced qwen3-0.6b and rwkv6-3b at batch 1, prompt 8, gen 4,
    the reference's weights carried across: the reference's greedy tokens;
  * train_lm ``--small``, 3 steps from the reference's initial state: the
    losses at ``tests/test_torch_train.py``'s rtol 1e-4, atol 1e-5;
  * calibrate_perturbation, two grid points at R = 20: gd's success rates
    bitwise, perturbation's success counts as in the quickstart;
  * baseline_vs_optimized, the SR table at 20 runs as in the quickstart;
    its roofline section from two record directories written by the port's
    dry-run writer, against the records' own numbers.
"""
import dataclasses
import importlib.util
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import api as r_api
from repro import configs as r_configs
from repro.core import DeviceModel as RDeviceModel
from repro.core import IsingMachine as RIsingMachine
from repro.core import PerturbationConfig as RPerturbationConfig
from repro.core import maxcut_value as r_maxcut_value
from repro.launch.serve_lm import serve as r_serve
from repro.launch.train import train as r_train
from repro.models import build as r_build
from repro.problems import problem_set as r_problem_set
from repro.solvers import best_known as r_best_known
from repro.training.steps import init_train_state as r_init_train_state
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import lm_params_from_arrays, train_state_from_arrays
from repro_torch.launch import dryrun
from repro_torch.launch import serve_lm as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.roofline import HW, model_flops, roofline_report

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
ENTRY_POINTS = ("examples/torch/quickstart.py", "examples/torch/maxcut_demo.py",
                "examples/torch/serve_lm.py", "examples/torch/train_lm.py",
                "scripts/torch/calibrate_perturbation.py",
                "scripts/torch/baseline_vs_optimized.py")


def _load(rel: str):
    """The entry point at ``rel`` as a module (its ``main`` does not run)."""
    spec = importlib.util.spec_from_file_location(
        "entry_" + Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Both packages' oracle caches in ``tmp_path``."""
    monkeypatch.setenv("REPRO_ORACLE_CACHE", str(tmp_path / "r_oracle.json"))
    monkeypatch.setenv("REPRO_TORCH_ORACLE_CACHE",
                       str(tmp_path / "oracle.json"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(threads)


def _counts(sr, runs: int) -> np.ndarray:
    return np.rint(np.asarray(sr, np.float64) * runs).astype(np.int64)


def _hold_srs(name, sr_gd, r_sr_gd, sr_pert, r_sr_pert, runs):
    """gd's success counts equal, perturbation's within 1 run a problem."""
    np.testing.assert_array_equal(_counts(sr_gd, runs),
                                  _counts(r_sr_gd, runs))
    off = np.abs(_counts(sr_pert, runs) - _counts(r_sr_pert, runs))
    print(f"{name}: perturbation success counts differ on {int((off > 0).sum())}"
          f" of {off.size} problems (at most {int(off.max())} run)")
    assert off.max() <= 1


@pytest.mark.parametrize("rel", ENTRY_POINTS)
def test_entry_point_needs_a_card_unless_given_the_cpu(rel, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load(rel).main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load(rel).main(["--torch-device", "cuda"])


def test_quickstart_matches_reference(caches):
    got = _load("examples/torch/quickstart.py").run(64, 2, 20, "cpu")
    suite = r_api.ProblemSuite.random(64, density=0.5, num_problems=2,
                                      seed=42)
    bk = r_api.best_known_energies(suite, seed=1)
    rep = r_api.solve_suite(suite, solver="engine", runs=20, seed=7,
                            oracle=False).attach_oracle(bk)
    rep_gd = r_api.solve_suite(suite, solver="engine", runs=20, seed=7,
                               oracle=False, variant="gd").attach_oracle(bk)
    np.testing.assert_array_equal(got["best_known"], bk)
    _hold_srs("quickstart", got["sr_gd"], rep_gd.success_rate(), got["sr"],
              rep.success_rate(), 20)
    assert np.isfinite(got["ratio"])


def test_maxcut_demo_matches_reference(caches):
    got = _load("examples/torch/maxcut_demo.py").run(16, 200, 64, 16, 2,
                                                     "cpu")
    p16 = r_api.Problem.maxcut(n=16, density=0.5, seed=3)
    out = r_api.solve_suite(p16, solver="engine", runs=200, seed=1,
                            oracle=False)
    exact = r_api.solve_suite(p16, solver="brute-force", oracle=False)
    assert got["small_im"] == float(r_maxcut_value(p16.meta["W"],
                                                   out.best_sigma[0]))
    assert got["small_exact"] == float(r_maxcut_value(p16.meta["W"],
                                                      exact.best_sigma[0]))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-3b"])
def test_serve_lm_gives_reference_tokens(arch, monkeypatch):
    cfg = configs.get_config(arch).reduced()
    r_params = r_build(r_configs.get_config(arch).reduced()).init(
        jax.random.PRNGKey(0))
    params = lm_params_from_arrays(jax.tree.map(np.asarray, r_params), cfg,
                                   torch_device="cpu")
    build = serve_cli.build
    monkeypatch.setattr(serve_cli, "build", lambda c: dataclasses.replace(
        build(c), init=lambda gen, dev: params))
    got = _load("examples/torch/serve_lm.py").run(arch, 1, 8, 4, "cpu")
    want = r_serve(arch, 1, 8, 4, reduced=True)
    np.testing.assert_array_equal(got["generated"],
                                  np.asarray(want["generated"]))


def test_train_lm_small_matches_reference(tmp_path, monkeypatch):
    cfg = dataclasses.replace(configs.get_config("qwen3-0.6b").reduced(),
                              dtype="float32")
    r_cfg = dataclasses.replace(r_configs.get_config("qwen3-0.6b").reduced(),
                                dtype="float32")
    a = jax.tree.map(np.asarray,
                     r_init_train_state(r_cfg, jax.random.PRNGKey(0)))
    carried = train_state_from_arrays(a.params, a.opt, a.step, cfg,
                                      torch_device="cpu")
    monkeypatch.setattr(train_cli, "init_train_state",
                        lambda c, gen, dev: carried)
    got = _load("examples/torch/train_lm.py").run(
        True, 3, str(tmp_path / "port"), "cpu")
    want = r_train("qwen3-0.6b", steps=3, batch=8, seq=128,
                   ckpt_dir=str(tmp_path / "ref"), reduced=True)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)


def test_calibrate_perturbation_matches_reference(caches):
    mod = _load("scripts/torch/calibrate_perturbation.py")
    grid = [(1.0, (48, 8), 1.0), (0.5, (96, 16), 1.0)]
    assert all(g in mod.GRID for g in grid) and len(mod.GRID) == 12
    rows = mod.run(64, 2, 20, grid, "cpu")
    ps = r_problem_set(64, 0.5, 2, seed=42)
    bk = r_best_known(ps.J, seed=1)
    for row, (drive, (period, off), settle) in zip(rows, grid):
        gd = RIsingMachine(device=RDeviceModel(
            n_spins=64, drive=drive, tau_leak_sweeps=float("inf")))
        sr_g = gd.gradient_descent_baseline().solve(
            ps.J, num_runs=20, seed=9).success_rate(bk)
        m = RIsingMachine(device=RDeviceModel(n_spins=64, drive=drive),
                          perturbation=RPerturbationConfig(
                              period_slots=period, off_slots=off,
                              settle_sweeps=settle))
        sr_p = m.solve(ps.J, num_runs=20, seed=9).success_rate(bk)
        np.testing.assert_array_equal(row["best_known"], bk)
        assert np.array_equal(row["sr_gd"], sr_g)
        _hold_srs(f"calibrate {drive} {period} {off}", row["sr_gd"], sr_g,
                  row["sr_pert"], sr_p, 20)


def _write_records(out_dir, batch: int) -> None:
    """One dry-run record of reduced qwen3-0.6b's train step at ``batch``
    on the host mesh, through the port's dry-run writer."""
    cfg = configs.get_config("qwen3-0.6b").reduced()
    shape = ShapeConfig("train_4k", 16, batch, "train")
    traced, params, trace_s = dryrun._lower(cfg, shape,
                                            make_host_mesh("cpu"))
    result = {"arch": cfg.name, "shape": shape.name, "mesh": "1x1",
              "kind": shape.kind, "trace_s": trace_s, "chips": 1,
              "memory": dryrun._memory_analysis(traced),
              "roofline": roofline_report(
                  traced.cost, HW(), chips=1,
                  model_flops_total=model_flops(cfg, shape, params))}
    dryrun._report(cfg.name, "1x1", result, str(out_dir))


def test_baseline_vs_optimized_matches_reference(caches):
    base, opt = caches / "dryrun_base", caches / "dryrun_opt"
    _write_records(base, 4)
    _write_records(opt, 2)
    out = caches / "perf_delta_torch.md"
    got = _load("scripts/torch/baseline_vs_optimized.py").run(
        20, ((32, 0.5), (64, 0.5)), str(base), str(opt), str(out), "cpu")
    assert out.read_text() == got["text"]
    for cell, (n, d) in zip(got["cells"], ((32, 0.5), (64, 0.5))):
        suite = r_api.ProblemSuite.random(n, d, 4, seed=100 + n)
        bk = r_api.best_known_energies(suite, seed=1)
        sr_p = r_api.solve_suite(suite, "engine", runs=20, seed=7,
                                 oracle=False, variant="perturbation"
                                 ).attach_oracle(bk).success_rate()
        sr_g = r_api.solve_suite(suite, "engine", runs=20, seed=7,
                                 oracle=False, variant="gd"
                                 ).attach_oracle(bk).success_rate()
        np.testing.assert_array_equal(cell["best_known"], bk)
        _hold_srs(f"baseline {n}", cell["sr_gd"], sr_g, cell["sr_pert"],
                  sr_p, 20)
    (row,) = got["roofline_rows"]
    name = os.listdir(base)[0]
    assert os.listdir(opt) == [name] == ["qwen3-0.6b__train_4k__1x1.json"]
    b = dryrun_record(base / name)
    o = dryrun_record(opt / name)
    assert row == ("qwen3-0.6b", "train_4k", "1x1",
                   b["bound_step_s"], o["bound_step_s"],
                   b["roofline_fraction"], o["roofline_fraction"])
    assert 0 < o["bound_step_s"] < b["bound_step_s"]
    assert f"| qwen3-0.6b | train_4k | 1x1 | {b['bound_step_s']:.3f} |" \
        in got["text"]


def dryrun_record(path) -> dict:
    import json
    with open(path) as f:
        return json.load(f)["roofline"]
