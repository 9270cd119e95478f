"""The reference's frozen copies (LFSR, column schedule, Threefry inits,
c0 / Jc, the ordered SB sum) bitwise against the port's plain versions
at small sizes, and the reference's anneal against the port's scan path.
The test imports both; the reference imports neither."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import cardbench_util  # noqa: F401  (paths)
from cardbench.harness import problems as gen
from cardbench.reference import anneal as ra, sb as rs
from repro_torch.core import lfsr
from repro_torch.core.device_model import DeviceModel
from repro_torch.core.perturbation import (DEFAULT_PERTURBATION, NOMINAL,
                                           scales_from_cols)
from repro_torch.kernels import sb_kernel
from repro_torch.problems.gset import random_gset
from repro_torch.problems.random_qubo import problem_set
from repro_torch.solvers import sb_jax

CHIP = {"vdd": 1.0, "cols_per_tile": 64, "substeps": 8,
        "anneal_sweeps": 3.75, "drive": 1.0, "tau_leak_sweeps": 10.0,
        "init_swing": 0.5}
PERT = {"period_slots": 48, "off_slots": 8, "settle_sweeps": 1.0,
        "leak": True}
GD = {"period_slots": 48, "off_slots": 0, "settle_sweeps": 1.0,
      "leak": False}
SEEDS = [0, 5, 2**31 + 77, 2**33 + 1]


@pytest.mark.parametrize("n", [16, 64, 130])
def test_lfsr_voltages_bitwise(n):
    got = ra.lfsr_voltages(n, 40, SEEDS, 1.0, 0.5)
    want = np.stack([lfsr.lfsr_voltage_inits(n, 40, seed=s, vdd=1.0,
                                             swing=0.5) for s in SEEDS])
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("variant", ["perturbation", "gd"])
@pytest.mark.parametrize("n", [64, 100])
def test_schedule_bitwise(variant, n):
    dev, pert = DeviceModel(), DEFAULT_PERTURBATION
    if variant == "gd":
        dev = DeviceModel(tau_leak_sweeps=float("inf"))
        pert = NOMINAL
    got = ra.schedule(CHIP, PERT if variant == "perturbation" else GD, n,
                      "cpu")
    steps = torch.arange(dev.n_steps)[:, None]
    want = scales_from_cols(steps, torch.arange(n)[None, :], dev, pert)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_true", [130, 100])
def test_threefry_inits_bitwise(n_true):
    x0, y0 = sb_jax.sb_inits(2, 8, 192, n_true=[192, n_true],
                             seed=2**31 + 5, torch_device="cpu")
    x, y = rs.inits(2**31 + 5, 1, 8, 192, n_true, "cpu")
    assert torch.equal(x, x0[1]) and torch.equal(y, y0[1])


def test_coupling_scale_bitwise():
    W = random_gset(150, seed=3, degree=4.0)
    J = -W.astype(np.float32)
    want = sb_jax.sb_scaled_couplings(J[None], [150])[0]
    assert np.array_equal(rs.scaled(J, 150), want)


@pytest.mark.parametrize("variant", ["aSB", "bSB", "dSB"])
def test_ordered_sb_bitwise(variant):
    J, = gen.make_problems({"family": "gset_uniform", "n": 60,
                            "degree": 6.0, "max_w": 1}, {"problems": 1}, 4)
    Jc = rs.scaled(J, 60)
    x0, y0 = rs.inits(9, 0, 16, 64, 60, "cpu")
    got = rs.integrate(Jc, x0[:, :60], y0[:, :60], variant=variant,
                       n_steps=60, dt=0.5, a0=1.0)
    want = sb_kernel.sb_reference(torch.as_tensor(Jc)[None],
                                  x0[None, :, :60], y0[None, :, :60],
                                  variant=variant, n_steps=60)[0]
    assert torch.equal(got, want)


def test_generators_match_the_programs():
    ps = problem_set(64, 0.5, 3, 2**31 + 9)
    cfg = {"family": "random_ising", "n": 64, "density": 0.5,
           "max_level": 15}
    got = gen.make_problems(cfg, {"problems": 3}, 2**31 + 9)
    assert all(np.array_equal(g, w) for g, w in zip(got, ps.J))
    cfg = {"family": "gset_uniform", "n": 300, "degree": 6.0, "max_w": 1}
    got = gen.make_problems(cfg, {"problems": 1}, 11)[0]
    assert np.array_equal(got, -random_gset(300, seed=11, degree=6.0))


def test_reference_anneal_matches_the_scan_path_on_the_cpu():
    from repro_torch.core.annealer import anneal
    J = torch.as_tensor(np.stack(problem_set(64, 0.5, 2, 7).J))
    v0 = torch.as_tensor(ra.lfsr_voltages(64, 32, [3, 4], 1.0, 0.5))
    want = anneal(J, v0, DeviceModel(), DEFAULT_PERTURBATION).sigma
    assert torch.equal(ra.anneal(J, v0, CHIP, PERT), want)


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0e-5])
    r = ra.tf32_round(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10
    assert r[2] == 1.0 + 2**-9
    assert (r.view(torch.int32) & 0x1FFF == 0).all()
    assert abs(float(r[3]) - -3.0e-5) <= 2**-11 * 3.0e-5
