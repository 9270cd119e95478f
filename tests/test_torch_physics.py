"""repro_torch.physics against repro.physics, on the CPU — the mirror of
``tests/test_physics.py`` plus the port's own rungs.

Tolerances:
  * bitwise: the discrete limit against the port's own scan path
    (``core.annealer.anneal``), variation draws across processes and as
    the fleet grows, noise streams as the fleet grows, the float64 host
    energies;
  * against the reference (same numpy inputs; the reference's chip draws
    carried by ``convert.chip_variation_from_arrays``): identical spins and
    energies, the mismatch count reported as 0, and |dv| within about three
    times the largest difference read at these inputs (the port's ``exp``
    and division differ from XLA's by an ULP): <= 5e-7 for the discrete
    limit (1.64e-7 read, under perturbation) and <= 1.5e-6 for the varied
    fleet (5.4e-7 read, tanh ADC);
  * statistical: the port's own variation draws (mean and spread of each
    parameter), since they come from ``rng`` and not ``jax.random``.
"""
import dataclasses
import hashlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro_torch
from repro.api import ProblemSuite as RProblemSuite
from repro.core.annealer import anneal as r_anneal
from repro.core.device_model import DeviceModel as RDeviceModel
from repro.core.lfsr import lfsr_voltage_inits
from repro.core.perturbation import DEFAULT_PERTURBATION as R_PERT
from repro.core.perturbation import NOMINAL as R_NOMINAL
from repro.core.perturbation import scales_from_cols as r_scales_from_cols
from repro.physics import DEFAULT_PHYSICS as R_DEFAULT_PHYSICS
from repro.physics import DISCRETE_LIMIT as R_DISCRETE_LIMIT
from repro.physics import PhysicsParams as RPhysicsParams
from repro.physics import VariationModel as RVariationModel
from repro.physics import fleet_anneal as r_fleet_anneal
from repro_torch import convert
from repro_torch.api import ProblemSuite, get_solver
from repro_torch.core.annealer import anneal
from repro_torch.core.device_model import DeviceModel
from repro_torch.core.engine import AnnealEngine
from repro_torch.core.perturbation import (DEFAULT_PERTURBATION, NOMINAL,
                                           column_scales, scales_from_cols,
                                           unit_scales)
from repro_torch.physics import (DEFAULT_PHYSICS, DISCRETE_LIMIT,
                                 ChipVariation, PhysicsParams,
                                 VariationModel, dispatch_count, fingerprint,
                                 fleet_anneal, reset_dispatch_count)

SRC_DIR = repro_torch.__path__[0].rsplit("/repro_torch", 1)[0]
CPU = "cpu"

#: quick device: 2 Euler substeps per slot keeps every loop here short
DEV = dataclasses.replace(DeviceModel(), substeps=2)
RDEV = dataclasses.replace(RDeviceModel(), substeps=2)
VARIED = VariationModel(j_mismatch_sigma=0.1, tau_leak_spread=0.2,
                        refresh_jitter_slots=3, sigma_gain_spread=0.05)
R_VARIED = RVariationModel(**dataclasses.asdict(VARIED))
PERTS = {"pert": (DEFAULT_PERTURBATION, R_PERT),
         "nominal": (NOMINAL, R_NOMINAL)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _instance(n=16, seed=0, problems=1):
    """Quantized level-space couplings + the engine's v0 streams (numpy)."""
    suite = ProblemSuite.random(n, 0.5, problems, seed=seed)
    J = suite.buckets(n)[0].J
    v0 = np.stack([lfsr_voltage_inits(n, 4, seed=1 + 7919 * p, vdd=DEV.vdd,
                                      swing=DEV.init_swing)
                   for p in range(J.shape[0])])
    return np.asarray(J, np.float32), v0.astype(np.float32)


def _fleet(J, v0, dev=DEV, pert=DEFAULT_PERTURBATION, **kw):
    return fleet_anneal(J, v0, dev, pert, torch_device=CPU, **kw)


# -- variation-model determinism ----------------------------------------------

def test_zero_variation_samples_the_nominal_chip_exactly():
    chips = VariationModel().sample(3, 4, 8)
    assert torch.equal(chips.j_gain, torch.ones(4, 8, 8))
    assert torch.equal(chips.tau_scale, torch.ones(4))
    assert torch.equal(chips.slot_offset, torch.zeros(4, dtype=torch.int32))
    assert torch.equal(chips.gain_scale, torch.ones(4))
    assert VariationModel().is_zero and not VARIED.is_zero


def test_chip_draws_are_prefix_stable_and_indexable():
    full = VARIED.sample(5, 8, 12)
    head = VARIED.sample(5, 4, 12)
    tail = VARIED.sample(5, 4, 12, chip0=4)
    # growing the fleet never reshuffles existing chips...
    assert fingerprint(head) == fingerprint(
        ChipVariation(j_gain=full.j_gain[:4], tau_scale=full.tau_scale[:4],
                      slot_offset=full.slot_offset[:4],
                      gain_scale=full.gain_scale[:4]))
    # ...and chip index, not array position, owns the stream
    assert torch.equal(tail.j_gain, full.j_gain[4:])
    assert fingerprint(ChipVariation.concat([head, tail])) == \
        fingerprint(full)
    # independent streams: no two chips share a draw
    for a in range(8):
        for b in range(a + 1, 8):
            assert not torch.equal(full.j_gain[a], full.j_gain[b])
    # different seeds -> different fleets
    assert fingerprint(full) != fingerprint(VARIED.sample(6, 8, 12))


def test_variation_draw_statistics():
    chips = VARIED.sample(0, 64, 32)
    jg = chips.j_gain.numpy()
    assert abs(jg.mean() - 1.0) < 0.005 and abs(jg.std() - 0.1) < 0.005
    lt = np.log(chips.tau_scale.numpy())
    assert abs(lt.mean()) < 0.1 and 0.1 < lt.std() < 0.3
    off = chips.slot_offset.numpy()
    assert off.dtype == np.int32 and set(off.tolist()) <= set(range(-3, 4))
    assert len(set(off.tolist())) >= 5
    lg = np.log(chips.gain_scale.numpy())
    assert 0.02 < lg.std() < 0.08


_FP_SCRIPT = """\
import sys
sys.path.insert(0, {src!r})
from repro_torch.physics import VariationModel, fingerprint
vm = VariationModel(j_mismatch_sigma=0.1, tau_leak_spread=0.2,
                    refresh_jitter_slots=3, sigma_gain_spread=0.05)
print(fingerprint(vm.sample(5, 8, 12)))
"""

_SOLVE_SCRIPT = """\
import sys
sys.path.insert(0, {src!r})
import hashlib
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.api import ProblemSuite, get_solver
from repro_torch.physics import VariationModel
suite = ProblemSuite.random(12, 0.5, 2, seed=3)
s = get_solver("ode-jax", n_chips=3, torch_device="cpu",
               variation=VariationModel(j_mismatch_sigma=0.1))
rep = s.solve(suite, runs=2, seed=1, block=16)
e = np.concatenate([np.asarray(x, np.float64) for x in rep.energies])
print(hashlib.sha256(e.tobytes()).hexdigest())
"""


def _run_script(template: str) -> str:
    out = subprocess.run(
        [sys.executable, "-c", template.format(src=SRC_DIR)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_variation_draws_bit_identical_across_processes():
    local = fingerprint(VARIED.sample(5, 8, 12))
    assert _run_script(_FP_SCRIPT) == local


def test_solve_report_energies_bit_identical_across_processes():
    suite = ProblemSuite.random(12, 0.5, 2, seed=3)
    s = get_solver("ode-jax", n_chips=3, torch_device=CPU,
                   variation=VariationModel(j_mismatch_sigma=0.1))
    rep = s.solve(suite, runs=2, seed=1, block=16)
    e = np.concatenate([np.asarray(x, np.float64) for x in rep.energies])
    local = hashlib.sha256(e.tobytes()).hexdigest()
    assert _run_script(_SOLVE_SCRIPT) == local


# -- per-chip noise streams ---------------------------------------------------

def test_noise_streams_stable_as_fleet_grows():
    J, v0 = _instance()
    # two Euler steps: early-trajectory voltages, BEFORE the clipped
    # dynamics pin every chip to the rails
    dev = dataclasses.replace(DEV, anneal_sweeps=1.0 / 64)
    params = PhysicsParams(noise_sigma=0.2)
    vm = VariationModel(j_mismatch_sigma=0.05)
    small = _fleet(J, v0, dev, params=params, chips=vm.sample(9, 2, 16),
                   key=11)
    big = _fleet(J, v0, dev, params=params, chips=vm.sample(9, 5, 16),
                 key=11)
    # chip c's noise depends only on (key, step, c)
    assert torch.equal(small.v_final, big.v_final[:2])
    assert torch.equal(small.sigma, big.sigma[:2])
    for a in range(5):
        for b in range(a + 1, 5):
            assert not torch.equal(big.v_final[a], big.v_final[b])
    # the noise moves the trajectory, and another key moves it elsewhere
    quiet = _fleet(J, v0, dev, params=PhysicsParams(),
                   chips=vm.sample(9, 2, 16))
    other = _fleet(J, v0, dev, params=params, chips=vm.sample(9, 2, 16),
                   key=12)
    assert not torch.equal(quiet.v_final, small.v_final)
    assert not torch.equal(other.v_final, small.v_final)


def test_noise_without_key_is_rejected():
    J, v0 = _instance()
    with pytest.raises(ValueError, match="PRNG key"):
        _fleet(J, v0, params=PhysicsParams(noise_sigma=0.1))


def test_fleet_sampled_at_wrong_width_is_rejected():
    J, v0 = _instance(n=16)
    with pytest.raises(ValueError, match="PADDED"):
        _fleet(J, v0, chips=VARIED.sample(0, 2, 12))


def test_physics_params_validate():
    with pytest.raises(ValueError, match="integrator"):
        PhysicsParams(integrator="rk4")
    with pytest.raises(ValueError, match="gain"):
        PhysicsParams(gain=0.0)
    with pytest.raises(ValueError, match="nonnegative"):
        PhysicsParams(noise_sigma=-1.0)
    with pytest.raises(ValueError, match="nonnegative"):
        VariationModel(j_mismatch_sigma=-0.1)


# -- discrete-limit parity ----------------------------------------------------

LIMIT_CASES = [("pert", 10.0),          # perturbation + leakage schedule
               ("nominal", 10.0),       # leakage-only schedule
               ("nominal", float("inf"))]   # unit schedule (pure GD)


@pytest.mark.parametrize("pert,tau", LIMIT_CASES)
def test_discrete_limit_is_bitwise_identical_to_engine(pert, tau):
    """The port's scan path is the discrete engine here: bitwise."""
    dev = dataclasses.replace(DEV, tau_leak_sweeps=tau)
    tpert = PERTS[pert][0]
    J, v0 = _instance(problems=2)
    ref = anneal(torch.as_tensor(J), torch.as_tensor(v0), dev, tpert)
    ode = _fleet(J, v0, dev, tpert, params=DISCRETE_LIMIT)
    assert ode.sigma.shape[0] == 1             # trivial fleet: one chip
    assert torch.equal(ode.v_final[0], ref.v_final)
    assert torch.equal(ode.sigma[0], ref.sigma)
    assert torch.equal(ode.energy[0], ref.energy)


#: |dv| bounds against the reference, about 3x the largest reading
LIMIT_DV = 5e-7          # discrete limit: 1.64e-7 read (perturbation)
VARIED_DV = 1.5e-6       # varied fleet: 5.4e-7 read (tanh ADC)


def _hold_to_reference(ode, ref, dv_max):
    """Identical spins and energies (0 mismatches), |dv| <= ``dv_max``."""
    v, rv = ode.v_final.numpy(), np.asarray(ref.v_final).reshape(
        ode.v_final.shape)
    mismatches = int((ode.sigma.numpy() !=
                      np.asarray(ref.sigma).reshape(v.shape)).sum())
    dv = float(np.abs(v - rv).max())
    assert mismatches == 0, f"{mismatches} spins differ (|dv| {dv:.3g})"
    assert np.array_equal(ode.energy.numpy(),
                          np.asarray(ref.energy).reshape(
                              ode.energy.shape))
    assert dv <= dv_max, dv


@pytest.mark.parametrize("pert,tau", LIMIT_CASES)
def test_discrete_limit_matches_the_reference_engine(pert, tau):
    dev = dataclasses.replace(DEV, tau_leak_sweeps=tau)
    rdev = dataclasses.replace(RDEV, tau_leak_sweeps=tau)
    tpert, rpert = PERTS[pert]
    J, v0 = _instance(problems=2)
    ref = r_anneal(J, v0, rdev, rpert)
    _hold_to_reference(_fleet(J, v0, dev, tpert, params=DISCRETE_LIMIT),
                       ref, LIMIT_DV)


def _reference_chips(vm: RVariationModel, seed, n_chips, n):
    c = vm.sample(seed, n_chips, n)
    return c, convert.chip_variation_from_arrays(
        np.asarray(c.j_gain), np.asarray(c.tau_scale),
        np.asarray(c.slot_offset), np.asarray(c.gain_scale))


@pytest.mark.parametrize("params", ["limit", "default", "heun"])
@pytest.mark.parametrize("pert", ["pert", "nominal"])
def test_varied_fleet_matches_the_reference(params, pert):
    """The reference's chip draws injected: the varied branch (per-chip J
    gains, leakage spread, refresh jitter, gain spread) against
    ``repro.physics.fleet_anneal``."""
    tp, rp = {"limit": (DISCRETE_LIMIT, R_DISCRETE_LIMIT),
              "default": (DEFAULT_PHYSICS, R_DEFAULT_PHYSICS),
              "heun": (PhysicsParams(integrator="heun", tau_rc_sweeps=4.0),
                       RPhysicsParams(integrator="heun",
                                      tau_rc_sweeps=4.0))}[params]
    tpert, rpert = PERTS[pert]
    J, v0 = _instance(problems=2)
    rchips, tchips = _reference_chips(R_VARIED, 5, 3, 16)
    ref = r_fleet_anneal(J, v0, RDEV, rpert, params=rp, chips=rchips)
    _hold_to_reference(_fleet(J, v0, DEV, tpert, params=tp, chips=tchips),
                       ref, VARIED_DV)


def test_scales_overrides_match_the_reference():
    chips = R_VARIED.sample(2, 6, 16)
    tau = np.asarray(chips.tau_scale)[:, None] * DEV.tau_leak_sweeps
    off = np.asarray(chips.slot_offset)[:, None]
    for pert, rpert in PERTS.values():
        for t in (0, 7, 200, DEV.n_steps - 1):
            a = scales_from_cols(t, torch.arange(16)[None], DEV, pert,
                                 tau_leak_sweeps=torch.tensor(tau),
                                 slot_offset=torch.tensor(off)).numpy()
            b = np.asarray(r_scales_from_cols(
                t, jax.numpy.arange(16)[None], RDEV, rpert,
                tau_leak_sweeps=tau, slot_offset=off))
            assert np.array_equal(a == 0, b == 0)
            assert np.max(np.abs(a - b)) <= 2 * np.spacing(np.float32(1))
    # both overrides None: the nominal op sequence, bitwise
    assert torch.equal(scales_from_cols(9, torch.arange(16), DEV,
                                        DEFAULT_PERTURBATION),
                       column_scales(9, DEV, DEFAULT_PERTURBATION, 16))


def test_soft_physics_departs_from_the_discrete_engine():
    # the parity test would pass vacuously if DEFAULT_PHYSICS were secretly
    # the discrete limit
    J, v0 = _instance()
    dev = dataclasses.replace(DEV, anneal_sweeps=1.0 / 64)
    ref = anneal(torch.as_tensor(J), torch.as_tensor(v0), dev,
                 DEFAULT_PERTURBATION)
    ode = _fleet(J, v0, dev)
    assert not torch.equal(ode.v_final[0], ref.v_final)


# -- dispatch accounting ------------------------------------------------------

def test_one_dispatch_per_pad_bucket_through_the_registry():
    suite = ProblemSuite.random(12, 0.5, 2, seed=4) \
        + ProblemSuite.random(40, 0.5, 1, seed=5)
    solver = get_solver("ode-jax", n_chips=4, torch_device=CPU,
                        variation=VariationModel(j_mismatch_sigma=0.1))
    reset_dispatch_count()
    rep = solver.solve(suite, runs=2, seed=1, budget=0.25)
    assert dispatch_count() == suite.num_dispatches()
    assert rep.dispatches == suite.num_dispatches()
    # chip-major rows: runs * n_chips energies per problem, native-N spins
    assert rep.runs == 2 * 4
    assert [np.asarray(e).shape for e in rep.energies] == [(8,)] * 3
    assert [np.asarray(s).shape for s in rep.best_sigma] == \
        [(12,), (12,), (40,)]
    # the reported energies are float64 host recomputes: the best energy
    # must match an exact recompute from the best spins (integer-exact)
    for p, e, sg in zip(suite.problems, rep.energies, rep.best_sigma):
        s64 = np.asarray(sg, np.float64)
        J64 = np.asarray(p.J_levels, np.float64)
        assert float(np.min(e)) == -0.5 * s64 @ J64 @ s64


def test_registry_solve_matches_the_reference_solver():
    """ode-jax through both registries, nominal fleet (no draws): the same
    chip-major energies. The port's suite is carried from the reference's."""
    from repro.api import get_solver as r_get_solver
    rsuite = RProblemSuite.random(12, 0.5, 2, seed=8)
    suite = convert.suite_from_arrays(
        [p.levels for p in rsuite.problems],
        scales=[p.scale for p in rsuite.problems])
    kw = dict(runs=4, seed=2, budget=0.25)
    a = get_solver("ode-jax", variant="gd", torch_device=CPU).solve(suite,
                                                                    **kw)
    b = r_get_solver("ode-jax", variant="gd").solve(rsuite, **kw)
    for x, y in zip(a.energies, b.energies):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert a.meta["physics"] == b.meta["physics"]


# -- the shared leakage predicate (has_leakage call sites) --------------------

def test_has_leakage_pins_all_three_call_sites():
    leak = dataclasses.replace(DEV, tau_leak_sweeps=10.0)
    ideal = dataclasses.replace(DEV, tau_leak_sweeps=float("inf"))
    frozen = dataclasses.replace(DEV, tau_leak_sweeps=0.0)
    assert leak.has_leakage
    assert not ideal.has_leakage and not frozen.has_leakage

    # call site 1: the schedule — no leakage means NO decay anywhere
    t = leak.slots_per_sweep * leak.substeps * 2      # two sweeps in
    assert torch.all(column_scales(t, ideal, NOMINAL) == 1.0)
    assert torch.all(column_scales(t, frozen, NOMINAL) == 1.0)
    assert torch.any(column_scales(t, leak, NOMINAL) < 1.0)

    # call site 2: the integer fast-path gate
    assert unit_scales(ideal, NOMINAL)
    assert not unit_scales(leak, NOMINAL)
    assert not unit_scales(ideal, DEFAULT_PERTURBATION)

    # call site 3: the autotune cache key's schedule kind
    def sched(dev, pert):
        k = AnnealEngine(device=dev, perturbation=pert,
                         torch_device=CPU)._key(1, 1, 16, "f32")
        return k.split("sched=")[1].split("|")[0]
    assert sched(ideal, NOMINAL) == "unit"
    assert sched(leak, NOMINAL) == "leak"
    assert sched(leak, DEFAULT_PERTURBATION) == "pert"


# -- the physics tier as a serve fallback rung --------------------------------

def test_ode_jax_rescues_a_dead_primary_in_the_fallback_chain():
    import time

    from repro_torch.serve import FlushExecutor, ResiliencePolicy
    from repro_torch.serve.service import ServeTicket, _Request

    class _Dead:
        def solve(self, *a, **k):
            raise RuntimeError("primary down")

    ex = FlushExecutor(
        ResiliencePolicy(max_retries=0, fallback=("ode-jax",)),
        primary=lambda: _Dead(), solver_name="dead", runs=2, seed=5,
        block=16, torch_device=CPU)
    probs = [ProblemSuite.random(12, 0.5, 1, seed=100 + i).problems[0]
             for i in range(2)]
    reqs = [_Request(problem=p, budget=None, deadline_s=None,
                     submitted=time.monotonic(), ticket=ServeTicket())
            for p in probs]
    outcomes, partials, _ = ex.execute(reqs)
    assert all(o.ok and o.degraded and o.solver == "ode-jax"
               for o in outcomes)
    assert ex.fallback_solves == 2
