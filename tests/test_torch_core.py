"""The port's core modules against the JAX package's, on the CPU.

Same numpy inputs through ``repro`` and ``repro_torch`` (torch_device="cpu").
Tolerances, fixed before the port was written:
  * bitwise: LFSR inits, the unit-schedule ``schedule_table``, energies on
    integer J, and the scan anneal's ``v_final`` on the unit schedule (f32
    and bf16) — every sum there is integer-exact;
  * the schedule under leakage / perturbation: <= 2 ULP of 1.0 with an
    identical zero pattern (XLA turns ``x / 640`` into a reciprocal multiply
    and its ``exp`` differs from torch's by an ULP);
  * the scan anneal under DEFAULT_PERTURBATION: <= 1% of spins differ, and
    |dv| <= 1e-5 over runs whose final spins all agree;
  * the noise path: exact when the port is handed the reference's per-step
    normals (regenerated here with ``jax.random.split`` as ``anneal`` does),
    against the reference's formula evaluated op by op; see the test for
    the ULP by which XLA's fused code departs from that formula.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import annealer as r_annealer
from repro.core import hamiltonian as r_ham
from repro.core import lfsr as r_lfsr
from repro.core import perturbation as r_pert
from repro.core.device_model import DeviceModel as RDeviceModel
from repro.core.engine import AnnealEngine as RAnnealEngine
from repro_torch.convert import (device_model_from_fields,
                                 perturbation_from_fields)
from repro_torch.core import annealer as t_annealer
from repro_torch.core import hamiltonian as t_ham
from repro_torch.core import lfsr as t_lfsr
from repro_torch.core import perturbation as t_pert
from repro_torch.core.binarize import sign_pm1
from repro_torch.core.engine import AnnealEngine
from repro_torch.kernels import ising_anneal as ka
from repro_torch.kernels.ising_anneal import (KERNEL_DESIGN,
                                              anneal_block_r_candidates)
from repro_torch.core.machine import IsingMachine

ULP1 = float(np.finfo(np.float32).eps)      # one ULP of 1.0
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU matmuls run faster on one thread than on a pool that also
    competes with XLA's; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dev_kw=None, pert=None):
    """The same device model and schedule in both packages."""
    rdev = RDeviceModel(**(dev_kw or {}))
    rpert = pert if pert is not None else r_pert.DEFAULT_PERTURBATION
    return (rdev, rpert,
            device_model_from_fields(dataclasses.asdict(rdev)),
            perturbation_from_fields(dataclasses.asdict(rpert)))


def _inputs(n, p, r, seed=0, density=0.5):
    rng = np.random.default_rng(seed)
    J = np.zeros((p, n, n), np.float32)
    for k in range(p):
        iu = np.triu_indices(n, 1)
        w = np.where(rng.random(len(iu[0])) < density,
                     rng.integers(1, 16, len(iu[0])) *
                     rng.choice([-1, 1], len(iu[0])), 0)
        J[k][iu] = w
        J[k] = J[k] + J[k].T
    v0 = np.stack([r_lfsr.lfsr_voltage_inits(n, r, seed=seed + 3 * k)
                   for k in range(p)]).astype(np.float32)
    return J, v0


def _spin_stats(v_port, v_ref, thr=0.5):
    sp, sr = v_port >= thr, v_ref >= thr
    run_same = (sp == sr).all(axis=-1)
    frac = float((sp != sr).mean())
    dv = np.abs(v_port - v_ref)[run_same]
    return frac, float(dv.max()) if dv.size else 0.0


# -- numpy copies --------------------------------------------------------

@pytest.mark.parametrize("n,runs,seed", [(16, 32, 0x5EED), (64, 40, 7),
                                         (130, 8, 123)])
def test_lfsr_inits_bitwise(n, runs, seed):
    a = r_lfsr.lfsr_voltage_inits(n, runs, seed=seed, swing=0.5)
    b = t_lfsr.lfsr_voltage_inits(n, runs, seed=seed, swing=0.5)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(r_lfsr.lfsr64_states(seed, runs),
                          t_lfsr.lfsr64_states(seed, runs))


def test_qubo_and_field_maps_match():
    rng = np.random.default_rng(3)
    Q = rng.integers(-5, 6, (7, 7)).astype(float)
    for a, b in zip(r_ham.qubo_to_ising(Q), t_ham.qubo_to_ising(Q)):
        assert np.array_equal(a, b)
    W = np.abs(Q + Q.T)
    assert np.array_equal(r_ham.maxcut_to_ising(W), t_ham.maxcut_to_ising(W))
    h = rng.standard_normal(7)
    assert np.array_equal(r_ham.absorb_fields(Q, h),
                          t_ham.absorb_fields(Q, h))


# -- device model / ADC / energies ---------------------------------------

def test_quantize_and_adc_match():
    rng = np.random.default_rng(1)
    J = (rng.standard_normal((3, 12, 12)) * 4).astype(np.float32)
    J[1] = 0.0                                  # all-zero problem: scale 1
    rdev, _, tdev, _ = _pair()
    a = np.asarray(rdev.quantize(jnp.asarray(J)))
    b = tdev.quantize(torch.as_tensor(J)).numpy()
    assert np.array_equal(a, b)
    v = np.array([0.0, 0.5, np.nextafter(np.float32(0.5), np.float32(0)),
                  1.0], np.float32)
    assert np.array_equal(np.asarray(rdev.adc(jnp.asarray(v))),
                          tdev.adc(torch.as_tensor(v)).numpy())
    assert sign_pm1(torch.as_tensor(v), 0.5, torch.int8).tolist() == \
        [-1, 1, -1, 1]


def test_energies_exact_on_integer_j():
    J, _ = _inputs(20, 3, 1, seed=5)
    s = np.random.default_rng(2).choice([-1.0, 1.0], (3, 9, 20)) \
        .astype(np.float32)
    Jt, st = torch.as_tensor(J), torch.as_tensor(s)
    assert np.array_equal(np.asarray(r_ham.ising_energy(jnp.asarray(J), s)),
                          t_ham.ising_energy(Jt, st).numpy())
    assert np.array_equal(np.asarray(r_ham.local_field(jnp.asarray(J), s)),
                          t_ham.local_field(Jt, st).numpy())
    assert np.array_equal(
        np.asarray(r_ham.flip_deltas(jnp.asarray(J), jnp.asarray(s))),
        t_ham.flip_deltas(Jt, st).numpy())


# -- schedule ------------------------------------------------------------

def test_schedule_table_unit_bitwise():
    rdev, rpert, tdev, tpert = _pair({"tau_leak_sweeps": float("inf")},
                                     r_pert.NOMINAL)
    a = np.asarray(r_pert.schedule_table(rdev, rpert, n_cols=24))
    b = t_pert.schedule_table(tdev, tpert, n_cols=24).numpy()
    assert a.shape == b.shape and np.array_equal(a, b)
    assert r_pert.unit_scales(rdev, rpert) and t_pert.unit_scales(tdev, tpert)


@pytest.mark.parametrize("pert", [
    r_pert.NOMINAL, r_pert.DEFAULT_PERTURBATION,
    r_pert.PerturbationConfig(period_slots=24, off_slots=5,
                              settle_sweeps=0.5)])
@pytest.mark.parametrize("tau", [10.0, 2.5, float("inf")])
def test_schedule_table_within_2ulp(pert, tau):
    # 100 columns: ids >= 64 wrap onto the 64-column refresh pointer
    rdev, rpert, tdev, tpert = _pair({"tau_leak_sweeps": tau}, pert)
    a = np.asarray(r_pert.schedule_table(rdev, rpert, n_cols=100))
    b = t_pert.schedule_table(tdev, tpert, n_cols=100).numpy()
    assert a.shape == b.shape == (rdev.n_steps, 100)
    assert np.array_equal(a == 0, b == 0)
    assert np.abs(a - b).max() <= 2 * ULP1


def test_scales_from_cols_floor_mod_pointwise():
    """Steps before the first refresh pass (slot - j < 0) and the pre-load
    pass (last_sel < 0) are where a truncating modulo would go wrong."""
    rdev, rpert, tdev, tpert = _pair()
    cols = np.arange(70, dtype=np.int32)
    for step in (0, 1, 7, 8, 63, 64 * 8 - 1, 64 * 8, 1000, 1919):
        a = np.asarray(r_pert.scales_from_cols(step, jnp.asarray(cols), rdev,
                                               rpert))
        b = t_pert.scales_from_cols(step, torch.as_tensor(cols), tdev,
                                    tpert).numpy()
        assert np.array_equal(a == 0, b == 0), step
        assert np.abs(a - b).max() <= 2 * ULP1, step


# -- scan anneal ---------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,p,r", [(16, 2, 24), (21, 1, 32)])
def test_scan_anneal_unit_schedule_bitwise(compute_dtype, n, p, r):
    rdev, rpert, tdev, tpert = _pair(
        {"n_spins": n, "anneal_sweeps": 0.5, "tau_leak_sweeps": float("inf"),
         "compute_dtype": compute_dtype}, r_pert.NOMINAL)
    J, v0 = _inputs(n, p, r, seed=n)
    ref = r_annealer.anneal(jnp.asarray(J), jnp.asarray(v0), rdev, rpert)
    out = t_annealer.anneal(torch.as_tensor(J), torch.as_tensor(v0), tdev,
                            tpert)
    assert np.array_equal(np.asarray(ref.v_final), out.v_final.numpy())
    assert np.array_equal(np.asarray(ref.energy), out.energy.numpy())
    assert np.array_equal(np.asarray(ref.sigma), out.sigma.numpy())


@pytest.mark.parametrize("n,p,r,seed", [(16, 2, 32, 0), (24, 2, 32, 1)])
def test_scan_anneal_perturbation_within_tolerance(n, p, r, seed):
    rdev, rpert, tdev, tpert = _pair({"n_spins": n, "anneal_sweeps": 1.5})
    J, v0 = _inputs(n, p, r, seed=seed)
    ref = r_annealer.anneal(jnp.asarray(J), jnp.asarray(v0), rdev, rpert)
    out = t_annealer.anneal(torch.as_tensor(J), torch.as_tensor(v0), tdev,
                            tpert)
    frac, dv = _spin_stats(out.v_final.numpy(), np.asarray(ref.v_final))
    assert frac <= 0.01, f"{frac:.4f} of spins differ"
    assert dv <= 1e-5, dv


def _reference_normals(key, n_steps, shape):
    """The per-step normals ``repro.core.annealer.anneal`` draws: split the
    carried key, draw from the subkey."""
    def body(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.normal(sub, shape, jnp.float32)
    return np.asarray(jax.lax.scan(body, key, None, length=n_steps)[1])


def test_noise_path_exact_with_injected_normals():
    """Handed the reference's per-step normals, the port is bitwise equal
    to the reference's formula evaluated op by op in float32 (numpy). The
    compiled reference itself may differ by an ULP per step: XLA fuses the
    normal's last multiply, the sigma*dt scale and the add into one loop
    and contracts them into an FMA. Against it: identical spins, and |dv|
    within the perturbation tolerance."""
    rdev, rpert, tdev, tpert = _pair(
        {"n_spins": 12, "anneal_sweeps": 0.25, "tau_leak_sweeps": float("inf"),
         "noise_sigma": 2.0}, r_pert.NOMINAL)
    J, v0 = _inputs(12, 2, 16, seed=9)
    key = jax.random.PRNGKey(17)
    z = _reference_normals(key, rdev.n_steps, v0.shape)
    out = t_annealer.anneal(torch.as_tensor(J), torch.as_tensor(v0), tdev,
                            tpert, noise=torch.as_tensor(z))

    v = v0.copy()
    c = np.float32(rdev.noise_sigma * rdev.dt)
    dd = np.float32(rdev.drive_eff * rdev.dt)
    for t in range(rdev.n_steps):
        sq = np.where(v >= rdev.threshold, 1, -1).astype(np.float32) * dd
        dv = np.einsum("pij,prj->pri", J, sq).astype(np.float32)
        v = np.clip(v + (dv + c * z[t]), 0, rdev.vdd).astype(np.float32)
    assert np.array_equal(v, out.v_final.numpy())

    ref = r_annealer.anneal(jnp.asarray(J), jnp.asarray(v0), rdev, rpert,
                            key=key)
    frac, dv = _spin_stats(out.v_final.numpy(), np.asarray(ref.v_final))
    assert frac == 0.0 and dv <= 1e-5, (frac, dv)
    # and the noise really moved the anneal
    quiet = t_annealer.anneal(torch.as_tensor(J), torch.as_tensor(v0), tdev,
                              tpert)
    assert not torch.equal(quiet.v_final, out.v_final)


def test_noise_generator_is_seeded_and_shape_checked():
    _, _, tdev, tpert = _pair({"n_spins": 8, "anneal_sweeps": 0.125,
                               "noise_sigma": 2.0}, r_pert.NOMINAL)
    J, v0 = (torch.as_tensor(x) for x in _inputs(8, 1, 4, seed=2))
    runs = [t_annealer.anneal(J, v0, tdev, tpert,
                              noise_seed=5)
            for _ in range(2)]
    assert torch.equal(runs[0].v_final, runs[1].v_final)
    with pytest.raises(ValueError, match="noise must be"):
        t_annealer.anneal(J, v0, tdev, tpert, noise=torch.zeros(3, 1, 4, 8))


def test_energy_trace_matches_reference():
    rdev, rpert, tdev, tpert = _pair(
        {"n_spins": 16, "anneal_sweeps": 0.5, "tau_leak_sweeps": float("inf")},
        r_pert.NOMINAL)
    J, v0 = _inputs(16, 2, 8, seed=4)
    a = np.asarray(r_annealer.anneal_energy_trace(
        jnp.asarray(J), jnp.asarray(v0), rdev, rpert, record_every=16))
    b = t_annealer.anneal_energy_trace(torch.as_tensor(J),
                                       torch.as_tensor(v0), tdev, tpert,
                                       record_every=16).numpy()
    assert a.shape == b.shape == (2, 8, rdev.n_steps // 16)
    assert np.array_equal(a, b)


# -- engine / machine ----------------------------------------------------

def test_engine_plan_rules_on_cpu(tmp_path):
    cache = str(tmp_path / "tune.json")
    J, _ = _inputs(16, 2, 1)
    eng = AnnealEngine(cache_path=cache, torch_device=CPU)
    assert eng.plan(2, 32, 16, J=torch.as_tensor(J)).path == "scan"
    assert eng.plan(2, 32, 16, needs_scan=True).reason.startswith("feature")
    assert AnnealEngine(path="fused", cache_path=cache,
                        torch_device=CPU).plan(2, 32, 16).path == "fused"
    with pytest.raises(ValueError):
        AnnealEngine(path="pallas", torch_device=CPU)
    assert eng._key(2, 32, 16, "float32").startswith("cpu|")


@pytest.mark.parametrize("dev_kw,pert,expect", [
    ({"tau_leak_sweeps": float("inf")}, r_pert.NOMINAL, "int8"),
    ({}, r_pert.DEFAULT_PERTURBATION, "float32"),
    ({"compute_dtype": "bfloat16"}, r_pert.DEFAULT_PERTURBATION, "bfloat16"),
    ({"tau_leak_sweeps": float("inf"), "drive": 0.7}, r_pert.NOMINAL,
     "float32"),
])
def test_engine_j_dtype_autoselect_matches_reference(tmp_path, dev_kw, pert,
                                                     expect):
    rdev, rpert, tdev, tpert = _pair(dev_kw, pert)
    J, _ = _inputs(16, 2, 1)
    ref = RAnnealEngine(rdev, rpert, cache_path=str(tmp_path / "r.json"))
    eng = AnnealEngine(tdev, tpert, cache_path=str(tmp_path / "t.json"),
                       torch_device=CPU)
    assert ref._auto_j_dtype(J) == eng._auto_j_dtype(torch.as_tensor(J)) \
        == expect
    assert eng._auto_j_dtype(torch.as_tensor(J) + 0.5) != "int8"


def test_engine_autotune_cache_roundtrip(tmp_path):
    cache = str(tmp_path / "tune.json")
    eng = AnnealEngine(cache_path=cache, torch_device=CPU)
    plan = eng.autotune(1, 8, 8, probe_sweeps=0.05)
    assert plan.path == "scan" and plan.reason == "autotuned"
    again = AnnealEngine(cache_path=cache, torch_device=CPU)
    assert again.plan(1, 8, 8, J=None).reason == "cache"


class _CudaPlanner(AnnealEngine):
    """Plans and tunes as on a CUDA device (``plan`` and ``autotune`` read
    only ``on_cuda``); its tensors stay on the CPU."""
    on_cuda = property(lambda self: True)


@pytest.fixture
def h100_sms(monkeypatch):
    """The card's SM count, as the autotuner asks for it, an H100's."""
    monkeypatch.setattr(ka, "card_sm_count", lambda device="cuda": 132)
    return 132


def test_engine_cached_scan_never_moves_auto_plan_off_the_kernel(tmp_path):
    eng = _CudaPlanner(cache_path=str(tmp_path / "tune.json"),
                       torch_device=CPU)
    key = eng._key(2, 64, 16, "float32")
    eng._cache[key] = {"path": "scan", "block_r": 64}
    plan = eng.plan(2, 64, 16)
    # block_r: None, the launch plan's own pick, not the stale entry's
    assert (plan.path, plan.block_r, plan.reason) == ("fused", None, "auto")
    eng._cache[key] = {"path": "fused", "block_r": 32}
    plan = eng.plan(2, 64, 16)
    assert (plan.path, plan.block_r, plan.reason) == ("fused", 32, "cache")


def test_engine_autotune_on_cuda_tunes_only_the_kernel(tmp_path, h100_sms):
    eng = _CudaPlanner(cache_path=str(tmp_path / "tune.json"),
                       torch_device=CPU)
    plan = eng.autotune(1, 8, 8, probe_sweeps=0.05)
    assert (plan.path, plan.reason) == ("fused", "autotuned")
    # the candidates are runs per block that the launch plan accepts
    assert plan.block_r in anneal_block_r_candidates(1, 8, 8, plan.j_dtype,
                                                     h100_sms)
    assert eng.plan(1, 8, 8).reason == "cache"


def test_engine_plan_block_r_from_launch_plan_and_design_tagged_key(
        tmp_path):
    """block_r is None unless the cache holds one: the wrapper then
    launches ``anneal_launch_plan``'s pick, made once where it launches.
    The cache key carries the kernel design, so a block_r tuned for
    another design is never read back."""
    eng = _CudaPlanner(cache_path=str(tmp_path / "tune.json"),
                       torch_device=CPU)
    for j_dtype in ("float32", "bfloat16", "int8"):
        key = eng._key(8, 1024, 64, j_dtype)
        assert key.endswith(f"|kernel={KERNEL_DESIGN}")
    old_key = eng._key(8, 1024, 64, "float32").rsplit("|kernel=", 1)[0]
    eng._cache[old_key] = {"path": "fused", "block_r": 256}
    plan = eng.plan(8, 1024, 64)
    assert (plan.path, plan.block_r, plan.reason) == ("fused", None, "auto")
    eng._cache[eng._key(8, 1024, 64, plan.j_dtype)] = {"path": "fused",
                                                        "block_r": 16}
    assert eng.plan(8, 1024, 64).block_r == 16
    # past the kernel's limit the plan is the same: the wrapper refuses
    # the launch on the card, and the CPU's plain version takes any N
    assert eng.plan(1, 8, ka.MAX_N + 1).block_r is None


def test_engine_scan_and_fused_agree_on_unit_schedule(tmp_path):
    rdev, rpert, tdev, tpert = _pair(
        {"n_spins": 16, "anneal_sweeps": 0.5, "tau_leak_sweeps": float("inf")},
        r_pert.NOMINAL)
    J, v0 = _inputs(16, 2, 16, seed=8)
    outs = [AnnealEngine(tdev, tpert, path=path, torch_device=CPU,
                         cache_path=str(tmp_path / "c.json")).run(J, v0)
            for path in ("scan", "fused")]
    assert torch.equal(outs[0].v_final, outs[1].v_final)
    assert torch.equal(outs[0].energy, outs[1].energy)
    ref = r_annealer.anneal(jnp.asarray(J), jnp.asarray(v0), rdev, rpert)
    assert np.array_equal(np.asarray(ref.energy), outs[1].energy.numpy())


@pytest.mark.parametrize("path", ["scan", "fused"])
@pytest.mark.parametrize("dev_kw,pert,expect", [
    ({"tau_leak_sweeps": float("inf")}, r_pert.NOMINAL, "int8"),
    ({}, r_pert.DEFAULT_PERTURBATION, "float32"),
])
def test_engine_run_reports_the_variant_it_planned(tmp_path, path, dev_kw,
                                                   pert, expect):
    _, _, tdev, tpert = _pair({"n_spins": 16, "anneal_sweeps": 0.25,
                               **dev_kw}, pert)
    J, v0 = _inputs(16, 2, 4, seed=3)
    eng = AnnealEngine(tdev, tpert, path=path, torch_device=CPU,
                       cache_path=str(tmp_path / "c.json"))
    res = eng.run(J, v0)
    assert res.j_dtype == eng.plan(2, 4, 16,
                                   J=torch.as_tensor(J)).j_dtype == expect


def test_machine_baselines_and_backends():
    m = IsingMachine(torch_device=CPU)
    gd = m.gradient_descent_baseline()
    assert not gd.device.has_leakage and not gd.perturbation.enabled
    noisy = m.inherent_noise_baseline(1.5)
    assert noisy.device.noise_sigma == 1.5 and noisy.torch_device.type == CPU
    with pytest.raises(ValueError, match="backend"):
        IsingMachine(backend="jnp", torch_device=CPU)
    J, _ = _inputs(12, 1, 1)
    dev = dataclasses.replace(gd.device, anneal_sweeps=0.25)
    outs = [IsingMachine(dev, gd.perturbation, backend=b,
                         torch_device=CPU).solve(J[0], num_runs=8, seed=3)
            for b in ("scan", "fused")]
    assert outs[0].energy.shape == (1, 8)
    assert np.array_equal(outs[0].energy, outs[1].energy)
    assert np.array_equal(outs[0].best_sigma, outs[1].best_sigma)
