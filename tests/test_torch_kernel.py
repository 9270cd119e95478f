"""The anneal kernel's wrapper and plain version against the JAX package.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there. Here the plain version (what the wrapper
runs for CPU tensors) is held against ``repro``'s ``fused_anneal_kernel``,
run in Pallas interpret mode as ``tests/test_kernel.py`` runs it:
  * unit schedule: ``v_final`` bitwise, for f32, int8 and bf16;
  * DEFAULT_PERTURBATION: <= 1% of spins differ, and |dv| <= 1e-5 over runs
    whose final spins all agree.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import perturbation as r_pert
from repro.core.device_model import DeviceModel as RDeviceModel
from repro.kernels import fused_anneal_kernel as r_fused_anneal_kernel
from repro.kernels import fused_anneal_ref as r_fused_anneal_ref
from repro.kernels import ops as r_ops
from repro_torch.convert import (device_model_from_fields,
                                 perturbation_from_fields)
from repro_torch.core import perturbation as t_pert
from repro_torch.kernels import build
from repro_torch.kernels import ising_anneal as ka
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels.ref import fused_anneal_ref

UNIT = {"tau_leak_sweeps": float("inf")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU matmuls run faster on one thread than on a pool that also
    competes with XLA's; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dev_kw, pert):
    rdev = RDeviceModel(**dev_kw)
    return (rdev, pert, device_model_from_fields(dataclasses.asdict(rdev)),
            perturbation_from_fields(dataclasses.asdict(pert)))


def _inputs(n, p, r, seed):
    from repro.core.lfsr import lfsr_voltage_inits
    from repro.problems import problem_set
    J = problem_set(n, 0.5, p, seed=seed).J.astype(np.float32)
    v0 = np.stack([lfsr_voltage_inits(n, r, seed=seed + k)
                   for k in range(p)]).astype(np.float32)
    return J, v0


def _reference(J, v0, rdev, rpert, j_dtype):
    return np.asarray(r_fused_anneal_kernel(
        jnp.asarray(J), jnp.asarray(v0), dev=rdev, pert=rpert,
        j_dtype=j_dtype, interpret=True))


@pytest.mark.parametrize("j_dtype", ka.J_DTYPES)
@pytest.mark.parametrize("n,p,r", [(16, 2, 24), (21, 1, 32)])
def test_plain_version_unit_schedule_bitwise(j_dtype, n, p, r):
    rdev, rpert, tdev, tpert = _pair({"n_spins": n, "anneal_sweeps": 0.5,
                                      **UNIT}, r_pert.NOMINAL)
    J, v0 = _inputs(n, p, r, seed=n)
    ref = _reference(J, v0, rdev, rpert, j_dtype)
    out = ka.fused_anneal_kernel(torch.as_tensor(J), torch.as_tensor(v0),
                                 dev=tdev, pert=tpert, j_dtype=j_dtype)
    assert out.shape == ref.shape and np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("j_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,p,r,seed", [(16, 2, 32, 3), (24, 1, 32, 4)])
def test_plain_version_perturbation_within_tolerance(j_dtype, n, p, r, seed):
    rdev, rpert, tdev, tpert = _pair({"n_spins": n, "anneal_sweeps": 1.5},
                                     r_pert.DEFAULT_PERTURBATION)
    J, v0 = _inputs(n, p, r, seed=seed)
    ref = _reference(J, v0, rdev, rpert, j_dtype)
    out = ka.fused_anneal_torch(torch.as_tensor(J), torch.as_tensor(v0),
                                tdev, tpert, j_dtype).numpy()
    s_out, s_ref = out >= 0.5, ref >= 0.5
    assert (s_out != s_ref).mean() <= 0.01
    same = (s_out == s_ref).all(axis=-1)
    assert same.any() and np.abs(out - ref)[same].max() <= 1e-5


def test_table_oracle_matches_reference_and_plain_version():
    """``fused_anneal_ref`` on the reference's own table: bitwise on the
    unit schedule; under perturbation the port's oracle equals the port's
    plain version bitwise (same table values, same op order)."""
    rdev, rpert, tdev, tpert = _pair({"n_spins": 16, "anneal_sweeps": 0.5,
                                      **UNIT}, r_pert.NOMINAL)
    J, v0 = _inputs(16, 2, 16, seed=2)
    table = np.asarray(r_pert.schedule_table(rdev, rpert))
    dd = rdev.drive_eff * rdev.dt
    a = np.asarray(r_fused_anneal_ref(J, v0, table, dd, rdev.vdd))
    b = fused_anneal_ref(torch.as_tensor(J), torch.as_tensor(v0),
                         torch.as_tensor(table), dd, tdev.vdd).numpy()
    assert np.array_equal(a, b)

    _, _, tdev, tpert = _pair({"n_spins": 16, "anneal_sweeps": 0.5},
                              r_pert.DEFAULT_PERTURBATION)
    table = t_pert.schedule_table(tdev, tpert)
    Jt, vt = torch.as_tensor(J), torch.as_tensor(v0)
    assert torch.equal(fused_anneal_ref(Jt, vt, table, dd, tdev.vdd),
                       ka.fused_anneal_torch(Jt, vt, tdev, tpert))


def test_ops_fused_anneal_outputs_match_reference():
    rdev, rpert, tdev, tpert = _pair({"n_spins": 16, "anneal_sweeps": 0.5,
                                      **UNIT}, r_pert.NOMINAL)
    J, v0 = _inputs(16, 2, 8, seed=6)
    rv, rs, re = r_ops.fused_anneal(J, v0, rdev, rpert, interpret=True,
                                    j_dtype="int8")
    tv, ts, te = t_ops.fused_anneal(torch.as_tensor(J), torch.as_tensor(v0),
                                    tdev, tpert, j_dtype="int8")
    for a, b in ((rv, tv), (rs, ts), (re, te)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_wrapper_rules_on_cpu():
    _, _, tdev, tpert = _pair({"n_spins": 8, "anneal_sweeps": 0.125, **UNIT},
                              r_pert.NOMINAL)
    J, v0 = (torch.as_tensor(x) for x in _inputs(8, 1, 4, seed=1))
    ka.reset_launches()
    ka.fused_anneal_kernel(J, v0, dev=tdev, pert=tpert, j_dtype="int8")
    # the plain version ran: CPU tensors never count as a kernel launch
    assert set(ka.launches) == set(ka.KERNEL_NAMES.values())
    assert all(v == 0 for v in ka.launches.values())
    with pytest.raises(ValueError, match="j_dtype"):
        ka.fused_anneal_kernel(J, v0, dev=tdev, pert=tpert, j_dtype="fp8")
    with pytest.raises(ValueError, match="unit schedule"):
        ka.fused_anneal_kernel(J, v0, dev=tdev,
                               pert=t_pert.DEFAULT_PERTURBATION,
                               j_dtype="int8")
    with pytest.raises(ValueError, match="integer coupling levels"):
        t_ops.fused_anneal(J + 0.5, v0, tdev, tpert, j_dtype="int8")
    big = torch.zeros(1, ka.MAX_N + 1, ka.MAX_N + 1)
    with pytest.raises(ValueError, match="N <= 128"):
        ka.fused_anneal_kernel(big, torch.zeros(1, 2, ka.MAX_N + 1),
                               dev=tdev, pert=tpert)
    # a tensor that is neither on the CPU nor on CUDA is refused, not
    # quietly moved
    with pytest.raises(ValueError, match="CUDA device"):
        ka.fused_anneal_kernel(J.to("meta"), v0.to("meta"), dev=tdev,
                               pert=tpert)


def test_build_names_library_by_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// one\n")
    first = build.library_path("k.cu")
    assert first.name.startswith("libk-") and first.suffix == ".so"
    assert first.parent == build.BUILD_DIR
    (tmp_path / "k.cu").write_text("// two\n")
    assert build.library_path("k.cu") != first
    # the real source's flags keep IEEE division and expf
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_find_nvcc_raises_when_missing(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os.path, "isfile",
                        lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_kernel_source_carries_its_notes():
    src = (build.CSRC / ka.SOURCE).read_text()
    assert "src/repro/kernels/ising_anneal.py:59" in src
    assert "floor_mod" in src and "use_fast_math" in src
    assert "wgmma" in src
