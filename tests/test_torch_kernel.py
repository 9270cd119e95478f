"""The anneal kernel's wrapper and plain version against the JAX package.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there. Here the plain version (what the wrapper
runs for CPU tensors) is held against ``repro``'s ``fused_anneal_kernel``,
run in Pallas interpret mode as ``tests/test_kernel.py`` runs it:
  * unit schedule: ``v_final`` bitwise, for f32, int8 and bf16;
  * DEFAULT_PERTURBATION: <= 1% of spins differ, and |dv| <= 1e-5 over runs
    whose final spins all agree;
both at small N and at N = 160, past the kernel's register regime. The
facts the kernel's design rests on are pinned here too: the bf16 sums are
exact in any order, the int8 k permutation, the tensor-core fragment
layout (emulated lane by lane from the PTX fragment definitions), and the
launch plan's arithmetic.
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

#: the SM count the launch plan is given here, an H100's
H100_SMS = 132

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
    # CPU tensors run the plain version at any N, past the kernel's 64 and
    # its old limit of 128; the card's limit is the launch plan's
    J160, v160 = (torch.as_tensor(x) for x in _inputs(160, 1, 2, seed=1))
    out = ka.fused_anneal_kernel(J160, v160, dev=tdev, pert=tpert,
                                 j_dtype="int8")
    assert out.shape == (1, 2, 160) and all(
        v == 0 for v in ka.launches.values())
    with pytest.raises(ValueError, match=f"N <= {ka.MAX_N}"):
        ka.anneal_launch_plan(1, 2, ka.MAX_N + 1, "float32", H100_SMS)
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


# -- N past the register regime ------------------------------------------

@pytest.mark.parametrize("j_dtype", ka.J_DTYPES)
def test_port_matches_reference_at_n160_unit_schedule(j_dtype):
    """The reference pads N to 256 and runs; the port's wrapper takes N =
    160 too (plain version on the CPU), bitwise on the unit schedule."""
    rdev, rpert, tdev, tpert = _pair({"n_spins": 160, "anneal_sweeps": 0.25,
                                      **UNIT}, r_pert.NOMINAL)
    J, v0 = _inputs(160, 1, 8, seed=160)
    ref = _reference(J, v0, rdev, rpert, j_dtype)
    out = ka.fused_anneal_kernel(torch.as_tensor(J), torch.as_tensor(v0),
                                 dev=tdev, pert=tpert, j_dtype=j_dtype)
    assert out.shape == ref.shape == (1, 8, 160)
    assert np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("j_dtype", ["float32", "bfloat16"])
def test_port_matches_reference_at_n160_perturbation(j_dtype):
    rdev, rpert, tdev, tpert = _pair({"n_spins": 160, "anneal_sweeps": 0.5},
                                     r_pert.DEFAULT_PERTURBATION)
    J, v0 = _inputs(160, 1, 16, seed=161)
    ref = _reference(J, v0, rdev, rpert, j_dtype)
    out = ka.fused_anneal_kernel(torch.as_tensor(J), torch.as_tensor(v0),
                                 dev=tdev, pert=tpert,
                                 j_dtype=j_dtype).numpy()
    s_out, s_ref = out >= 0.5, ref >= 0.5
    assert (s_out != s_ref).mean() <= 0.01
    same = (s_out == s_ref).all(axis=-1)
    assert same.any() and np.abs(out - ref)[same].max() <= 1e-5


# -- the facts the tensor-core design rests on ----------------------------

def test_bf16_sums_exact_in_any_order_over_default_schedule():
    """Under the default device model and perturbation schedule, every
    bf16-rounded column scale is a multiple of 2^-17, so each step's
    ``bf16(q*s) @ J^T`` is exact in f32: a random order of j, and float64,
    give the plain version's product bit for bit at every step. This is
    why the bf16 tensor-core kernel can be bitwise equal to
    ``fused_anneal_torch`` under both schedules."""
    from repro_torch.core import DEFAULT_PERTURBATION, DeviceModel
    from repro_torch.core.perturbation import scales_from_cols
    dev = DeviceModel(compute_dtype="bfloat16")
    J, v0 = _inputs(64, 2, 32, seed=14)
    J, v = torch.as_tensor(J), torch.as_tensor(v0)
    Jt = J.to(torch.bfloat16).float().transpose(-1, -2).contiguous()
    dd = float(dev.drive_eff * dev.dt)
    scales = scales_from_cols(torch.arange(dev.n_steps)[:, None],
                              torch.arange(64)[None, :], dev,
                              DEFAULT_PERTURBATION) * dd
    sb = scales.to(torch.bfloat16).double()
    assert torch.all(sb * 2 ** 17 == torch.round(sb * 2 ** 17))
    perm = torch.as_tensor(np.random.default_rng(3).permutation(64))
    for t in range(dev.n_steps):
        sq = (torch.where(v >= dev.threshold, 1.0, -1.0) * scales[t]).to(
            torch.bfloat16).float()
        dv = torch.matmul(sq, Jt)
        assert torch.equal(dv, torch.matmul(sq[..., perm], Jt[:, perm]))
        assert torch.equal(dv.double(),
                           torch.matmul(sq.double(), Jt.double()))
        v = torch.clamp(v + dv, 0.0, dev.vdd)
    plain = ka.fused_anneal_torch(J, torch.as_tensor(v0), dev,
                                  DEFAULT_PERTURBATION, "bfloat16")
    assert torch.equal(v, plain)


def test_int8_k_permutation_is_a_bijection_and_keeps_the_product():
    perm = list(ka.INT8_K_PERM)
    assert sorted(perm) == list(range(32))
    # slot k = 16h + 4c + i of quad lane c holds a column of that lane's
    # own accumulators: n-tile 2h + i//2, column 2c + i%2
    for h in range(2):
        for c in range(4):
            for i in range(4):
                col = perm[16 * h + 4 * c + i]
                assert divmod(col, 8) == (2 * h + i // 2, 2 * c + i % 2)
    rng = np.random.default_rng(5)
    sq = torch.as_tensor(rng.choice([-1.0, 1.0], size=(16, 64)))
    Jt = torch.as_tensor(rng.integers(-15, 16, size=(64, 64)).astype(float))
    full = torch.as_tensor([32 * kt + k for kt in range(2) for k in perm])
    assert torch.equal(sq[:, full] @ Jt[full], sq @ Jt)


def _ptx_a(kd, lane, reg, el):
    """(row, k) of A element ``el`` of register ``reg`` of ``lane`` (PTX
    ISA, mma.m16n8k16 .bf16 / mma.m16n8k32 .s8 fragment layouts)."""
    g, c = lane // 4, lane % 4
    per = 2 if kd == 16 else 4
    return g + 8 * (reg % 2), per * c + el + (kd // 2) * (reg // 2)


def _ptx_b(kd, lane, reg, el):
    g, c = lane // 4, lane % 4
    per = 2 if kd == 16 else 4
    return per * c + el + (kd // 2) * reg, g


def _emulate_tile(v, sb, Jp, j_dtype, thr):
    """One step of one warp's 16-run tile as ``anneal_mma`` computes it:
    A fragments packed from the accumulator layout of v by the kernel's
    rules, B fragments from ``mma_fragment_index``, each mma evaluated
    from the PTX fragment definitions; returns the (16, n_pad) sums."""
    n_pad = v.shape[1]
    kd, per = (16, 2) if j_dtype == "bfloat16" else (32, 4)
    n_idx, k_idx = ka.mma_fragment_index(n_pad, j_dtype)
    Bf = Jp[n_idx.numpy(), k_idx.numpy()]             # (KT, UT, 32, 4*per)
    q = np.where(v >= thr, 1.0, -1.0)
    if sb is not None:
        q = q * sb[None, :]

    def x(lane, nt, e):                  # accumulator element of a lane
        g, c = lane // 4, lane % 4
        return q[g + 8 * (e >> 1), 8 * nt + 2 * c + (e & 1)]

    acc = np.zeros((32, n_pad // 8, 4))
    for kt in range(n_pad // kd):
        A = np.zeros((16, kd))
        for lane in range(32):
            if j_dtype == "bfloat16":
                n0, n1 = 2 * kt, 2 * kt + 1
                regs = [(x(lane, n0, 0), x(lane, n0, 1)),
                        (x(lane, n0, 2), x(lane, n0, 3)),
                        (x(lane, n1, 0), x(lane, n1, 1)),
                        (x(lane, n1, 2), x(lane, n1, 3))]
            else:
                n = [4 * kt + d for d in range(4)]
                regs = [(x(lane, n[0], 0), x(lane, n[0], 1),
                         x(lane, n[1], 0), x(lane, n[1], 1)),
                        (x(lane, n[0], 2), x(lane, n[0], 3),
                         x(lane, n[1], 2), x(lane, n[1], 3)),
                        (x(lane, n[2], 0), x(lane, n[2], 1),
                         x(lane, n[3], 0), x(lane, n[3], 1)),
                        (x(lane, n[2], 2), x(lane, n[2], 3),
                         x(lane, n[3], 2), x(lane, n[3], 3))]
            for reg, vals in enumerate(regs):
                for el, val in enumerate(vals):
                    A[_ptx_a(kd, lane, reg, el)] = val
        for u in range(n_pad // 16):
            for half in range(2):
                B = np.zeros((kd, 8))
                for lane in range(32):
                    for reg in range(2):
                        for el in range(per):
                            B[_ptx_b(kd, lane, reg, el)] = Bf[
                                kt, u, lane, (2 * half + reg) * per + el]
                D = A @ B
                for lane in range(32):
                    g, c = lane // 4, lane % 4
                    for e in range(4):
                        acc[lane, 2 * u + half, e] += \
                            D[g + 8 * (e >> 1), 2 * c + (e & 1)]
    out = np.zeros((16, n_pad))
    for lane in range(32):
        for nt in range(n_pad // 8):
            for e in range(4):
                g, c = lane // 4, lane % 4
                out[g + 8 * (e >> 1), 8 * nt + 2 * c + (e & 1)] = \
                    acc[lane, nt, e]
    return out


@pytest.mark.parametrize("j_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("n", [64, 160])
def test_mma_fragment_layout_gives_the_product(j_dtype, n):
    """The kernel's register-level step, emulated: its sums equal
    ``bf16(q*s) @ J^T`` (or ``q @ J^T``) exactly, padding included."""
    rng = np.random.default_rng(n)
    n_pad = ka.anneal_launch_plan(1, 16, n, j_dtype, H100_SMS).n_pad
    J = np.zeros((n_pad, n_pad))
    J[:n, :n] = rng.integers(-15, 16, size=(n, n))
    v = rng.uniform(0.0, 1.0, size=(16, n_pad))
    sb = None
    if j_dtype == "bfloat16":
        s = torch.as_tensor(rng.uniform(0.0, 0.002, size=n_pad),
                            dtype=torch.float32)
        sb = s.to(torch.bfloat16).double().numpy()
    got = _emulate_tile(v, sb, J, j_dtype, 0.5)
    q = np.where(v >= 0.5, 1.0, -1.0) * (1.0 if sb is None else sb)
    assert np.array_equal(got, q @ J.T)


# -- the launch plan --------------------------------------------------------

_SHAPES = [(8, 1024, 64), (400, 300, 64), (4, 1000, 37), (4, 1000, 160),
           (2, 64, 1024), (128, 4, 64), (3, 5, 300)]


@pytest.mark.parametrize("j_dtype", ka.J_DTYPES)
@pytest.mark.parametrize("shape", _SHAPES)
def test_launch_plan_covers_every_run_once_within_the_card(j_dtype, shape):
    P, R, N = shape
    plan = ka.anneal_launch_plan(P, R, N, j_dtype, H100_SMS)
    assert plan.smem_bytes <= ka.SMEM_MAX and plan.registers <= 255
    assert plan.n_pad >= N and plan.n_pad % plan.spins_per_warp == 0
    assert plan.warps_per_tile * plan.spins_per_warp == plan.n_pad
    assert plan.threads == 32 * plan.tiles_per_block * plan.warps_per_tile
    assert plan.block_r == plan.tiles_per_block * plan.runs_per_warp
    # every run of a problem in exactly one warp tile
    blocks_r = plan.blocks // P
    seen = np.zeros(R, dtype=int)
    for b in range(blocks_r):
        for tile in range(plan.tiles_per_block):
            r0 = b * plan.block_r + tile * plan.runs_per_warp
            seen[r0:min(r0 + plan.runs_per_warp, R)] += 1
    assert (seen == 1).all()
    # each alternative geometry is inside the card too
    for br in ka.anneal_block_r_candidates(P, R, N, j_dtype, H100_SMS):
        alt = ka.anneal_launch_plan(P, R, N, j_dtype, H100_SMS, block_r=br)
        assert alt.smem_bytes <= ka.SMEM_MAX and alt.registers <= 255
        assert alt.threads <= ka.MAX_THREADS["split"]


@pytest.mark.parametrize("j_dtype", ka.J_DTYPES)
def test_launch_plan_fills_the_card_and_picks_the_regime(j_dtype):
    for shape in ((8, 1024, 64), (400, 300, 64)):
        plan = ka.anneal_launch_plan(*shape, j_dtype, H100_SMS)
        assert plan.blocks >= H100_SMS
    regimes = {N: ka.anneal_launch_plan(4, 100, N, j_dtype, H100_SMS).regime
               for N in (64, 160, 1024)}
    assert regimes == {64: "registers", 160: "shared", 1024: "streamed"}
    with pytest.raises(ValueError, match=f"N <= {ka.MAX_N}"):
        ka.anneal_launch_plan(1, 8, ka.MAX_N + 1, j_dtype, H100_SMS)
    with pytest.raises(ValueError, match="multiple"):
        ka.anneal_launch_plan(1, 8, 64, j_dtype, H100_SMS, block_r=12)
    with pytest.raises(ValueError, match="regime"):
        ka.anneal_launch_plan(1, 8, 160, j_dtype, H100_SMS,
                              regime="registers")
    # a forced regime is a valid plan of its own
    alt = ka.anneal_launch_plan(8, 1024, 64, j_dtype, H100_SMS,
                                regime="shared")
    assert alt.regime == "shared" and alt.warps_per_tile == 1


@pytest.mark.parametrize("j_dtype", ka.J_DTYPES)
def test_launch_plan_takes_runs_past_grid_y(j_dtype):
    """The blocks lie on grid.x, problem-major, so a one-tile plan takes
    more than grid.y's 65535 run blocks of a problem; past ``MAX_BLOCKS``
    blocks the plan puts more runs in a block instead."""
    plan = ka.anneal_launch_plan(1, 1 << 20, 64, j_dtype, H100_SMS)
    assert plan.tiles_per_block == 1 and plan.blocks > 65535
    rpw = ka.RUNS_PER_WARP[j_dtype]
    P, R = 1 << 16, (1 << 15) * rpw            # 2^31 one-tile blocks
    with pytest.raises(ValueError, match="block_r"):
        ka.anneal_launch_plan(P, R, 64, j_dtype, H100_SMS, block_r=rpw)
    plan = ka.anneal_launch_plan(P, R, 64, j_dtype, H100_SMS)
    assert plan.tiles_per_block > 1 and plan.blocks <= ka.MAX_BLOCKS
    assert rpw not in ka.anneal_block_r_candidates(P, R, 64, j_dtype,
                                                   H100_SMS)


def test_launch_plan_one_geometry_for_mma_at_max_n():
    """bf16 / int8 at N = 1024: sixteen warps of 64 spins fill a block of
    512 threads and J^T does not fit in shared memory, so the kernel has
    one geometry there (f32, 128 spins a warp, has two)."""
    for j_dtype in ("bfloat16", "int8"):
        assert ka.anneal_block_r_candidates(2, 64, 1024, j_dtype,
                                            H100_SMS) == [16]
        with pytest.raises(ValueError):
            ka.anneal_launch_plan(2, 64, 1024, j_dtype, H100_SMS,
                                  regime="shared")
    assert ka.anneal_block_r_candidates(2, 64, 1024, "float32",
                                        H100_SMS) == [8, 16]


def test_layout_j_shapes_and_values():
    J = torch.as_tensor(_inputs(37, 2, 1, seed=2)[0])
    for j_dtype in ka.J_DTYPES:
        plan = ka.anneal_launch_plan(2, 16, 37, j_dtype, H100_SMS)
        Jl = ka.layout_j(J, plan)
        if j_dtype == "float32":
            assert Jl.shape == (2, 64, 64)
            assert torch.equal(Jl[:, :37, :37], J.transpose(-1, -2))
            assert not Jl[:, 37:].any() and not Jl[:, :, 37:].any()
        else:
            per = 8 if j_dtype == "bfloat16" else 16
            assert Jl.dtype == ka._J_STORE[j_dtype]
            assert Jl.numel() * Jl.element_size() == 2 * 64 * 64 * (
                2 if j_dtype == "bfloat16" else 1)
            assert Jl.shape[-1] == per and Jl.float().abs().sum() == \
                J.abs().sum()
