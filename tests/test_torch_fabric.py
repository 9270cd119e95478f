"""The mega-fabric in the port (``repro_torch.distributed.fabric``,
``fabric-jax``) against the JAX package, mirroring ``tests/test_fabric.py``
case for case.

The port's dies are virtual (K dies on one torch device), so its
mesh-invariance cases run here; the reference's need forced host devices
and skip. Tolerances, fixed before the port was written:
  * bitwise: ``FabricLayout`` (tiles, colors, ``die_of``, occupancy),
    ``FieldExchange.fields`` against the float64 host product, mesh
    invariance, ``FabricLNS`` on the unit schedule (no perturbation, no
    finite leakage) against the reference's, ``fabric-jax`` against
    ``engine`` at N <= 64, the init stream, the duel graph's best cut;
  * under the default perturbation schedule (``anneal_sweeps=0.5``):
    >= 99% of restarts with equal energies, the tolerance of
    ``test_chip_lns_default_schedule_matches_reference`` for the same
    <= 1 ULP ``exp`` difference.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import Problem as RProblem
from repro.api import get_solver as r_get_solver
from repro.core import perturbation as r_pert
from repro.core.device_model import DeviceModel as RDeviceModel
from repro.core.engine import AnnealEngine as RAnnealEngine
from repro.distributed.fabric import FabricLayout as RFabricLayout
from repro.distributed.fabric import FabricLNS as RFabricLNS
from repro.distributed.fabric import fabric_mesh as r_fabric_mesh
from repro.problems.gset import cut_from_energy as r_cut_from_energy
from repro.problems.gset import gset_problem as r_gset_problem
from repro_torch.api import Problem, get_solver
from repro_torch.convert import (device_model_from_fields,
                                 perturbation_from_fields)
from repro_torch.core import AnnealEngine, maxcut_value
from repro_torch.core.device_model import DeviceModel
from repro_torch.core.engine import BlockLNS, lns_blocks
from repro_torch.distributed import (FabricLayout, FabricLNS, FieldExchange,
                                     fabric_mesh)
from repro_torch.problems import cut_from_energy, gset_problem

SEED = 42
CPU = {"torch_device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU ops run faster on one thread than on a pool that also
    competes with XLA's; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine():
    dev = dataclasses.replace(DeviceModel(), anneal_sweeps=0.5)
    return AnnealEngine(device=dev, path="scan", **CPU)


def _r_engine():
    dev = dataclasses.replace(RDeviceModel(), anneal_sweeps=0.5)
    return RAnnealEngine(device=dev, path="scan")


def _unit_engines(anneal_sweeps=0.25):
    """Reference and port engines on the unit schedule (no perturbation,
    no finite leakage) with the same device model."""
    rdev = RDeviceModel(anneal_sweeps=anneal_sweeps,
                        tau_leak_sweeps=float("inf"))
    tdev = device_model_from_fields(dataclasses.asdict(rdev))
    tpert = perturbation_from_fields(dataclasses.asdict(r_pert.NOMINAL))
    return (RAnnealEngine(device=rdev, perturbation=r_pert.NOMINAL),
            AnnealEngine(device=tdev, perturbation=tpert, **CPU))


def _mesh(k=None):
    return fabric_mesh(k, **CPU)


def _couplings(n, seed):
    rng = np.random.default_rng(seed)
    J = rng.integers(-15, 16, size=(n, n)).astype(np.float64)
    return np.triu(J, 1) + np.triu(J, 1).T


# -- FabricLayout ------------------------------------------------------------

def test_layout_tiles_partition_and_color():
    lay = FabricLayout.build(200, n_dies=4)
    assert lay.n_tiles == len(lns_blocks(200, 63))
    all_idx = np.concatenate(lay.tiles)
    assert np.array_equal(np.sort(all_idx), np.arange(200))
    for t in range(lay.n_tiles - 1):
        assert lay.color_of(t) != lay.color_of(t + 1)
    assert lay.n_colors == 2


def test_layout_single_tile_has_one_color():
    lay = FabricLayout.build(40, n_dies=2)
    assert lay.n_tiles == 1
    assert lay.n_colors == 1


def test_layout_color_phases_spread_over_dies():
    # 8 tiles over 4 dies: every color phase uses ALL dies (t % n_dies
    # would alias with the parity coloring)
    lay = FabricLayout.build(8 * 63, n_dies=4)
    assert lay.n_tiles == 8
    for c in range(2):
        assert lay.occupancy(c) == {"tiles": 4, "dies_busy": 4,
                                    "dies_idle": 0, "max_tiles_per_die": 1,
                                    "pad_tiles": 0}


def test_layout_occupancy_counts_idle_and_padding():
    lay = FabricLayout.build(150, n_dies=4)
    assert lay.n_tiles == 3
    occ0, occ1 = lay.occupancy(0), lay.occupancy(1)
    assert occ0["tiles"] == 2 and occ1["tiles"] == 1
    assert occ0["dies_busy"] + occ0["dies_idle"] == 4
    assert occ1["max_tiles_per_die"] == 1


def test_layout_rejects_bad_args():
    with pytest.raises(ValueError):
        FabricLayout.build(100, n_dies=0)
    with pytest.raises(ValueError):
        fabric_mesh(0, **CPU)
    # virtual dies: more dies than devices is a valid fabric here
    assert _mesh(16).n_dies == 16 and _mesh().n_dies == 1


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n", [40, 150, 200, 504, 2000])
def test_layout_matches_reference(n, k):
    a, b = FabricLayout.build(n, k), RFabricLayout.build(n, k)
    assert (a.n_tiles, a.n_colors) == (b.n_tiles, b.n_colors)
    assert all(np.array_equal(x, y) for x, y in zip(a.tiles, b.tiles))
    for t in range(a.n_tiles):
        assert (a.color_of(t), a.die_of(t)) == (b.color_of(t), b.die_of(t))
    for c in range(a.n_colors):
        assert a.die_color_tiles(c) == b.die_color_tiles(c)
        assert a.occupancy(c) == b.occupancy(c)


# -- FieldExchange -----------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 8])
def test_field_exchange_matches_host_matmul_exactly(k):
    n = 130                               # divisible by none of 3 and 8
    J = _couplings(n, SEED)
    s = np.random.default_rng(SEED + 1).choice([-1.0, 1.0], size=(5, n))
    ex = FieldExchange(J, _mesh(k))
    assert ex.n_pad == -(-n // k) * k
    h = ex.fields(s)
    assert h.dtype == np.float32
    assert np.array_equal(h.astype(np.float64), s @ J)
    assert ex.exchanges == 1
    ex.fields(s)
    assert ex.exchanges == 2


def test_field_exchange_holds_k_column_tiles():
    """J is placed once as K column tiles of the padded matrix (the
    reference shards it P(None, 'fabric'))."""
    J = _couplings(130, SEED)
    ex = FieldExchange(J, _mesh(3))
    assert [t.shape for t in ex._J] == [(132, 44)] * 3
    Jp = np.zeros((132, 132), np.float32)
    Jp[:130, :130] = J
    assert np.array_equal(torch.cat(ex._J, dim=1).numpy(), Jp)


def test_field_exchange_rejects_bad_shapes():
    with pytest.raises(ValueError):
        FieldExchange(np.zeros((4, 5)), _mesh())
    ex = FieldExchange(np.zeros((6, 6)), _mesh())
    with pytest.raises(ValueError):
        ex.fields(np.ones((2, 7)))


# -- FabricLNS ---------------------------------------------------------------

def _solve_fabric(n=150, restarts=3, sweeps=2, seed=SEED, **kw):
    J = _couplings(n, seed)
    lns = FabricLNS(_engine(), inner_runs=4, **kw)
    out, d = lns.solve([J], restarts=restarts, outer_sweeps=sweeps,
                       seed=seed)
    return J, lns, out, d


def test_fabric_dispatches_are_colors_times_sweeps():
    _, lns, _, d = _solve_fabric(n=150, sweeps=3)
    assert d == 2 * 3                     # never one dispatch per tile
    assert lns.ledger["dispatches"] == d
    assert lns.ledger["n_tiles"] == [3]
    assert lns.ledger["field_exchanges"] == 2 * 3
    for rec in lns.ledger["per_sweep"]:
        assert rec["j_dtypes"] == ["float32"] * 2


def test_fabric_monotone_and_energy_identity():
    J, _, out, _ = _solve_fabric()
    (e, sig, e0), = out
    assert np.all(e <= e0 + 1e-9)
    s = sig.astype(np.float64)
    assert np.array_equal(e, -0.5 * np.einsum("ri,ij,rj->r", s, J, s))


def test_fabric_deterministic_per_seed():
    _, _, out_a, _ = _solve_fabric(seed=7)
    _, _, out_b, _ = _solve_fabric(seed=7)
    _, _, out_c, _ = _solve_fabric(seed=8)
    assert np.array_equal(out_a[0][0], out_b[0][0])
    assert np.array_equal(out_a[0][1], out_b[0][1])
    assert not np.array_equal(out_c[0][0], out_a[0][0])


def test_fabric_same_init_stream_as_block_lns_and_reference():
    J = _couplings(100, 3)
    out_f, _ = FabricLNS(_engine(), inner_runs=4).solve(
        [J], restarts=4, outer_sweeps=0, seed=5)
    out_b, _ = BlockLNS(_engine(), inner_runs=4).solve(
        [J], restarts=4, outer_sweeps=0, seed=5)
    out_r, _ = RFabricLNS(_r_engine(), inner_runs=4).solve(
        [J], restarts=4, outer_sweeps=0, seed=5)
    for other in (out_b, out_r):
        assert np.array_equal(out_f[0][2], other[0][2])
        assert np.array_equal(out_f[0][1], other[0][1])


def test_fabric_multi_problem_batch():
    Js = [_couplings(100, 11), _couplings(150, 12)]
    lns = FabricLNS(_engine(), inner_runs=4)
    out, d = lns.solve(Js, restarts=2, outer_sweeps=2, seed=SEED)
    assert d == 2 * 2                     # both problems share dispatches
    assert lns.ledger["field_exchanges"] == 2 * 2 * 2
    for (e, sig, e0), J in zip(out, Js):
        assert sig.shape == (2, J.shape[0])
        assert np.all(e <= e0 + 1e-9)


@pytest.mark.parametrize("n,k", [
    (150, 3),     # 3 tiles over 3 dies: <= 1 tile per die per color
    (252, 8),     # BENCH_fabric.json's first invariance row
    # 6 tiles -> 3 per color class on 2 dies: the die-major slot order
    # differs from tile order, so this row fails unless acceptance runs
    # in canonical (problem, tile) order
    (378, 2),
])
def test_fabric_bitwise_mesh_invariant(n, k):
    _, _, out_1, _ = _solve_fabric(n=n, mesh=_mesh(1))
    _, lns, out_k, _ = _solve_fabric(n=n, mesh=_mesh(k))
    assert lns.ledger["mesh_devices"] == k
    assert np.array_equal(out_1[0][0], out_k[0][0])
    assert np.array_equal(out_1[0][1], out_k[0][1])


@pytest.mark.parametrize("n,k", [(150, 3), (378, 2)])
def test_fabric_unit_schedule_bitwise_against_reference(n, k):
    """On the unit schedule every sum is exact: the port's FabricLNS (K
    virtual dies) equals the reference's (a mesh of one JAX device) in
    energies, states, initial energies and the dispatch ledger."""
    J = [_couplings(n, 5), gset_problem(n, seed=3, degree=8.0)
         .J_levels.astype(np.float64)]
    r_eng, t_eng = _unit_engines()
    r_lns = RFabricLNS(r_eng, mesh=r_fabric_mesh(1), inner_runs=4)
    ref, r_d = r_lns.solve(J, restarts=4, outer_sweeps=2, seed=11)
    lns = FabricLNS(t_eng, mesh=_mesh(k), inner_runs=4)
    out, t_d = lns.solve(J, restarts=4, outer_sweeps=2, seed=11)
    assert t_d == r_d == 4
    for key in ("n_colors", "n_tiles", "field_exchanges", "dispatches",
                "restarts", "inner_runs"):
        assert lns.ledger[key] == r_lns.ledger[key], key
    for (e, s, e0), (re, rs, re0) in zip(out, ref):
        assert np.array_equal(e, re) and np.array_equal(e0, re0)
        assert s.dtype == np.int8 and np.array_equal(s, rs)


def test_fabric_default_schedule_matches_reference():
    """Under the default perturbation schedule: >= 99% of restarts with
    equal energies, the same dispatch ledger."""
    J = [_couplings(200, 9)]
    ref, r_d = RFabricLNS(_r_engine(), inner_runs=4).solve(
        J, restarts=8, outer_sweeps=2, seed=13)
    out, t_d = FabricLNS(_engine(), mesh=_mesh(4), inner_runs=4).solve(
        J, restarts=8, outer_sweeps=2, seed=13)
    assert t_d == r_d == 4
    same = out[0][0] == ref[0][0]
    assert same.mean() >= 0.99


def test_fabric_registry_small_n_bit_identical_to_engine():
    p = Problem.maxcut(32, density=0.5, seed=SEED)
    rep_f = get_solver("fabric-jax", mesh_devices=8, **CPU).solve(
        p, runs=4, seed=SEED)
    rep_e = get_solver("engine", **CPU).solve(p, runs=4, seed=SEED)
    assert rep_f.meta["lns_problems"] == []
    assert np.array_equal(rep_f.energies[0], rep_e.energies[0])
    assert np.array_equal(rep_f.best_sigma[0], rep_e.best_sigma[0])


def test_fabric_registry_ledger_and_meta():
    p = gset_problem(130, seed=SEED, degree=5.0)
    s = get_solver("fabric-jax", anneal_sweeps=0.5, inner_runs=4,
                   outer_sweeps=2, **CPU)
    rep = s.solve(p, runs=2, seed=SEED)
    fab = rep.meta["fabric"]
    assert rep.dispatches == fab["n_colors"] * 2
    assert len(fab["per_sweep"]) == 2
    for rec in fab["per_sweep"]:
        assert set(rec) >= {"t_fields", "t_assemble", "t_engine",
                            "t_accept", "t_total"}
    assert fab["color_peaks"] and fab["restarts"] == 2
    ref = r_get_solver("fabric-jax", anneal_sweeps=0.5, inner_runs=4,
                       outer_sweeps=2).solve(
        r_gset_problem(130, seed=SEED, degree=5.0), runs=2, seed=SEED)
    assert set(ref.meta["fabric"]) <= set(fab)
    assert set(ref.meta) <= set(rep.meta)
    assert rep.meta["outer_sweeps"] == ref.meta["outer_sweeps"]


def test_gset_problem_end_to_end_decode_verify():
    p = gset_problem(130, seed=SEED, degree=5.0)
    W = p.meta["W"]
    rep = get_solver("fabric-jax", anneal_sweeps=0.5, inner_runs=4,
                     outer_sweeps=2, mesh_devices=3, **CPU).solve(
        p, runs=2, seed=SEED)
    cut = float(maxcut_value(torch.as_tensor(W, dtype=torch.float64),
                             torch.as_tensor(rep.best_sigma[0])))
    assert cut == cut_from_energy(W, float(np.min(rep.energies[0])))


def test_fabric_duel_graph_cut_matches_reference():
    """The N=2000 duel with its recorded settings (inner_runs 4, outer
    sweeps 2, anneal_sweeps 0.5, 4 restarts, seed 1207, K = 8): the
    reference's best cut (BENCH_fabric.json records 4144)."""
    kw = dict(anneal_sweeps=0.5, inner_runs=4, outer_sweeps=2)
    p = gset_problem(2000, seed=1209, degree=6.0)
    rep = get_solver("fabric-jax", mesh_devices=8, **kw, **CPU).solve(
        p, runs=4, seed=1207)
    ref = r_get_solver("fabric-jax", **kw).solve(
        r_gset_problem(2000, seed=1209, degree=6.0), runs=4, seed=1207)
    W = p.meta["W"]
    cut = cut_from_energy(W, float(np.min(rep.energies[0])))
    assert cut == r_cut_from_energy(W, float(np.min(ref.energies[0])))
    assert cut == 4144.0
    fab = rep.meta["fabric"]
    assert rep.dispatches == fab["n_colors"] * 2 == 4
    assert fab["color_peaks"] == [2, 2] and fab["n_tiles"] == [32]


def test_fabric_solver_small_n_matches_reference():
    """fabric-jax delegates N <= 64 to the engine in both packages: under
    the default schedule >= 99% of the runs' energies equal."""
    rp = RProblem.maxcut(24, density=0.5, seed=3)
    p = Problem.maxcut(24, density=0.5, seed=3)
    assert p.content_hash == rp.content_hash
    rep = get_solver("fabric-jax", **CPU).solve(p, runs=8, seed=1)
    ref = r_get_solver("fabric-jax").solve(rp, runs=8, seed=1)
    assert rep.dispatches == ref.dispatches == 1
    assert (np.asarray(rep.energies[0]) ==
            np.asarray(ref.energies[0])).mean() >= 0.99
