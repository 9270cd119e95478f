"""The port's sharding layer (``distributed.sharding``, ``launch.mesh``,
``models.common``'s mesh names, ``distributed.elastic``'s remesh, MoE's F
slices, the trainer's ``mesh=`` and ``Checkpointer.restore(shardings=)``)
against the JAX package's.

Exactness, fixed before the port was written:
  * exact: every spec (the port's tuple against ``tuple(reference P)``),
    ``largest_mesh_shape``, the production meshes' shapes and names, the
    local shapes a spec implies on a fake world's ranks;
  * bitwise: MoE's path under a (1, 1) mesh against the path with no
    mesh, the trainer's losses under ``make_host_mesh('cpu')`` against the
    step function run with no mesh active, a restore with ``shardings=``;
  * ``tests/test_torch_moe.py``'s rtol=1e-4, atol=1e-5: MoE's slices at
    tp = 2, 4 and the reference's ``shard_map`` path at tp = 1.

Tests that need a process group run it in a child process (``"fake"``
backend, no devices): a default group would leak into the next test file
of the same worker.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.distributed import elastic as r_elastic
from repro.distributed import sharding as r_sharding
from repro.launch import mesh as r_mesh
from repro.models import build as r_build
from repro.models import common as r_common
from repro.models.moe import apply_moe as r_apply_moe
from repro.models.moe import init_moe as r_init_moe
from repro_torch import configs
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import SyntheticLM
from repro_torch.distributed import elastic, sharding
from repro_torch.launch.mesh import (activate_mesh, make_host_mesh,
                                     virtual_mesh)
from repro_torch.launch.train import train
from repro_torch.models import common, moe
from repro_torch.optim import AdamWConfig
from repro_torch.pytree import flatten_with_paths, leaves
from repro_torch.training import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
#: every arch of the registry with a model (ising64 has none)
ARCHS = sorted(a for a, c in r_configs.REGISTRY.items()
               if c.family != "ising")


class _FakeMesh:
    """Axis sizes only (the reference test's idiom), with the axis names
    the reference's cache and batch rules read."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _leaf(shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _spec_pair(path, shape, arch, tp):
    cfg, r_cfg = configs.get_config(arch), r_configs.get_config(arch)
    return (sharding.param_spec(path, shape, cfg, tp),
            tuple(r_sharding.param_spec(path, _leaf(shape), r_cfg, tp)))


# -- the reference's three spec tests, case for case -------------------------

@pytest.mark.parametrize("path,shape,want", [
    (("blocks", "attn", "wq"), (28, 3584, 28, 128), (None, None, "model", None)),
    (("blocks", "attn", "wo"), (28, 28, 128, 3584), (None, "model", None, None)),
    (("blocks", "attn", "wk"), (28, 3584, 4, 128), (None, None, None, None)),
    (("embed",), (152064, 3584), ("model", None)),
    (("head",), (3584, 152064), (None, "model")),
    (("blocks", "norm1", "w"), (28, 3584), (None, None)),
])
def test_param_spec_rules(path, shape, want):
    port, ref = _spec_pair(path, shape, "qwen2-7b", 16)
    assert port == ref == want


@pytest.mark.parametrize("arch,path,shape,want", [
    ("olmoe-1b-7b", ("blocks", "ffn", "wi"), (16, 64, 2048, 1024),
     (None, None, None, "model")),
    ("granite-moe-3b-a800m", ("blocks", "ffn", "wi"), (32, 40, 1536, 512),
     (None, None, None, "model")),
    ("granite-moe-3b-a800m", ("blocks", "ffn", "wo"), (32, 40, 512, 1536),
     (None, None, "model", None)),
])
def test_moe_spec_f_sharded(arch, path, shape, want):
    port, ref = _spec_pair(path, shape, arch, 16)
    assert port == ref == want


@pytest.mark.parametrize("s,shape,want", [
    (("model", None), (49155, 1536), (None, None)),
    (("model", None), (49152, 1536), ("model", None)),
    ((("data", "model"), None), (512, 4), (("data", "model"), None)),
    ((("data", "model"), None), (100, 4), (None, None)),
])
def test_fit_spec_drops_indivisible(s, shape, want):
    mesh = _FakeMesh({"model": 16, "data": 16})
    from jax.sharding import PartitionSpec as P
    assert sharding.fit_spec(s, shape, mesh) == \
        tuple(r_sharding.fit_spec(P(*s), shape, mesh)) == want


# -- every leaf of every config ----------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_param_leaves(arch):
    """(path keys, shape) of every leaf of the reference's full-size init,
    from ``jax.eval_shape`` (nothing is allocated)."""
    shapes = jax.eval_shape(r_build(r_configs.get_config(arch)).init,
                            jax.random.PRNGKey(0))
    return [(tuple(p.key for p in path), tuple(leaf.shape)) for path, leaf
            in jax.tree_util.tree_flatten_with_path(shapes)[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_equals_reference_for_every_leaf(arch):
    mesh = _FakeMesh({"data": 16, "model": 16})
    for tp in (1, 16):
        for path, shape in _ref_param_leaves(arch):
            port, ref = _spec_pair(path, shape, arch, tp)
            assert port == ref, (arch, tp, path)
            assert sharding.fit_spec(port, shape, mesh) == tuple(
                r_sharding.fit_spec(r_sharding.param_spec(
                    path, _leaf(shape), r_configs.get_config(arch), tp),
                    shape, mesh)), (arch, tp, path)


MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 4, "model": 1}]


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if r_configs.get_config(a).has_decode])
def test_cache_spec_equals_reference_for_every_leaf(arch):
    cfg, r_cfg = configs.get_config(arch), r_configs.get_config(arch)
    r_model = r_build(r_cfg)
    for batch in (1, 4, 256):
        cache = jax.eval_shape(functools.partial(r_model.init_cache, batch,
                                                 4096))
        for axes in MESHES:
            mesh = _FakeMesh(axes)
            for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
                keys, shape = tuple(p.key for p in path), tuple(leaf.shape)
                port = sharding.cache_spec(keys, shape, mesh, cfg, batch)
                ref = r_sharding.cache_spec(keys, leaf, mesh, r_cfg, batch)
                assert port == tuple(ref), (arch, batch, axes, keys)
                assert sharding.fit_spec(port, shape, mesh) == tuple(
                    r_sharding.fit_spec(ref, shape, mesh))


@pytest.mark.parametrize("axes", MESHES)
def test_batch_spec_equals_reference(axes):
    mesh = _FakeMesh(axes)
    for ndim in (1, 2, 3):
        for batch in (1, 4, 16, 256, 512):
            assert sharding.batch_spec(mesh, ndim, batch) == tuple(
                r_sharding.batch_spec(mesh, ndim, batch))
    assert sharding.batch_axes(mesh) == tuple(r_sharding.batch_axes(mesh))
    assert sharding.data_size(mesh) == r_sharding.data_size(mesh)
    assert sharding.tp_size(mesh) == r_sharding.tp_size(mesh)


def test_largest_mesh_shape_equals_reference():
    for n in (1, 2, 3, 6, 15, 16, 17, 64, 100, 255, 256, 257, 511, 512, 1024):
        for tp in (1, 2, 4, 8, 16, 32):
            for pods in (1, 2, 4):
                assert elastic.largest_mesh_shape(n, tp, pods) == \
                    r_elastic.largest_mesh_shape(n, tp, pods), (n, tp, pods)


# -- meshes and the ambient mesh ---------------------------------------------

def test_host_and_virtual_meshes():
    m = make_host_mesh("cpu")
    assert m.shape == {"data": 1, "model": 1} and m.device_mesh is None
    assert m.torch_device == torch.device("cpu")
    v = virtual_mesh((2, 4), ("data", "model"), "cpu")
    assert v.shape == {"data": 2, "model": 4}
    with pytest.raises(ValueError):
        virtual_mesh((2, 4), ("data",), "cpu")
    with pytest.raises(ValueError):
        virtual_mesh((0, 4), ("data", "model"), "cpu")
    r = elastic.remesh(list(range(6)), 2, torch_device="cpu")
    assert r.shape == {"data": 3, "model": 2} and r.device_mesh is None
    r = elastic.remesh(list(range(12)), 2, pods=2, torch_device="cpu")
    assert r.shape == {"pod": 2, "data": 3, "model": 2}


@pytest.mark.parametrize("axes,sizes", [
    (("data", "model"), (2, 4)), (("pod", "data", "model"), (2, 2, 2)),
    (("model",), (4,)), (("data",), (4,))])
def test_logical_equals_reference(axes, sizes):
    """``logical`` and ``active_mesh`` under an active mesh, against the
    reference under an abstract mesh of the same names and sizes."""
    from jax.sharding import AbstractMesh, AxisType
    r_mesh_ = AbstractMesh(sizes, axes, axis_types=(AxisType.Auto,) *
                           len(axes))
    names = [("batch", None, "model"), ("model",), ("batch",), (None, "x")]
    assert common.active_mesh() is None
    assert common.logical("batch", "model") == (None, None)
    x = torch.ones(2)
    assert common.shard(x, "batch") is x
    with activate_mesh(virtual_mesh(sizes, axes, "cpu")) as m, \
            jax.sharding.use_abstract_mesh(r_mesh_):
        assert common.active_mesh() is m
        for n in names:
            assert common.logical(*n) == tuple(r_common.logical(*n)), n
        assert common.shard(x, "batch") is x       # virtual: identity
    assert common.active_mesh() is None


# -- MoE's F slices on a virtual mesh ----------------------------------------

def _moe_case(seed, b=2, s=12, d=16, f=32, e=8):
    r_p = r_init_moe(jax.random.PRNGKey(seed), d, f, e)
    p = {k: torch.as_tensor(np.array(v)) for k, v in r_p.items()}
    x = np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)
    return r_p, p, x


@pytest.mark.parametrize("seed,k", [(0, 2), (1, 4)])
def test_moe_slices_match_the_unsliced_path_and_the_reference(seed, k,
                                                              monkeypatch):
    r_p, p, x = _moe_case(seed)
    xt = torch.as_tensor(x)
    with torch.no_grad():
        whole = moe.apply_moe(p, xt, top_k=k)
        seen = []
        real = moe.route
        monkeypatch.setattr(moe, "route", lambda *a, **kw: seen.append(
            real(*a, **kw)) or seen[-1])
        sliced = {}
        for tp in (1, 2, 4):
            with activate_mesh(virtual_mesh((1, tp), ("data", "model"),
                                            "cpu")):
                sliced[tp] = moe.apply_moe(p, xt, top_k=k)
    ref = np.asarray(r_apply_moe(r_p, jnp.asarray(x), top_k=k))
    with r_mesh.activate_mesh(r_mesh.make_host_mesh()):
        ref_sm = np.asarray(r_apply_moe(r_p, jnp.asarray(x), top_k=k))
    assert torch.equal(sliced[1], whole)
    # routing is computed once a call, the same at every tp
    assert len(seen) == 3 and all(
        torch.equal(r[key], seen[0][key]) for r in seen
        for key in ("se", "keep", "dest", "idx"))
    np.testing.assert_allclose(sliced[1].numpy(), ref_sm, rtol=RTOL,
                               atol=ATOL)
    for tp in (2, 4):
        np.testing.assert_allclose(sliced[tp].numpy(), ref, rtol=RTOL,
                                   atol=ATOL)


def test_moe_takes_the_unsliced_path_when_tp_does_not_divide():
    _, p, x = _moe_case(2, b=3, f=24)
    xt = torch.as_tensor(x)
    with torch.no_grad():
        whole = moe.apply_moe(p, xt, top_k=2)
        for shape in ((1, 5), (2, 2)):       # F % 5, B % 2
            with activate_mesh(virtual_mesh(shape, ("data", "model"),
                                            "cpu")):
                assert torch.equal(moe.apply_moe(p, xt, top_k=2), whole)


# -- the trainer and the checkpointer under a mesh ---------------------------

def test_train_under_the_host_mesh_is_bitwise(tmp_path):
    """``train`` under a mesh against the step function with no mesh
    active: reduced olmoe, whose MoE layers run as F slices under the
    mesh, forward and backward."""
    kw = dict(batch=4, seq=32, ckpt_every=3, reduced=True, torch_device="cpu")
    cfg = dataclasses.replace(configs.get_config("olmoe-1b-7b").reduced(),
                              dtype="float32")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), total_steps=10_000,
                           warmup_steps=5)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    assert common.active_mesh() is None
    plain = []
    for i in range(4):
        tokens, labels = ds.batch_at(i)
        state, m = step(state, {"tokens": torch.as_tensor(tokens),
                                "labels": torch.as_tensor(labels)})
        plain.append(float(m["loss"]))
    meshed = train("olmoe-1b-7b", steps=4, ckpt_dir=str(tmp_path / "b"),
                   mesh=make_host_mesh("cpu"), **kw)
    assert meshed == plain
    # the restart restores with shardings and replays bitwise
    resumed = train("olmoe-1b-7b", steps=4, ckpt_dir=str(tmp_path / "c"),
                    mesh=make_host_mesh("cpu"), **dict(kw, ckpt_every=2))
    train("olmoe-1b-7b", steps=2, ckpt_dir=str(tmp_path / "d"),
          mesh=make_host_mesh("cpu"), **dict(kw, ckpt_every=2))
    again = train("olmoe-1b-7b", steps=4, ckpt_dir=str(tmp_path / "d"),
                  mesh=make_host_mesh("cpu"), **dict(kw, ckpt_every=2))
    assert again == resumed[2:] == plain[2:]


def test_train_refuses_a_mesh_on_another_device(tmp_path, monkeypatch):
    mesh = make_host_mesh("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="mesh is on"):
        train("qwen3-0.6b", steps=1, batch=2, seq=8,
              ckpt_dir=str(tmp_path), mesh=mesh, torch_device="cuda")


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
def test_restore_with_shardings_is_bitwise(tmp_path, mesh_shape):
    cfg = configs.get_config("olmoe-1b-7b").reduced()
    state = init_train_state(cfg, torch.Generator().manual_seed(3), "cpu")
    Checkpointer(str(tmp_path)).save(1, state)
    mesh = virtual_mesh(mesh_shape, ("data", "model"), "cpu")
    shardings = sharding.param_shardings(mesh, cfg, state)
    template = init_train_state(cfg, torch.Generator().manual_seed(4), "cpu")
    restored, meta = Checkpointer(str(tmp_path)).restore(
        template, shardings=shardings)
    assert meta["step"] == 1
    assert all(torch.equal(a, b) for a, b in zip(leaves(restored),
                                                 leaves(state)))
    # the moments follow their parameters' rule; the step is replicated
    flat = dict(flatten_with_paths(shardings))
    assert flat[".params|blocks|ffn|wi"].spec == \
        flat[".opt|m|blocks|ffn|wi"].spec
    assert flat[".step"].spec == ()


# -- a fake world: meshes of processes ---------------------------------------

def _in_world(world: int, body: str) -> dict:
    """Run ``body`` as rank 0 of a fake ``torch.distributed`` world of
    ``world`` ranks in a child process; it prints one JSON line."""
    code = textwrap.dedent(f"""
        import json
        import torch
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size={world})
    """) + textwrap.dedent(body)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("multi_pod,world", [(False, 256), (True, 512)])
def test_production_mesh_in_a_fake_world(multi_pod, world, monkeypatch):
    got = _in_world(world, f"""
        from repro_torch.launch.mesh import make_production_mesh
        m = make_production_mesh(multi_pod={multi_pod}, torch_device="cpu")
        try:
            make_production_mesh(multi_pod={not multi_pod},
                                 torch_device="cpu")
            wrong = "no error"
        except RuntimeError as e:
            wrong = "raised"
        print(json.dumps({{"shape": list(m.sizes),
                          "names": list(m.axis_names),
                          "dm": list(m.device_mesh.shape),
                          "dm_names": list(m.device_mesh.mesh_dim_names),
                          "wrong_world": wrong}}))
    """)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert tuple(got["shape"]) == shape
    assert tuple(got["names"]) == names
    # the DeviceMesh lays 'pod' and 'data' out as one batch dimension
    assert tuple(got["dm"]) == ((32, 16) if multi_pod else shape)
    assert tuple(got["dm_names"]) == (("pod_data", "model") if multi_pod
                                      else names)
    assert got["wrong_world"] == "raised"
    # the shape and names the reference's make_production_mesh asks jax for
    monkeypatch.setattr(r_mesh.jax, "make_mesh",
                        lambda shape, axes, **kw: (shape, axes))
    assert r_mesh.make_production_mesh(multi_pod=multi_pod) == (shape, names)


def test_production_mesh_needs_a_world():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="initialised world"):
        make_production_mesh(torch_device="cpu")


def _local_shapes_implied(arch, sizes):
    """{path: local shape} the reference's fitted specs imply on a mesh of
    ``sizes`` for the reduced config's leaves."""
    r_cfg = dataclasses.replace(r_configs.get_config(arch),
                                **dataclasses.asdict(
                                    configs.get_config(arch).reduced()))
    shapes = jax.eval_shape(r_build(r_cfg).init, jax.random.PRNGKey(0))
    mesh = _FakeMesh(sizes)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = tuple(p.key for p in path)
        spec = r_sharding.fit_spec(r_sharding.param_spec(
            keys, leaf, r_cfg, sizes["model"]), leaf.shape, mesh)
        local = list(leaf.shape)
        for i, entry in enumerate(tuple(spec)):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    local[i] //= sizes[a]
        out["|".join(keys)] = local
    return out


def test_param_shardings_on_a_fake_world():
    got = _in_world(4, """
        from repro_torch.configs import get_config
        from repro_torch.distributed import param_shardings, remesh
        from repro_torch.distributed.sharding import NamedSharding, place_tree
        from repro_torch.launch.mesh import activate_mesh
        from repro_torch.models import build
        from repro_torch.models.common import shard
        from repro_torch.models.moe import apply_moe
        from repro_torch.pytree import flatten_with_paths
        mesh = remesh(list(range(4)), 2, torch_device="cpu")
        out = {"mesh": list(mesh.sizes), "names": list(mesh.axis_names)}
        for arch in ("qwen3-0.6b", "olmoe-1b-7b"):
            cfg = get_config(arch).reduced()
            params = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
            placed = place_tree(params, param_shardings(mesh, cfg, params))
            out[arch] = {k: list(t.to_local().shape)
                         for k, t in flatten_with_paths(placed)}
        with activate_mesh(mesh):
            x = NamedSharding(mesh, ()).place(torch.ones(8, 6))
            y = shard(x, "batch", "model")
            out["shard"] = [p.dim if p.is_shard() else None
                            for p in y.placements]
            out["shard_local"] = list(y.to_local().shape)
            try:
                shard(torch.ones(2), "batch")
                out["plain"] = "no error"
            except TypeError:
                out["plain"] = "raised"
            p = build(get_config("olmoe-1b-7b").reduced()).init(
                torch.Generator().manual_seed(0), "cpu")["blocks"]["ffn"]
            layer = {k: v[0] for k, v in p.items()}
            try:
                apply_moe(layer, torch.ones(2, 4, 128), top_k=2)
                out["moe_plain"] = "no error"
            except TypeError:
                out["moe_plain"] = "raised"
            specs = {"router": (), "wi": (None, None, "model"),
                     "wg": (None, None, "model"), "wo": (None, "model", None)}
            y = apply_moe({k: NamedSharding(mesh, specs[k]).place(v)
                           for k, v in layer.items()},
                          NamedSharding(mesh, ("data", None, None)).place(
                              torch.ones(2, 4, 128)), top_k=2)
            out["moe"] = [p.dim if p.is_shard() else None
                          for p in y.placements]
            out["moe_local"] = list(y.to_local().shape)
        print(json.dumps(out))
    """)
    assert got["mesh"] == [2, 2] and got["names"] == ["data", "model"]
    for arch in ("qwen3-0.6b", "olmoe-1b-7b"):
        assert got[arch] == _local_shapes_implied(
            arch, {"data": 2, "model": 2}), arch
    assert got["shard"] == [0, 1]
    assert got["shard_local"] == [4, 3]
    assert got["plain"] == "raised"
    # MoE's F slices run across the ranks (one all-reduce over 'model');
    # its per-rank code takes DTensors only
    assert got["moe_plain"] == "raised"
    assert got["moe"] == [0, None] and got["moe_local"] == [1, 4, 128]


def test_remesh_over_six_ranks():
    got = _in_world(6, """
        from repro_torch.distributed import remesh
        m = remesh(list(range(6)), 2, torch_device="cpu")
        print(json.dumps({"shape": list(m.sizes), "names": list(m.axis_names),
                          "dm": list(m.device_mesh.shape)}))
    """)
    assert got == {"shape": [3, 2], "names": ["data", "model"],
                   "dm": [3, 2]}
    assert tuple(got["shape"]) == r_elastic.largest_mesh_shape(6, 2)
