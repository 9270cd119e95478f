"""The port's dry-run (``launch.dryrun``, ``models.zoo.input_specs`` /
``cache_specs``, ``pytree.eval_shape``, ``roofline.op_cost``'s per-rank
count), the models on DTensors over fake worlds (the reference's sharding
constraints) and MoE's F slices across real ranks, against the JAX
package's.

Exactness, fixed before the port was written:
  * exact: the inputs' and decode caches' shapes and dtypes for every
    cell against the reference's ``jax.eval_shape``; parameter counts and
    per-rank parameter bytes on both production meshes against the
    reference's fitted specs; ``model_flops`` of every cell, Ising
    included; the (1, 1) trace's FLOPs, bytes, peak and argument bytes
    against ``op_cost.analyze`` of the real step; per-rank FLOPs on a
    (4, 1) world against the (1, 1) count at a quarter of the batch; a
    megatron pair's local FLOPs and its all-reduce's bytes on (16, 16);
    reduced zamba2's and rwkv6's per-rank counts on (2, 2, 2) against
    (4, 2);
  * bounds: full-width zamba2-7b (6 layers) and rwkv6-3b (1 layer) at
    train_4k and prefill_32k count 0.5-1.5x the reference's compiled
    per-device FLOPs on (16, 16) and (2, 16, 16), and the train steps'
    (2, 16, 16) count is 0.49-0.52 of their (16, 16) count;
  * bitwise: MoE's F slices across 2 gloo ranks against the virtual
    (1, 2) mesh, and the routing at tp = 2 and 4;
  * ``tests/test_torch_moe.py``'s rtol=1e-4, atol=1e-5: the slices across
    4 gloo ranks, every gradient of the MoE layer, and the losses and
    three decode steps' logits of reduced qwen3-0.6b, hubert-xlarge,
    zamba2-7b and rwkv6-3b on (1, 2), (2, 2) and (2, 1, 2) gloo meshes
    against one process, qwen3-0.6b's prefill logits and KV cache there,
    and heads that 'model' does not divide on (1, 2);
    their gradients at ``tests/test_torch_train.py``'s rtol 1e-3, atol
    1e-4 of each leaf's largest magnitude.

A fake world (``"fake"`` backend) and a gloo world each run in child
processes, so no default group leaks into the next test of a worker.
"""
import ast
import functools
import json
import os
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.configs.base import SHAPES as R_SHAPES
from repro.core import DeviceModel as RDeviceModel
from repro.distributed import sharding as r_sharding
from repro.models import build as r_build
from repro.models import cache_specs as r_cache_specs
from repro.models import input_specs as r_input_specs
from repro.roofline import analysis as r_analysis
from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core import DeviceModel
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import cache_specs, input_specs
from repro_torch.pytree import eval_shape, flatten_with_paths, leaves
from repro_torch.roofline import analyze, count_params, model_flops
from repro_torch.training import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
ARCHS = sorted(a for a, c in r_configs.REGISTRY.items()
               if c.family != "ising")
CELLS = [(a, s) for a, s, _ in configs.cells()]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def _spawn_world(world: int, body: str) -> subprocess.Popen:
    """``body`` as rank 0 of a fake world of ``world`` ranks in a child
    process, started; it prints one JSON line (``_read``)."""
    code = textwrap.dedent(f"""
        import json
        import logging
        import torch
        torch.set_num_threads(1)
        from repro_torch.launch.dryrun import init_fake_world
        init_fake_world({world})
        logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
        logging.getLogger("torch._logging").setLevel(logging.ERROR)
    """) + textwrap.dedent(body)
    return subprocess.Popen([sys.executable, "-c", code], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _read(proc: subprocess.Popen, timeout: int = 240) -> dict:
    """The JSON line a child process printed last."""
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def _in_world(world: int, body: str, timeout: int = 240) -> dict:
    return _read(_spawn_world(world, body), timeout)


def _sds(t):
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    if isinstance(t, torch.Tensor):
        return tuple(t.shape), str(t.dtype).split(".")[-1]
    return tuple(t.shape), str(jnp.dtype(t.dtype))


# -- shape stand-ins ---------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_and_cache_specs_equal_reference(arch, shape):
    cfg, r_cfg = configs.get_config(arch), r_configs.get_config(arch)
    got = input_specs(cfg, SHAPES[shape])
    want = r_input_specs(r_cfg, R_SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device.type == "meta"
        assert _sds(got[k]) == _sds(want[k]), k
    if not SHAPES[shape].is_decode:
        return
    got = flatten_with_paths(cache_specs(cfg, SHAPES[shape]))
    want = jax.tree_util.tree_flatten_with_path(
        r_cache_specs(r_cfg, R_SHAPES[shape]))[0]
    want = {"|".join(p.key for p in path): leaf for path, leaf in want}
    assert [k for k, _ in got] == sorted(want)
    for k, leaf in got:
        if k == "pos":               # the port's position is a Python int
            assert leaf == 0 and _sds(want[k]) == ((), "int32")
            continue
        assert leaf.device.type == "meta" and _sds(leaf) == _sds(want[k]), k


def test_eval_shape_of_a_7b_init_draws_and_allocates_nothing():
    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    cfg = configs.get_config("qwen2-7b")
    before, t0 = rss(), time.perf_counter()
    state = eval_shape(init_train_state, cfg,
                       torch.Generator().manual_seed(0), "cpu")
    wall = time.perf_counter() - t0
    n = count_params(state.params)
    assert n > 7e9 and wall < 60
    assert rss() - before < 2**30          # 3 x 30 GB of float32 otherwise
    assert {t.device.type for t in leaves(state)} == {"meta"}
    r_params = jax.eval_shape(r_build(r_configs.get_config("qwen2-7b")).init,
                              jax.random.PRNGKey(0))
    assert n == r_analysis.count_params(r_params)


# -- parameter bytes per rank and model FLOPs --------------------------------

@functools.lru_cache(maxsize=None)
def _param_shapes(arch: str):
    return dryrun._param_shapes(configs.get_config(arch))


@functools.lru_cache(maxsize=None)
def _production_world(multi_pod: bool) -> dict:
    """{arch: this rank's parameter bytes} as the dry-run places each
    full-size model (its shapes made here) on a production mesh."""
    shapes = {a: [[p, list(t.shape), str(t.dtype).split(".")[-1]]
                  for p, t in flatten_with_paths(_param_shapes(a))]
              for a in ARCHS}
    return _in_world(512 if multi_pod else 256, f"""
        from repro_torch.configs import get_config
        from repro_torch.distributed import param_shardings
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.pytree import SEP
        mesh = make_production_mesh(multi_pod={multi_pod},
                                    torch_device="cpu")
        out = {{}}
        for arch, flat in {shapes!r}.items():
            params = {{}}
            for path, shape, dtype in flat:
                node = params
                *keys, last = path.split(SEP)
                for k in keys:
                    node = node.setdefault(k, {{}})
                node[last] = torch.empty(shape, dtype=getattr(torch, dtype),
                                         device="meta")
            cfg = get_config(arch)
            out[arch] = dryrun._local_bytes(dryrun._placed(
                params, param_shardings(mesh, cfg, params)))
        print(json.dumps(out))
    """)


def _reference_bytes_per_rank(arch, sizes):
    """The reference's per-device parameter bytes: ``eval_shape`` of its
    init, each leaf's fitted spec's local shape (as
    ``test_torch_sharding._local_shapes_implied`` reads it)."""
    r_cfg = r_configs.get_config(arch)
    shapes = jax.eval_shape(r_build(r_cfg).init, jax.random.PRNGKey(0))

    class _Mesh:
        shape = sizes
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = tuple(p.key for p in path)
        spec = r_sharding.fit_spec(r_sharding.param_spec(
            keys, leaf, r_cfg, sizes["model"]), leaf.shape, _Mesh)
        local = list(leaf.shape)
        for i, entry in enumerate(tuple(spec)):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    local[i] //= sizes[a]
        total += int(np.prod(local)) * jnp.dtype(leaf.dtype).itemsize
    return r_analysis.count_params(shapes), total


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_per_rank_equal_reference(arch, multi_pod):
    sizes = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    n = count_params(_param_shapes(arch))
    nbytes = _production_world(multi_pod)[arch]
    assert (n, nbytes) == _reference_bytes_per_rank(arch, sizes)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_of_every_cell_equal_reference(arch):
    cfg, r_cfg = configs.get_config(arch), r_configs.get_config(arch)
    params = _param_shapes(arch)
    r_params = jax.eval_shape(r_build(r_cfg).init, jax.random.PRNGKey(0))
    for a, shape in CELLS:
        if a == arch:
            assert model_flops(cfg, SHAPES[shape], params) == \
                r_analysis.model_flops(r_cfg, R_SHAPES[shape], r_params)


@pytest.mark.parametrize("key", sorted(configs.ISING_SHAPES))
def test_ising_model_flops_equal_reference(key):
    spec = configs.ISING_SHAPES[key]
    n, p, r = spec["n_spins"], spec["problems"], spec["runs"]
    dev = DeviceModel(n_spins=n, compute_dtype="bfloat16")
    r_dev = RDeviceModel(n_spins=n, compute_dtype="bfloat16")
    # the reference's dry-run: 2.0 * n * n * R * P_ * dev.n_steps
    assert dryrun._ising_model_flops(n, p, r, dev) == \
        2.0 * n * n * r * p * r_dev.n_steps


# -- the per-rank count is exact ---------------------------------------------

def _qwen3_batch(cfg, b, s):
    g = torch.Generator().manual_seed(1)
    return {k: torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                             dtype=torch.int32) for k in ("tokens", "labels")}


def test_count_on_the_host_mesh_equals_the_real_step():
    cfg = configs.get_config("qwen3-0.6b").reduced()
    b, s = 4, 32
    traced, _, _ = dryrun._lower(cfg, ShapeConfig("t", s, b, "train"),
                                 make_host_mesh("cpu"))
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _qwen3_batch(cfg, b, s)
    real = analyze(make_train_step(cfg), state, batch)
    assert traced.cost.flops == real.flops > 0
    assert traced.cost.bytes == real.bytes > 0
    assert traced.cost.peak_bytes == real.peak_bytes > 0
    assert traced.cost.collectives == real.collectives
    assert traced.argument_bytes == sum(
        t.numel() * t.element_size() for t in leaves((state, batch)))


def test_megatron_pair_counts_its_local_flops_and_all_reduce():
    t, d, f = 16 * 64, 256, 1024
    got = _in_world(256, f"""
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.launch.dryrun import _placed
        from repro_torch.distributed.sharding import NamedSharding
        from repro_torch.launch.mesh import activate_mesh, make_production_mesh
        from repro_torch.roofline import analyze
        mesh = make_production_mesh(torch_device="cpu")
        meta = lambda *s: torch.empty(s, device="meta")
        x, w1, w2 = _placed(
            [meta({t}, {d}), meta({d}, {f}), meta({f}, {d})],
            [NamedSharding(mesh, s) for s in
             (("data", None), (None, "model"), ("model", None))])

        def pair(x, w1, w2):
            y = (x @ w1) @ w2
            return y.redistribute(mesh.device_mesh, [Shard(0), Replicate()])
        with activate_mesh(mesh):
            cost = analyze(pair, x, w1, w2)
        print(json.dumps({{"flops": cost.flops,
                           "coll": cost.collectives}}))
    """)
    t_l, f_l = t // 16, f // 16
    assert got["flops"] == 2 * (2 * t_l * d * f_l)
    assert got["coll"] == {"all-reduce": t_l * d * 4, "all-gather": 0,
                           "reduce-scatter": 0, "all-to-all": 0,
                           "collective-permute": 0}


# -- the models on a fake world of 4 ranks ----------------------------------

#: (arch, kinds): one reduced cell of each family in the kinds it has
FAMILY_CELLS = (("qwen3-0.6b", ("train", "prefill", "decode")),
                ("olmoe-1b-7b", ("train", "prefill", "decode")),
                ("llava-next-mistral-7b", ("train", "prefill", "decode")),
                ("hubert-xlarge", ("train", "prefill")),
                ("zamba2-7b", ("train", "prefill", "decode")),
                ("rwkv6-3b", ("train", "prefill", "decode")))


@functools.lru_cache(maxsize=None)
def _world_of_4() -> dict:
    """One fake world of 4 ranks for every check that needs one (they
    share DTensor's sharding-propagation cache): the families on (2, 2),
    the forward with and without the constraints, the Ising layouts, and
    the train step's count on (4, 1)."""
    return _in_world(4, f"""
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.core import DeviceModel
        from repro_torch.distributed import param_shardings, remesh
        from repro_torch.distributed.sharding import NamedSharding
        from repro_torch.launch.dryrun import (_lower, _lower_ising,
                                               _param_shapes, _placed)
        from repro_torch.launch.mesh import activate_mesh, make_host_mesh
        from repro_torch.models import build, input_specs, transformer
        mesh = remesh(list(range(4)), 2, torch_device="cpu")
        out = {{"mesh": list(mesh.sizes)}}

        # the reference's constraints: the forward without and with them
        seen = []

        def layout(t):
            return [p.dim if p.is_shard() else
                    "R" if p.is_replicate() else str(p) for p in t.placements]

        def spy(x, *axes):
            y = repaired(x, *axes)
            if len(axes) == 3:
                seen.append(layout(y))
            return y

        def unconstrained(x, *axes):
            if len(axes) == 3:
                seen.append(layout(x))
            return x

        # the reduced arch's forward: its output's layout and each
        # boundary's, or the error it raised
        def forward(arch, constrain):
            cfg = get_config(arch).reduced()
            params = _param_shapes(cfg)
            params = _placed(params, param_shardings(mesh, cfg, params))
            batch = input_specs(cfg, ShapeConfig("t", 16, 4, "prefill"))
            batch = _placed(batch, {{k: NamedSharding(
                mesh, ("data",) + (None,) * (v.dim() - 1))
                for k, v in batch.items()}})
            seen.clear()
            transformer.shard = spy if constrain else unconstrained
            try:
                with activate_mesh(mesh):
                    h = build(cfg).forward(params, batch)
                return {{"after": layout(h), "boundaries": list(seen)}}
            except Exception as e:
                return type(e).__name__
            finally:
                transformer.shard = repaired
        repaired = transformer.shard
        out["after"] = forward("qwen3-0.6b", True)
        out["before"] = forward("qwen3-0.6b", False)
        out["encoder"] = [forward("hubert-xlarge", c) for c in (True, False)]
        cfg = get_config("hubert-xlarge").reduced()
        transformer.shard = lambda x, *axes: x
        try:
            _lower(cfg, ShapeConfig("t", 16, 4, "train"), mesh)
            out["encoder_train"] = "ran"
        except Exception as e:
            out["encoder_train"] = type(e).__name__
        finally:
            transformer.shard = repaired

        for arch, kinds in {FAMILY_CELLS!r}:
            cfg = get_config(arch).reduced()
            for kind in kinds:
                traced, _, _ = _lower(cfg, ShapeConfig("t", 16, 4, kind),
                                      mesh)
                out[arch + "/" + kind] = [traced.cost.flops,
                                          sum(traced.cost.collectives
                                              .values())]

        dev = DeviceModel(n_spins=64, anneal_sweeps=0.0625)
        out["steps"] = dev.n_steps
        for layout in ("runs", "spins"):
            traced, _ = _lower_ising(64, 4, 8, dev, mesh, layout)
            out[layout] = [traced.cost.flops,
                           sum(traced.cost.collectives.values())]

        cfg = get_config("qwen3-0.6b").reduced()
        data = remesh(list(range(4)), 1, torch_device="cpu")
        world, _, _ = _lower(cfg, ShapeConfig("t", 16, 8, "train"), data)
        host, _, _ = _lower(cfg, ShapeConfig("t", 16, 2, "train"),
                            make_host_mesh("cpu"))
        out["data_mesh"] = list(data.sizes)
        out["data_world"] = [world.cost.flops,
                             world.cost.collectives["all-reduce"]]
        out["data_host"] = host.cost.flops
        print(json.dumps(out))
    """)


def test_sharding_constraints_repair_the_forward_on_a_2x2_world():
    """With the reference's constraints the hidden states are
    batch-sharded at every block boundary. Without them a token model's
    forward lays out every boundary alike, since its embedding and blocks
    are per-rank code that leaves each output in that layout (the
    vocab-parallel embedding gives whole rows, not partial ones); the
    encoder's conv positional embedding leaves its output split over
    'model', which without the constraints stays so at every boundary, and
    its train step fails (DTensor cannot redistribute between a partial
    sum and the partial mean the norms leave)."""
    got = _world_of_4()
    assert got["mesh"] == [2, 2]
    # the embedding's, the stream's input (the reference's
    # transformer.py:205) and each of the 2 blocks' after attention and
    # after the MLP (:182, :184)
    after = got["after"]
    assert len(after["boundaries"]) == 6
    assert all(p == [0, "R"] for p in after["boundaries"])
    assert after["after"] == [0, "R"]
    assert got["before"] == after
    # the encoder's stream's input and its 2 blocks' boundaries: split
    # over 'model' without the constraints, and the final norm's mean over
    # the split channels left partial
    with_, without = got["encoder"]
    assert with_ == {"after": [0, "R"], "boundaries": [[0, "R"]] * 5}
    assert without == {"after": [0, "P(avg)"], "boundaries": [[0, 2]] * 5}
    assert got["encoder_train"] == "AssertionError"


@pytest.mark.parametrize("arch,kinds", FAMILY_CELLS)
def test_every_family_traces_on_a_2x2_world(arch, kinds):
    got = _world_of_4()
    for kind in kinds:
        flops, coll = got[f"{arch}/{kind}"]
        assert flops > 0 and coll > 0, (arch, kind)


def test_ising_layouts_runs_local_and_spins_exchanging():
    """'runs' moves nothing; 'spins' gathers a rank's 2 problems x 8 runs
    of int8 spins each step (the reference's ``_replicate_spin_axis``:
    1 byte a spin, where the scaled f32 spins would be 4) and the f32
    readout once for the energy."""
    got = _world_of_4()
    assert got["steps"] == 32
    assert got["runs"][1] == 0 and got["runs"][0] > 0
    assert got["spins"][0] > 0
    assert got["spins"][1] == got["steps"] * 2 * 8 * 64 + 2 * 8 * 64 * 4


def test_count_per_rank_on_a_4x1_world_is_the_count_of_its_batch():
    got = _world_of_4()
    assert got["data_mesh"] == [4, 1]
    flops, all_reduce = got["data_world"]
    assert flops == got["data_host"] > 0
    assert all_reduce > 0                        # the gradients' reduction


def test_recurrent_families_count_alike_over_pod_and_data():
    """Reduced zamba2 / rwkv6 train steps on a fake world of 8 ranks:
    (2, 2, 2) ("pod", "data", "model") splits the batch over 'pod' and
    'data' as (4, 2) splits it over 'data', so each rank's count (FLOPs,
    bytes, peak, every collective kind, argument bytes) is the same, and
    DTensor plans no more layouts (on a three-dimensional DeviceMesh it
    planned thousands more, each a graph search, 30-50 times the wall)."""
    got = _in_world(8, """
        from torch.distributed.tensor import _redistribute
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.distributed import remesh
        from repro_torch.launch.dryrun import _lower
        plan = _redistribute._gen_transform_infos_non_cached
        plans = [0]

        def counted(*a, **k):
            plans[0] += 1
            return plan(*a, **k)
        _redistribute._gen_transform_infos_non_cached = counted
        out = {}
        for pods in (1, 2):
            mesh = remesh(list(range(8)), 2, pods=pods, torch_device="cpu")
            for arch in ("zamba2-7b", "rwkv6-3b"):
                _redistribute._gen_transform_infos.cache_clear()
                plans[0] = 0
                traced, _, _ = _lower(get_config(arch).reduced(),
                                      ShapeConfig("t", 16, 8, "train"), mesh)
                c = traced.cost
                out[f"{arch}/{pods}"] = {
                    "mesh": list(mesh.sizes), "flops": c.flops,
                    "bytes": c.bytes, "peak": c.peak_bytes,
                    "collectives": c.collectives,
                    "args": traced.argument_bytes, "plans": plans[0]}
        print(json.dumps(out))
    """)
    for arch in ("zamba2-7b", "rwkv6-3b"):
        two, three = got[f"{arch}/1"], got[f"{arch}/2"]
        assert two.pop("mesh") == [4, 2] and three.pop("mesh") == [2, 2, 2]
        assert two["flops"] > 0 and two["collectives"]["all-reduce"] > 0
        assert three.pop("plans") <= two.pop("plans"), arch
        assert three == two, arch


# -- the per-rank work at full width, against the reference's compiled count -

#: (arch, layers, shape): full-width configs cut in depth (zamba2-7b to one
#: attn_every period, rwkv6-3b to one layer), whose per-rank work a layer
#: is the full models'. A pair of depths (lo, hi) counts the work of the
#: layers between them, count(hi) - count(lo): rwkv6-3b's decode of one
#: sequence, whose count at any depth the head decides (XLA runs the
#: reference's head whole on every rank, 2.10e7 FLOPs; the port splits its
#: contraction over the batch axes, 1.31e6), and the decode steps whose
#: collective bytes were repaired, with their whole cells (the registry's
#: depth)
DEPTH_CUT = (("rwkv6-3b", 1, "prefill_32k"), ("zamba2-7b", 6, "prefill_32k"),
             ("rwkv6-3b", 1, "train_4k"), ("zamba2-7b", 6, "train_4k"),
             ("rwkv6-3b", (1, 2), "long_500k"),
             ("qwen3-0.6b", (1, 2), "decode_32k"),
             ("qwen3-0.6b", 28, "decode_32k"),
             ("olmoe-1b-7b", (1, 2), "decode_32k"),
             ("olmoe-1b-7b", 16, "decode_32k"),
             ("zamba2-7b", (6, 12), "decode_32k"),
             ("zamba2-7b", 81, "decode_32k"))
#: the shapes held on (2, 16, 16) as well as (16, 16)
BOTH_MESHES = ("train_4k", "long_500k", "decode_32k")
#: the most collective bytes a rank the port may move, over the
#: reference's ``collective_bytes_per_device`` (each package's all-reduce
#: counted twice)
COLL_MAX = 1.25
#: chip_smoke.py's whole dry-run cells on (16, 16): (arch, layers, shape)
CHIP_SMOKE_CELLS = (("qwen2-7b", 28, "decode_32k"),
                    ("olmoe-1b-7b", 16, "train_4k"))

_REFERENCE_COUNT = """
import dataclasses, json, sys
from repro import configs
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
from repro.roofline.analysis import HW, roofline_report
out = {}
for arch, layers, shape, multi_pod in json.loads(sys.argv[1]):
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers)
    dryrun.get_config = lambda name, cfg=cfg: cfg
    compiled, aux = dryrun.lower_cell(
        arch, shape, make_production_mesh(multi_pod=multi_pod))
    rep = roofline_report(compiled, HW(), chips=aux["chips"])
    out[f"{arch}/{layers}/{shape}/{multi_pod}"] = [
        rep["hlo_flops_per_device"], rep["collective_bytes_per_device"]]
print(json.dumps(out))
"""


def _depths(layers) -> tuple:
    return layers if isinstance(layers, tuple) else (layers,)


def _cut(count: dict, arch: str, layers, shape: str, multi_pod,
         what: int = 0) -> float:
    """A ``DEPTH_CUT`` cell's FLOPs (``what`` 0) or collective bytes (1) a
    rank from ``count`` (keyed arch/layers/shape/multi_pod): at its depth,
    or for a pair of depths the layers' between them."""
    n = [count[f"{arch}/{d}/{shape}/{multi_pod}"][what]
         for d in _depths(layers)]
    return n[-1] - (n[0] if len(n) > 1 else 0)


@functools.lru_cache(maxsize=None)
def _depth_cut_counts() -> dict:
    """Per-rank FLOPs and collective bytes of the ``DEPTH_CUT`` cells on
    (16, 16) and, for the ``BOTH_MESHES`` shapes, (2, 16, 16): the port's
    traced as rank 0 of fake worlds of 256 and 512 ranks, the reference's
    ``hlo_flops_per_device`` and ``collective_bytes_per_device`` compiled
    on 512 forced host devices (``lower_cell`` with the depth-cut config
    in place of the registry's; nothing is written), at each depth of a
    cell (keyed arch/layers/shape/multi_pod); and the reference's counts
    of ``CHIP_SMOKE_CELLS``. The children (two worlds of the port, one
    reference Python an arch) run at once."""
    def port(multi_pod):
        cells = [(a, d, s) for a, n, s in DEPTH_CUT for d in _depths(n)
                 if not multi_pod or s in BOTH_MESHES]
        return _spawn_world(512 if multi_pod else 256, f"""
            import dataclasses
            from repro_torch.configs import SHAPES, get_config
            from repro_torch.launch.dryrun import _lower
            from repro_torch.launch.mesh import make_production_mesh
            from repro_torch.roofline import roofline_report
            mesh = make_production_mesh(multi_pod={multi_pod},
                                        torch_device="cpu")
            out = {{}}
            for arch, layers, shape in {cells!r}:
                cfg = dataclasses.replace(get_config(arch), n_layers=layers)
                traced, _, _ = _lower(cfg, SHAPES[shape], mesh)
                out[f"{{arch}}/{{layers}}/{{shape}}/{multi_pod}"] = [
                    traced.cost.flops, roofline_report(traced.cost)[
                        "collective_bytes_per_device"]]
            print(json.dumps(out))
        """)

    def reference(arch):
        cells = [(a, d, s, mp) for a, n, s in DEPTH_CUT if a == arch
                 for d in _depths(n)
                 for mp in ((False, True) if s in BOTH_MESHES else (False,))]
        cells += [(a, n, s, False) for a, n, s in CHIP_SMOKE_CELLS
                  if a == arch]
        env = dict(_env(), XLA_FLAGS="--xla_force_host_platform_device_count"
                                     "=512")
        return subprocess.Popen(
            [sys.executable, "-c", _REFERENCE_COUNT, json.dumps(cells)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    archs = sorted({a for a, _, _ in DEPTH_CUT + CHIP_SMOKE_CELLS})
    procs = {"port": [port(False), port(True)],
             "reference": [reference(a) for a in archs]}
    return {k: {c: n for p in ps for c, n in _read(p, 600).items()}
            for k, ps in procs.items()}


def _chip_smoke_constant(name: str):
    """A constant of chip_smoke.py, read from its source, which imports
    CUDA-only code."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    value, = (n.value for n in tree.body if isinstance(n, ast.Assign)
              and [getattr(t, "id", None) for t in n.targets] == [name])
    return ast.literal_eval(value)


def _chip_smoke_depth_cut() -> dict:
    """chip_smoke.py's ``DRYRUN_DEPTH_CUT`` (the reference's counts the
    card's gate holds the port to): {arch/shape: [reference FLOPs a rank,
    reference collective bytes a rank]}."""
    return {f"{a}/{s}": [flops, coll] for a, _, s, flops, coll
            in _chip_smoke_constant("DRYRUN_DEPTH_CUT")}


@pytest.mark.parametrize("arch,layers,shape", DEPTH_CUT, ids=[
    "-".join(map(str, (a, *_depths(n), s))) for a, n, s in DEPTH_CUT])
def test_depth_cut_cells_do_the_references_work_a_rank(arch, layers, shape):
    """Per-rank FLOPs at full width, cut in depth, on both production
    meshes: at most 1.5x (and at least half) the reference's, and a train
    step's halving from (16, 16) to (2, 16, 16) with the batch it splits;
    for a pair of depths, the work of the layers between them. Collective
    bytes a rank (an all-gather charged its result) at most ``COLL_MAX``
    of the reference's, a layer's and a whole decode cell's.
    chip_smoke.py's copy of the reference's counts for a cell it gates is
    the count measured here."""
    got = _depth_cut_counts()
    meshes = (False, True) if shape in BOTH_MESHES else (False,)
    (port, ref), (port_coll, ref_coll) = (
        [{mp: _cut(got[k], arch, layers, shape, mp, what) for mp in meshes}
         for k in ("port", "reference")] for what in (0, 1))
    for multi_pod in meshes:
        assert 0.5 * ref[multi_pod] <= port[multi_pod] <= 1.5 * ref[
            multi_pod], (arch, layers, shape, multi_pod, port, ref)
        assert 0 < port_coll[multi_pod] <= COLL_MAX * ref_coll[
            multi_pod], (arch, layers, shape, multi_pod, port_coll, ref_coll)
    copied = _chip_smoke_depth_cut().get(f"{arch}/{shape}")
    if copied is not None:
        assert copied == [ref[False], ref_coll[False]]
    if shape == "train_4k":
        ratio = port[True] / port[False]
        assert 0.49 <= ratio <= 0.52, ratio


def test_chip_smoke_copies_the_references_whole_cell_counts():
    """chip_smoke.py's ``DRYRUN_REFERENCE``, the reference's FLOPs and
    collective bytes a rank of the whole cells its dry-run phase traces on
    (16, 16), is the count the reference's compile gives here."""
    got = _depth_cut_counts()["reference"]
    copied = _chip_smoke_constant("DRYRUN_REFERENCE")
    assert {(a, s) for a, _, s in CHIP_SMOKE_CELLS} == set(copied)
    for arch, layers, shape in CHIP_SMOKE_CELLS:
        assert copied[(arch, shape)] == got[
            f"{arch}/{layers}/{shape}/False"], (arch, shape)


def _record(directory, arch, shape, mesh, flops, coll):
    os.makedirs(directory, exist_ok=True)
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "roofline": {
        "hlo_flops_per_device": flops, "collective_bytes_per_device": coll,
        "collective_breakdown": {"all-reduce": coll / 4,
                                 "all-gather": coll / 2},
        "t_compute_s": flops / 989e12, "t_memory_s": 0.5,
        "t_collective_s": coll / 450e9, "useful_flops_ratio": 0.25},
        "memory": {"argument_size_in_bytes": 2**30,
                   "temp_size_in_bytes": 2**31}}
    with open(os.path.join(directory, f"{arch}__{shape}__{mesh}.json"),
              "w") as f:
        json.dump(rec, f)


def test_dryrun_vs_reference_reads_both_packages_records(tmp_path):
    """``scripts/torch/dryrun_vs_reference.py``: each cell's per-rank FLOPs
    and collective bytes against the reference's record of the same cell
    and mesh, with both packages' bytes by kind, and against an earlier
    run of the port."""
    import importlib.util
    path = ROOT / "scripts" / "torch" / "dryrun_vs_reference.py"
    spec = importlib.util.spec_from_file_location("dryrun_vs_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    port, ref, base = (str(tmp_path / d) for d in ("port", "ref", "base"))
    _record(port, "rwkv6-3b", "train_4k", "16x16", 3e14, 2e9)
    _record(port, "rwkv6-3b", "train_4k", "2x16x16", 1.5e14, 1e9)
    _record(ref, "rwkv6-3b", "train_4k", "16x16", 1e14, 5e9)
    _record(base, "rwkv6-3b", "train_4k", "16x16", 6e14, 4e9)
    row, = mod.main(["--port", port, "--reference", ref,
                     "--baseline", base])
    assert (row["arch"], row["shape"]) == ("rwkv6-3b", "train_4k")
    assert row["16x16"]["over_reference"] == 3.0
    assert row["16x16"]["coll_over_reference"] == 0.4
    assert row["16x16"]["breakdown"] == {
        "port": {"all-reduce": 5e8, "all-gather": 1e9},
        "reference": {"all-reduce": 1.25e9, "all-gather": 2.5e9}}
    assert row["16x16"]["flops_over_baseline"] == 0.5
    assert row["16x16"]["collectives_over_baseline"] == 0.5
    assert row["2x16x16"]["over_reference"] is None
    assert row["2x16x16"]["coll_over_reference"] is None
    assert row["16x16"]["gib"] == [1.0, 2.0]
    assert mod.table([row]).splitlines()[2].startswith(
        "| rwkv6-3b x train_4k | 1.00 / 2.00 | 303.3 / 500.0 / 4.4 | 0.250 "
        "| 3.000 | 0.400 | 0.500, 0.500 | 1.00 / 2.00 |")


def test_dryrun_split_attributes_every_flop():
    """``scripts/torch/dryrun_split.py``: a cell's per-rank FLOPs split by
    op, autograd node and model line add up to the cell's count, and its
    collective bytes split by kind, node and line to the cell's bytes of
    each kind; a collective's line is the model's, past the helpers of
    ``models/common.py``."""
    path = ROOT / "scripts" / "torch" / "dryrun_split.py"
    got = _in_world(256, f"""
        import collections
        import importlib.util
        spec = importlib.util.spec_from_file_location("dryrun_split",
                                                      {str(path)!r})
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        cost, flops, coll = mod.split("rwkv6-3b", "decode_32k", 1, 256)
        (op, node, site, _), n = flops.most_common(1)[0]
        kinds = collections.Counter()
        for (kind, _, _, _), b in coll.items():
            kinds[kind] += b
        print(json.dumps({{"total": cost.flops, "sum": sum(flops.values()),
                           "top": [op, node, site, n],
                           "coll": cost.collectives, "kinds": kinds,
                           "sites": sorted({{(k, s) for k, _, s, _
                                             in coll}})}}))
    """)
    assert got["sum"] == got["total"] > 0
    op, node, site, n = got["top"]
    assert (op, node) == ("mm.default", "fwd") and site.startswith("rwkv6")
    assert sum(got["coll"].values()) > 0
    assert got["kinds"] == {k: v for k, v in got["coll"].items() if v}
    # a collective inside the per-rank helpers names the model line that
    # called them (the decode step's gathers of r, k, v and the decay)
    assert all("common.py" not in s for _, s in got["sites"]), got["sites"]
    assert any(k == "all-gather" and s.startswith("rwkv6.py")
               for k, s in got["sites"]), got["sites"]


#: qwen3-0.6b's vocab-split table: a 'model' rank's rows of the 152,064
#: (the padded vocabulary) and their f32 gradient's bytes, the reference's
#: all-reduce f32[9504,1024]
TABLE_ROWS, TABLE = (9504, 1024), 9504 * 1024 * 4


@functools.lru_cache(maxsize=None)
def _serving_counts() -> dict:
    """On fake worlds of 256 and 512 ranks (the production meshes):
    qwen3-0.6b x train_4k at 1 layer split by ``dryrun_split.py`` (its
    collectives by kind and shapes), and two decode steps of rwkv6-3b x
    long_500k at 2 layers (one sequence), the second fed the cache the
    first returned (each step's collective bytes a rank, all-reduces
    counted twice)."""
    path = ROOT / "scripts" / "torch" / "dryrun_split.py"
    procs = {world: _spawn_world(world, f"""
        import dataclasses
        import importlib.util
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.distributed import cache_shardings, param_shardings
        from repro_torch.launch.dryrun import (_batch_shardings,
                                               _param_shapes, _placed)
        from repro_torch.launch.mesh import (activate_mesh,
                                             make_production_mesh)
        from repro_torch.models import build, cache_specs, input_specs
        from repro_torch.roofline import analyze, roofline_report
        spec = importlib.util.spec_from_file_location("dryrun_split",
                                                      {str(path)!r})
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _, _, coll = mod.split("qwen3-0.6b", "train_4k", 1, {world})
        out = {{"train": [[k, [list(t) for t in shapes], n]
                          for (k, _, _, shapes), n in coll.items()]}}

        mesh = make_production_mesh(multi_pod={world == 512},
                                    torch_device="cpu")
        cfg = dataclasses.replace(get_config("rwkv6-3b"), n_layers=2)
        shape = SHAPES["long_500k"]
        model = build(cfg)
        params = _param_shapes(cfg)
        params = _placed(params, param_shardings(mesh, cfg, params))
        cache = cache_specs(cfg, shape)
        cache = _placed(cache, cache_shardings(mesh, cfg, cache, 1))
        toks = input_specs(cfg, shape)
        toks = _placed(toks, _batch_shardings(mesh, toks, 1))["tokens"]
        out["steps"] = []
        for _ in range(2):
            new = []
            with activate_mesh(mesh):
                cost = analyze(lambda: new.append(
                    model.decode_step(params, cache, toks)))
            cache = new[0][1]
            out["steps"].append(
                roofline_report(cost)["collective_bytes_per_device"])
        print(json.dumps(out))
    """) for world in (256, 512)}
    return {w: _read(p, 300) for w, p in procs.items()}


@pytest.mark.parametrize("world", [256, 512])
def test_train_step_reduces_only_the_ranks_rows_of_the_table(world):
    """qwen3-0.6b x train_4k (1 layer, full width) as rank 0 of (16, 16)
    and (2, 16, 16): the vocab-parallel embedding's gradient is the
    rank's own rows of the table, which cross ranks once, in one
    all-reduce over the batch axes of at most 1.25x the reference's
    f32[9504,1024]; no collective moves the whole table (152,064 rows)."""
    got = _serving_counts()[world]["train"]
    assert not any([152064, 1024] in shapes for _, shapes, _ in got), got
    table = [(k, n) for k, shapes, n in got if list(TABLE_ROWS) in shapes]
    assert len(table) == 1 and table[0][0] == "all-reduce", table
    assert 0 < table[0][1] <= COLL_MAX * TABLE, table


@pytest.mark.parametrize("world", [256, 512])
def test_second_decode_step_moves_no_more_than_the_first(world):
    """rwkv6-3b x long_500k (one sequence, 2 layers, full width) as rank 0
    of (16, 16) and (2, 16, 16): a second decode step, fed the cache the
    first returned (its WKV states split over 'model' by heads, its token
    shifts over the batch axes), moves no more collective bytes a rank
    than the first, so a serving loop gathers no state."""
    first, second = _serving_counts()[world]["steps"]
    assert 0 < second <= first, (first, second)


@pytest.mark.parametrize("n,sizes", [(2560, (16, 16)), (2560, (16, 32)),
                                     (2560, (32, 16)), (64, (2, 2)),
                                     (90, (3, 4)), (90, (4, 3))])
def test_crossing_moves_each_chunk_from_its_holders(n, sizes):
    """``common._crossing``, the plan of ``model_to_batch`` and of its
    gradient (the sizes the other way round), for every rank of two mesh
    dimensions: each rank gets exactly its chunk of the split over the
    second dimension, each piece from a rank that holds it in the split
    over the first, and what a rank is sent is what its sender sends it;
    where the sizes are equal, each rank swaps its chunk with one other
    (the transposition of (16, 16))."""
    from repro_torch.models.common import _chunk, _crossing
    a, b = sizes
    plans = {(i, j): _crossing(n, sizes, (i, j))
             for i in range(a) for j in range(b)}
    for me, (sent, got) in plans.items():
        lo, hi = _chunk(n, b, me[1])
        assert [c for _, s, e in got for c in range(s, e)] == list(
            range(lo, hi))
        for src, s, e in got:
            held = _chunk(n, a, src[0])
            assert held[0] <= s < e <= held[1]
            assert src == me or (me, s, e) in plans[src][0]
        for dst, s, e in sent:
            assert (me, s, e) in plans[dst][1]
        if a == b:
            assert [src for src, _, _ in got] == [me[::-1]]


# -- a gloo world: MoE's F slices and the dense model across real ranks -------

_GLOO = """
import contextlib, json, sys
import torch
import torch.distributed as dist
rank, world, port, pods = map(int, sys.argv[1:5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from torch.distributed.tensor import DTensor
from repro_torch.distributed import remesh
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.launch.mesh import activate_mesh, virtual_mesh
from repro_torch.models import moe

full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
mesh = remesh(list(range(world)), world, torch_device="cpu")
gen = torch.Generator().manual_seed(0)
p = moe.init_moe(gen, 32, 64, 8)
x = torch.randn((2, 16, 32), generator=gen)
cot = torch.randn((2, 16, 32), generator=gen)
specs = {"router": (), "wi": (None, None, "model"),
         "wg": (None, None, "model"), "wo": (None, "model", None)}
X = ("data", None, None)


def run(m, place):
    seen = []
    route = moe.route

    def spy(*a, **k):
        seen.append(route(*a, **k))
        return seen[-1]
    moe.route = spy
    ins = {k: place(v, specs[k]).requires_grad_() for k, v in p.items()}
    xi = place(x, X).requires_grad_()
    with activate_mesh(m):
        out = moe.apply_moe(ins, xi, top_k=2)
        loss = (out * place(cot, X)).sum()
        grads = torch.autograd.grad(full(loss) if isinstance(loss, DTensor)
                                    else loss, [xi, *ins.values()])
    moe.route = route
    return full(out).detach(), [full(g) for g in grads], seen[0]


ref = run(virtual_mesh((1, world), ("data", "model"), "cpu"),
          lambda t, s: t.clone())
got = run(mesh, lambda t, s: NamedSharding(mesh, s).place(t.clone()))
res = {"mesh": list(mesh.sizes),
       "bitwise": bool(torch.equal(got[0], ref[0])),
       "max_abs": float((got[0] - ref[0]).abs().max()),
       "close": bool(torch.allclose(got[0], ref[0], rtol=1e-4, atol=1e-5)),
       "grads_close": [bool(torch.allclose(a, b, rtol=1e-4, atol=1e-5))
                       for a, b in zip(got[1], ref[1])],
       "routing_bitwise": all(torch.equal(got[2][k], ref[2][k])
                              for k in ref[2])}


# reduced models on a mesh of processes against one process: the
# constraints, per-rank attention, recurrences, conv and vocab-parallel
# CE, gradients partial over the data axis; prefill's logits and cache;
# then decode steps on a sequence-sharded cache
MODELS = [(a, a, {}) for a in ("qwen3-0.6b", "hubert-xlarge", "zamba2-7b",
                               "rwkv6-3b")]
# the dense families' other attention options on the two-axis worlds: qkv
# biases (qwen2-1.5b, chatglm3-6b) and rope on half the head dims
# (chatglm3-6b)
DENSE = [(a, a, {}) for a in ("qwen2-1.5b", "chatglm3-6b")]
# heads that 'model' = 2 does not divide: 5 RWKV heads (3 and 2 a rank),
# 5 Mamba heads (in_proj's 357 columns replicated), 1 KV head (read by
# both ranks, cached by rank 0); and an MLP width it does not divide (255:
# every rank runs the whole MLP); and a vocabulary padded from 250 to 256,
# whose logits' columns are re-cut to chunks of 125 (3 move rank)
UNEVEN = [("rwkv6-3b/5-heads", "rwkv6-3b", {"d_model": 160}),
          ("zamba2-7b/5-heads", "zamba2-7b", {"d_model": 80, "d_ff": 192}),
          ("qwen3-0.6b/1-kv-head", "qwen3-0.6b", {"n_kv_heads": 1}),
          ("qwen2-1.5b/odd-ff", "qwen2-1.5b", {"d_ff": 255}),
          ("qwen3-0.6b/padded-vocab", "qwen3-0.6b", {"vocab_size": 250})]


def models_on(m, cases):
    from repro_torch.configs import get_config
    from repro_torch.distributed import cache_shardings, param_shardings
    from repro_torch.distributed.sharding import batch_spec, place_tree
    from repro_torch.models import build
    from repro_torch.pytree import leaves, unflatten
    out = {}
    for name, arch, overrides in cases:
        cfg = get_config(arch).reduced(**overrides)
        model = build(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        g = torch.Generator().manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
                 for k in ("tokens", "labels")}
        if cfg.family == "encoder":
            batch["embeds"] = torch.randn((2, 24, cfg.d_model), generator=g)
        plain = [t.clone().requires_grad_() for t in leaves(params)]
        loss = model.loss(unflatten(params, plain), batch)
        grads = torch.autograd.grad(loss, plain, allow_unused=True,
                                    materialize_grads=True)
        placed = place_tree(params, param_shardings(m, cfg, params))
        p_leaves = [t.detach().requires_grad_() for t in leaves(placed)]
        pb = {k: NamedSharding(m, batch_spec(m, v.dim(), 2)).place(v)
              for k, v in batch.items()}
        with activate_mesh(m):
            d_loss = model.loss(unflatten(params, p_leaves), pb)
            d_grads = torch.autograd.grad(full(d_loss), p_leaves,
                                          allow_unused=True,
                                          materialize_grads=True)
        # test_torch_train.py's gradient bound: rtol 1e-3, atol 1e-4 of
        # the leaf's largest magnitude
        row = {"loss": [float(loss), float(full(d_loss))],
               "grads_close": all(bool(torch.allclose(
                   full(a), b, rtol=1e-3,
                   atol=1e-4 * float(b.abs().max()) + 1e-12))
                   for a, b in zip(d_grads, grads))}
        if cfg.has_decode and model.prefill is not None:
            with torch.no_grad():
                want = model.prefill(params, {"tokens": batch["tokens"]})
                with activate_mesh(m):
                    have = model.prefill(placed, {"tokens": pb["tokens"]})
            row["prefill_close"] = [bool(torch.allclose(
                full(a), b, rtol=1e-4, atol=1e-5)) for a, b in (
                    (have[0], want[0]), (have[1]["k"], want[1]["k"]),
                    (have[1]["v"], want[1]["v"]))]
        if cfg.has_decode:
            cache = model.init_cache(2, 16, torch_device="cpu")
            d_cache = place_tree(cache, cache_shardings(m, cfg, cache, 2))
            row["decode_close"] = []
            with torch.no_grad():
                for t in range(3):
                    tok = batch["tokens"][:, t]
                    logits, cache = model.decode_step(params, cache, tok)
                    with activate_mesh(m):
                        d_logits, d_cache = model.decode_step(
                            placed, d_cache, NamedSharding(
                                m, batch_spec(m, 1, 2)).place(tok))
                    row["decode_close"].append(bool(torch.allclose(
                        full(d_logits), logits, rtol=1e-4, atol=1e-5)))
            row["logits_local"] = list(d_logits.to_local().shape)
        out[name] = row
    return out


# a DTensor's placements: a shard's dimension, "R" or "P"
def layout(t):
    return [p.dim if p.is_shard() else "R" if p.is_replicate() else "P"
            for p in t.placements] if isinstance(t, DTensor) else None


def close(a, b):
    return bool(torch.allclose(full(a), b, rtol=1e-4, atol=1e-5))


# the vocab-parallel embedding (each rank looks its tokens up in its own
# rows of the table, the rows all-reduced over 'model') against one
# process: the lookup, and the table's gradient, each rank's own rows; a
# vocabulary of 250 padded to 256 rows (128 a 'model' rank), tokens on
# both ranks' rows, each of them twice
def embedding(m):
    from repro_torch.configs import get_config
    from repro_torch.distributed import param_shardings
    from repro_torch.distributed.sharding import batch_spec
    from repro_torch.models import transformer
    cfg = get_config("qwen3-0.6b").reduced(vocab_size=250)
    gen = torch.Generator().manual_seed(4)
    table = torch.randn((transformer.padded_vocab(cfg), cfg.d_model),
                        generator=gen)
    first = torch.randperm(cfg.vocab_size, generator=gen)[:12]
    tokens = torch.cat([first, first.flip(0)]).reshape(2, 12)
    cot = torch.randn((2, 12, cfg.d_model), generator=gen)
    rule = param_shardings(m, cfg, {"embed": table})["embed"].spec

    def run(place, ctx):
        t = place(table, rule).requires_grad_()
        with ctx():
            x = transformer._embed({"embed": t}, cfg,
                                   place(tokens, batch_spec(m, 2, 2)))
            loss = (x * place(cot, batch_spec(m, 3, 2))).sum()
            g, = torch.autograd.grad(full(loss), [t])
        return full(x).detach(), full(g), layout(g)
    want = run(lambda t, s: t.clone(), contextlib.nullcontext)
    got = run(lambda t, s: NamedSharding(m, s).place(t.clone()),
              lambda: activate_mesh(m))
    rows = table.shape[0] // m.shape["model"]
    return {"lookup_bitwise": bool(torch.equal(got[0], want[0])),
            "grad_close": bool(torch.allclose(
                got[1], want[1], rtol=1e-3,
                atol=1e-4 * float(want[1].abs().max()))),
            "grad_rows": int((want[1].abs().sum(1) > 0).sum()),
            "padded_grad_zero": bool((got[1][cfg.vocab_size:] == 0).all()),
            "grad_layout": got[2],
            "model_ranks_hit": sorted({int(t) // rows
                                       for t in tokens.flatten()})}


# RWKV-6's mixes and head for one sequence on (2, 1, 2): 'pod' and 'data'
# cannot split a batch of one, so they split the column-parallel products'
# contracted channels and the row-parallel products' output channels
# (rwkv6._Ranks), against one process: 4 heads (one a 'model' rank, as the
# decode cache splits them), 5 (3 and 2 a rank in a sequence's run; the
# cache replicates them, and a decode step runs all 5), and 4 with a decay
# lora 63 wide, which 'model' does not divide (the time mix whole over it)
ONE_SEQUENCE = {"4-heads": (64, 64), "5-heads": (80, 64),
                "whole-over-model": (64, 63)}


def one_sequence(m, d, lora):
    from repro_torch.models import rwkv6
    gen = torch.Generator().manual_seed(2)
    hd = 16
    tm = rwkv6.init_rwkv_tmix(gen, d, hd, lora)
    cm = rwkv6.init_rwkv_cmix(gen, d, 128)
    head = torch.randn((d, 256), generator=gen)
    x = torch.randn((1, 8, d), generator=gen)
    state = {"x": torch.randn((1, 1, d), generator=gen),
             "S": 0.1 * torch.randn((1, d // hd, hd, hd), generator=gen)}
    cot = [torch.randn((1, 8, d), generator=gen) for _ in range(2)]
    col, row = (None, "model"), ("model", None)
    specs = {"Wr": col, "Wk": col, "Wv": col, "Wg": col, "wA": col,
             "Wo": row}
    from repro_torch.distributed.sharding import cache_spec
    from repro_torch.configs import get_config
    s_spec = cache_spec(("S",), (1, 1) + tuple(state["S"].shape[1:]), m,
                        get_config("rwkv6-3b"), 1)[1:]
    c_specs = {"Wk": col, "Wr": col, "Wv": row}

    def run(place, ctx):
        tp = {k: place(v, specs.get(k, (None,) * v.dim())).requires_grad_()
              for k, v in tm.items()}
        cp = {k: place(v, c_specs.get(k, (None,) * v.dim())).requires_grad_()
              for k, v in cm.items()}
        xi = place(x, (None,) * 3).requires_grad_()
        with ctx():
            yt, (_, st_whole) = rwkv6.apply_rwkv_tmix(tp, xi, head_dim=hd)
            yc, _ = rwkv6.apply_rwkv_cmix(cp, xi)
            loss = ((yt * place(cot[0], (None,) * 3)).sum()
                    + (yc * place(cot[1], (None,) * 3)).sum())
            grads = torch.autograd.grad(full(loss), [xi, *tp.values(),
                                                     *cp.values()])
            with torch.no_grad():
                ys, st = rwkv6.decode_rwkv_tmix(
                    tp, xi[:, :1], {"x": place(state["x"], (None,) * 3),
                                    "S": place(state["S"], s_spec)}, hd)
                h = xi[:, -1]
                w = place(head, col)
                logits = rwkv6.head_logits(h, w)
        return ([full(t).detach() for t in (yt, st_whole, yc, ys, st["S"],
                                            logits)],
                [full(g) for g in grads], layout(st["S"]))
    want = run(lambda t, s: t.clone(), contextlib.nullcontext)
    got = run(lambda t, s: NamedSharding(m, s).place(t.clone()),
              lambda: activate_mesh(m))
    return {"outputs_close": [bool(torch.allclose(a, b, rtol=1e-4,
                                                  atol=1e-5))
                              for a, b in zip(got[0], want[0])],
            "grads_close": [bool(torch.allclose(
                a, b, rtol=1e-3, atol=1e-4 * float(b.abs().max()) + 1e-12))
                for a, b in zip(got[1], want[1])],
            "state_layout": got[2]}


# reduced RWKV-6 decoding one sequence on (2, 1, 2) for two steps, the
# second from the cache the first returned, against one process: 4 heads
# (the cache splits them over 'model') and 5 (the cache replicates them,
# the step returns them split 3 and 2)
TWO_STEPS = {"4-heads": {}, "5-heads": {"d_model": 160}}


def two_steps(m, overrides):
    from repro_torch.configs import get_config
    from repro_torch.distributed import cache_shardings, param_shardings
    from repro_torch.distributed.sharding import batch_spec, place_tree
    from repro_torch.models import build
    cfg = get_config("rwkv6-3b").reduced(**overrides)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    placed = place_tree(params, param_shardings(m, cfg, params))
    # a cache of its own: a replicated leaf placed keeps its storage,
    # which the plain step writes in place
    cache, d_cache = (model.init_cache(1, 16, torch_device="cpu")
                      for _ in range(2))
    d_cache = place_tree(d_cache, cache_shardings(m, cfg, d_cache, 1))
    toks = torch.randint(0, cfg.vocab_size, (2, 1),
                         generator=torch.Generator().manual_seed(3))
    out = {"logits_close": []}
    with torch.no_grad():
        for tok in toks:
            logits, cache = model.decode_step(params, cache, tok)
            with activate_mesh(m):
                d_logits, d_cache = model.decode_step(
                    placed, d_cache, NamedSharding(
                        m, batch_spec(m, 1, 1)).place(tok))
            out["logits_close"].append(close(d_logits, logits))
    keys = ("tmix_x", "cmix_x", "S")
    out["states_close"] = [close(d_cache[k], cache[k]) for k in keys]
    out["layouts"] = [layout(d_cache[k]) for k in keys]
    return out


res["models"] = models_on(remesh(list(range(world)), 2, pods=pods,
                                  torch_device="cpu"), MODELS)
if world == 4:
    res["embedding"] = embedding(remesh(list(range(world)), 2, pods=pods,
                                        torch_device="cpu"))
if pods == 2:
    res["one_sequence"] = {case: one_sequence(remesh(
        list(range(world)), 2, pods=pods, torch_device="cpu"), d, lora)
        for case, (d, lora) in ONE_SEQUENCE.items()}
    res["two_steps"] = {case: two_steps(remesh(
        list(range(world)), 2, pods=pods, torch_device="cpu"), overrides)
        for case, overrides in TWO_STEPS.items()}
else:
    res["models"].update(models_on(remesh(list(range(world)), 2,
                                          torch_device="cpu"), DENSE))
if world == 2:
    res["uneven"] = models_on(remesh(list(range(world)), 2,
                                     torch_device="cpu"), UNEVEN)
    # a train step's temp bytes on each rank: op_cost's count and the CPU
    # allocator's peak over a plain step (scripts/torch/temp_vs_allocator.py)
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "temp_vs_allocator", "scripts/torch/temp_vs_allocator.py")
    tva = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tva)
    peaks = [None] * world
    dist.all_gather_object(peaks, tva.peaks_on(
        remesh(list(range(world)), 2, torch_device="cpu"), "qwen3-0.6b",
        8, 256, 4))
    res["peaks"] = peaks
res["models_mesh"] = list(remesh(list(range(world)), 2, pods=pods,
                                 torch_device="cpu").sizes)
if rank == 0:
    print(json.dumps(res))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@functools.lru_cache(maxsize=None)
def _gloo_world(world: int, pods: int = 1) -> dict:
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO, str(r),
                               str(world), str(port), str(pods)], env=_env(),
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.mark.parametrize("tp", [2, 4])
def test_moe_slices_across_gloo_ranks(tp):
    got = _gloo_world(tp)
    assert got["mesh"] == [1, tp]
    assert got["routing_bitwise"]
    if tp == 2:                       # two partials add alike either way
        assert got["bitwise"], got["max_abs"]
    assert got["close"], got["max_abs"]
    assert all(got["grads_close"]), got["grads_close"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "hubert-xlarge",
                                  "zamba2-7b", "rwkv6-3b"])
def test_models_across_gloo_ranks(arch, world):
    """(1, 2) and (2, 2) meshes of processes against one process."""
    got = _gloo_world(world)["models"][arch]
    plain, meshed = got["loss"]
    assert np.isclose(meshed, plain, rtol=RTOL, atol=ATOL)
    assert got["grads_close"]
    if configs.get_config(arch).has_decode:
        assert got["decode_close"] == [True] * 3


@pytest.mark.parametrize("world", [(2,), (4,), (4, 2)])
def test_prefill_across_gloo_ranks(world):
    """Reduced qwen3-0.6b's prefill on (1, 2), (2, 2) and (2, 1, 2) meshes
    of processes (the worlds above): its last logits and its KV cache
    (each rank's share of the KV heads) against one process."""
    got = _gloo_world(*world)["models"]["qwen3-0.6b"]
    assert got["prefill_close"] == [True] * 3


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "chatglm3-6b"])
def test_bias_and_partial_rope_across_gloo_ranks(arch, world):
    """The per-rank attention's qkv biases (each rank adds its own heads'
    shares) and chatglm3-6b's rope on half the head dims, on (1, 2) and
    (2, 2) meshes of processes against one process: loss, gradients,
    prefill's logits and KV cache, and decode, within the bounds above."""
    got = _gloo_world(world)["models"][arch]
    plain, meshed = got["loss"]
    assert np.isclose(meshed, plain, rtol=RTOL, atol=ATOL)
    assert got["grads_close"]
    assert got["prefill_close"] == [True] * 3
    assert got["decode_close"] == [True] * 3


def test_peak_bytes_follow_the_allocator_across_gloo_ranks():
    """On a (1, 2) mesh of processes, with its collectives, op_cost's peak
    bytes of a train step (reduced qwen3-0.6b at 8 layers, batch 4 x 256)
    follow each rank's CPU allocator over the same step run plainly
    within 1%, as they do in one process (test_torch_roofline.py)."""
    for rank in _gloo_world(2)["peaks"]:
        assert rank["allocator"] > 0
        assert rank["op_cost"] == pytest.approx(rank["allocator"], rel=0.01)


def test_fake_world_peak_bytes_follow_the_allocator():
    """The dry-run's count of the same train step, traced as rank 0 of a
    fake world of two on meta tensors (``temp_vs_allocator.py``'s fake
    column), within 1% of each gloo rank's allocator peak: a collective's
    result counts for as long as a real rank holds it, though the meta
    kernel of its wrapper returns a fresh tensor."""
    got = _in_world(2, f"""
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "temp_vs_allocator",
            {str(ROOT / "scripts" / "torch" / "temp_vs_allocator.py")!r})
        tva = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tva)
        print(json.dumps(tva.fake_peak("qwen3-0.6b", 8, 256, 4)))
    """)
    for rank in _gloo_world(2)["peaks"]:
        assert got == pytest.approx(rank["allocator"], rel=0.01)


@pytest.mark.parametrize("case", ["rwkv6-3b/5-heads", "zamba2-7b/5-heads",
                                  "qwen3-0.6b/1-kv-head",
                                  "qwen2-1.5b/odd-ff",
                                  "qwen3-0.6b/padded-vocab"])
def test_uneven_head_shares_across_gloo_ranks(case):
    """Heads (or an MLP width) that 'model' does not divide, on a (1, 2)
    mesh of processes against one process: each rank runs its own whole
    heads (3 and 2 of 5; rank 1 no KV head of its own), or the whole MLP,
    within the bounds above. A padded vocabulary's decode logits stay
    split over 'model', 125 columns of 250 on rank 0."""
    got = _gloo_world(2)["uneven"][case]
    plain, meshed = got["loss"]
    assert np.isclose(meshed, plain, rtol=RTOL, atol=ATOL)
    assert got["grads_close"]
    assert got["decode_close"] == [True] * 3
    assert got.get("prefill_close", [True] * 3) == [True] * 3
    if case.endswith("padded-vocab"):
        assert got["logits_local"] == [2, 125]


@pytest.mark.parametrize("case", ["4-heads", "5-heads", "whole-over-model"])
def test_one_sequence_splits_the_contraction_across_gloo_ranks(case):
    """RWKV-6's time and channel mixes (outputs, the whole sequence's state
    and every gradient), one decode step (its output and new state, in
    the decode cache's layout) and the head for a batch of one on a (2, 1,
    2) mesh of processes, whose 'pod' axis then splits the column-parallel
    products' contracted channels and the row-parallel products' output
    channels, against one process: 4 heads, 5, which split unevenly over
    'model' (a rank with 2), and a time mix that 'model' does not split
    (which runs every head and returns its new state whole, not in the
    cache's split of 4 heads)."""
    got = _gloo_world(4, 2)["one_sequence"][case]
    assert got["outputs_close"] == [True] * 6
    assert got["grads_close"] == [True] * 21      # x and 20 parameters
    # the new decode state by heads over 'model' (2 and 2, or 3 and 2 of
    # the 5 the cache replicates), whole where 'model' splits no time mix
    assert got["state_layout"] == (
        ["R", "R"] if case == "whole-over-model" else ["R", 1])


@pytest.mark.parametrize("case", ["4-heads", "5-heads"])
def test_one_sequence_decodes_from_its_own_cache_across_gloo_ranks(case):
    """Reduced RWKV-6 decoding one sequence on a (2, 1, 2) mesh of
    processes for two steps, the second from the cache the first
    returned, in the layout the step left it (token shifts split over the
    batch axes, WKV states by heads over 'model'), against one process's
    two steps: both steps' logits and the last cache."""
    got = _gloo_world(4, 2)["two_steps"][case]
    assert got["logits_close"] == [True] * 2
    assert got["states_close"] == [True] * 3
    assert got["layouts"] == [[3, "R"], [3, "R"], ["R", 2]]


@pytest.mark.parametrize("world", [(4,), (4, 2)])
def test_vocab_parallel_embedding_across_gloo_ranks(world):
    """The token embedding on (2, 2) and (2, 1, 2) meshes of processes
    against one process: each rank looks its tokens up in its own rows of
    the vocab-split table (tokens on both 'model' ranks' rows, each twice)
    and the rows are summed over 'model', bitwise the one process's
    lookup; the table's gradient, within the file's gradient bound, comes
    back split over 'model' as the table is, zero on the padded rows."""
    got = _gloo_world(*world)["embedding"]
    assert got["model_ranks_hit"] == [0, 1]
    assert got["grad_rows"] == 12
    assert got["lookup_bitwise"]
    assert got["grad_close"]
    assert got["padded_grad_zero"]
    assert got["grad_layout"][-1] == 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "hubert-xlarge", "zamba2-7b",
                                  "rwkv6-3b"])
def test_models_across_gloo_ranks_on_three_axes(arch):
    """A (2, 1, 2) ("pod", "data", "model") mesh of 4 processes against one
    process, within the two-axis worlds' bounds and their timeout."""
    got = _gloo_world(4, 2)
    assert got["models_mesh"] == [2, 1, 2]
    got = got["models"][arch]
    plain, meshed = got["loss"]
    assert np.isclose(meshed, plain, rtol=RTOL, atol=ATOL)
    assert got["grads_close"]
    if configs.get_config(arch).has_decode:
        assert got["decode_close"] == [True] * 3
