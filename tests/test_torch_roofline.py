"""The port's roofline counter (``roofline.op_cost``, ``roofline.analysis``)
against the JAX package's (``roofline.hlo_cost``, ``roofline.analysis``).

Exactness, fixed before the port was written:
  * bitwise: ``count_params`` / ``active_params`` / ``model_flops`` (shape
    arithmetic summed in the reference's leaf order), and
    ``roofline_report``'s arithmetic on the same counts and hardware;
  * the reference's 1%: the FLOPs of a 10-trip loop (the port counts
    products only, the reference also 1 an element of ``tanh``);
  * exact: collective bytes in a fake world, each collective charged
    max(operand, result) as ``hlo_cost`` charges it;
  * 1%: ``peak_bytes`` of a reduced train step against the CPU allocator's
    peak above the step's arguments (the profiler's allocation records),
    every family; there is no reference number to hold it against (XLA's
    ``temp_size_in_bytes`` is its own buffer assignment).
"""
import dataclasses
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
from repro.configs.base import SHAPES as R_SHAPES
from repro.models import build as r_build
from repro.roofline import analysis as r_analysis
from repro.roofline import hlo_cost as r_hlo_cost
from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.models import build
from repro_torch.roofline import (HW, Cost, active_params, analyze,
                                  collective_bytes, count_params,
                                  model_flops, roofline_report)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(a for a, c in r_configs.REGISTRY.items()
               if c.family != "ising")


def _reduced(arch):
    cfg = configs.get_config(arch)
    return cfg.reduced(n_layers=5) if cfg.family == "hybrid" else \
        cfg.reduced()


def _r_cfg(cfg):
    return dataclasses.replace(r_configs.get_config(cfg.name),
                               **dataclasses.asdict(cfg))


def test_model_flops_moe_active_only():
    cfg, r_cfg = (configs.get_config("olmoe-1b-7b"),
                  r_configs.get_config("olmoe-1b-7b"))
    shape = (16, 64, 2048, 1024)
    n_act = active_params(cfg, {"blocks": {"ffn": {
        "wi": torch.empty(shape, device="meta")}}})
    r_act = r_analysis.active_params(r_cfg, {"blocks": {"ffn": {
        "wi": jax.ShapeDtypeStruct(shape, jnp.float32)}}})
    assert n_act == r_act
    assert np.isclose(n_act, 16 * 64 * 2048 * 1024 * (8 / 64))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_equal_reference(arch):
    """The port's own init of each reduced config against the reference's
    ``eval_shape`` of its init, for every shape kind."""
    cfg = _reduced(arch)
    r_cfg = _r_cfg(cfg)
    params = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    r_params = jax.eval_shape(r_build(r_cfg).init, jax.random.PRNGKey(0))
    assert count_params(params) == r_analysis.count_params(r_params)
    assert active_params(cfg, params) == r_analysis.active_params(
        r_cfg, r_params)
    for name in SHAPES:
        assert model_flops(cfg, SHAPES[name], params) == \
            r_analysis.model_flops(r_cfg, R_SHAPES[name], r_params), name


def test_loop_flops_scale_with_trips():
    """``test_hlo_cost_scales_while_loops``: a 10-trip loop of tanh(c @ w)
    counts every trip (the reference's scan, a Python loop here)."""
    def f_loop(x, w):
        c = x
        for _ in range(10):
            c = torch.tanh(c @ w)
        return c

    x, w = torch.randn(128, 128), torch.randn(128, 128)
    cost = analyze(f_loop, x, w)
    expect = 10 * (2 * 128 ** 3 + 128 * 128)
    assert abs(cost.flops - expect) / expect < 0.01
    # operands and results of the 20 executed ops, 64 KiB each
    assert cost.bytes == 10 * (3 + 2) * 128 * 128 * 4
    assert collective_bytes(cost) == {k: 0 for k in cost.collectives}


def test_views_move_no_bytes():
    x = torch.randn(64, 32)
    assert analyze(lambda: x.t()[:10].unsqueeze(0)).bytes == 0
    assert analyze(lambda: x + 1).bytes == 2 * 64 * 32 * 4
    # a reshape that must copy is a copy
    assert analyze(lambda: x.t().reshape(-1)).bytes == 2 * 64 * 32 * 4


def test_collective_bytes_in_a_fake_world():
    """``test_collective_regex``: an all-reduce of f32[128, 256], an
    all-gather of bf16[64] shards, a reduce-scatter of f32[256] and an
    all-to-all of f32[32] over a fake world of 4, each charged
    max(operand, result) as the reference's ``hlo_cost`` charges it: the
    gather its bf16[256] result, in the tensor form and the list form."""
    code = textwrap.dedent("""
        import json
        import torch
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.roofline import analyze, collective_bytes
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=4)
        x = torch.randn(128, 256)
        y = torch.randn(64, dtype=torch.bfloat16)
        out = torch.empty(256, dtype=torch.bfloat16)
        parts = [torch.empty(64, dtype=torch.bfloat16) for _ in range(4)]
        z, zs = torch.randn(256), torch.empty(64)
        w, ws = torch.randn(32), torch.empty(32)

        def step():
            dist.all_reduce(x)
            dist.all_gather_into_tensor(out, y)
            dist.reduce_scatter_tensor(zs, z)
            dist.all_to_all_single(ws, w)

        one = collective_bytes(analyze(step))
        listed = collective_bytes(analyze(lambda: dist.all_gather(parts, y)))
        print(json.dumps({"one": one, "listed": listed}))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-W", "ignore", "-c", code],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["one"] == {"all-reduce": 128 * 256 * 4,
                          "all-gather": 256 * 2, "reduce-scatter": 256 * 4,
                          "all-to-all": 32 * 4, "collective-permute": 0}
    assert got["listed"]["all-gather"] == 256 * 2
    # the reference's parser reads the same bytes from real HLO, where the
    # result's shape comes before the op's name
    ref = r_analysis.collective_bytes_from_hlo(
        "  %ar = f32[128,256]{1,0} all-reduce(%x), channel_id=1, "
        "replica_groups={{0,1,2,3}}, to_apply=%add\n"
        "  %ag = bf16[256]{0} all-gather(%y), channel_id=2, "
        "replica_groups={{0,1,2,3}}, dimensions={0}\n")
    assert ref["all-reduce"] == got["one"]["all-reduce"]
    assert ref["all-gather"] == got["one"]["all-gather"]


_COMPILED_COLLECTIVES = """
import json
import numpy as np
import jax, jax.numpy as jnp
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from jax.sharding import Mesh, PartitionSpec as P
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro.distributed.sharding import shard_map
from repro.roofline import hlo_cost
from repro_torch.roofline import analyze, collective_bytes

mesh = Mesh(np.array(jax.devices()[:4]), ("x",))


def compiled(f, n):
    return jax.jit(shard_map(f, mesh, in_specs=P("x"), out_specs=P("x"),
                             check_vma=False)).lower(
        jnp.zeros((n,), jnp.float32)).compile().as_text()


ref = {"ag": hlo_cost.analyze(compiled(
           lambda a: jax.lax.all_gather(a, "x", tiled=True), 256)),
       "rs": hlo_cost.analyze(compiled(
           lambda a: jax.lax.psum_scatter(a, "x", tiled=True), 1024))}
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
group = dist.group.WORLD
a, b = torch.randn(64), torch.randn(256)
ag, rs = torch.empty(256), torch.empty(64)
port = {"ag": analyze(lambda: dist.all_gather_into_tensor(ag, a)),
        "rs": analyze(lambda: dist.reduce_scatter_tensor(rs, b)),
        "ag_functional": analyze(
            lambda: funcol.all_gather_tensor(a, 0, group).wait()),
        "rs_functional": analyze(
            lambda: funcol.reduce_scatter_tensor(b, "sum", 0, group).wait())}
print(json.dumps({"ref": {k: c.collectives for k, c in ref.items()},
                  "port": {k: collective_bytes(c) for k, c in port.items()}}))
"""


def test_collectives_are_charged_as_the_reference_compiles_them():
    """An all-gather of f32[64] shards into f32[256] and a reduce-scatter
    of f32[256] into f32[64], compiled with ``shard_map`` on 4 forced host
    devices and read by ``repro.roofline.hlo_cost.analyze``, and run by
    ``c10d`` and the functional collectives on a fake world of 4 under
    ``op_cost``: the same bytes, 1024 each (the gather's result, the
    scatter's operand)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-W", "ignore", "-c",
                          _COMPILED_COLLECTIVES], env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    ref, port = got["ref"], got["port"]
    assert ref["ag"]["all-gather"] == ref["rs"]["reduce-scatter"] == 1024
    for form in ("", "_functional"):
        assert port["ag" + form] == ref["ag"], form
        assert port["rs" + form] == ref["rs"], form


@pytest.mark.parametrize("chips,mft", [(None, None), (1, 3.1e15),
                                       (4, 7.0e16)])
@pytest.mark.parametrize("flops,nbytes,coll", [
    (2.5e14, 1.2e11, {"all-reduce": 3e9, "all-gather": 1e8}),
    (1.0e12, 9.9e12, {}),
    (0.0, 0.0, {"reduce-scatter": 5e10, "all-to-all": 1.5e9}),
])
def test_roofline_report_equals_reference_arithmetic(flops, nbytes, coll,
                                                     chips, mft,
                                                     monkeypatch):
    hw = HW()
    cost = Cost(flops=flops, bytes=nbytes)
    cost.collectives.update(coll)
    r_cost = r_hlo_cost.Cost(flops, nbytes)
    r_cost.collectives.update(coll)
    monkeypatch.setattr(r_hlo_cost, "analyze", lambda text: r_cost)
    monkeypatch.setattr(r_analysis, "_cost", lambda compiled: {})

    class _Compiled:
        def as_text(self):
            return ""
    r_hw = r_analysis.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                         ici_bw=hw.ici_bw, hbm_bytes=hw.hbm_bytes)
    ref = r_analysis.roofline_report(_Compiled(), r_hw, chips=chips,
                                     model_flops_total=mft)
    got = roofline_report(cost, hw, chips=chips, model_flops_total=mft)
    assert set(ref) - set(got) == {"xla_flops_unscaled",
                                   "xla_bytes_unscaled"}
    assert set(got) <= set(ref)
    for k in got:
        assert got[k] == ref[k], k


def test_hw_is_the_h100():
    hw = HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.hbm_bytes) == \
        (989e12, 3.35e12, 450e9, 80 * 2**30)


def _allocator_peak(fn) -> int:
    """The most bytes the CPU allocator held during ``fn()`` above what it
    held when ``fn`` began, from the profiler's allocation records."""
    import gc

    from torch.profiler import ProfilerActivity, profile
    gc.collect()
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as p:
        fn()
    allocs = []

    def walk(node):
        f = node.extra_fields
        if type(f).__name__ == "_ExtraFields_Allocation":
            allocs.append((node.start_time_ns, f.alloc_size,
                           f.total_allocated))
        for c in node.children:
            walk(c)
    for root in p.profiler.kineto_results.experimental_event_tree():
        walk(root)
    allocs.sort()
    start = allocs[0][2] - allocs[0][1]
    return max(total for _, _, total in allocs) - start


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b", "zamba2-7b",
                                  "rwkv6-3b", "hubert-xlarge"])
def test_peak_bytes_follow_the_allocator(arch):
    """A storage counts once, from its allocation to its release, whatever
    aliases it: the count tracked per result was 1.15-2.30x this peak."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import init_train_state, make_train_step
    cfg = configs.get_config(arch).reduced()
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 64), generator=g)
             for k in ("tokens", "labels")}
    if cfg.family == "encoder":
        batch["embeds"] = torch.randn((4, 64, cfg.d_model), generator=g)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), 10_000, 5)
    step(state, batch)                      # first-call allocations
    got = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # a threaded convolution's workspaces are
    try:                        # the kernel's, not any op's result
        peak = _allocator_peak(lambda: got.update(
            cost=analyze(step, state, batch)))
    finally:
        torch.set_num_threads(threads)
    assert peak > 0
    assert got["cost"].peak_bytes == pytest.approx(peak, rel=0.01)
