"""The LM trainer in the port (``optim``, ``chunked_ce_loss`` / ``lm_loss``,
``Model.loss``, ``training``, ``checkpoint``, ``launch.train``) against the
JAX package.

The same numpy inputs, and the reference's own initial weights and train
states carried across by ``convert``, go to ``repro`` and ``repro_torch``
(``torch_device="cpu"``). Tolerances, fixed before the port was written:
  * the schedule and ``global_norm``: rtol 1e-6 (float32 scalars);
  * AdamW over 5 steps with injected identical grads (the optimizer on its
    own, so that no sum order of a gradient enters): m, v, updates and
    params at rtol 1e-5, atol 1e-7; the step count exactly;
  * ``int8_compress`` / ``int8_decompress``: bitwise (q, scale and the
    dequantized values); ``compressed_psum`` at K = 1 against the
    reference's one-device ``shard_map`` bitwise, at K = 4 against a
    numpy float32 version of the same formula bitwise, ``out + resid == x``
    at rtol 1e-5, atol 1e-6 (the reference test's bound);
  * ``chunked_ce_loss``: rtol 1e-5, atol 1e-6;
  * every family reduced: the loss at rtol 1e-4, atol 1e-5 (the serving
    outputs' bound), and every gradient leaf against ``jax.grad`` of the
    reference's ``model.loss`` at rtol 1e-3 with an atol of 1e-4 times
    the leaf's largest reference gradient (an element that cancels to
    rounding noise has no relative precision);
  * five train steps from one carried ``TrainState``: each step, taken
    from the reference's own state, by its loss at rtol 1e-4, atol 1e-5,
    grad_norm at rtol 1e-4 and lr_scale at rtol 1e-6; the port's own
    trajectory by its losses at rtol 1e-4, atol 1e-5. Params after a step
    are not compared elementwise: AdamW's first step is a sign function,
    so an element whose gradient is rounding noise may move by 2 lr
    either way in either package, and AdamW amplifies rounding-level
    gradient differences into parameter differences of ~1e-5;
  * checkpoints: bitwise both ways (keys, shapes, dtypes, values, the
    manifest);
  * the trainer: a restart gives the straight run's losses at rtol 1e-5
    (the reference's gate; bitwise expected on the CPU and checked);
  * the serving forward with remat and unbind in place: bitwise equal to
    the same forward under grad (remat on) and with remat off.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.checkpoint import Checkpointer as RCheckpointer
from repro.checkpoint import load_pytree as r_load_pytree
from repro.models import build as r_build
from repro.models import transformer as r_transformer
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw as r_adamw
from repro.optim import apply_updates as r_apply_updates
from repro.optim import clip_by_global_norm as r_clip
from repro.optim import compressed_psum as r_compressed_psum
from repro.optim import cosine_schedule as r_cosine
from repro.optim import init_opt_state as r_init_opt_state
from repro.optim import int8_compress as r_int8_compress
from repro.optim import int8_decompress as r_int8_decompress
from repro.optim import linear_warmup_cosine as r_warmup_cosine
from repro.training.steps import init_train_state as r_init_train_state
from repro.training.steps import make_train_step as r_make_train_step
from repro_torch import configs
from repro_torch.checkpoint import Checkpointer, load_pytree, save_pytree
from repro_torch.convert import lm_params_from_arrays, train_state_from_arrays
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import train
from repro_torch.models import build, transformer
from repro_torch.optim import (AdamWConfig, adamw, apply_updates,
                               clip_by_global_norm, compressed_psum,
                               cosine_schedule, global_norm, init_opt_state,
                               int8_compress, int8_decompress,
                               linear_warmup_cosine)
from repro_torch.pytree import flatten_with_paths, leaves, tree_map
from repro_torch.training import (TrainState, init_train_state,
                                  make_eval_step, make_train_step)

GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-3, 1e-4
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
ARCHS = [a for a, c in configs.REGISTRY.items() if c.family != "ising"]
#: the trainer's optimizer settings (launch.train)
TRAINER = dict(lr=1e-3, total_steps=10_000, warmup_steps=5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU ops run faster on one thread than on a pool that also
    competes with XLA's; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _ref_paths(tree):
    """{path: numpy leaf} of a reference tree in the checkpointer's key
    spelling."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "|".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = np.asarray(leaf)
    return out


def _paths(tree):
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in flatten_with_paths(tree)}


def _reduced(arch):
    """``tests/test_models_smoke.py``'s reduced configs (zamba2 at 5
    layers: two groups and a tail layer)."""
    cfg = configs.get_config(arch)
    return cfg.reduced(n_layers=5) if cfg.family == "hybrid" else \
        cfg.reduced()


def _r_cfg(cfg):
    """The reference's config with every field of the port's ``cfg``."""
    return dataclasses.replace(r_configs.get_config(cfg.name),
                               **dataclasses.asdict(cfg))


def _smoke_batch(cfg, b=2, s=64, seed=0):
    """``tests/test_models_smoke.py``'s batch, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "encoder":
        batch["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        batch["labels"][:, :cfg.n_vision_tokens] = -1
    return batch


def _close_grads(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        atol = GRAD_ATOL_OF_MAX * float(np.abs(ref).max()) + 1e-12
        np.testing.assert_allclose(got[key], ref, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=key)


# -- schedule, clipping, AdamW -----------------------------------------------

@pytest.mark.parametrize("warmup,total", [(5, 10_000), (10, 100),
                                          (200, 10_000), (0, 1)])
def test_schedule_matches_reference(warmup, total):
    for step in (0, 1, 2, 4, 5, 6, 10, 11, 57, 100, 101, 5000, 9999,
                 10_000, 12_345):
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = linear_warmup_cosine(s, warmup, total)
            assert got.dtype == torch.float32
            want = r_warmup_cosine(jnp.asarray(step, jnp.int32), warmup,
                                   total)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       atol=1e-7)
        np.testing.assert_allclose(
            float(cosine_schedule(step, total)),
            float(r_cosine(jnp.asarray(step, jnp.int32), total)), rtol=1e-6,
            atol=1e-7)


def test_schedule_shape():
    assert float(linear_warmup_cosine(0, 10, 100)) == 0.0
    assert float(linear_warmup_cosine(10, 10, 100)) == pytest.approx(1.0)
    assert float(linear_warmup_cosine(100, 10, 100)) == pytest.approx(
        0.1, abs=0.02)


def _grad_tree(rng, scale=1.0):
    return {"b": {"w": rng.normal(size=(7, 5)).astype(np.float32) * scale,
                  "a": rng.normal(size=(3,)).astype(np.float32) * scale},
            "a": rng.normal(size=(4, 2, 3)).astype(np.float32) * scale}


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 100.0])
def test_global_norm_and_clipping_match_reference(max_norm):
    tree = _grad_tree(np.random.default_rng(1), scale=2.0)
    clipped, norm = clip_by_global_norm(tree_map(_t, tree), max_norm)
    r_clipped, r_norm = r_clip(jax.tree.map(jnp.asarray, tree), max_norm)
    np.testing.assert_allclose(float(norm), float(r_norm), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(tree_map(_t, tree))),
                               float(r_norm), rtol=1e-6)
    got, want = _paths(clipped), _ref_paths(r_clipped)
    assert list(got) == list(want)           # the reference's leaf order
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)


def test_clipping():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = clip_by_global_norm(g, max_norm=1.0)
    assert np.isclose(float(norm), np.sqrt(1000.0))
    cn = float(torch.sqrt(torch.sum(clipped["a"] ** 2)))
    assert np.isclose(cn, 1.0, rtol=1e-5)


def test_adamw_matches_reference_with_injected_grads():
    rng = np.random.default_rng(2)
    params = _grad_tree(rng)
    cfg = AdamWConfig()
    r_cfg = RAdamWConfig()
    p, r_p = tree_map(_t, params), jax.tree.map(jnp.asarray, params)
    opt, r_opt = init_opt_state(p), r_init_opt_state(r_p)
    for step in range(5):
        g = _grad_tree(rng, scale=10.0 ** -step)
        lr_scale = float(r_warmup_cosine(step + 1, 2, 100))
        upd, opt = adamw(tree_map(_t, g), opt, p, cfg, lr_scale)
        r_upd, r_opt = r_adamw(jax.tree.map(jnp.asarray, g), r_opt, r_p,
                               r_cfg, lr_scale)
        p, r_p = apply_updates(p, upd), r_apply_updates(r_p, r_upd)
        for got, want in ((upd, r_upd), (opt["m"], r_opt["m"]),
                          (opt["v"], r_opt["v"]), (p, r_p)):
            got, want = _paths(got), _ref_paths(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)
        assert opt["step"].dtype == torch.int32
        assert int(opt["step"]) == int(r_opt["step"]) == step + 1


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = init_opt_state(params)
    cfg = AdamWConfig(lr=0.2, weight_decay=0.0)
    for _ in range(100):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        upd, opt = adamw({"w": g}, opt, params, cfg)
        params = apply_updates(params, upd)
    assert float(params["w"].abs().max()) < 0.05


def test_adamw_never_writes_into_its_inputs():
    rng = np.random.default_rng(3)
    p = tree_map(_t, _grad_tree(rng))
    g = tree_map(_t, _grad_tree(rng))
    opt = init_opt_state(p)
    before = [t.clone() for t in leaves((p, g, opt))]
    upd, new_opt = adamw(g, opt, p, AdamWConfig(), 0.5)
    apply_updates(p, upd)
    for a, b in zip(before, leaves((p, g, opt))):
        assert torch.equal(a, b)
    assert int(opt["step"]) == 0 and int(new_opt["step"]) == 1


# -- int8 compression --------------------------------------------------------

@pytest.mark.parametrize("shape,scale", [((256,), 3.0), ((17, 33), 0.01),
                                         ((4, 5, 6), 100.0)])
def test_int8_compression_matches_reference(shape, scale):
    x = (np.random.default_rng(4).normal(size=shape) * scale).astype(
        np.float32)
    q, s = int8_compress(_t(x))
    r_q, r_s = r_int8_compress(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(r_q))
    assert s.numpy().tobytes() == np.asarray(r_s).tobytes()
    y = int8_decompress(q, s)
    assert y.numpy().tobytes() == np.asarray(
        r_int8_decompress(r_q, r_s)).tobytes()


def test_int8_compression_roundtrip(rng):
    x = torch.as_tensor(rng.normal(size=(256,)) * 3, dtype=torch.float32)
    q, s = int8_compress(x)
    y = int8_decompress(q, s)
    assert q.dtype == torch.int8
    assert float((x - y).abs().max()) <= float(s) * 0.51


def _ref_psum_one_device(x, residual=None):
    """The reference's ``compressed_psum`` under its one-device
    ``shard_map`` (``tests/test_substrates.py``)."""
    from repro.distributed.sharding import shard_map
    from repro.launch.mesh import _mesh_kwargs
    mesh = jax.make_mesh((1,), ("d",), **_mesh_kwargs(1))
    spec = jax.sharding.PartitionSpec(None)

    def f(x, r):
        return r_compressed_psum(x, "d", r)
    if residual is None:
        residual = np.zeros_like(x)
    out, resid = jax.jit(shard_map(f, mesh=mesh, in_specs=(spec, spec),
                                   out_specs=spec))(jnp.asarray(x),
                                                    jnp.asarray(residual))
    return np.asarray(out), np.asarray(resid)


def _numpy_psum(x, residual=None):
    """The reference's formula over K stacked replicas, in numpy float32."""
    x = x if residual is None else x + residual
    k = x.shape[0]
    scales = np.abs(x).reshape(k, -1).max(axis=1) / np.float32(127.0) + \
        np.float32(1e-12)
    scale = scales.max()
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    # the exact error, rounded once (one fused multiply-add)
    resid = (x.astype(np.float64) - q.astype(np.float64) *
             np.float64(scale)).astype(np.float32)
    summed = q.astype(np.int32).sum(axis=0)
    return summed.astype(np.float32) * scale / np.float32(k), resid


def test_compressed_psum_one_replica_matches_reference_shard_map():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64,)).astype(np.float32)
    r0 = (rng.normal(size=(64,)) * 0.01).astype(np.float32)
    for residual in (None, r0):
        out, resid = compressed_psum(
            _t(x)[None], None if residual is None else _t(residual)[None])
        r_out, r_resid = _ref_psum_one_device(x, residual)
        assert out.shape == (64,) and resid.shape == (1, 64)
        assert out.numpy().tobytes() == r_out.tobytes()
        assert resid[0].numpy().tobytes() == r_resid.tobytes()
        want = x if residual is None else x + residual
        np.testing.assert_allclose((out + resid[0]).numpy(), want,
                                   rtol=1e-5, atol=1e-6)


def test_compressed_psum_four_replicas_match_the_formula():
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(4, 3, 40)) * np.array([1, 5, 0.1, 2])[
        :, None, None]).astype(np.float32)
    resid = None
    for _ in range(3):                       # error feedback over 3 rounds
        out, new = compressed_psum(_t(x), resid)
        want_out, want_resid = _numpy_psum(
            x, None if resid is None else resid.numpy())
        assert out.shape == (3, 40) and new.shape == (4, 3, 40)
        assert out.numpy().tobytes() == want_out.tobytes()
        assert new.numpy().tobytes() == want_resid.tobytes()
        # the K dequantized replicas and their residuals add up to the sum
        # of what went in
        xin = x if resid is None else x + resid.numpy()
        np.testing.assert_allclose(4 * out.numpy() + new.numpy().sum(0),
                                   xin.sum(0), rtol=1e-5, atol=1e-6)
        resid = new


def test_compressed_psum_error_feedback(rng):
    x = torch.as_tensor(rng.normal(size=(64,)), dtype=torch.float32)
    out, resid = compressed_psum(x[None])
    np.testing.assert_allclose((out + resid[0]).numpy(), x.numpy(),
                               rtol=1e-5, atol=1e-6)


# -- the loss ----------------------------------------------------------------

@pytest.mark.parametrize("vocab,chunk,S,tie", [
    (250, 16, 37, False),      # padded vocab, 3 chunks, the last padded
    (256, 64, 20, False),      # one chunk shorter than loss_chunk
    (250, 8, 21, True)])       # tied embeddings
def test_chunked_ce_loss_matches_reference(vocab, chunk, S, tie):
    cfg = configs.get_config("qwen3-0.6b").reduced(
        vocab_size=vocab, loss_chunk=chunk, tie_embeddings=tie)
    vp = transformer.padded_vocab(cfg)
    rng = np.random.default_rng(S)
    B, D = 2, cfg.d_model
    w = (rng.normal(size=(D, vp)) / np.sqrt(D)).astype(np.float32)
    params = {"embed": np.ascontiguousarray(w.T)} if tie else {"head": w}
    hidden = rng.normal(size=(B, S, D)).astype(np.float32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.2] = -1
    labels[0, :3] = -1

    tp = tree_map(lambda a: _t(a).requires_grad_(), params)
    th = _t(hidden).requires_grad_()
    loss = transformer.chunked_ce_loss(tp, cfg, th, _t(labels))
    grads = torch.autograd.grad(loss, [th, *leaves(tp)])

    def r_loss(p, h):
        return r_transformer.chunked_ce_loss(p, _r_cfg(cfg), h,
                                             jnp.asarray(labels))
    r_val, (r_gp, r_gh) = jax.value_and_grad(r_loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(hidden))
    np.testing.assert_allclose(float(loss.detach()), float(r_val), rtol=1e-5,
                               atol=1e-6)
    _close_grads({"hidden": grads[0].numpy(), "w": grads[1].numpy()},
                 {"hidden": np.asarray(r_gh),
                  "w": np.asarray(jax.tree.leaves(r_gp)[0])})


def _family(arch, seed=0):
    """The reference's reduced model with its own initial weights, and the
    port's with the same weights carried across."""
    cfg = _reduced(arch)
    r_model = r_build(_r_cfg(cfg))
    r_params = r_model.init(jax.random.PRNGKey(seed))
    params = lm_params_from_arrays(jax.tree.map(np.asarray, r_params), cfg,
                                   torch_device="cpu")
    return cfg, r_model, r_params, build(cfg), params


@pytest.mark.parametrize("arch", ARCHS)
def test_family_loss_and_grads_match_reference(arch):
    cfg, r_model, r_params, model, params = _family(arch)
    batch = _smoke_batch(cfg)
    tp = tree_map(lambda t: t.requires_grad_(), params)
    loss = model.loss(tp, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves(tp), allow_unused=True,
                                materialize_grads=True)
    r_loss, r_grads = jax.jit(jax.value_and_grad(r_model.loss))(
        r_params, jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(float(loss.detach()), float(r_loss),
                               rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    got = {k: g.numpy() for (k, _), g in zip(flatten_with_paths(tp), grads)}
    want = _ref_paths(r_grads)
    assert all(np.isfinite(g).all() for g in want.values()), arch
    _close_grads(got, want)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_moe_f_slices_loss_and_grads_match_reference(tp):
    """MoE's F slices with their backward: the port's loss and gradients
    under a virtual (1, tp) mesh against ``jax.grad`` of the reference's
    ``shard_map`` path under its one-device host mesh."""
    from repro.launch import mesh as r_mesh
    from repro_torch.launch.mesh import activate_mesh, virtual_mesh
    cfg, r_model, r_params, model, params = _family("olmoe-1b-7b")
    assert cfg.d_ff % tp == 0
    batch = _smoke_batch(cfg)
    tp_params = tree_map(lambda t: t.requires_grad_(), params)
    with activate_mesh(virtual_mesh((1, tp), ("data", "model"), "cpu")):
        loss = model.loss(tp_params, {k: _t(v) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves(tp_params),
                                    materialize_grads=True)
    with r_mesh.activate_mesh(r_mesh.make_host_mesh()):
        r_loss, r_grads = jax.jit(jax.value_and_grad(r_model.loss))(
            r_params, jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(float(loss.detach()), float(r_loss),
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    _close_grads({k: g.numpy() for (k, _), g in
                  zip(flatten_with_paths(tp_params), grads)},
                 _ref_paths(r_grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_and_unbind_leave_the_forward_bitwise(arch):
    """The serving forward (no grad), the training forward (grad on, each
    block under activation checkpointing) and the same with remat off give
    the same bits; so do the gradients with and without remat."""
    cfg = _reduced(arch)
    assert cfg.remat
    params = build(cfg).init(torch.Generator().manual_seed(1), "cpu")
    batch = {k: _t(v) for k, v in _smoke_batch(cfg, s=24, seed=1).items()}
    with torch.no_grad():
        served = build(cfg).forward(params, batch)
    outs, grads = [], []
    for remat in (True, False):
        model = build(dataclasses.replace(cfg, remat=remat))
        tp = tree_map(lambda t: t.detach().requires_grad_(), params)
        outs.append(model.forward(tp, batch))
        loss = model.loss(tp, batch)
        grads.append(torch.autograd.grad(loss, leaves(tp), allow_unused=True,
                                         materialize_grads=True))
    for out in outs:
        assert torch.equal(out.detach(), served)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_mamba2_overflow_gradient_is_the_references():
    """Inherited from the reference: above the diagonal a fast decay's
    exp(cum_t - cum_j) overflows to inf and is selected away, so the
    forward is finite, but backward multiplies the selection's zero
    gradient by inf (NaN), in JAX as in torch. The port mirrors it: both
    gradients are non-finite at the same leaves, both forwards finite."""
    from repro.models import mamba2 as r_mamba2
    from repro_torch.models import mamba2
    d, hd, ds = 32, 16, 8
    r_p = r_mamba2.init_mamba2(jax.random.PRNGKey(2), d, head_dim=hd,
                               d_state=ds)
    r_p = dict(r_p, A_log=jnp.full_like(r_p["A_log"], 6.0),
               dt_bias=jnp.full_like(r_p["dt_bias"], 3.0))
    x = np.random.default_rng(5).normal(size=(1, 40, d)).astype(np.float32)

    def r_f(p):
        return jnp.sum(r_mamba2.apply_mamba2(p, jnp.asarray(x), head_dim=hd,
                                             d_state=ds)[0] ** 2)
    r_val, r_g = jax.value_and_grad(r_f)(r_p)
    p = {k: _t(v).requires_grad_() for k, v in r_p.items()}
    val = torch.sum(mamba2.apply_mamba2(p, _t(x), head_dim=hd,
                                        d_state=ds)[0] ** 2)
    g = dict(zip(p, torch.autograd.grad(val, list(p.values()))))
    assert np.isfinite(float(r_val)) and torch.isfinite(val)
    r_bad = {k for k, v in r_g.items() if not np.isfinite(v).all()}
    bad = {k for k, v in g.items() if not torch.isfinite(v).all()}
    assert r_bad and bad == r_bad


def test_eval_step_is_the_loss_without_grad():
    cfg, _, _, model, params = _family("qwen3-0.6b")
    batch = {k: _t(v) for k, v in _smoke_batch(cfg).items()}
    loss = make_eval_step(cfg)(params, batch)
    assert not loss.requires_grad
    with torch.no_grad():
        assert torch.equal(loss, model.loss(params, batch))


# -- train steps -------------------------------------------------------------

def _carried_state(cfg, seed=0):
    r_state = r_init_train_state(_r_cfg(cfg), jax.random.PRNGKey(seed))
    a = jax.tree.map(np.asarray, r_state)
    return r_state, train_state_from_arrays(a.params, a.opt, a.step, cfg,
                                            torch_device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b", "rwkv6-3b"])
def test_train_steps_match_reference(arch):
    cfg = _reduced(arch)
    r_state, state = _carried_state(cfg)
    assert _paths(state).keys() == _ref_paths(r_state).keys()
    step = make_train_step(cfg, AdamWConfig(lr=TRAINER["lr"]),
                           TRAINER["total_steps"], TRAINER["warmup_steps"])
    r_step = jax.jit(r_make_train_step(
        _r_cfg(cfg), RAdamWConfig(lr=TRAINER["lr"]), TRAINER["total_steps"],
        TRAINER["warmup_steps"]))
    ds = SyntheticLM(cfg.vocab_size, 64, 4)
    for i in range(5):
        tokens, labels = ds.batch_at(i)
        batch = {"tokens": _t(tokens), "labels": _t(labels)}
        # the step: from the reference's own state
        a = jax.tree.map(np.asarray, r_state)
        _, m = step(train_state_from_arrays(a.params, a.opt, a.step, cfg,
                                            torch_device="cpu"), batch)
        # the trajectory: from the port's own state
        state, traj = step(state, batch)
        r_state, r_m = r_step(r_state, {"tokens": jnp.asarray(tokens),
                                        "labels": jnp.asarray(labels)})
        for got in (m, traj):
            np.testing.assert_allclose(float(got["loss"]),
                                       float(r_m["loss"]), rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(r_m["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["lr_scale"]),
                                   float(r_m["lr_scale"]), rtol=1e-6)
        assert int(state.step) == int(r_state.step) == i + 1
        assert int(state.opt["step"]) == i + 1


def test_train_step_is_functional():
    """The step returns new tensors and leaves the state it was given as it
    was: a retry with that state replays the same step."""
    cfg = _reduced("qwen3-0.6b")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    before = [t.clone() for t in leaves(state)]
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), warmup_steps=5)
    tokens, labels = SyntheticLM(cfg.vocab_size, 32, 2).batch_at(0)
    batch = {"tokens": _t(tokens), "labels": _t(labels)}
    new, m = step(state, batch)
    for a, b in zip(before, leaves(state)):
        assert torch.equal(a, b)
    again, m2 = step(state, batch)
    assert float(m["loss"]) == float(m2["loss"])
    for a, b in zip(leaves(new), leaves(again)):
        assert torch.equal(a, b)
    assert int(new.step) == 1 and int(state.step) == 0
    assert all(not t.requires_grad for t in leaves(new))


def test_train_state_from_arrays_checks_the_config():
    r_state = r_init_train_state(_r_cfg(_reduced("qwen3-0.6b")),
                                 jax.random.PRNGKey(0))
    a = jax.tree.map(np.asarray, r_state)
    with pytest.raises(ValueError, match="layers"):
        train_state_from_arrays(
            a.params, a.opt, a.step,
            dataclasses.replace(_reduced("qwen3-0.6b"), n_layers=3),
            torch_device="cpu")


# -- checkpoints -------------------------------------------------------------

def test_checkpoints_cross_between_the_packages(tmp_path):
    cfg = _reduced("qwen3-0.6b")
    r_state, _ = _carried_state(cfg, seed=3)
    r_state = dataclasses.replace(r_state, step=jnp.asarray(7, jnp.int32))
    meta = {"data_step": 7, "arch": cfg.name}
    # the reference saves, the port restores
    RCheckpointer(str(tmp_path / "ref")).save(7, r_state, meta)
    template = init_train_state(cfg, torch.Generator().manual_seed(9), "cpu")
    ck = Checkpointer(str(tmp_path / "ref"))
    assert ck.latest_step() == 7
    restored, got_meta = ck.restore(template)
    assert isinstance(restored, TrainState)
    assert got_meta == {**meta, "step": 7}
    want = _ref_paths(r_state)
    got = _paths(restored)
    assert list(got) == list(want) and len(got) == 44
    assert {".params|blocks|attn|wq", ".opt|v|head", ".opt|step",
            ".step"} <= set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].tobytes() == want[k].tobytes(), k
    assert all(isinstance(t, torch.Tensor) for t in leaves(restored))
    # the port saves, the reference restores
    Checkpointer(str(tmp_path / "port")).save(7, restored, meta)
    files = {}
    for side in ("ref", "port"):
        with np.load(tmp_path / side / "ckpt_00000007.npz") as z:
            files[side] = {k: z[k] for k in z.files}
        with open(tmp_path / side / "ckpt_00000007.npz.meta.json") as f:
            files[side + "_meta"] = f.read()
    assert list(files["port"]) == list(files["ref"])
    assert files["port_meta"] == files["ref_meta"]
    for k, a in files["ref"].items():
        assert files["port"][k].dtype == a.dtype
        assert files["port"][k].tobytes() == a.tobytes(), k
    back, r_meta = RCheckpointer(str(tmp_path / "port")).restore(r_state)
    assert r_meta == {**meta, "step": 7}
    for k, a in _ref_paths(back).items():
        assert a.dtype == want[k].dtype and a.tobytes() == want[k].tobytes()


def test_checkpoint_refuses_a_missing_key_and_a_shape_mismatch(tmp_path):
    p = str(tmp_path / "x.npz")
    np.savez(p, **{".a": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="missing .b"):
        load_pytree(p, _Pair(a=torch.zeros(3), b=torch.zeros(2)))
    save_pytree(p, {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch for w"):
        load_pytree(p, {"w": torch.zeros((3, 3))})
    # the reference refuses the port's file the same way
    with pytest.raises(ValueError):
        r_load_pytree(p, {"w": np.zeros((3, 3))})
    with pytest.raises(KeyError):
        r_load_pytree(p, {"w": np.zeros((2, 2)), "v": np.zeros(1)})


@dataclasses.dataclass
class _Pair:
    a: object
    b: object


def test_checkpoint_restores_onto_the_templates_device_and_numpy(tmp_path):
    p = str(tmp_path / "x.npz")
    tree = {"t": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "n": np.asarray(3, np.int32)}
    save_pytree(p, tree)
    out = load_pytree(p, tree)
    assert isinstance(out["t"], torch.Tensor) and \
        out["t"].device == tree["t"].device
    assert torch.equal(out["t"], tree["t"])
    assert isinstance(out["n"], np.ndarray) and int(out["n"]) == 3


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.asarray(3)}}
    p = os.path.join(tmp_path, "x.npz")
    save_pytree(p, tree, {"step": 7})
    out = load_pytree(p, tree)
    np.testing.assert_array_equal(out["a"], tree["a"])
    assert int(out["b"]["c"]) == 3


def test_checkpointer_latest_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"w": np.zeros(3)}
    for s in (10, 20, 30):
        ck.save(s, {"w": np.full(3, s)})
    assert ck.latest_step() == 30
    restored, meta = ck.restore(tree)
    assert meta["step"] == 30
    assert restored["w"][0] == 30
    files = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert len(files) == 2   # keep=2 retention


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    p = os.path.join(tmp_path, "x.npz")
    save_pytree(p, {"w": np.zeros((2, 2))})
    with pytest.raises(ValueError):
        load_pytree(p, {"w": np.zeros((3, 3))})


# -- the trainer -------------------------------------------------------------

def test_loss_decreases(tmp_path):
    losses = train("qwen3-0.6b", steps=25, batch=8, seq=128,
                   ckpt_dir=str(tmp_path), ckpt_every=100, reduced=True,
                   torch_device="cpu")
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert last < first - 0.1, (first, last)


def test_restart_is_bit_exact(tmp_path):
    d1 = os.path.join(tmp_path, "run_straight")
    d2 = os.path.join(tmp_path, "run_restarted")
    kw = dict(batch=4, seq=64, ckpt_every=10, reduced=True,
              torch_device="cpu")
    losses_a = train("qwen3-0.6b", steps=20, ckpt_dir=d1, **kw)
    train("qwen3-0.6b", steps=10, ckpt_dir=d2, **kw)
    losses_b = train("qwen3-0.6b", steps=20, ckpt_dir=d2, **kw)
    assert len(losses_a) == 20 and len(losses_b) == 10
    np.testing.assert_allclose(losses_b[-5:], losses_a[-5:], rtol=1e-5)
    # on one device the replay is bitwise
    assert losses_b == losses_a[10:]


def test_train_cli_on_the_cpu(tmp_path, capsys):
    train_cli.main(["--arch", "rwkv6-3b", "--steps", "3", "--batch", "2",
                    "--seq", "16", "--ckpt-dir", str(tmp_path),
                    "--torch-device", "cpu"])
    assert "final loss" in capsys.readouterr().out
    assert Checkpointer(str(tmp_path)).latest_step() == 3
