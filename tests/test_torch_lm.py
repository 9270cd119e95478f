"""The LM scaffolding's serving path in the port (configs, every model
family, ``serve_lm``) against the JAX package.

The same numpy inputs, and the reference's own initial weights carried
across by ``convert.lm_params_from_arrays``, go to ``repro`` and
``repro_torch`` (``torch_device="cpu"``). Tolerances, fixed before the port
was written:
  * bitwise: every config field (``REGISTRY``, ``reduced()``, ``cells()``),
    the synthetic data batches, the greedy tokens;
  * within 1e-6: ``rms_norm``, ``layer_norm``, ``apply_rope``;
  * within 1e-5 (rtol and atol): the attention functions against the
    reference's at ``tests/test_attention.py``'s cases (1e-2 in bf16);
  * dense models (reduced, float32): forward hiddens, prefill logits and
    caches and 8 greedy decode steps at ``rtol=1e-4, atol=1e-5``; before
    tokens are compared, each step's top-2 logit gap must exceed 10x that
    tolerance (a near-tie is reported, never re-seeded away);
  * the other families (reduced, float32) at the same tolerance and the
    same greedy rule: moe and vlm as the dense ones (vlm with vision
    embeddings spliced over the prompt's prefix); the encoder's forward at
    an even and an odd length; hybrid and rwkv, which have no prefill,
    through the prompt token by token and then 8 greedy steps;
  * the encoder's conv positional embedding against
    ``jax.lax.conv_general_dilated`` at 1e-5.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.data import SyntheticLM as RSyntheticLM
from repro.data import DataState as RDataState
from repro.data import make_batch_iterator as r_make_batch_iterator
from repro.models import build as r_build
from repro.models import attention as r_attention
from repro.models import common as r_common
from repro_torch import configs
from repro_torch.convert import lm_params_from_arrays
from repro_torch.data import DataState, SyntheticLM, make_batch_iterator
from repro_torch.launch import serve_lm
from repro_torch.models import attention, build, common, transformer
from repro_torch.pytree import leaves

RTOL, ATOL = 1e-4, 1e-5
DENSE = ["qwen3-0.6b", "qwen2-7b", "qwen2-1.5b", "chatglm3-6b"]
#: the families past the dense one, one arch each (two for moe)
FAMILIES = ["granite-moe-3b-a800m", "olmoe-1b-7b", "llava-next-mistral-7b",
            "hubert-xlarge", "zamba2-7b", "rwkv6-3b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU ops run faster on one thread than on a pool that also
    competes with XLA's; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(dtype)


# -- configs -----------------------------------------------------------------

def test_registry_and_shapes_match_reference():
    assert list(configs.REGISTRY) == list(r_configs.REGISTRY)
    for arch, cfg in configs.REGISTRY.items():
        ref = r_configs.REGISTRY[arch]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), arch
        assert dataclasses.asdict(cfg.reduced()) == \
            dataclasses.asdict(ref.reduced()), arch
        over = {"n_layers": 5, "d_model": 64}
        assert dataclasses.asdict(cfg.reduced(**over)) == \
            dataclasses.asdict(ref.reduced(**over)), arch
        # ising64 has no heads: its head_dim divides by zero in both
        pairs = [(cfg.reduced(), ref.reduced())] + (
            [(cfg, ref)] if cfg.family != "ising" else [])
        for a, r in pairs:
            for prop in ("head_dim", "padded_heads", "sub_quadratic",
                         "has_decode"):
                assert getattr(a, prop) == getattr(r, prop), (arch, prop)
        assert configs.get_config(arch) == cfg
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in r_configs.SHAPES.items()}
    assert configs.ISING_SHAPES == r_configs.ISING_SHAPES
    for skipped in (False, True):
        assert configs.cells(skipped) == r_configs.cells(skipped)
    with pytest.raises(KeyError):
        configs.get_config("gpt-5")


# -- common ops --------------------------------------------------------------

def test_norms_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    w = rng.normal(size=(48,)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    np.testing.assert_allclose(
        common.rms_norm(_t(x), _t(w), 1e-5).numpy(),
        np.asarray(r_common.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        common.layer_norm(_t(x), _t(w), _t(b), 1e-5).numpy(),
        np.asarray(r_common.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), 1e-5)),
        rtol=1e-6, atol=1e-6)
    out = common.rms_norm(_t(x, torch.bfloat16), _t(w), 1e-5)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_act_fn_matches_reference(name):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(
        common.act_fn(name)(_t(x)).numpy(),
        np.asarray(r_common.act_fn(name)(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_matches_reference(fraction, theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 40, 3, 32)).astype(np.float32)
    pos = np.tile(np.arange(40, dtype=np.int32), (2, 1))
    out = common.apply_rope(_t(x), torch.as_tensor(pos), fraction=fraction,
                            theta=theta)
    ref = r_common.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                              fraction=fraction, theta=theta)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(out.numpy()[..., int(32 * fraction):],
                                  x[..., int(32 * fraction):])


# -- attention ---------------------------------------------------------------

def _qkv(rng, b, s, h, hkv, d):
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))


@pytest.mark.parametrize("b,s,h,hkv,d,causal,qc,kc", [
    (2, 128, 8, 4, 32, True, 64, 64),
    (2, 128, 8, 8, 32, False, 32, 64),
    (1, 200, 6, 2, 16, True, 64, 64),     # uneven chunking
    (1, 64, 4, 1, 64, True, 16, 16),      # MQA
    (2, 96, 12, 4, 8, False, 96, 32),
    (1, 300, 2, 1, 8, True, 8, 40),       # the q-chunk rule: 8 -> 19
])
def test_flash_attention_matches_reference(b, s, h, hkv, d, causal, qc, kc):
    q, k, v = _qkv(np.random.default_rng(s + h), b, s, h, hkv, d)
    out = attention.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                    q_chunk=qc, k_chunk=kc)
    ref = r_attention.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      q_chunk=qc, k_chunk=kc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    full = attention.reference_attention(_t(q), _t(k), _t(v), causal=causal)
    r_full = r_attention.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(full.numpy(), np.asarray(r_full), rtol=1e-5,
                               atol=1e-5)


def test_flash_attention_bf16_matches_reference():
    q, k, v = _qkv(np.random.default_rng(3), 1, 64, 4, 2, 32)
    out = attention.flash_attention(*(_t(a, torch.bfloat16)
                                      for a in (q, k, v)),
                                    causal=True, q_chunk=32, k_chunk=32)
    ref = r_attention.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                        for a in (q, k, v)),
                                      causal=True, q_chunk=32, k_chunk=32)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_decode_attention_matches_reference():
    b, s, h, hkv, d, smax = 2, 33, 8, 4, 16, 40
    q, k, v = _qkv(np.random.default_rng(4), b, s, h, hkv, d)
    kc = np.zeros((b, smax, hkv, d), np.float32)
    vc = np.zeros((b, smax, hkv, d), np.float32)
    kc[:, :s], vc[:, :s] = k, v
    out = attention.decode_attention(_t(q[:, -1:]), _t(kc), _t(vc), s)
    ref = r_attention.decode_attention(jnp.asarray(q[:, -1:]),
                                       jnp.asarray(kc), jnp.asarray(vc),
                                       jnp.asarray(s))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    lens = np.array([s, 20])
    out = attention.decode_attention(_t(q[:, -1:]), _t(kc), _t(vc),
                                     torch.as_tensor(lens))
    ref = r_attention.decode_attention(jnp.asarray(q[:, -1:]),
                                       jnp.asarray(kc), jnp.asarray(vc),
                                       jnp.asarray(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# -- dense models ------------------------------------------------------------

def _cfg(arch):
    if arch == "qwen2-7b-padded":
        # 3 heads padded to 4: the padded head must be masked
        return configs.get_config("qwen2-7b").reduced(
            n_heads=3, n_kv_heads=1, head_pad_multiple=4)
    if arch == "zamba2-7b":
        # 5 layers at attn_every 2: two groups and a tail layer
        return configs.get_config(arch).reduced(n_layers=5)
    return configs.get_config(arch).reduced()


def _r_cfg(cfg):
    """The reference's config with every field of the port's ``cfg``."""
    return dataclasses.replace(r_configs.get_config(cfg.name),
                               **dataclasses.asdict(cfg))


def _models(arch, seed=0):
    """The reference model with its own initial weights, and the port's
    with the same weights carried across."""
    cfg = _cfg(arch)
    r_model = r_build(_r_cfg(cfg))
    r_params = r_model.init(jax.random.PRNGKey(seed))
    arrays = jax.tree.map(np.asarray, r_params)
    params = lm_params_from_arrays(arrays, cfg, torch_device="cpu")
    return cfg, r_model, r_params, build(cfg), params, arrays


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=RTOL,
                               atol=ATOL)


def _check_gap(logits):
    """Each row's top-2 logit gap exceeds 10x the comparison tolerance, so
    the greedy token is decided by the model, not by rounding."""
    top2 = np.sort(logits, axis=-1)[:, -2:]
    tol = ATOL + RTOL * np.abs(top2[:, 1])
    gap = top2[:, 1] - top2[:, 0]
    assert np.all(gap > 10 * tol), f"near-tie: gaps {gap}, tolerance {tol}"


@pytest.mark.parametrize("arch", [*DENSE, "qwen2-7b-padded"])
def test_dense_model_matches_reference(arch):
    cfg, r_model, r_params, model, params, arrays = _models(arch)
    if arch == "qwen2-7b-padded":
        assert cfg.padded_heads == 4 > cfg.n_heads
        assert np.all(arrays["blocks"]["attn"]["wo"][:, 3:] == 0)
    # the parameter tree and shapes: the port's own init equals the
    # reference's
    own = model.init(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(np.shape, arrays) == \
        jax.tree.map(lambda t: tuple(t.shape), own)
    B, S, gen, smax = 2, 20, 8, 32
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S))
    with torch.no_grad():
        _close(model.forward(params, {"tokens": torch.as_tensor(toks)}),
               r_model.forward(r_params, {"tokens": jnp.asarray(toks)}))
        logits, cache = model.prefill(params, {"tokens": torch.as_tensor(
            toks)}, max_len=smax)
        r_logits, r_cache = r_model.prefill(
            r_params, {"tokens": jnp.asarray(toks, jnp.int32)}, max_len=smax)
        _close(logits, r_logits)
        for key in ("k", "v"):
            assert tuple(cache[key].shape) == r_cache[key].shape == (
                cfg.n_layers, B, smax, cfg.n_kv_heads, cfg.head_dim)
            _close(cache[key], r_cache[key])
        assert cache["pos"] == int(r_cache["pos"]) == S
        for step in range(gen):
            r_np = np.asarray(r_logits)
            _check_gap(r_np)
            tok = torch.argmax(logits, -1)
            r_tok = jnp.argmax(r_logits, -1).astype(jnp.int32)
            np.testing.assert_array_equal(tok.numpy(), np.asarray(r_tok))
            logits, cache = model.decode_step(params, cache, tok)
            r_logits, r_cache = r_model.decode_step(r_params, r_cache, r_tok)
            _close(logits, r_logits)
        _close(cache["k"], r_cache["k"])
        assert cache["pos"] == int(r_cache["pos"]) == S + gen


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-0.6b", "chatglm3-6b",
                                  "olmoe-1b-7b", "zamba2-7b", "rwkv6-3b"])
def test_decode_parity(arch):
    """Parallel forward == sequential KV-cache decode (the reference's
    ``test_decode_parity``, on the port alone). MoE: capacity drops differ
    between batch routing and per-token decode, so, as in the reference,
    a capacity factor of 8 removes them."""
    cfg = dataclasses.replace(_cfg(arch), capacity_factor=8.0)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 20
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)))
    with torch.no_grad():
        h = model.forward(params, {"tokens": toks})
        logits_par = (h @ transformer.lm_head_weight(params, cfg)).numpy()
        cache = model.init_cache(B, S, torch_device="cpu")
        outs = []
        for t in range(S):
            lg, cache = model.decode_step(params, cache, toks[:, t])
            outs.append(lg.numpy())
    logits_seq = np.stack(outs, 1)
    logits_par = logits_par[..., :cfg.vocab_size]
    scale = np.abs(logits_par).max()
    np.testing.assert_allclose(logits_par / scale, logits_seq / scale,
                               atol=3e-5)


def test_prefill_matches_decode_warmup():
    cfg = configs.get_config("qwen3-0.6b").reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(3), "cpu")
    B, S = 2, 12
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)))
    with torch.no_grad():
        logits_pre, cache_pre = model.prefill(params, {"tokens": toks},
                                              max_len=S + 4)
        cache = model.init_cache(B, S + 4, torch_device="cpu")
        for t in range(S):
            lg, cache = model.decode_step(params, cache, toks[:, t])
    np.testing.assert_allclose(logits_pre.numpy(), lg.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(cache_pre["k"][:, :, :S].numpy(),
                               cache["k"][:, :, :S].numpy(), rtol=2e-4,
                               atol=2e-4)
    assert cache_pre["pos"] == S


def test_params_from_arrays_refuses_another_config():
    _, _, _, _, _, arrays = _models("qwen3-0.6b")
    other = configs.get_config("qwen3-0.6b").reduced(n_layers=3)
    with pytest.raises(ValueError, match="layers"):
        lm_params_from_arrays(arrays, other, torch_device="cpu")
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_arrays(
            arrays, configs.get_config("qwen3-0.6b").reduced(vocab_size=512),
            torch_device="cpu")


# -- data --------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,shards", [
    (256, 64, 4, 1), (151936, 33, 6, 3), (65024, 128, 2, 2)])
def test_synthetic_batches_bitwise(vocab, seq, batch, shards):
    ds, rds = SyntheticLM(vocab, seq, batch), RSyntheticLM(vocab, seq, batch)
    for step in (0, 1, 17):
        for shard in range(shards):
            for a, b in zip(ds.batch_at(step, shard, shards),
                            rds.batch_at(step, shard, shards)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    st, rst = DataState(step=5), RDataState(step=5)
    it, rit = make_batch_iterator(ds, st), r_make_batch_iterator(rds, rst)
    for _ in range(3):
        a, b = next(it), next(rit)
        assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "labels"))
    assert st.step == rst.step == 8


# -- serving -----------------------------------------------------------------

def test_serve_cuts_the_depth_and_keeps_the_widths(monkeypatch, capsys):
    built, real = [], serve_lm.build
    monkeypatch.setattr(serve_lm, "build",
                        lambda cfg: built.append(cfg) or real(cfg))
    out = serve_lm.serve("qwen3-0.6b", batch=1, prompt_len=4, gen=2,
                         torch_device="cpu", n_layers=1)
    serve_lm.main(["--arch", "rwkv6-3b", "--layers", "1", "--batch", "1",
                   "--prompt-len", "4", "--gen", "2", "--torch-device",
                   "cpu"])
    assert "tok/s), sample:" in capsys.readouterr().out
    assert out["generated"].shape == (1, 2)
    assert built == [dataclasses.replace(
        configs.get_config(arch).reduced(), n_layers=1)
        for arch in ("qwen3-0.6b", "rwkv6-3b")]


def test_serve_runs_on_the_cpu_and_the_shim_warns(capsys):
    out = serve_lm.serve("qwen3-0.6b", batch=2, prompt_len=16, gen=4,
                         torch_device="cpu")
    assert out["generated"].shape == (2, 4)
    assert out["generated"].dtype == np.int32
    assert np.all((out["generated"] >= 0) &
                  (out["generated"] < configs.get_config(
                      "qwen3-0.6b").vocab_size))
    assert out["prefill_s"] > 0 and out["decode_s"] > 0
    assert out["tok_per_s"] > 0
    again = serve_lm.serve("qwen3-0.6b", batch=2, prompt_len=16, gen=4,
                           torch_device="cpu")
    assert np.array_equal(out["generated"], again["generated"])
    serve_lm.main(["--arch", "chatglm3-6b", "--batch", "1", "--prompt-len",
                   "8", "--gen", "3", "--torch-device", "cpu"])
    assert "tok/s), sample:" in capsys.readouterr().out
    import importlib
    import sys
    sys.modules.pop("repro_torch.launch.serve", None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        shim = importlib.import_module("repro_torch.launch.serve")
    assert any(issubclass(w.category, DeprecationWarning) and
               "serve_lm" in str(w.message) for w in caught)
    assert shim.serve is serve_lm.serve


@pytest.mark.parametrize("arch", [a for a, c in configs.REGISTRY.items()
                                  if c.family not in ("dense", "ising")])
def test_other_families_raise(arch):
    """Every family now builds, and raises where the reference raises: the
    entries its ``Model`` lacks are None in the port too (the encoder has
    no decode, the recurrent families no prefill), serving the encoder
    exits with the reference's message, and ``ising`` is no model."""
    cfg = configs.get_config(arch).reduced()
    model, r_model = build(cfg), r_build(_r_cfg(cfg))
    for entry in ("prefill", "init_cache", "decode_step"):
        assert (getattr(model, entry) is None) == \
            (getattr(r_model, entry) is None), (arch, entry)
    if cfg.family == "encoder":
        with pytest.raises(SystemExit, match="encoder-only; no decode path"):
            serve_lm.serve(arch, 1, 4, 2, torch_device="cpu")
    with pytest.raises(ValueError, match="no model family"):
        build(configs.get_config("ising64"))


# -- the other families ------------------------------------------------------

def _prompt_batch(cfg, B, S, seed=7):
    rng = np.random.default_rng(seed)
    if cfg.family == "encoder":
        x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        return {"embeds": x}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
            for k, v in batch.items()}


def _greedy_against_reference(model, params, r_decode, r_params, logits,
                              r_logits, cache, r_cache, gen):
    """``gen`` greedy steps on both, comparing tokens and logits."""
    for _ in range(gen):
        _check_gap(np.asarray(r_logits))
        tok = torch.argmax(logits, -1)
        r_tok = jnp.argmax(r_logits, -1).astype(jnp.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(r_tok))
        logits, cache = model.decode_step(params, cache, tok)
        r_logits, r_cache = r_decode(r_params, r_cache, r_tok)
        _close(logits, r_logits)
    return cache, r_cache


@pytest.mark.parametrize("arch,S", [
    ("granite-moe-3b-a800m", 20), ("olmoe-1b-7b", 20),
    ("llava-next-mistral-7b", 20), ("hubert-xlarge", 20),
    ("hubert-xlarge", 21), ("zamba2-7b", 20), ("rwkv6-3b", 20)])
def test_family_model_matches_reference(arch, S):
    """The reference runs jitted, as its ``serve_lm`` runs it."""
    cfg, r_model, r_params, model, params, arrays = _models(arch)
    own = model.init(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(np.shape, arrays) == \
        jax.tree.map(lambda t: tuple(t.shape), own)
    B, gen, smax = 2, 8, 32
    batch = _prompt_batch(cfg, B, S)
    tb, jb = _torch_batch(batch), _jax_batch(batch)
    with torch.no_grad():
        _close(model.forward(params, tb),
               jax.jit(r_model.forward)(r_params, jb))
        r_decode = (jax.jit(r_model.decode_step)
                    if r_model.decode_step is not None else None)
        if model.prefill is not None:
            logits, cache = model.prefill(params, tb, max_len=smax)
            r_logits, r_cache = jax.jit(
                lambda p, b: r_model.prefill(p, b, max_len=smax))(
                    r_params, jb)
            _close(logits, r_logits)
            for key in ("k", "v"):
                _close(cache[key], r_cache[key])
        elif model.decode_step is not None:
            # no prefill: the prompt goes through decode_step token by token
            cache = model.init_cache(B, smax, torch_device="cpu")
            r_cache = r_model.init_cache(B, smax)
            for t in range(S):
                logits, cache = model.decode_step(params, cache,
                                                  tb["tokens"][:, t])
                r_logits, r_cache = r_decode(r_params, r_cache,
                                             jb["tokens"][:, t])
                _close(logits, r_logits)
        else:
            assert cfg.family == "encoder"
            return
        cache, r_cache = _greedy_against_reference(
            model, params, r_decode, r_params, logits, r_logits, cache,
            r_cache, gen)
    assert cache["pos"] == int(r_cache["pos"]) == S + gen
    for key, t in cache.items():
        if key != "pos":
            assert t.dtype == getattr(torch, str(r_cache[key].dtype)), key
            _close(t, r_cache[key])


def test_vlm_prefix_splice():
    cfg, r_model, r_params, model, params, _ = _models(
        "llava-next-mistral-7b")
    batch = _torch_batch(_prompt_batch(cfg, 2, 24))
    with torch.no_grad():
        h1 = model.forward(params, batch)
        h2 = model.forward(params, dict(
            batch, vision_embeds=batch["vision_embeds"] + 1.0))
        # the splice replaces the first n_vis token embeddings outright
        nv = cfg.n_vision_tokens
        other = dict(batch, tokens=batch["tokens"].clone())
        other["tokens"][:, :nv] = (other["tokens"][:, :nv] + 1) \
            % cfg.vocab_size
        h3 = model.forward(params, other)
    assert not np.allclose(h1.numpy(), h2.numpy())
    np.testing.assert_array_equal(h1.numpy(), h3.numpy())


def test_encoder_is_bidirectional():
    cfg = _cfg("hubert-xlarge")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(_prompt_batch(cfg, 2, 64))
    with torch.no_grad():
        h1 = model.forward(params, batch)
        batch["embeds"][:, -1] += 10.0
        h2 = model.forward(params, batch)
    # perturbing the LAST frame changes the FIRST frame's output
    assert (h2[:, 0] - h1[:, 0]).abs().max() > 1e-6


@pytest.mark.parametrize("s", [150, 151])
def test_encoder_pos_conv_matches_reference(s):
    """Kernel 128 with "SAME" padding pads 63 left and 64 right; at an
    even and an odd length past the kernel's width."""
    rng = np.random.default_rng(s)
    d = 128
    x = rng.normal(size=(2, s, d)).astype(np.float32)
    w = rng.normal(size=(transformer.POS_CONV_KERNEL,
                         d // transformer.POS_CONV_GROUPS, d)).astype(
        np.float32) * 0.05
    out = transformer.pos_conv({"w": torch.as_tensor(w)}, torch.as_tensor(x))
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1,), "SAME",
        dimension_numbers=("NWC", "WIO", "NWC"), feature_group_count=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# -- seeded weights: drawn on the CPU, copied to the device ------------------

class _NotOnTheCpu:
    """A generator-like object on another device (this container's torch
    cannot make a CUDA generator)."""
    device = torch.device("cuda")


@pytest.mark.parametrize("arch", DENSE[:1] + FAMILIES)
def test_init_takes_a_cpu_generator_and_a_device(arch):
    from repro_torch.training import init_train_state
    cfg = configs.get_config(arch).reduced()
    model = build(cfg)
    a = model.init(torch.Generator().manual_seed(0), "cpu")
    b = model.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    assert all(torch.equal(x, y) and x.device.type == "cpu"
               for x, y in zip(leaves(a), leaves(b)))
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        model.init(_NotOnTheCpu(), "cpu")
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        init_train_state(cfg, _NotOnTheCpu(), "cpu")
    with pytest.raises(TypeError):
        model.init(torch.Generator().manual_seed(0))   # no device given


def test_entry_points_make_their_generator_on_the_cpu(monkeypatch,
                                                      tmp_path):
    """``serve`` and ``train`` draw from ``torch.Generator()``, never from a
    generator on their ``torch_device`` (whose stream depends on the
    device): the generator they make names no device."""
    from repro_torch.launch.train import train
    made = []

    class Spy(torch.Generator):
        def __init__(self, *args, **kw):
            made.append((args, kw))
            super().__init__(*args, **kw)
    monkeypatch.setattr(torch, "Generator", Spy)
    serve_lm.serve("olmoe-1b-7b", batch=1, prompt_len=4, gen=2,
                   torch_device="cpu")
    train("qwen3-0.6b", steps=1, batch=2, seq=8, ckpt_dir=str(tmp_path),
          torch_device="cpu")
    assert made == [((), {}), ((), {})]


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "olmoe-1b-7b",
                                  "llava-next-mistral-7b", "zamba2-7b",
                                  "rwkv6-3b"])
def test_serve_each_family_on_the_cpu(arch):
    out = serve_lm.serve(arch, batch=2, prompt_len=6, gen=3,
                         torch_device="cpu")
    vocab = configs.get_config(arch).vocab_size
    assert out["generated"].shape == (2, 3)
    assert np.all((out["generated"] >= 0) & (out["generated"] < vocab))
    assert out["tok_per_s"] > 0 and out["logits_finite"]


@pytest.mark.parametrize("arch,other,match", [
    ("olmoe-1b-7b", dict(n_experts=4), "ffn.router"),
    ("olmoe-1b-7b", dict(d_ff=128), "ffn.wi"),
    ("hubert-xlarge", dict(d_model=64, d_head=16), "embed"),
    ("zamba2-7b", dict(n_layers=4), "layers"),
    ("zamba2-7b", dict(n_heads=8), "shared.attn.wq"),
    ("rwkv6-3b", dict(rwkv_head_dim=16), "tmix.u")])
def test_lm_params_from_arrays_checks_family_shapes(arch, other, match):
    cfg, _, _, _, _, arrays = _models(arch)
    with pytest.raises(ValueError, match=match):
        lm_params_from_arrays(arrays, dataclasses.replace(cfg, **other),
                              torch_device="cpu")
    # zamba: one shared block, blocks over every layer (13 x 6 + 3 at 81)
    if arch == "zamba2-7b":
        assert arrays["shared"]["attn"]["wq"].ndim == 3


def test_apply_block_matches_reference():
    """One reduced dense block, the reference's public ``apply_block``
    against the port's, on the same weights and a random stream."""
    from repro.models import transformer as r_transformer
    cfg, _, r_params, _, params, _ = _models("qwen3-0.6b")
    r_p = jax.tree.map(lambda a: a[0], r_params["blocks"])
    p = transformer.layers(params["blocks"])[0]
    x = np.random.default_rng(3).normal(
        size=(2, 12, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    want = r_transformer.apply_block(r_p, _r_cfg(cfg), jnp.asarray(x),
                                     jnp.asarray(pos))
    got = transformer.apply_block(p, cfg, torch.as_tensor(x),
                                  torch.as_tensor(pos))
    assert got.shape == want.shape
    _close(got.numpy(), want)
