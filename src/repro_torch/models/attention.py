"""Attention: chunked flash-style self-attention (training / prefill) and
KV-cache decode attention (the reference's ``models.attention``).

Plain torch ops, as the reference is plain ``jnp`` (it spends its Pallas
budget on the Ising anneal): the online-softmax chunked form keeps long
prefills from materializing (S x S) scores. No library attention
(``scaled_dot_product_attention``): its order of summation would part from
the reference's. Products whose reference sets
``preferred_element_type=float32`` run on float32 copies of their operands:
bf16 x bf16 products are exact in float32, so this is that contract.

Shapes: q (B, S, H, D); k, v (B, S, Hkv, D) with H = Hkv * G (GQA).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import spec
from .common import (from_local, local_shard, process_mesh, psum,
                     shard_axes, shard_index)

NEG_INF = -1e30


def _expand_kv(k, n_heads: int):
    """GQA KV expansion (B, S, Hkv, D) -> (B, S, H, D): each KV head is
    repeated for its G query heads, as ``jnp.repeat`` along the head axis."""
    g = n_heads // k.shape[2]
    if g == 1:
        return k
    return torch.repeat_interleave(k, g, dim=2)


def _einsum32(eq, a, b):
    return torch.einsum(eq, a.float(), b.float())


def flash_attention(q, k, v, *, causal: bool = True, q_chunk: int = 512,
                    k_chunk: int = 512, scale: float | None = None):
    """Online-softmax chunked attention. Never materializes (S, S) scores.

    q chunk i attends to kv chunks [0, n_need) only when causal; fully
    masked entries inside those chunks are computed and masked, as in the
    reference. On a mesh of processes the models call it on each rank's
    own batch rows and heads (``transformer._attn_over_ranks``).
    """
    b, s, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    out_dtype = q.dtype

    k = _expand_kv(k, h)
    v = _expand_kv(v, h)

    # keep the causal q loop short: at most 16 q chunks
    q_chunk = min(max(q_chunk, -(-s // 16)), s)
    k_chunk = min(k_chunk, s)
    nq, nk = -(-s // q_chunk), -(-s // k_chunk)
    sp_q, sp_k = nq * q_chunk, nk * k_chunk
    qp = F.pad(q, (0, 0, 0, 0, 0, sp_q - s))
    kp = F.pad(k, (0, 0, 0, 0, 0, sp_k - s))
    vp = F.pad(v, (0, 0, 0, 0, 0, sp_k - s))

    qc = qp.reshape(b, nq, q_chunk, h, d)
    kc = kp.reshape(b, nk, k_chunk, h, d)
    vc = vp.reshape(b, nk, k_chunk, h, d)

    dev = q.device
    q_pos_base = torch.arange(q_chunk, device=dev)
    k_pos_base = torch.arange(k_chunk, device=dev)

    def run_q_chunk(i):
        q_blk = qc[:, i]
        q_pos = i * q_chunk + q_pos_base
        n_need = min(-(-((i + 1) * q_chunk) // k_chunk), nk) if causal else nk
        acc = torch.zeros((b, q_chunk, h, d), dtype=torch.float32, device=dev)
        m = torch.full((b, q_chunk, h), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, q_chunk, h), dtype=torch.float32, device=dev)
        for j in range(n_need):
            k_blk, v_blk = kc[:, j], vc[:, j]
            s_blk = _einsum32("bqhd,bchd->bqhc", q_blk, k_blk) * scale
            k_pos = j * k_chunk + k_pos_base
            valid = (k_pos < s)[None, None, None, :]
            if causal:
                cm = k_pos[None, :] <= q_pos[:, None]            # (qc, kc)
                valid = valid & cm[None, :, None, :]
            s_blk = torch.where(valid, s_blk, NEG_INF)
            m_new = torch.maximum(m, s_blk.amax(dim=-1))
            # p at INPUT precision for the PV product; the running
            # (m, l, acc) statistics stay f32 regardless
            p32 = torch.exp(s_blk - m_new[..., None])
            p = p32.to(out_dtype)
            corr = torch.exp(m - m_new)
            l = l * corr + p32.sum(dim=-1)
            pv = _einsum32("bqhc,bchd->bqhd", p, v_blk)
            acc = acc * corr[..., None] + pv
            m = m_new
        return acc / torch.clamp(l[..., None], min=1e-30)

    out = torch.stack([run_q_chunk(i) for i in range(nq)], dim=1)
    out = out.reshape(b, sp_q, h, d)[:, :s]
    return out.to(out_dtype)


def write_position(cache, pos: int, new) -> None:
    """``cache[:, pos] = new`` in place, for ``cache`` (B, S, ...) and
    ``new`` (B, ...). On a DTensor cache only the rank whose shard holds
    ``pos`` writes, into its local shard (the reference's
    ``dynamic_update_slice``): selecting ``pos`` from the DTensor would
    gather the sharded sequence and write into the gathered copy."""
    mesh = getattr(cache, "device_mesh", None)
    if mesh is None:
        cache[:, pos] = new
        return
    from torch.distributed.tensor import Replicate, Shard
    start, size = 0, cache.shape[1]
    new_pl = []
    for i, p in enumerate(cache.placements):
        if p.is_shard(1):                  # mesh axes cut S major to minor
            size //= mesh.size(i)
            start += mesh.get_coordinate()[i] * size
            p = Replicate()
        elif p.is_shard() and p.dim > 1:
            p = Shard(p.dim - 1)
        new_pl.append(p)
    new = new.redistribute(mesh, new_pl).to_local()
    if start <= pos < start + size:
        cache.to_local()[:, pos - start] = new


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     scale: float | None = None):
    """One-token attention against a KV cache.

    q: (B, 1, H, D); k_cache / v_cache: (B, Smax, Hkv, D); cache_len: an
    integer or (B,) number of valid cache entries (the new token's K/V must
    already be written at position cache_len - 1). A full pass over Smax.
    On a mesh of processes each rank attends over its own slice of the
    cache (``_decode_over_ranks``).
    """
    mesh = process_mesh()
    if mesh is not None:
        return _decode_over_ranks(q, k_cache, v_cache, cache_len, scale,
                                  mesh)
    return _decode(q, k_cache, v_cache, cache_len, scale)


def _decode(q, k_cache, v_cache, cache_len, scale, start: int = 0,
            reduce=None):
    """``decode_attention`` over cache positions ``start`` on; ``reduce``
    combines the softmax's max and sum and the output across the ranks
    that hold the other positions."""
    b, _, h, d = q.shape
    n_kv = k_cache.shape[2]
    g = h // n_kv
    scale = scale if scale is not None else d ** -0.5
    reduce = reduce or (lambda t, op: t)
    qg = q.reshape(b, n_kv, g, d)
    s_all = _einsum32("bkgd,bskd->bkgs", qg, k_cache) * scale
    pos = torch.arange(start, start + k_cache.shape[1], device=q.device)
    valid = pos[None, :] < torch.as_tensor(
        cache_len, device=q.device).reshape(-1, 1)               # (B, Smax)
    s_all = torch.where(valid[:, None, None, :], s_all, NEG_INF)
    m = reduce(s_all.amax(dim=-1, keepdim=True), "max")
    p = torch.exp(s_all - m)
    l = reduce(p.sum(dim=-1, keepdim=True), "sum")
    out = reduce(_einsum32("bkgs,bskd->bkgd", p / torch.clamp(l, min=1e-30),
                           v_cache), "sum")
    return out.reshape(b, 1, h, d).to(q.dtype)


def _decode_over_ranks(q, k_cache, v_cache, cache_len: int, scale, mesh):
    """Flash-decoding's split-KV on a mesh of processes, what XLA makes of
    the reference's full pass over a sequence-sharded cache: each rank
    scores its own cache positions for its batch rows (every head), and
    the max, the sum and the output are all-reduced over the ranks that
    split the sequence."""
    s_axes = shard_axes(k_cache, mesh, 1)
    b_entry = spec(shard_axes(k_cache, mesh, 0))[0]
    layout = (b_entry, None, None, None)
    kl = k_cache.to_local()
    out = _decode(local_shard(q, mesh, layout, split=s_axes), kl,
                  v_cache.to_local(), cache_len, scale,
                  shard_index(k_cache, mesh, 1) * kl.shape[1],
                  lambda t, op: psum(t, mesh, s_axes, op))
    return from_local(out, mesh, layout, q.shape)


def reference_attention(q, k, v, *, causal: bool = True,
                        scale: float | None = None):
    """O(S^2)-memory oracle for tests."""
    b, s, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    s_all = _einsum32("bqhd,bchd->bhqc", q, k) * scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        s_all = torch.where(mask[None, None], s_all, NEG_INF)
    p = torch.softmax(s_all, dim=-1)
    out = _einsum32("bhqc,bchd->bqhd", p, v)
    return out.to(q.dtype)
