"""Top-k routed MoE with sort-based (active-FLOPs-only) dispatch (the
reference's ``models.moe``).

Routing, per sequence (batch-local: capacity is per sequence and no sort
or scatter crosses the batch axis):
* gates = softmax(x @ router) in float32; the top k by a stable
  descending sort, so ties go to the lower expert index as
  ``jax.lax.top_k`` breaks them (``torch.topk`` promises no tie order);
* the (token, expert) pairs are sorted by expert with a STABLE sort,
  which decides the tokens that overflow an expert's capacity
  ``cap = max(k, round(s * k / E * capacity_factor))`` (Python's round,
  half to even) and are dropped: their combine weight contributes
  nothing;
* kept tokens are copied into an (E * cap) slot buffer, each expert runs
  its SwiGLU on its cap slots, and every token sums its k contributions.

Sums that must not depend on the device: the expert counts are integers;
the dispatch adds each kept token once into a zeroed slot and overflow
rows add zeros, so any order of that scatter gives the same bits; the
combine sums each token's k contributions in a fixed loop in ascending
expert order, the order in which XLA's CPU scatter applies them (a CUDA
``index_add_`` would add them in atomic, run-dependent order). In the
backward, each token's gradient sums its k slots' gradients: the token
gather is ``F.embedding`` over the (B * S, D) rows, whose backward sums
repeats in a fixed order on both devices (``torch.gather``'s adds them
atomically on CUDA, so that a top-8 step on the card did not repeat bit
for bit).

Expert stacks are cast to the activations' dtype at every call, as in
the reference. In a decode step (s = 1) the capacity is k, so each
sequence runs E * k expert slots for its k real ones: the reference's
design, kept.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import (BATCH_AXES, MODEL_AXIS, act_fn, active_mesh, dense_init,
                     from_local, local_shard, logical, process_mesh, psum)


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int):
    """router (D, E); expert stacks wi, wg (E, D, F) and wo (E, F, D), drawn
    on the CPU generator ``gen``."""
    def stack(d_in, d_out):
        return torch.randn((n_experts, d_in, d_out), generator=gen,
                           dtype=torch.float32) * (1.0 / math.sqrt(d_in))
    return {"router": dense_init(gen, d_model, n_experts),
            "wi": stack(d_model, d_ff), "wg": stack(d_model, d_ff),
            "wo": stack(d_ff, d_model)}


def capacity(s: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert and sequence (the reference's rule)."""
    cap = int(max(top_k, round(s * top_k / n_experts * capacity_factor)))
    return min(cap, s * top_k)


def top_k_gates(gates, k: int):
    """(values, indices) of the k largest gates along the last axis, in
    descending order, ties to the lower index (``jax.lax.top_k``'s rule)."""
    idx = torch.argsort(gates, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(gates, -1, idx), idx


def route(router, x, *, top_k: int, cap: int):
    """The routing of ``x`` (B, S, D): a dict of (B, S*k) tensors in
    expert-sorted order: ``se`` expert, ``st`` token, ``sw`` normalised
    gate weight, ``keep`` (within capacity), ``dest`` (slot in the
    (E * cap) buffer; overflow rows point at the last slot); plus ``idx``
    (B, S, k), each token's experts in descending gate order."""
    b, s, _ = x.shape
    e = router.shape[-1]
    tk = s * top_k
    dev = x.device
    gates = torch.softmax(x.float() @ router.float(), dim=-1)      # (B,S,E)
    w, idx = top_k_gates(gates, top_k)                              # (B,S,k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)

    flat_e = idx.reshape(b, tk)
    flat_t = torch.arange(s, device=dev).repeat_interleave(top_k) \
        .expand(b, tk)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = torch.gather(flat_t, 1, order)
    sw = torch.gather(w.reshape(b, tk), 1, order)
    counts = torch.zeros((b, e), dtype=torch.int64, device=dev) \
        .scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=1) - counts                   # exclusive
    pos = torch.arange(tk, device=dev)[None] - torch.gather(starts, 1, se)
    keep = pos < cap
    dest = torch.where(keep, se * cap + pos,
                       torch.full_like(se, e * cap - 1))
    return {"se": se, "st": st, "sw": sw, "keep": keep, "dest": dest,
            "order": order, "idx": idx}


def _dispatch(x, r, n_experts: int, cap: int):
    """The (B, E, cap, D) slot buffer: each kept token copied into its
    slot, overflow rows adding zeros into the last slot."""
    b, s, d = x.shape
    dt = x.dtype
    rows = r["st"] + s * torch.arange(b, device=x.device)[:, None]
    xg = F.embedding(rows, x.reshape(b * s, d))                     # (B,Tk,D)
    buf = torch.zeros((b, n_experts * cap, d), dtype=dt, device=x.device)
    buf.scatter_add_(1, r["dest"][..., None].expand(-1, -1, d),
                     torch.where(r["keep"][..., None], xg,
                                 torch.zeros((), dtype=dt, device=x.device)))
    return buf.reshape(b, n_experts, cap, d)


def _experts_combine(wi, wg, wo, xe, r, *, top_k: int, act: str):
    """Each expert's SwiGLU on its slots, then every token's k weighted
    contributions summed in ascending expert order: (B, S, D). With F-slices
    of the expert stacks, a partial sum over F."""
    b, e, cap, d = xe.shape
    s = r["idx"].shape[1]
    dt = xe.dtype
    a = act_fn(act)
    hi = torch.einsum("becd,edf->becf", xe, wi.to(dt))
    hg = torch.einsum("becd,edf->becf", xe, wg.to(dt))
    ye = torch.einsum("becf,efd->becd", a(hg) * hi, wo.to(dt))

    yflat = ye.reshape(b, e * cap, d)
    contrib = torch.gather(yflat, 1, r["dest"][..., None].expand(-1, -1, d)) \
        * r["sw"][..., None].to(dt)
    contrib = torch.where(r["keep"][..., None], contrib,
                          torch.zeros((), dtype=dt, device=xe.device))
    # back to (token, k) order, then each token's k contributions in
    # ascending expert order, summed left to right from zero
    unsorted = torch.empty_like(contrib)
    unsorted.scatter_(1, r["order"][..., None].expand(-1, -1, d), contrib)
    by_expert = torch.argsort(r["idx"], dim=-1)                     # (B,S,k)
    per_token = torch.gather(
        unsorted.reshape(b, s, top_k, d), 2,
        by_expert[..., None].expand(-1, -1, -1, d))
    out = torch.zeros((b, s, d), dtype=dt, device=xe.device)
    for j in range(top_k):
        out = out + per_token[:, :, j]
    return out


def _slice_count(f_total: int, b: int) -> int:
    """tp, the number of F slices: the active mesh's 'model' axis size when
    it divides F and the data axes divide the batch (the reference's
    ``use_shard_map`` test), else 1."""
    mesh = active_mesh()
    if mesh is None or MODEL_AXIS not in mesh.shape:
        return 1
    tp = mesh.shape[MODEL_AXIS]
    dsize = math.prod(mesh.shape[a] for a in BATCH_AXES if a in mesh.shape)
    if f_total % tp or b % dsize:
        return 1
    return tp


def _experts_over_ranks(params, x, mesh, *, top_k: int, cap: int, act: str):
    """The reference's ``shard_map`` + ``psum`` on a mesh of processes:
    each rank routes and dispatches its local batch, runs its F slice of
    the experts and combines it to a (B_local, S, D) partial; one
    all-reduce over 'model' sums the tp partials. ``x`` and the weights
    are DTensors (``common.local_shard`` gives each rank its part)."""
    x_spec = logical("batch", None, None)
    x_l = local_shard(x, mesh, x_spec)
    wi = local_shard(params["wi"], mesh, (None, None, MODEL_AXIS))
    wg = local_shard(params["wg"], mesh, (None, None, MODEL_AXIS))
    wo = local_shard(params["wo"], mesh, (None, MODEL_AXIS, None))
    router = local_shard(params["router"], mesh, ())
    r = route(router, x_l, top_k=top_k, cap=cap)
    part = _experts_combine(wi, wg, wo,
                            _dispatch(x_l, r, router.shape[-1], cap), r,
                            top_k=top_k, act=act)
    return from_local(psum(part, mesh, (MODEL_AXIS,)), mesh, x_spec, x.shape)


def apply_moe(params, x, *, top_k: int, capacity_factor: float = 1.25,
              act: str = "silu"):
    """x: (B, S, D) -> (B, S, D): route, dispatch, expert SwiGLU, combine.

    Under an active mesh with a 'model' axis of size tp that divides F,
    and data axes that divide the batch, this is the one-device form of
    the reference's ``shard_map`` path: the experts' F axis is cut into tp
    slices, each slice's partial output is combined to (B, S, D) BEFORE
    the slices are summed (the reference's combine-before-psum), and the
    tp partials are summed in slice order, as ``FieldExchange`` sums dies.
    Otherwise tp = 1: one slice, the whole F, which is the reference's
    unsharded path. Routing and dispatch do not depend on F, so they are
    computed once for all slices; the data axes need no split, because
    dispatch is batch-local. On a mesh whose ranks are processes each rank
    computes its own slice's partial and an all-reduce over 'model' sums
    them (``_experts_over_ranks``).
    """
    b, s, d = x.shape
    e = params["router"].shape[-1]
    cap = capacity(s, top_k, e, capacity_factor)
    f_total = params["wi"].shape[-1]
    tp = _slice_count(f_total, b)
    if tp > 1 and process_mesh() is not None:
        return _experts_over_ranks(params, x, process_mesh(), top_k=top_k,
                                   cap=cap, act=act)

    r = route(params["router"], x, top_k=top_k, cap=cap)
    xe = _dispatch(x, r, e, cap)
    ws = (params["wi"], params["wg"], params["wo"])
    if tp > 1:
        fs = f_total // tp
        ws = (ws[0].split(fs, -1), ws[1].split(fs, -1), ws[2].split(fs, 1))
    else:
        ws = tuple((w,) for w in ws)
    out = None
    for wi, wg, wo in zip(*ws):
        part = _experts_combine(wi, wg, wo, xe, r, top_k=top_k, act=act)
        out = part if out is None else out + part
    return out
