"""Carry configurations and problems across from the JAX package.

The port never imports ``repro``; what crosses is plain data. A caller that
has both packages passes ``dataclasses.asdict`` of a reference
``DeviceModel`` / ``PerturbationConfig`` and ``np.asarray`` views of a
reference ``Problem``'s arrays. A carried problem has the same
``content_hash``, so it keys the same oracle-cache entry. The reference's
``jax.random`` draws (SB initial states; the SA, PT and tabu searches'
initial spins, spin orders, uniforms and kick indices) and the physics
tier's chip-variation draws cross as numpy arrays too, and so do the LM
families' parameter trees and the trainer's states.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .api.problem import MAX_LEVEL, Problem
from .api.suite import ProblemSuite
from .core.device_model import DeviceModel
from .core.perturbation import PerturbationConfig
from .device import resolve_device
from .pytree import leaves


def _from_fields(cls, fields: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(**fields)


def device_model_from_fields(fields: dict) -> DeviceModel:
    """``DeviceModel`` from a field dict (e.g. ``dataclasses.asdict`` of the
    reference's)."""
    return _from_fields(DeviceModel, fields)


def perturbation_from_fields(fields: dict) -> PerturbationConfig:
    """``PerturbationConfig`` from a field dict."""
    return _from_fields(PerturbationConfig, fields)


def problem_from_arrays(levels, scale: float = 1.0, h=None,
                        kind: str = "custom", meta: Optional[dict] = None,
                        max_level: int = MAX_LEVEL) -> Problem:
    """``Problem`` from its arrays: (N, N) integer levels, the level ->
    physical ``scale``, optional bias fields ``h``."""
    return Problem(levels=np.asarray(levels), scale=float(scale),
                   h=None if h is None else np.asarray(h), kind=kind,
                   meta=dict(meta or {}), max_level=max_level)


def suite_from_arrays(levels: Sequence, scales: Optional[Sequence] = None,
                      hs: Optional[Sequence] = None,
                      kinds: Optional[Sequence[str]] = None,
                      metas: Optional[Sequence[dict]] = None,
                      max_level: int = MAX_LEVEL) -> ProblemSuite:
    """``ProblemSuite`` from per-problem arrays (aligned sequences; missing
    ones default to scale 1, no fields, kind ``"custom"``, empty meta)."""
    n = len(levels)
    scales = scales if scales is not None else [1.0] * n
    hs = hs if hs is not None else [None] * n
    kinds = kinds if kinds is not None else ["custom"] * n
    metas = metas if metas is not None else [None] * n
    if not all(len(x) == n for x in (scales, hs, kinds, metas)):
        raise ValueError("levels, scales, hs, kinds and metas must align")
    return ProblemSuite([
        problem_from_arrays(lv, sc, h, kind, meta, max_level)
        for lv, sc, h, kind, meta in zip(levels, scales, hs, kinds, metas)])


def sb_inits_from_arrays(x0, y0, torch_device: str | torch.device = "cuda"):
    """The reference's ``sb_inits`` output (numpy (P, R, N) positions and
    momenta) as the port's (P, R, N) float32 tensors on ``torch_device``,
    for ``simulated_bifurcation_jax_runs(x0=, y0=)``."""
    dev = resolve_device(torch_device)
    x0, y0 = (torch.as_tensor(np.array(a, dtype=np.float32),
                              device=dev).contiguous() for a in (x0, y0))
    if x0.dim() != 3 or x0.shape != y0.shape:
        raise ValueError(f"need x0 and y0 of one (P, R, N) shape, got "
                         f"{tuple(x0.shape)} and {tuple(y0.shape)}")
    return x0, y0


def chip_variation_from_arrays(j_gain, tau_scale, slot_offset, gain_scale):
    """The reference's ``ChipVariation`` (numpy: j_gain (C, N, N), tau_scale
    (C,), slot_offset (C,), gain_scale (C,)) as the port's, CPU tensors as
    ``VariationModel.sample`` makes them; ``fleet_anneal`` moves them to
    its device."""
    from .physics.variation import ChipVariation
    jg, tau, off, gain = (torch.as_tensor(np.array(a, dtype=dt))
                          for a, dt in zip((j_gain, tau_scale, slot_offset,
                                            gain_scale),
                                           (np.float32, np.float32,
                                            np.int32, np.float32)))
    C = tau.shape[0]
    if jg.dim() != 3 or jg.shape[0] != C or jg.shape[1] != jg.shape[2] or \
            tuple(off.shape) != (C,) or tuple(gain.shape) != (C,) or \
            tau.dim() != 1:
        raise ValueError(f"need j_gain (C, N, N) and tau_scale, slot_offset, "
                         f"gain_scale (C,), got {tuple(jg.shape)}, "
                         f"{tuple(tau.shape)}, {tuple(off.shape)}, "
                         f"{tuple(gain.shape)}")
    return ChipVariation(j_gain=jg, tau_scale=tau, slot_offset=off,
                         gain_scale=gain)


def _draw_tensors(arrays, dtypes, dev):
    return tuple(torch.as_tensor(np.array(a, dtype=dt), device=dev)
                 for a, dt in zip(arrays, dtypes, strict=True))


def _check_leading(names, tensors, lead: int) -> None:
    """The draws share their leading (problem, restart) dimensions."""
    shapes = [tuple(t.shape[:lead]) for t in tensors]
    if len(set(shapes)) != 1:
        raise ValueError(f"draws {names} disagree on their leading "
                         f"dimensions: {shapes}")


def sa_draws_from_arrays(s0, order, u,
                         torch_device: str | torch.device = "cuda"):
    """The reference's SA draws (numpy: initial spins s0 (P, R, n) ±1, spin
    orders (P, R, T, n), uniforms (P, R, T, n)) as the port's
    ``sa_draws`` tensors, for ``simulated_annealing_jax_runs(draws=)``."""
    dev = resolve_device(torch_device)
    out = _draw_tensors((s0, order, u), (np.float32, np.int32, np.float32),
                        dev)
    _check_leading(("s0", "order", "u"), out, 2)
    return out


def pt_draws_from_arrays(s0, order, u, swap_u,
                         torch_device: str | torch.device = "cuda"):
    """The reference's PT draws (numpy: s0 (P, R, K, n), orders and sweep
    uniforms (P, R, T, K, n), swap uniforms (P, R, T, K)) as the port's
    ``pt_draws`` tensors, for ``parallel_tempering_jax_runs(draws=)``."""
    dev = resolve_device(torch_device)
    out = _draw_tensors((s0, order, u, swap_u),
                        (np.float32, np.int32, np.float32, np.float32), dev)
    _check_leading(("s0", "order", "u", "swap_u"), out, 2)
    return out


def tabu_draws_from_arrays(s0, kick,
                           torch_device: str | torch.device = "cuda"):
    """The reference's tabu draws (numpy: initial spins s0 (P, R, n) ±1 and
    the kick index of every iteration, (P, R, max_iters)) as the port's
    ``tabu_draws`` tensors, for ``tabu_search_jax_runs(draws=)``."""
    dev = resolve_device(torch_device)
    out = _draw_tensors((s0, kick), (np.float32, np.int64), dev)
    _check_leading(("s0", "kick"), out, 2)
    return out


def lm_params_from_arrays(tree, cfg,
                          torch_device: str | torch.device = "cuda"):
    """The reference's LM parameter tree (nested dicts of numpy arrays,
    blocks stacked as (L, ...) leaves: ``jax.tree.map(np.asarray,
    params)``) as the port's float32 parameters on ``torch_device``, for
    the model ``models.build(cfg)`` makes. The two trees have one layout,
    so the leaves are copied as they are; the shapes that tell one
    configuration from another are checked against ``cfg``:
    * every family: the embedding (the padded vocabulary for the
      transformer families), blocks stacked over ``cfg.n_layers``;
    * moe: router (L, D, E), expert stacks wi / wg (L, E, D, F) and
      wo (L, E, F, D);
    * encoder: ``pos_conv`` w (128, D/16, D);
    * hybrid: ONE shared attention + MLP block (no layer axis), so 81
      layers at attn_every 6 are 13 groups of 6 and 3 tail layers;
    * rwkv: the bonus u (L, D/N, N) of N-wide heads.
    """
    from .models import transformer
    if cfg.family not in (*transformer.FAMILIES, "hybrid", "rwkv"):
        raise ValueError(f"no model family {cfg.family!r}")
    dev = resolve_device(torch_device)

    def leaf(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=dev)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else leaf(v)
                for k, v in t.items()}
    params = walk(tree)
    L, D = cfg.n_layers, cfg.d_model
    vocab = (transformer.padded_vocab(cfg)
             if cfg.family in transformer.FAMILIES else cfg.vocab_size)
    want = {"embed": (params["embed"], (vocab, D))}
    if cfg.family == "moe":
        E, F = cfg.n_experts, cfg.d_ff
        ffn = params["blocks"]["ffn"]
        want.update({"blocks.ffn.router": (ffn["router"], (L, D, E)),
                     "blocks.ffn.wi": (ffn["wi"], (L, E, D, F)),
                     "blocks.ffn.wg": (ffn["wg"], (L, E, D, F)),
                     "blocks.ffn.wo": (ffn["wo"], (L, E, F, D))})
    if cfg.family == "encoder":
        want["pos_conv.w"] = (params["pos_conv"]["w"],
                              (transformer.POS_CONV_KERNEL,
                               D // transformer.POS_CONV_GROUPS, D))
    if cfg.family == "hybrid":
        want["shared.attn.wq"] = (params["shared"]["attn"]["wq"],
                                  (D, cfg.padded_heads, cfg.head_dim))
    if cfg.family == "rwkv":
        n = cfg.rwkv_head_dim
        want["blocks.tmix.u"] = (params["blocks"]["tmix"]["u"],
                                 (L, D // n, n))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, {cfg.name} "
                             f"needs {shape}")
    layers = {tuple(t.shape[:1]) for t in leaves(params["blocks"])}
    if layers != {(L,)}:
        raise ValueError(f"block leaves stack {sorted(layers)} layers, "
                         f"{cfg.name} has {L}")
    return params


def train_state_from_arrays(params, opt, step, cfg,
                            torch_device: str | torch.device = "cuda"):
    """The reference's ``TrainState`` (numpy: its params tree, its opt
    ``{"m", "v", "step"}`` and step, e.g. through ``jax.tree.map(
    np.asarray, state)``) as the port's ``training.TrainState`` on
    ``torch_device``: the params and both moment trees go through
    ``lm_params_from_arrays`` (float32, shapes checked against ``cfg``),
    the steps become 0-d int32 tensors."""
    from .training import TrainState
    dev = resolve_device(torch_device)

    def count(a):
        return torch.as_tensor(np.array(a, dtype=np.int32), device=dev)
    return TrainState(
        params=lm_params_from_arrays(params, cfg, torch_device=dev),
        opt={"m": lm_params_from_arrays(opt["m"], cfg, torch_device=dev),
             "v": lm_params_from_arrays(opt["v"], cfg, torch_device=dev),
             "step": count(opt["step"])},
        step=count(step))
