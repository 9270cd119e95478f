"""Carry configurations and problems across from the JAX package.

The port never imports ``repro``; what crosses is plain data. A caller that
has both packages passes ``dataclasses.asdict`` of a reference
``DeviceModel`` / ``PerturbationConfig`` and ``np.asarray`` views of a
reference ``Problem``'s arrays. A carried problem has the same
``content_hash``, so it keys the same oracle-cache entry. The reference's
``jax.random`` draws (SB initial states) cross as numpy arrays too.
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
