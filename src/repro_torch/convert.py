"""Carry configurations and problems across from the JAX package.

The port never imports ``repro``; what crosses is plain data. A caller that
has both packages passes ``dataclasses.asdict`` of a reference
``DeviceModel`` / ``PerturbationConfig`` and ``np.asarray`` views of a
reference ``Problem``'s arrays. A carried problem has the same
``content_hash``, so it keys the same oracle-cache entry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .api.problem import MAX_LEVEL, Problem
from .api.suite import ProblemSuite
from .core.device_model import DeviceModel
from .core.perturbation import PerturbationConfig


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
