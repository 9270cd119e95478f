"""Disk-backed best-known-energy oracle, keyed by ``Problem.content_hash``.

Level-space best-known energies persist in the port's own sharded cache
(default ``experiments/oracle_cache_torch.json``, stored as
``experiments/oracle_cache_torch.shards/``; ``REPRO_TORCH_ORACLE_CACHE``
relocates it). The port never writes the JAX package's
``experiments/oracle_cache.shards/``.

Tiering: N <= ``BRUTE_FORCE_MAX_N`` is solved exactly by brute force;
larger problems get the host numpy ``tabu_search`` with
``TABU_JAX_ORACLE_RESTARTS`` restarts per problem (method ``"tabu"``).

Escape hatches: ``use_cache=False`` bypasses reads AND writes;
``refresh=True`` recomputes but still persists.
"""
from __future__ import annotations

import os
import time

import numpy as np

from ..solvers.brute_force import BRUTE_FORCE_MAX_N
from ..utils import load_sharded_json_cache, store_sharded_json_cache
from .problem import Problem
from .suite import ProblemSuite

_CACHE_ENV = "REPRO_TORCH_ORACLE_CACHE"
_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))
DEFAULT_CACHE = os.path.join(_REPO_ROOT, "experiments",
                             "oracle_cache_torch.json")

#: restarts per problem for the tabu tier (the reference's batched tier
#: uses the same count).
TABU_JAX_ORACLE_RESTARTS = 16


def cache_path() -> str:
    return os.environ.get(_CACHE_ENV, DEFAULT_CACHE)


_load = load_sharded_json_cache


def _keep_best(old: dict, new: dict) -> dict:
    """Concurrent-writer conflict rule: best-known energies are upper
    bounds on the ground state, so the LOWER energy wins the merge. Ties go
    to the NEW entry, so an exact-tier upgrade keeps its method."""
    try:
        return new if float(new["energy"]) <= float(old["energy"]) else old
    except (KeyError, TypeError, ValueError):
        return new


def _store(path: str, cache: dict) -> None:
    store_sharded_json_cache(path, cache, resolve=_keep_best)


def _compute(problem: Problem, seed: int) -> dict:
    """Exact tier for n <= the shared boundary, host tabu above it."""
    stamp = time.strftime("%Y-%m-%d %H:%M:%S")
    if problem.n <= BRUTE_FORCE_MAX_N:
        from ..solvers.brute_force import brute_force_ground_state
        e, _ = brute_force_ground_state(problem.J_levels)
        return {"energy": float(e), "method": "brute_force", "n": problem.n,
                "kind": problem.kind, "computed_at": stamp}
    from ..solvers.tabu import tabu_search
    e, _ = tabu_search(problem.J_levels, n_restarts=TABU_JAX_ORACLE_RESTARTS,
                       seed=seed)
    return {"energy": float(e), "method": "tabu", "n": problem.n,
            "kind": problem.kind, "restarts": TABU_JAX_ORACLE_RESTARTS,
            "computed_at": stamp}


def _as_problems(problems):
    if isinstance(problems, Problem):
        return [problems]
    if isinstance(problems, ProblemSuite):
        return problems.problems
    return problems


def best_known_energies(problems, use_cache: bool = True,
                        refresh: bool = False, seed: int = 0,
                        path: str | None = None) -> np.ndarray:
    """(P,) level-space best-known energies for a suite / problem list.
    Cache hits skip the solver; misses are computed per problem by tier and
    persisted in one store."""
    problems = _as_problems(problems)
    path = path or cache_path()
    cache = _load(path) if use_cache else {}
    fresh: dict = {}
    out = np.empty(len(problems), dtype=np.float64)
    for i, p in enumerate(problems):
        key = p.content_hash
        entry = None if refresh else cache.get(key)
        if entry is not None and p.n <= BRUTE_FORCE_MAX_N and \
                entry.get("method") != "brute_force":
            entry = None        # a heuristic entry inside the exact tier
        if entry is None:
            entry = _compute(p, seed)
            cache[key] = fresh[key] = entry
        out[i] = entry["energy"]
    if use_cache and fresh:
        _store(path, fresh)
    return out


def reconcile_best_known(problems, candidates, use_cache: bool = True,
                         path: str | None = None, method: str = "solver",
                         write_missing: bool = False) -> np.ndarray:
    """Elementwise-min merge of candidate energies with the cache.

    Returns the best of (candidate, cached) per problem. Strict
    improvements found by a solver are persisted back; ``write_missing``
    additionally seeds absent entries (only safe when the candidates are
    ground truth — exact solvers).
    """
    problems = _as_problems(problems)
    path = path or cache_path()
    cache = _load(path) if use_cache else {}
    out = np.asarray(candidates, dtype=np.float64).copy()
    fresh: dict = {}
    for i, p in enumerate(problems):
        key = p.content_hash
        entry = cache.get(key)
        cached_e = None if entry is None else float(entry["energy"])
        if cached_e is not None and cached_e < out[i] - 1e-9:
            out[i] = cached_e
        elif (cached_e is None and write_missing) or \
                (cached_e is not None and out[i] < cached_e - 1e-9):
            cache[key] = fresh[key] = {
                "energy": float(out[i]), "method": method,
                "n": p.n, "kind": p.kind,
                "computed_at": time.strftime("%Y-%m-%d %H:%M:%S")}
    if use_cache and fresh:
        _store(path, fresh)
    return out
