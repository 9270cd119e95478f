"""Disk-backed best-known-energy oracle, keyed by ``Problem.content_hash``.

Level-space best-known energies persist in the port's own sharded cache
(default ``experiments/oracle_cache_torch.json``, stored as
``experiments/oracle_cache_torch.shards/``; ``REPRO_TORCH_ORACLE_CACHE``
relocates it). The port never writes the JAX package's
``experiments/oracle_cache.shards/``.

Tiering, as the reference tiers: N <= ``BRUTE_FORCE_MAX_N`` (the constant
shared with the brute-force solver) is solved exactly on the host; cache
misses above it are padded into suite buckets and refreshed by batched
``tabu-jax`` on the torch device (``solvers.tabu_jax``), one
``_tabu_jax_batch`` per pad bucket for the whole refresh, with
``TABU_JAX_ORACLE_RESTARTS`` restarts (method ``"tabu-jax"``). An entry an
older port cache holds from its host-tabu tier (method ``"tabu"``) stays
valid: the lower energy wins every merge (``_keep_best``).

Escape hatches: ``use_cache=False`` bypasses reads AND writes;
``refresh=True`` recomputes but still persists.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..solvers.brute_force import BRUTE_FORCE_MAX_N
from ..utils import load_sharded_json_cache, store_sharded_json_cache
from .batching import plan_buckets
from .problem import Problem
from .suite import ProblemSuite

_CACHE_ENV = "REPRO_TORCH_ORACLE_CACHE"
_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))
DEFAULT_CACHE = os.path.join(_REPO_ROOT, "experiments",
                             "oracle_cache_torch.json")

#: restarts per problem for the batched tabu-jax tier: restarts are batch
#: rows, so they cost device parallelism, not wall time.
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


def _compute(problem: Problem) -> dict:
    """Exact tier: brute-force one small problem (n <= the shared
    boundary). Larger problems go to the batched tier (``_tabu_jax_batch``)."""
    from ..solvers.brute_force import brute_force_ground_state
    e, _ = brute_force_ground_state(problem.J_levels)
    return {"energy": float(e), "method": "brute_force", "n": problem.n,
            "kind": problem.kind,
            "computed_at": time.strftime("%Y-%m-%d %H:%M:%S")}


def _tabu_jax_batch(J, n_true, seed: int,
                    torch_device: torch.device) -> np.ndarray:
    """ONE batch of the oracle's tabu-jax tier: (P, n_pad, n_pad) padded
    couplings -> (P,) best tabu energies. Kept as a seam so tests can count
    the batches the oracle runs."""
    from ..solvers.tabu_jax import tabu_search_jax_runs
    e, _, _ = tabu_search_jax_runs(
        J, n_true=n_true, n_restarts=TABU_JAX_ORACLE_RESTARTS, seed=seed,
        torch_device=torch_device)
    return e.min(axis=1)


def _as_problems(problems):
    if isinstance(problems, Problem):
        return [problems]
    if isinstance(problems, ProblemSuite):
        return problems.problems
    return problems


def best_known_energies(problems, use_cache: bool = True,
                        refresh: bool = False, seed: int = 0,
                        path: str | None = None,
                        torch_device: str | torch.device = "cuda"
                        ) -> np.ndarray:
    """(P,) level-space best-known energies for a suite / problem list.

    Cache hits skip the solver. Misses tier by size: N <=
    ``BRUTE_FORCE_MAX_N`` is brute-forced (host); everything larger is
    stacked into padded suite buckets and refreshed by the tabu-jax tier on
    ``torch_device``, one batch per pad bucket for the whole refresh.
    Results persist in one store.
    """
    dev = resolve_device(torch_device)
    problems = _as_problems(problems)
    path = path or cache_path()
    cache = _load(path) if use_cache else {}
    fresh: dict = {}
    out = np.empty(len(problems), dtype=np.float64)
    large: list[int] = []
    for i, p in enumerate(problems):
        key = p.content_hash
        entry = None if refresh else cache.get(key)
        if entry is not None and p.n <= BRUTE_FORCE_MAX_N and \
                entry.get("method") != "brute_force":
            entry = None        # a heuristic entry inside the exact tier
        if entry is None:
            if p.n > BRUTE_FORCE_MAX_N:
                large.append(i)                  # batched below
                continue
            entry = _compute(p)
            cache[key] = fresh[key] = entry
        out[i] = entry["energy"]

    if large:
        subs = [problems[i] for i in large]
        plan = plan_buckets([p.n for p in subs])
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        for bucket in plan.materialize([p.J_levels for p in subs]):
            e_best = _tabu_jax_batch(
                bucket.J, [subs[k].n for k in bucket.indices], seed=seed,
                torch_device=dev)
            for k, sub_i in enumerate(bucket.indices):
                i = large[sub_i]
                p = problems[i]
                cache[p.content_hash] = fresh[p.content_hash] = {
                    "energy": float(e_best[k]), "method": "tabu-jax",
                    "n": p.n, "kind": p.kind,
                    "restarts": TABU_JAX_ORACLE_RESTARTS,
                    "computed_at": stamp}
                out[i] = e_best[k]

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
