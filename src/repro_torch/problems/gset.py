"""Gset-format Max-Cut instances — the large sparse Max-Cut workload.

The Gset benchmark family (G1..G81, Stanford SteinLib distribution) is the
standard Max-Cut corpus every Ising-machine paper reports on; instances
are plain text::

    n_vertices n_edges
    i j w          # one edge per line, 1-indexed endpoints, integer weight

This module reads/writes that format and generates Gset-style random
instances (G1-class uniform random graphs and G11-class ±1-weighted
toroidal grids) at the N=800–2000 scales that ``sb-jax`` and
``chip-lns`` solve, wrapped as :class:`repro_torch.api.Problem` (J = -W,
exact integer DAC levels). A copy of the reference's numpy module: the same
seed gives the same graph, byte for byte.
"""
from __future__ import annotations

import io
import os
from typing import Union

import numpy as np

__all__ = ["parse_gset", "dump_gset", "load_gset", "random_gset",
           "gset_problem", "cut_from_energy"]


def parse_gset(text: str) -> np.ndarray:
    """Parse Gset text into a dense symmetric (n, n) int32 weight matrix.

    Duplicate edges accumulate; self-loops are rejected (a cut never sees
    them and silently dropping weight would corrupt verify).
    """
    lines = [ln.split("#", 1)[0].strip() for ln in text.splitlines()]
    lines = [ln for ln in lines if ln]
    if not lines:
        raise ValueError("empty Gset input")
    head = lines[0].split()
    if len(head) != 2:
        raise ValueError(f"Gset header must be 'n_vertices n_edges', "
                         f"got {lines[0]!r}")
    n, m = int(head[0]), int(head[1])
    if n < 1:
        raise ValueError(f"Gset n_vertices must be >= 1, got {n}")
    if len(lines) - 1 != m:
        raise ValueError(f"Gset header promises {m} edges, file has "
                         f"{len(lines) - 1}")
    W = np.zeros((n, n), dtype=np.int64)
    for ln in lines[1:]:
        parts = ln.split()
        if len(parts) != 3:
            raise ValueError(f"Gset edge line must be 'i j w', got {ln!r}")
        i, j, w = int(parts[0]), int(parts[1]), int(parts[2])
        if not (1 <= i <= n and 1 <= j <= n):
            raise ValueError(f"edge ({i}, {j}) outside 1..{n}")
        if i == j:
            raise ValueError(f"self-loop on vertex {i} has no cut meaning")
        W[i - 1, j - 1] += w
        W[j - 1, i - 1] += w
    return W.astype(np.int32)


def dump_gset(W: np.ndarray) -> str:
    """Serialize a symmetric weight matrix to Gset text (upper triangle,
    1-indexed, nonzero edges only)."""
    W = np.asarray(W)
    if W.ndim != 2 or W.shape[0] != W.shape[1]:
        raise ValueError(f"Gset wants a square matrix, got {W.shape}")
    if not np.array_equal(W, W.T):
        raise ValueError("Gset weight matrix must be symmetric")
    n = W.shape[0]
    ii, jj = np.nonzero(np.triu(W, k=1))
    out = io.StringIO()
    out.write(f"{n} {len(ii)}\n")
    for i, j in zip(ii, jj):
        out.write(f"{i + 1} {j + 1} {int(W[i, j])}\n")
    return out.getvalue()


def load_gset(path: Union[str, os.PathLike]) -> np.ndarray:
    """Read a Gset file from disk into a weight matrix."""
    with open(path) as f:
        return parse_gset(f.read())


def random_gset(n: int, seed: int = 0, kind: str = "uniform",
                degree: float = 6.0, max_w: int = 1) -> np.ndarray:
    """Gset-style random weight matrix at Gset scale (N = 800-2000).

    ``kind='uniform'`` draws a G1-class Erdos–Renyi graph with expected
    vertex degree ``degree`` and weights uniform in {1..max_w} (G1 itself
    is unweighted: max_w=1); ``kind='torus'`` builds a G11-class
    sqrt(n) x sqrt(n) toroidal grid with ±1 weights. Both are integer
    DAC levels, so level-space field arithmetic stays exact.
    """
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        if n < 2:
            raise ValueError(f"uniform Gset needs n >= 2, got {n}")
        p = min(1.0, degree / max(1, n - 1))
        mask = np.triu(rng.random((n, n)) < p, k=1)
        w = rng.integers(1, max_w + 1, size=(n, n))
        W = np.where(mask, w, 0)
        W = W + W.T
        return W.astype(np.int32)
    if kind == "torus":
        side = int(round(np.sqrt(n)))
        if side * side != n:
            raise ValueError(f"torus Gset needs a square n, got {n}")
        W = np.zeros((n, n), dtype=np.int32)
        for r in range(side):
            for c in range(side):
                i = r * side + c
                for j in (r * side + (c + 1) % side,
                          ((r + 1) % side) * side + c):
                    w = int(rng.choice([-1, 1]))
                    W[i, j] += w
                    W[j, i] += w
        return W
    raise ValueError(f"unknown Gset kind {kind!r} "
                     f"(expected 'uniform' or 'torus')")


def gset_problem(source, seed: int = 0, kind: str = "uniform",
                 degree: float = 6.0, max_w: int = 1):
    """Wrap a Gset instance as a :class:`repro_torch.api.Problem` (J = -W).

    ``source`` is an int (generate ``random_gset(n=source, ...)``), a
    path to a Gset file, or a weight matrix. The graph rides in
    ``meta['W']`` for cut-value readout, exactly like ``Problem.maxcut``.
    """
    from ..api import Problem
    from ..core.hamiltonian import maxcut_to_ising
    if isinstance(source, (int, np.integer)):
        W = random_gset(int(source), seed=seed, kind=kind, degree=degree,
                        max_w=max_w)
        meta = {"W": W, "gset_kind": kind, "seed": seed}
    elif isinstance(source, (str, os.PathLike)):
        W = load_gset(source)
        meta = {"W": W, "gset_path": os.fspath(source)}
    else:
        W = np.asarray(source)
        if W.ndim != 2 or W.shape[0] != W.shape[1]:
            raise ValueError(f"gset_problem source matrix must be square, "
                             f"got {W.shape}")
        meta = {"W": W.astype(np.int32)}
    return Problem.from_couplings(maxcut_to_ising(W), kind="maxcut",
                                  meta=meta)


def cut_from_energy(W: np.ndarray, energy_levels: float) -> float:
    """Cut value from a level-space Ising energy (J = -W):
    cut = 0.25 * sum(W) - 0.5 * H."""
    W = np.asarray(W, dtype=np.float64)
    return float(0.25 * W.sum() - 0.5 * float(energy_levels))
