"""The reference's answers to a window's calls, in the shape the solve API
returns them: per call, per problem, every run's level energy and the
spins of the best run.

The calls' seeds are spread over problems as the solve API documents
it: problems are grouped by size padded to the 64-spin die, groups in
ascending padded size; bucket b of a call seeded s draws from s + 7919 b,
and problem p of a bucket (in suite order) takes the anneal's LFSR seed
s + 7919 b + 7919 p, or SB's Threefry key (s + 7919 b, p). Each solver's
reference is a file of its own, ``solvers/<solver>.py``.
"""
from __future__ import annotations

import numpy as np

from cardbench.harness import spec

BLOCK = 64


def buckets(sizes) -> list[tuple[int, list[int]]]:
    """(padded size, problem indices) of each bucket, in dispatch order."""
    groups: dict[int, list[int]] = {}
    for i, n in enumerate(sizes):
        groups.setdefault(max(BLOCK, -(-int(n) // BLOCK) * BLOCK), []).append(i)
    return sorted(groups.items())


def answers(config: dict, traffic: dict, problems, seeds, device,
            tf32: bool = False) -> list[list[tuple[np.ndarray, np.ndarray]]]:
    """``[call][problem] -> (energies (R,) float64, best spins (n,) int8)``
    for the calls seeded ``seeds``, by the reference of the traffic's
    solver (``reference/solvers/<solver>.py``)."""
    return spec.reference(traffic["solver"]).answers(
        config, traffic, problems, seeds, device, tf32)


def best(e: np.ndarray, s: np.ndarray):
    """A problem's answer: its runs' energies and the best run's spins."""
    return e, s[int(np.argmin(e))].astype(np.int8)
