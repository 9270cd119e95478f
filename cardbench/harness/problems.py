"""The traffic generator: problems and call seeds from ``--seed``.

One general generator for every cell. A configuration names a problem
family and its shape, and the family's file
(``harness/families/<family>.py``) draws it; a traffic mix names how many
problems a call solves, how many runs each, and (optionally) a grid of
sizes and densities. Nothing here imports the program: the problems are
plain numpy level-space coupling matrices, handed to the program and to
the reference alike. The families are copies of the program's own
generators, so the same seed gives the instances the program's own
scripts draw.
"""
from __future__ import annotations

import numpy as np

from . import spec


def _stream(seed: int, *path: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed), *path])


def make_problems(config: dict, traffic: dict, seed: int) -> list[np.ndarray]:
    """The run's problems, drawn once from ``seed`` by the configuration's
    family (``harness/families/<family>.py``): a list of (n, n) float32
    level matrices in call order."""
    return spec.family(config["family"]).make(config, traffic, seed)


class CallSeeds:
    """The seed of each solve call: call k of a run takes the k-th draw of
    one stream of ``seed``; the warm-up call takes a draw of its own."""

    def __init__(self, seed: int):
        self._rng = np.random.default_rng(_stream(seed, 7))
        self.warmup = int(np.random.default_rng(_stream(seed, 8))
                          .integers(0, 2**31))

    def next(self) -> int:
        return int(self._rng.integers(0, 2**31))


def check_sample(seed: int, n_calls: int, k: int) -> list[int]:
    """Indices of the calls whose answers are judged: ``k`` of the window's
    ``n_calls`` drawn from ``seed``, in call order."""
    rng = np.random.default_rng(_stream(seed, 11))
    k = min(int(k), n_calls)
    return sorted(int(i) for i in rng.choice(n_calls, size=k, replace=False))
