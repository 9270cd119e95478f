"""A G1/G22-class Erdos-Renyi Max-Cut graph (rudy's ``-rnd_graph``), a
copy of the program's ``repro_torch.problems.gset.random_gset`` (uniform
kind).

Configuration keys: ``n``, ``degree`` (expected), ``max_w``."""
from __future__ import annotations

import numpy as np


def gset_uniform(n: int, seed: int, degree: float, max_w: int) -> np.ndarray:
    """Weights uniform in 1..max_w, each edge with probability degree /
    (n - 1); returns the Ising levels J = -W."""
    rng = np.random.default_rng(seed)
    p = min(1.0, degree / max(1, n - 1))
    mask = np.triu(rng.random((n, n)) < p, k=1)
    w = rng.integers(1, max_w + 1, size=(n, n))
    W = np.where(mask, w, 0)
    W = W + W.T
    return (-W).astype(np.float32)


def make(config: dict, traffic: dict, seed: int) -> list[np.ndarray]:
    """``traffic["problems"]`` graphs, graph i from the stream ``seed + i``
    (graph 0: ``random_gset(n, seed)``)."""
    return [gset_uniform(int(config["n"]), seed + i,
                         float(config["degree"]), int(config["max_w"]))
            for i in range(int(traffic["problems"]))]
