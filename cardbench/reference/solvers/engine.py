"""The reference of the ``engine`` solver: the perturbed anneal of the
64-spin die (``reference/anneal.py``), every run from its LFSR seed."""
from __future__ import annotations

import numpy as np
import torch

from cardbench.reference import anneal as ra
from cardbench.reference.answers import best, buckets


def answers(config, traffic, problems, seeds, device, tf32=False):
    """``[call][problem] -> (energies, best spins)`` of the calls seeded
    ``seeds`` (see ``reference/answers.py``)."""
    chip = config["chip"]
    pert = config["variants"][traffic["solver_opts"]["variant"]]
    R = int(traffic["runs"])
    out = [[None] * len(problems) for _ in seeds]
    for b, (n_pad, idx) in enumerate(buckets([J.shape[0] for J in problems])):
        Jp = np.zeros((len(idx), n_pad, n_pad), np.float32)
        for k, i in enumerate(idx):
            n = problems[i].shape[0]
            Jp[k, :n, :n] = problems[i]
        J = torch.as_tensor(np.tile(Jp, (len(seeds), 1, 1)), device=device)
        v0 = np.concatenate([ra.lfsr_voltages(
            n_pad, R, [s + 7919 * b + 7919 * p for p in range(len(idx))],
            chip["vdd"], chip["init_swing"]) for s in seeds])
        sig = ra.anneal(J, torch.as_tensor(v0, device=device), chip, pert,
                        tf32=tf32)
        e = ra.energies(J, sig).cpu().numpy()
        sig = sig.cpu().numpy()
        for c in range(len(seeds)):
            for k, i in enumerate(idx):
                row = c * len(idx) + k
                n = problems[i].shape[0]
                out[c][i] = best(e[row], sig[row, :, :n])
    return out
