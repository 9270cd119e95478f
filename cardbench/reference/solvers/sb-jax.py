"""The reference of the ``sb-jax`` solver: simulated bifurcation
(``reference/sb.py``), every restart from its Threefry key."""
from __future__ import annotations

import torch

from cardbench.reference import sb as rs
from cardbench.reference.answers import best, buckets


def answers(config, traffic, problems, seeds, device, tf32=False):
    """``[call][problem] -> (energies, best spins)`` of the calls seeded
    ``seeds`` (see ``reference/answers.py``)."""
    opts = traffic["solver_opts"]
    R = int(traffic["runs"])
    out = [[None] * len(problems) for _ in seeds]
    for b, (n_pad, idx) in enumerate(buckets([J.shape[0] for J in problems])):
        for p, i in enumerate(idx):
            J = problems[i]
            n = J.shape[0]
            xy = [rs.inits(s + 7919 * b, p, R, n_pad, n, device)
                  for s in seeds]
            x0 = torch.cat([x[:, :n] for x, _ in xy])
            y0 = torch.cat([y[:, :n] for _, y in xy])
            del xy
            x = rs.integrate(rs.scaled(J, n), x0, y0,
                             variant=opts["variant"],
                             n_steps=int(opts["n_steps"]),
                             dt=float(opts["dt"]), a0=float(opts["a0"]),
                             tf32=tf32)
            sig = torch.where(x >= 0, 1.0, -1.0)
            e = rs.energies(J, sig).cpu().numpy()
            sig = sig.cpu().numpy()
            for c in range(len(seeds)):
                rows = slice(c * R, (c + 1) * R)
                out[c][i] = best(e[rows], sig[rows])
    return out
