#!/usr/bin/env python3
"""Time the port's SB kernel at the Gset duel shape over ``block_r`` values.

    python3 scripts/sb_kernel_sweep.py

Builds ``src/repro_torch/kernels/csrc/sb_kernel.cu``, makes the inputs the
sb-jax solver hands the kernel for ``gset_problem(2000, seed=1209,
degree=6.0)`` (the reference's duel graph), 256 runs, padded by the 64-spin
block to (1, 256, 2048), and times bSB ``fused_sb_kernel`` (400 steps) at
block_r 2, 4, 8 and 16: CUDA events around each call, the median of 5
calls after one warm-up. Results of every ``block_r`` are held bitwise
equal to the first. Prints one JSON line per ``block_r``, then the card's
name and power limit. Needs a CUDA card.

It uses only ``fused_sb_kernel(..., block_r=...)``, which every version of
the kernel takes: copied into a checkout of an earlier version, it times
that version's kernel. In the first kernel (grid P x R/block_r) block_r
was the runs of one block; in the cluster kernel it is the runs of one
cluster (``chip_smoke.py`` prints the launch plans).
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

N, RUNS, STEPS, REPS = 2000, 256, 400, 5
BLOCK_R = (2, 4, 8, 16)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sb_kernel_sweep: CUDA is not available", file=sys.stderr)
        return 1

    from repro_torch.api import ProblemSuite
    from repro_torch.kernels.sb_kernel import fused_sb_kernel
    from repro_torch.problems import gset_problem
    from repro_torch.solvers.sb_jax import sb_inits, sb_scaled_couplings

    problem = gset_problem(N, seed=1209, degree=6.0)
    (bucket,) = ProblemSuite([problem]).buckets(64)
    Jc = torch.as_tensor(sb_scaled_couplings(bucket.J, [problem.n]),
                         device="cuda")
    x0, y0 = sb_inits(1, RUNS, bucket.n_pad, n_true=[problem.n], seed=7,
                      torch_device="cuda")
    first = None
    for block_r in BLOCK_R:
        kw = dict(variant="bSB", n_steps=STEPS, dt=0.5, a0=1.0,
                  block_r=block_r)
        out = fused_sb_kernel(Jc, x0, y0, **kw)      # warm-up
        torch.cuda.synchronize()
        if first is None:
            first = out
        times = []
        for _ in range(REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fused_sb_kernel(Jc, x0, y0, **kw)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        print(json.dumps({"variant": "bSB", "shape": list(x0.shape),
                          "steps": STEPS, "block_r": block_r,
                          "ms": statistics.median(times), "ms_all": times,
                          "bitwise_to_first": bool(torch.equal(out, first))}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
