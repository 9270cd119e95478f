"""Emit experiments/perf_delta_torch.md on the port: baseline vs optimized,
two layers. The counterpart of ``scripts/baseline_vs_optimized.py``.

1. Solver layer (always): the paper's headline claim through the solver
   registry — landscape perturbation vs the gradient-descent baseline on a
   shared suite, SR/TTS per cell plus the improvement ratio.
2. Roofline layer (when dry-run records exist): per-cell bound seconds
   per step from experiments/dryrun_torch_baseline vs
   experiments/dryrun_torch (``repro_torch.launch.dryrun``'s records).

    PYTHONPATH=src python scripts/torch/baseline_vs_optimized.py
    PYTHONPATH=src python scripts/torch/baseline_vs_optimized.py --torch-device cpu
"""
import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402

from repro_torch.api import (ProblemSuite, best_known_energies,  # noqa: E402
                             solve_suite)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.metrics import (paper_hw_constants,  # noqa: E402
                                 time_to_solution)

BASE = "experiments/dryrun_torch_baseline"
OPT = "experiments/dryrun_torch"
OUT = "experiments/perf_delta_torch.md"
RUNS = 200
CELLS = ((32, 0.5), (64, 0.5))


def run(runs: int, cells, base: str, opt: str, out: str,
        torch_device="cuda") -> dict:
    """The SR / TTS table of perturbation against gd at ``cells`` ((n,
    density) pairs, ``runs`` anneals a problem) and the roofline table of
    the dry-run records in ``base`` against ``opt``, written to ``out``.
    Returns the table's numbers and the text."""
    lines = ["# Baseline vs optimized", ""]

    # -- 1. solver layer: perturbation vs gradient descent ------------------
    hw = paper_hw_constants()
    lines += ["## Landscape perturbation vs gradient descent "
              "(solver registry)",
              "",
              "| N | density | SR base | SR pert | TTS base (ms) | "
              "TTS pert (ms) |",
              "|---|---|---|---|---|---|"]
    ratios, table = [], []
    for n, d in cells:
        suite = ProblemSuite.random(n, d, 4, seed=100 + n)
        bk = best_known_energies(suite, seed=1, torch_device=torch_device)
        sr_p = solve_suite(suite, "engine", runs=runs, seed=7, oracle=False,
                           variant="perturbation",
                           torch_device=torch_device
                           ).attach_oracle(bk).success_rate()
        sr_g = solve_suite(suite, "engine", runs=runs, seed=7, oracle=False,
                           variant="gd", torch_device=torch_device
                           ).attach_oracle(bk).success_rate()
        tts_p = np.median(time_to_solution(sr_p, hw.anneal_s))
        tts_g = np.median(time_to_solution(sr_g, hw.anneal_s))
        ratios.append(sr_p.mean() / max(sr_g.mean(), 1e-9))
        table.append({"n": n, "density": d, "best_known": bk,
                      "sr_gd": sr_g, "sr_pert": sr_p, "tts_gd_s": tts_g,
                      "tts_pert_s": tts_p})
        lines.append(f"| {n} | {d} | {sr_g.mean():.3f} | {sr_p.mean():.3f} "
                     f"| {tts_g*1e3:.3f} | {tts_p*1e3:.3f} |")
    lines += ["", f"Mean SR improvement: {np.mean(ratios):.2f}x "
              "(paper reports >1.7x on 64-node problems)", ""]

    # -- 2. roofline layer (optional records) -------------------------------
    rows = []
    for fb in sorted(glob.glob(os.path.join(base, "*.json"))):
        name = os.path.basename(fb)
        fo = os.path.join(opt, name)
        if not os.path.exists(fo):
            continue
        with open(fb) as f:
            b = json.load(f)
        with open(fo) as f:
            o = json.load(f)
        rb, ro = b["roofline"], o["roofline"]
        rows.append((b["arch"], b["shape"], b["mesh"],
                     rb["bound_step_s"], ro["bound_step_s"],
                     rb.get("roofline_fraction", 0),
                     ro.get("roofline_fraction", 0)))

    if rows:
        lines += ["## Roofline bound (seconds per step; §Perf)",
                  "",
                  "| arch | shape | mesh | bound before | bound after | "
                  "speedup | frac before | frac after |",
                  "|---|---|---|---|---|---|---|---|"]
        tot_b = tot_o = 0.0
        for a, s, m, bb, bo, fb_, fo_ in rows:
            sp = bb / bo if bo > 0 else float("inf")
            tot_b += bb
            tot_o += bo
            lines.append(f"| {a} | {s} | {m} | {bb:.3f} | {bo:.3f} | "
                         f"{sp:.2f}x | {fb_:.3f} | {fo_:.3f} |")
        lines.append("")
        lines.append(f"Aggregate bound over all cells: {tot_b:.1f}s -> "
                     f"{tot_o:.1f}s ({tot_b/max(tot_o,1e-9):.2f}x)")

    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    text = "\n".join(lines) + "\n"
    with open(out, "w") as f:
        f.write(text)
    print("\n".join(lines))
    return {"cells": table, "mean_ratio": float(np.mean(ratios)),
            "roofline_rows": rows, "text": text}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--torch-device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.torch_device)
    return run(RUNS, CELLS, BASE, OPT, OUT, args.torch_device)


if __name__ == "__main__":
    main()
