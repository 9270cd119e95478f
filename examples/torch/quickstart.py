"""Quickstart on the port: solve a random QUBO suite through the typed API
and reproduce the paper's headline behaviour (landscape perturbation beats
plain gradient descent). The counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch/quickstart.py
    PYTHONPATH=src python examples/torch/quickstart.py --torch-device cpu
"""
import argparse

import numpy as np

from repro_torch.api import ProblemSuite, best_known_energies, solve_suite
from repro_torch.device import resolve_device

N, PROBLEMS, RUNS = 64, 4, 300


def run(n: int, problems: int, runs: int, torch_device="cuda") -> dict:
    """The quickstart on ``problems`` random ``n``-spin problems, ``runs``
    anneals each. Returns the best-known energies, both reports, their
    success rates and the improvement ratio."""
    print(f"== {n}-spin all-to-all Ising machine (65nm CMOS digital twin) ==")
    suite = ProblemSuite.random(n, density=0.5, num_problems=problems,
                                seed=42)
    bk = best_known_energies(suite, seed=1,      # disk-cached tabu oracle
                             torch_device=torch_device)
    print("best-known energies (tabu oracle):", bk)

    # 'engine' is the digital twin behind the AnnealEngine (the hand-written
    # anneal kernel on the card, its plain PyTorch version on the CPU);
    # attach_oracle makes the report's SR/TTS/ETS metrics ready.
    report = solve_suite(suite, solver="engine", runs=runs, seed=7,
                         oracle=False, torch_device=torch_device
                         ).attach_oracle(bk)
    plan = report.meta["engine_plan"]
    print(f"engine plan: path={plan['path']} block_r={plan['block_r']} "
          f"j_dtype={plan['j_dtype']} ({plan['reason']})")
    sr = report.success_rate()
    print(f"\nwith landscape perturbation: best={report.best_energy}")
    print(f"  success rates: {np.round(sr, 3)} (mean {sr.mean():.3f})")

    # the paper's dashed baseline: same chip, no perturbation schedule
    report_gd = solve_suite(suite, solver="engine", runs=runs, seed=7,
                            oracle=False, variant="gd",
                            torch_device=torch_device).attach_oracle(bk)
    sr_gd = report_gd.success_rate()
    print(f"\ngradient descent only:       best={report_gd.best_energy}")
    print(f"  success rates: {np.round(sr_gd, 3)} (mean {sr_gd.mean():.3f})")

    ratio = sr.mean() / max(sr_gd.mean(), 1e-9)
    print(f"\nperturbation SR improvement: {ratio:.2f}x (paper reports >1.7x)")

    m = report.metrics()
    print(f"TTS at the chip's 3us anneal: {np.round(m['tts_s']*1e3, 3)} ms "
          f"(paper median: 0.72 ms)")
    return {"best_known": bk, "report": report, "report_gd": report_gd,
            "sr": sr, "sr_gd": sr_gd, "ratio": ratio, "tts_s": m["tts_s"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--torch-device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.torch_device)
    return run(N, PROBLEMS, RUNS, args.torch_device)


if __name__ == "__main__":
    main()
