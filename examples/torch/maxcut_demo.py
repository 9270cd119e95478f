"""Max-Cut on the Ising machine (paper Eq. 2 mapping) through the port's
typed API, validated against brute force on a small graph and tabu on a
64-node graph. The counterpart of ``examples/maxcut_demo.py``.

    PYTHONPATH=src python examples/torch/maxcut_demo.py
    PYTHONPATH=src python examples/torch/maxcut_demo.py --torch-device cpu
"""
import argparse

import torch

from repro_torch.api import Problem, solve_suite
from repro_torch.core import maxcut_value
from repro_torch.device import resolve_device


def _cut(problem, sigma) -> float:
    """The cut weight of the +-1 partition ``sigma`` of ``problem``'s
    graph."""
    return float(maxcut_value(torch.as_tensor(problem.meta["W"]),
                              torch.as_tensor(sigma)))


def run(small: int, small_runs: int, chip: int, chip_runs: int,
        tabu_runs: int, torch_device="cuda") -> dict:
    """The engine's best cut against the exact one on a ``small``-node
    graph (``small_runs`` anneals; asserts >= 95% of it), then against tabu
    (``tabu_runs`` restarts) on a ``chip``-node graph (``chip_runs``
    anneals). Returns the four cuts."""
    # -- small graph: exact check --------------------------------------------
    p16 = Problem.maxcut(n=small, density=0.5, seed=3)
    out = solve_suite(p16, solver="engine", runs=small_runs, seed=1,
                      oracle=False, torch_device=torch_device)
    best_cut_im = _cut(p16, out.best_sigma[0])
    exact = solve_suite(p16, solver="brute-force", oracle=False,
                        torch_device=torch_device)
    best_cut_exact = _cut(p16, exact.best_sigma[0])
    print(f"{small}-node Max-Cut: Ising machine {best_cut_im:.0f} "
          f"vs exact {best_cut_exact:.0f}")
    assert best_cut_im >= 0.95 * best_cut_exact

    # -- chip-sized graph ----------------------------------------------------
    p64 = Problem.maxcut(n=chip, density=0.5, seed=11)
    out = solve_suite(p64, solver="engine", runs=chip_runs, seed=2,
                      oracle=False, torch_device=torch_device)
    cut_im = _cut(p64, out.best_sigma[0])
    tabu = solve_suite(p64, solver="tabu", runs=tabu_runs, seed=5,
                       oracle=False, torch_device=torch_device)
    cut_tabu = _cut(p64, tabu.best_sigma[0])
    print(f"{chip}-node Max-Cut: Ising machine {cut_im:.0f} vs tabu "
          f"{cut_tabu:.0f} ({100*cut_im/max(cut_tabu,1):.1f}%)")
    return {"small_im": best_cut_im, "small_exact": best_cut_exact,
            "chip_im": cut_im, "chip_tabu": cut_tabu}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--torch-device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.torch_device)
    return run(16, 200, 64, 500, 8, args.torch_device)


if __name__ == "__main__":
    main()
