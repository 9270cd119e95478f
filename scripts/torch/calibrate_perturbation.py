"""Calibration sweep behind the defaults in core/perturbation.py and
core/device_model.py, on the port. The counterpart of
``scripts/calibrate_perturbation.py``.

Sweeps drive strength and the DAC-gating schedule on 64-node/50%-density
problems, comparing landscape-perturbation SR against the GD-only baseline
(the reference records drive=1.0 V/level/sweep and period=48 slots, off=8
as its defaults).

Run: PYTHONPATH=src python scripts/torch/calibrate_perturbation.py
     PYTHONPATH=src python scripts/torch/calibrate_perturbation.py --torch-device cpu
"""
import argparse
import itertools

from repro_torch.core import DeviceModel, IsingMachine, PerturbationConfig
from repro_torch.device import resolve_device
from repro_torch.problems import problem_set
from repro_torch.solvers import best_known

N, P, R = 64, 8, 200
#: (drive, (period, off), settle) over the reference's grid
GRID = list(itertools.product([0.5, 1.0, 2.0],
                              [(48, 8), (96, 16), (96, 24), (128, 32)],
                              [1.0]))


def run(n: int, problems: int, runs: int, grid, torch_device="cuda") -> list:
    """GD and landscape-perturbation SR at every ``grid`` point on
    ``problems`` problems of ``n`` spins, ``runs`` anneals each; returns
    one dict a point, with each problem's success rates."""
    ps = problem_set(n, 0.5, problems, seed=42)
    bk = best_known(ps.J, seed=1)
    rows = []
    for drive, (period, off), settle in grid:
        dev = DeviceModel(n_spins=n, drive=drive)
        gd = IsingMachine(device=DeviceModel(n_spins=n, drive=drive,
                                             tau_leak_sweeps=float("inf")),
                          torch_device=torch_device)
        sr_g = (gd.gradient_descent_baseline()
                .solve(ps.J, num_runs=runs, seed=9).success_rate(bk))
        m = IsingMachine(device=dev,
                         perturbation=PerturbationConfig(
                             period_slots=period, off_slots=off,
                             settle_sweeps=settle),
                         torch_device=torch_device)
        sr_p = m.solve(ps.J, num_runs=runs, seed=9).success_rate(bk)
        print(f"drive={drive:3.1f} P={period:3d} off={off:2d} | "
              f"GD {sr_g.mean():.4f} PERT {sr_p.mean():.4f} ratio "
              f"{sr_p.mean()/max(sr_g.mean(),1e-9):5.2f}x")
        rows.append({"drive": drive, "period": period, "off": off,
                     "settle": settle, "best_known": bk, "sr_gd": sr_g,
                     "sr_pert": sr_p})
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--torch-device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.torch_device)
    return run(N, P, R, GRID, args.torch_device)


if __name__ == "__main__":
    main()
