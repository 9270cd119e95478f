"""How ``correct`` is decided: the program's answers against the plain
reference's, call by call, problem by problem, run by run.

Two numbers, each beside its limit (``cardbench/limits/<cell>.json``):

  * ``energy_mismatch_share``: the share of the judged runs whose final
    level energy differs from the reference's run of the same seed (the
    energies are exact integers, so any difference is a run that ended
    elsewhere);
  * ``best_energy_gap``: the largest gap between a problem's best energy
    as the program reports it and the energy, worked out by the
    reference, of the spins the program returns as that best run (exact,
    limit 0).
"""
from __future__ import annotations

import numpy as np


def compare(program, reference, problems) -> dict[str, float]:
    """``program`` and ``reference``: ``[call][problem] -> (energies (R,),
    best spins (n,))`` of the same calls."""
    runs = differ = 0
    gap = 0.0
    for got_call, want_call in zip(program, reference, strict=True):
        for J, (e, best), (e_ref, _) in zip(problems, got_call, want_call,
                                            strict=True):
            e = np.asarray(e, np.float64)
            e_ref = np.asarray(e_ref, np.float64)
            if e.shape != e_ref.shape:
                raise ValueError(f"{e.shape[0]} runs answered where "
                                 f"{e_ref.shape[0]} were asked")
            runs += e.size
            differ += int(np.count_nonzero(e != e_ref))
            gap = max(gap, abs(exact_energy(J, best) - float(e.min())))
    return {"energy_mismatch_share": differ / max(runs, 1),
            "best_energy_gap": gap, "runs_judged": runs}


def exact_energy(J: np.ndarray, sigma) -> float:
    """-0.5 s'Js in integers (levels and spins are integers)."""
    s = np.asarray(sigma, np.int64)
    if s.shape != (J.shape[0],) or not np.all(np.abs(s) == 1):
        return float("inf")
    Ji = np.asarray(J).astype(np.int64)
    return -0.5 * float(s @ Ji @ s)


def judged(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every limited number at
    or under its limit."""
    shown = {name: {"value": numbers[name], "limit": limit}
             for name, limit in limits.items()}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in shown.values())
    return ok, shown


def program_answers(report) -> list[tuple[np.ndarray, np.ndarray]]:
    """One call's ``SolveReport`` as ``[problem] -> (energies, best
    spins)``."""
    return [(np.asarray(e, np.float64), np.asarray(s))
            for e, s in zip(report.energies, report.best_sigma)]
