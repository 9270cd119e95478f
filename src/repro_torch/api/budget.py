"""Uniform ``budget -> (iters, restarts, rungs)`` mapping for every solver.

``solve(suite, runs, seed, budget)`` takes one solver-relative effort
multiplier. Before this module each solver inverted it its own way
(``max(1, int(round(base * (budget or 1.0))))`` copy-pasted with drift
hazards); now every search solver maps the user's knobs through ONE
function with one documented semantics:

  * ``budget`` multiplies the PER-RESTART iteration budget (sweeps for the
    SAs and PT, flips for tabu, anneal length for the engine) — never the
    restart count, so ``runs`` always means what the caller asked for;
  * ``restarts`` is the report's ``runs`` (independent searches);
  * ``rungs`` is internal parallelism per restart (PT temperature ladder;
    1 for single-trajectory solvers).

Total work is proportional to ``iters * restarts * rungs`` — reports can
account for it uniformly across solvers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def budget_factor(budget: Optional[float]) -> float:
    """Effort multiplier as a float (None -> 1.0). Rejects nonpositive
    budgets — a zero budget silently degenerating to one iteration is how
    benchmark comparisons go quietly wrong."""
    if budget is None:
        return 1.0
    budget = float(budget)
    if budget <= 0:
        raise ValueError(f"budget must be positive, got {budget}")
    return budget


@dataclasses.dataclass(frozen=True)
class SearchEffort:
    iters: int          # per-restart iteration budget (budget-scaled)
    restarts: int       # independent restarts == the report's ``runs``
    rungs: int = 1      # internal replicas per restart (PT ladder)

    @property
    def total_iters(self) -> int:
        """Work proxy: lockstep iterations x restarts x rungs."""
        return self.iters * self.restarts * self.rungs


def search_effort(base_iters: float, runs: int,
                  budget: Optional[float] = None,
                  rungs: int = 1) -> SearchEffort:
    """The one mapping: scale ``base_iters`` by ``budget``, floor at 1."""
    return SearchEffort(
        iters=max(1, int(round(base_iters * budget_factor(budget)))),
        restarts=max(1, int(runs)), rungs=max(1, int(rungs)))


def degrade_budget(budget: Optional[float], level: int,
                   min_budget: float = 0.125) -> float:
    """Overload degradation ladder: halve the effort multiplier once per
    pressure ``level``, floored at ``min_budget``.

    The serve tier's graceful-degradation contract: when the request queue
    deepens past the admission threshold, budgets degrade through this
    ladder BEFORE any request is shed — every rung still flows through the
    uniform :func:`search_effort` mapping, so a degraded request gets a
    cheaper (not slower, not failed) answer. ``level <= 0`` is a no-op;
    the floor matches :func:`deadline_to_budget`'s clamp so degradation
    can never drive a shared batch to degenerate effort.
    """
    b = budget_factor(budget)
    if level <= 0:
        return b
    return max(min_budget, b * 0.5 ** int(level))


def deadline_to_budget(deadline_s: Optional[float],
                       reference_s: float = 1.0,
                       min_budget: float = 0.125,
                       max_budget: float = 8.0) -> Optional[float]:
    """Map a per-request latency deadline to the uniform effort multiplier.

    The serve tier's admission contract: a request that allows
    ``reference_s`` of solve time gets the solver's nominal effort
    (budget 1.0); tighter deadlines scale the per-restart iteration budget
    down linearly (work is linear in iters for every registered solver),
    looser ones scale it up. The clamp keeps one outlier request from
    driving a shared batch to degenerate (or unbounded) effort, and the
    result then flows through :func:`search_effort` exactly like a
    user-passed ``budget``. ``None`` (no deadline) means nominal effort.
    """
    if deadline_s is None:
        return None
    deadline_s = float(deadline_s)
    if deadline_s <= 0:
        raise ValueError(f"deadline must be positive, got {deadline_s}")
    if reference_s <= 0:
        raise ValueError(f"reference_s must be positive, got {reference_s}")
    return min(max(deadline_s / reference_s, min_budget), max_budget)
