"""``SolveReport`` — the uniform result every registered solver returns.

One schema for all solvers (heuristic or exact, JAX or numpy): per-problem
per-run energies in LEVEL space (multiply by each problem's ``scale`` for
physical units), best configurations trimmed to the true problem size,
wall time, and the dispatch count (device batches issued — the thing the
suite bucketing minimizes). Attach a best-known oracle and the paper's
success-rate → TTS → ETS pipeline (``metrics/success.py``) computes once,
identically, for every solver — no benchmark re-implements it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from ..metrics.success import (energy_to_solution, normalized_ets,
                               paper_hw_constants, success_rate,
                               time_to_solution, tts_distribution)


@dataclasses.dataclass
class SolveReport:
    solver: str
    runs: int                                 # runs/restarts per problem
    energies: list                            # per problem (R_p,) level units
    best_sigma: list                          # per problem (n,) int8
    problem_hashes: tuple                     # content hashes (oracle keys)
    sizes: tuple                              # true spin counts
    scales: tuple                             # level -> physical multipliers
    wall_s: float = 0.0                       # steady-state solve time
    compile_s: float = 0.0                    # one-time XLA compile/trace
    dispatches: int = 0                       # device batches issued
    meta: dict = dataclasses.field(default_factory=dict)
    best_known: Optional[np.ndarray] = None   # (P,) level units

    # -- derived views -----------------------------------------------------
    @property
    def num_problems(self) -> int:
        return len(self.energies)

    @property
    def best_energy(self) -> np.ndarray:
        """(P,) best level-space energy per problem."""
        return np.array([np.min(e) for e in self.energies], dtype=np.float64)

    @property
    def best_energy_physical(self) -> np.ndarray:
        return self.best_energy * np.asarray(self.scales, dtype=np.float64)

    @property
    def anneals_per_s(self) -> float:
        """Throughput against ``wall_s`` only: solvers run with warmup
        split one-time XLA compilation into ``compile_s``, so this stops
        charging trace/compile time to the steady-state solve rate."""
        total = sum(np.size(e) for e in self.energies)
        return total / max(self.wall_s, 1e-9)

    # -- oracle + metrics --------------------------------------------------
    def attach_oracle(self, best_known) -> "SolveReport":
        bk = np.asarray(best_known, dtype=np.float64)
        if bk.shape != (self.num_problems,):
            raise ValueError(f"oracle shape {bk.shape} != "
                             f"({self.num_problems},)")
        self.best_known = bk
        return self

    def success_rate(self, frac: float = 0.99) -> np.ndarray:
        """Per-problem fraction of runs reaching >= ``frac`` of best-known
        (the paper's 99%-of-best rule)."""
        if self.best_known is None:
            raise ValueError("attach_oracle() first (or solve via "
                             "solve_suite(oracle=True))")
        return np.array([success_rate(e[None], b[None], frac)[0]
                         for e, b in zip(self.energies, self.best_known)])

    def metrics(self, hw=None, frac: float = 0.99) -> dict:
        """The paper's full pipeline: SR -> TTS (Eq. 7) -> ETS (Table II) ->
        normalized ETS, per problem, sized by each problem's own N."""
        hw = hw or paper_hw_constants()
        sr = self.success_rate(frac)
        tts = time_to_solution(sr, hw.anneal_s)
        ets = energy_to_solution(hw.power_w, tts)
        sizes = np.asarray(self.sizes)
        norm = np.array([
            normalized_ets(e, hw.coeff_levels, n, max(n - 1, 1))
            for e, n in zip(np.atleast_1d(ets), sizes)])
        dist = tts_distribution(sr, hw.anneal_s)
        return {
            "success_rate": sr, "mean_success_rate": float(sr.mean()),
            "tts_s": tts, "median_tts_s": dist["median"],
            "mean_tts_s": dist["mean"],
            "solved_fraction": dist["solved_fraction"],
            "ets_j": ets, "normalized_ets_j": norm,
        }

    # -- composition / serialization ---------------------------------------
    def slice_problems(self, indices) -> "SolveReport":
        """Row subset of this report (problem-aligned columns sliced).

        The serve tier's supervised flush executor uses this to keep the
        VALID rows of a partially-corrupted flush (the invalid ones are
        quarantined and re-dispatched as their own flush): per-problem
        meta lists (length == problem count) slice along; scalar meta and
        the additive cost columns (``wall_s``/``compile_s``/``dispatches``)
        stay whole — the dispatch that produced these rows was paid once,
        and the re-dispatch of the dropped rows accounts for itself.
        """
        idx = [int(i) for i in indices]
        meta = {}
        for k, v in self.meta.items():
            if isinstance(v, list) and len(v) == self.num_problems:
                meta[k] = [v[i] for i in idx]
            else:
                meta[k] = v
        bk = (None if self.best_known is None
              else self.best_known[np.asarray(idx, dtype=int)])
        return SolveReport(
            solver=self.solver, runs=self.runs,
            energies=[self.energies[i] for i in idx],
            best_sigma=[self.best_sigma[i] for i in idx],
            problem_hashes=tuple(self.problem_hashes[i] for i in idx),
            sizes=tuple(self.sizes[i] for i in idx),
            scales=tuple(self.scales[i] for i in idx),
            wall_s=self.wall_s, compile_s=self.compile_s,
            dispatches=self.dispatches, meta=meta, best_known=bk)

    def merge(self, other: "SolveReport") -> "SolveReport":
        """Concatenate two reports from the same solver — shards of one
        sweep solved on different hosts, or the serve tier's streamed
        per-bucket partial reports.

        Additive columns (``wall_s`` / ``compile_s`` / ``dispatches``) sum.
        ``runs`` must agree: partial reports of one streamed solve share
        the per-problem run count, and silently keeping one side's value
        would make per-run metrics (``anneals_per_s``, SR) lie about the
        other side's problems. Meta entries that are per-problem lists
        (length == their report's problem count on BOTH sides — e.g. tabu's
        ``iters_used``, PT's ``swap_acceptances``) concatenate in problem
        order; other conflicting keys keep ``self``'s value, as before.
        """
        if other.solver != self.solver:
            raise ValueError(f"cannot merge reports from {self.solver!r} "
                             f"and {other.solver!r}")
        if other.runs != self.runs:
            raise ValueError(f"cannot merge reports with runs={self.runs} "
                             f"and runs={other.runs}; per-run metrics would "
                             f"be inconsistent across problems")
        bk = None
        if self.best_known is not None and other.best_known is not None:
            bk = np.concatenate([self.best_known, other.best_known])
        meta = dict(other.meta)
        for k, v in self.meta.items():
            w = meta.get(k)
            if isinstance(v, list) and isinstance(w, list) and \
                    len(v) == self.num_problems and \
                    len(w) == other.num_problems:
                meta[k] = v + w          # per-problem: self's problems first
            else:
                meta[k] = v
        return SolveReport(
            solver=self.solver, runs=self.runs,
            energies=list(self.energies) + list(other.energies),
            best_sigma=list(self.best_sigma) + list(other.best_sigma),
            problem_hashes=self.problem_hashes + other.problem_hashes,
            sizes=self.sizes + other.sizes,
            scales=self.scales + other.scales,
            wall_s=self.wall_s + other.wall_s,
            compile_s=self.compile_s + other.compile_s,
            dispatches=self.dispatches + other.dispatches,
            meta=meta, best_known=bk)

    @classmethod
    def merge_many(cls, reports, mixed_ok: bool = False) -> "SolveReport":
        """Multi-way ``merge`` in one pass — same semantics as pairwise
        left-folding, but each column is concatenated once, so assembling
        a long stream of per-bucket partials (the serve tier's ``report()``)
        is linear in the flush count instead of quadratic.

        ``mixed_ok`` relaxes the same-solver requirement for streams that
        legitimately mix backends — the serve tier under degradation, where
        some flushes fell down the fallback chain. The merged report keeps
        the first report's solver name; per-problem provenance lives in the
        meta lists the resilience layer attaches (``solver_by_problem``,
        ``degraded``), which concatenate in problem order like any other
        per-problem meta."""
        reports = list(reports)
        if not reports:
            raise ValueError("merge_many needs at least one report")
        first = reports[0]
        for r in reports[1:]:
            if r.solver != first.solver and not mixed_ok:
                raise ValueError(f"cannot merge reports from "
                                 f"{first.solver!r} and {r.solver!r}")
            if r.runs != first.runs:
                raise ValueError(f"cannot merge reports with runs="
                                 f"{first.runs} and runs={r.runs}; per-run "
                                 f"metrics would be inconsistent across "
                                 f"problems")
        bk = None
        if all(r.best_known is not None for r in reports):
            bk = np.concatenate([r.best_known for r in reports])
        meta: dict = {}
        for r in reports:                # first occurrence wins conflicts,
            for k, v in r.meta.items():  # per-problem lists concatenate —
                w = meta.get(k)          # exactly the pairwise fold's rules
                if w is None:
                    meta[k] = v
                elif isinstance(v, list) and isinstance(w, list):
                    meta[k] = w + v
        # re-check the per-problem alignment the pairwise rule enforces:
        # only lists that track problem count stay concatenated; anything
        # else falls back to its first occurrence (= pairwise self-wins)
        total = sum(r.num_problems for r in reports)
        for k in list(meta):
            if isinstance(meta[k], list) and len(meta[k]) != total:
                meta[k] = next(r.meta[k] for r in reports if k in r.meta)
        return cls(
            solver=first.solver, runs=first.runs,
            energies=[e for r in reports for e in r.energies],
            best_sigma=[s for r in reports for s in r.best_sigma],
            problem_hashes=tuple(h for r in reports
                                 for h in r.problem_hashes),
            sizes=tuple(n for r in reports for n in r.sizes),
            scales=tuple(s for r in reports for s in r.scales),
            wall_s=sum(r.wall_s for r in reports),
            compile_s=sum(r.compile_s for r in reports),
            dispatches=sum(r.dispatches for r in reports),
            meta=meta, best_known=bk)

    def to_json(self) -> dict:
        """JSON-serializable dict — one schema for every solver."""
        out = {
            "solver": self.solver,
            "runs": int(self.runs),
            "num_problems": self.num_problems,
            "sizes": [int(n) for n in self.sizes],
            "scales": [float(s) for s in self.scales],
            "problem_hashes": list(self.problem_hashes),
            "energies": [np.asarray(e, dtype=float).tolist()
                         for e in self.energies],
            "best_energy": self.best_energy.tolist(),
            "best_sigma": [np.asarray(s, dtype=int).tolist()
                           for s in self.best_sigma],
            "wall_s": float(self.wall_s),
            "compile_s": float(self.compile_s),
            "dispatches": int(self.dispatches),
            "anneals_per_s": float(self.anneals_per_s),
            "meta": _jsonable(self.meta),
            "best_known": (None if self.best_known is None
                           else self.best_known.tolist()),
            "metrics": None,
        }
        if self.best_known is not None:
            m = self.metrics()
            out["metrics"] = {k: (v.tolist() if isinstance(v, np.ndarray)
                                  else float(v)) for k, v in m.items()}
        return out

    def summary(self) -> str:
        compile_note = (f" + compile {self.compile_s:.2f}s"
                        if self.compile_s > 0 else "")
        lines = [f"[{self.solver}] {self.num_problems} problems "
                 f"(N={sorted(set(self.sizes))}), {self.runs} runs, "
                 f"{self.dispatches} dispatches, wall {self.wall_s:.2f}s"
                 f"{compile_note} ({self.anneals_per_s:.0f} anneals/s)"]
        with np.printoptions(precision=3, suppress=True):
            lines.append(f"  best energy : {self.best_energy}")
            if self.best_known is not None:
                m = self.metrics()
                lines.append(f"  best known  : {self.best_known}")
                lines.append(f"  success rate: "
                             f"{np.round(m['success_rate'], 4)} "
                             f"(mean {m['mean_success_rate']:.4f})")
                lines.append(f"  TTS (ms)    : {m['tts_s'] * 1e3}")
                lines.append(f"  norm ETS(nJ): "
                             f"{m['normalized_ets_j'] * 1e9}")
        return "\n".join(lines)


def _jsonable(obj):
    try:
        json.dumps(obj)
        return obj
    except TypeError:
        if isinstance(obj, dict):
            return {str(k): _jsonable(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [_jsonable(v) for v in obj]
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return repr(obj)
