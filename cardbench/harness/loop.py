"""One run of a cell: set-up, warm-up, the measured window, the readers,
and the judgement of the window's answers.

The traffic is a closed loop with one client, as a research script
drives the solve API: ``solve_suite`` on the run's problems (drawn once
from the seed), called back to back, each call from a new call seed,
the oracle off. The window starts after one warm-up call of the same
shape and ends when the last call begun inside ``seconds`` returns, so
a rate counts all the work and all the time of the window.
"""
from __future__ import annotations

import dataclasses
import json
import resource
import subprocess
import sys
import time
import traceback

import numpy as np

from . import check, problems as gen, spec
from .trace import CALL, Trace

#: top-level module names the measured process must never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Call:
    seed: int
    wall_s: float              # the harness's clock around solve_suite
    report_wall_s: float       # SolveReport.wall_s
    runs: int                  # runs completed (problems x runs)
    start_s: float = 0.0       # the call's start, from the window's


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""
    cell: spec.Cell
    problems: list[np.ndarray]     # the run's level matrices
    setup_s: float
    window_s: float
    calls: list[Call]
    trace: Trace | None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device: str, t_start: float, err=sys.stderr) -> dict:
    """Run the cell once on ``device`` ("cuda", or "cpu" in tests) and
    return the result line's object; ``t_start`` is the process's
    start on the host clock."""
    import torch
    from repro_torch.api import Problem, ProblemSuite, solve_suite

    t_ready = time.perf_counter()
    cfg, traffic = cell.config, cell.traffic
    mats = gen.make_problems(cfg, traffic, seed)
    suite = ProblemSuite([Problem.from_couplings(J) for J in mats])
    seeds = gen.CallSeeds(seed)
    runs = int(traffic["runs"])
    t_problems = time.perf_counter()

    def solve(s):
        return solve_suite(suite, solver=traffic["solver"], runs=runs,
                           seed=s, oracle=False, torch_device=device,
                           **traffic["solver_opts"])

    solve(seeds.warmup)
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(json.dumps({"setup_s": setup_s, "imports_s": t_ready - t_start,
                      "problems_s": t_problems - t_ready,
                      "warmup_s": t_start + setup_s - t_problems}), file=err)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
        prof.start()
    calls, answers, failed = [], [], 0
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        s = seeds.next()
        c0 = time.perf_counter()
        try:
            if prof is not None:
                with record_function(CALL):
                    rep = solve(s)
            else:
                rep = solve(s)
        except Exception:
            if not failed:
                traceback.print_exc(file=err)
            failed += 1
            continue
        c1 = time.perf_counter()
        calls.append(Call(s, c1 - c0, rep.wall_s,
                          sum(np.size(e) for e in rep.energies), c0 - t0))
        answers.append(check.program_answers(rep))
    window_s = time.perf_counter() - t0
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    tr = Trace.from_profiler(prof) if prof is not None else None
    ctx = Context(cell, mats, setup_s, window_s, calls, tr)
    metrics, info = {}, {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        mod = spec.reader(m["name"])
        value = mod.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            if hasattr(mod, "info"):
                info[m["name"]] = mod.info(ctx)
    if info:
        info["card"] = card_line(on_card)
        print(json.dumps({"beside_the_metrics": info}), file=err)
    if calls:
        print(json.dumps(window_line(calls, window_s, use0, use1)), file=err)

    del suite, prof
    if on_card:
        torch.cuda.empty_cache()
    sample = gen.check_sample(seed, len(calls), traffic["check_calls"])
    if sample:
        from cardbench.reference.answers import answers as reference
        want = reference(cfg, traffic, mats,
                         [calls[i].seed for i in sample], device)
        numbers = check.compare([answers[i] for i in sample], want, mats)
    else:                       # no answer came: every run counts as wrong
        numbers = {"energy_mismatch_share": 1.0, "best_energy_gap": 0.0,
                   "runs_judged": 0}
    ok, shown = check.judged(numbers, cell.limits)
    shown["calls_failed"] = {"value": failed, "limit": 0}
    ok = ok and failed == 0 and len(calls) > 0

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(ok), "attempted": len(calls) + failed,
           "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = window_s
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["compared"] = shown
    print(f"judged {numbers['runs_judged']} runs of {len(sample)} of "
          f"{len(calls)} calls", file=err)
    for name, v in shown.items():
        print(f"compared {name} = {v['value']!r} (limit {v['limit']!r})",
              file=err)
    return out


def window_line(calls, window_s, use0, use1) -> dict:
    """What the window's calls and the process's own resource use say
    of the spread between runs: the calls' wall (least, median, most) and
    its median in each quarter of the window, and the process's CPU
    seconds, page faults and context switches (those it gave up, and
    those the kernel took) over the window."""
    walls = sorted(1e3 * c.wall_s for c in calls)
    quarters = [sorted(1e3 * c.wall_s for c in calls
                       if q <= 4 * c.start_s / window_s < q + 1)
                for q in range(4)]
    d = {k: getattr(use1, k) - getattr(use0, k)
         for k in ("ru_utime", "ru_stime", "ru_minflt", "ru_majflt",
                   "ru_nvcsw", "ru_nivcsw")}
    return {"calls": len(calls), "window_s": window_s,
            "call_ms_min_median_max": [walls[0], walls[len(walls) // 2],
                                       walls[-1]],
            "call_ms_median_by_quarter": [q[len(q) // 2] if q else None
                                          for q in quarters],
            "host_cpu_s": d["ru_utime"] + d["ru_stime"],
            "page_faults": d["ru_minflt"] + d["ru_majflt"],
            "switches_voluntary": d["ru_nvcsw"],
            "switches_involuntary": d["ru_nivcsw"]}


def card_line(on_card: bool) -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    if not on_card:
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
