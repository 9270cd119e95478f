"""The port's Ising solve service CLI — closed-loop load against
``repro_torch.serve.IsingService`` (the reference's ``serve_ising``).

    # 8 closed-loop clients streaming a mixed 16/32/64-spin pool for 20 s
    PYTHONPATH=src python -m repro_torch.launch.serve_ising --solver sa-jax \
        --clients 8 --duration 20 --sizes 16,32,64 --pool 32

    # tight per-request deadlines (mapped to effort budgets) + no cache
    PYTHONPATH=src python -m repro_torch.launch.serve_ising --deadline-ms 50 \
        --no-cache

    # on the host instead of the card
    PYTHONPATH=src python -m repro_torch.launch.serve_ising --duration 5 \
        --torch-device cpu

Each client thread repeatedly submits a random problem from a pre-built
pool and blocks on the result (closed loop — a client's next request only
enters the queue after its last one resolved, so concurrency == clients).
The main thread prints a live line per second: sustained problems/s, p50
and p95 latency, cache hit rate, and the coalescing ledger (requests per
flush, device dispatches). On exit it prints the streamed ``SolveReport``
summary — the same schema the offline path produces. Every tier solves on
``--torch-device`` (default ``cuda``; without CUDA the CLI raises
unless given ``--torch-device cpu``).
"""
from __future__ import annotations

import argparse
import random
import threading
import time

from ..api import Problem
from ..serve import (DEFAULT_QOS, FaultPlan, IsingFleet, IsingService,
                     QOS_CLASSES, ResiliencePolicy)


def build_pool(sizes, density: float, pool: int, seed: int) -> list[Problem]:
    """``pool`` random-QUBO instances cycling through ``sizes``."""
    return [Problem.random_qubo(sizes[i % len(sizes)], density, seed=seed + i)
            for i in range(pool)]


def _live_view(stats: dict) -> dict:
    """Normalize service/fleet ``stats()`` to the live-line fields (the
    fleet nests its aggregate under ``"fleet"`` and has no mean_batch)."""
    if "fleet" not in stats:
        return stats
    f = dict(stats["fleet"])
    f["mean_batch"] = (f["completed"] / f["flushes"]) if f["flushes"] else 0.0
    return f


def run_load(svc, pool, clients: int, duration_s: float,
             deadline_s=None, seed: int = 0, live: bool = True,
             qos: str = DEFAULT_QOS) -> dict:
    """Closed-loop load generator against an ``IsingService`` or an
    ``IsingFleet``; returns the final (raw) stats."""
    stop = threading.Event()
    errors = []

    def client(cid: int):
        rng = random.Random(seed + cid)
        while not stop.is_set():
            p = rng.choice(pool)
            try:
                svc.submit(p, deadline_s=deadline_s,
                           qos=qos).result(timeout=300)
            except Exception as e:        # noqa: BLE001 — surface at exit
                errors.append(e)
                return

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    next_tick = t0 + 1.0
    while time.monotonic() - t0 < duration_s and not errors:
        time.sleep(max(0.0, next_tick - time.monotonic()))
        next_tick += 1.0
        if live:
            s = _live_view(svc.stats())
            print(f"[{time.monotonic() - t0:5.1f}s] "
                  f"{s['problems_per_s']:7.1f} problems/s  "
                  f"p50 {s['p50_latency_s'] * 1e3:7.1f} ms  "
                  f"p95 {s['p95_latency_s'] * 1e3:7.1f} ms  "
                  f"hit {s['cache_hit_rate']:5.1%}  "
                  f"{s['mean_batch']:4.1f} req/flush  "
                  f"{s['dispatches']} dispatches", flush=True)
    stop.set()
    for t in threads:
        t.join(timeout=300)
    if errors:
        raise errors[0]
    return svc.stats()


def _print_resilience(label: str, r: dict) -> None:
    print(f"-- {label}: retries {r['retries']}, "
          f"bisections {r['bisections']}, hedges {r['hedges']}, "
          f"validation rejects {r['validation_failures']}, "
          f"breaker trips {r['breaker_trips']}, "
          f"fallback solves {r['fallback_solves']}")


def _print_fleet_ledger(stats: dict) -> None:
    """Per-worker + fleet-aggregate resilience/ownership ledger."""
    f, led = stats["fleet"], stats["fleet"]["ledger"]
    print(f"-- fleet: {f['workers_live']} live / {f['workers_dead']} dead "
          f"({f['worker_crashes']} crashes), "
          f"leases reclaimed {led['reclaimed']} "
          f"{led['reclaims_by_reason'] or ''}, "
          f"stale resolves {led['stale_resolves']}, lost {f['lost']}, "
          f"shed {f['shed']} {f['shed_by_qos'] or ''}")
    for wid in sorted(stats["workers"]):
        w = stats["workers"][wid]
        _print_resilience(
            f"  {wid}: {w['flushes']} flushes/{w['dispatches']} dispatches"
            f" | resilience", w["resilience"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", default="sa-jax",
                    help="registered solver backing the service")
    ap.add_argument("--workers", type=int, default=1,
                    help="worker count; >1 serves through the "
                         "crash-tolerant IsingFleet (rendezvous-routed "
                         "batch keys, work-ownership ledger, reaper)")
    ap.add_argument("--qos", default=DEFAULT_QOS,
                    choices=sorted(QOS_CLASSES),
                    help="QoS class for every generated request — under "
                         "overload, low-priority classes degrade and "
                         "shed first")
    ap.add_argument("--sizes", default="16,32,64",
                    help="comma-separated spin counts in the problem mix")
    ap.add_argument("--density", type=float, default=0.5)
    ap.add_argument("--pool", type=int, default=32,
                    help="distinct problems the load generator cycles over")
    ap.add_argument("--clients", type=int, default=8,
                    help="closed-loop client threads")
    ap.add_argument("--duration", type=float, default=20.0,
                    help="seconds of sustained load")
    ap.add_argument("--runs", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=64,
                    help="admission policy: flush a pad bucket at this size")
    ap.add_argument("--max-wait-ms", type=float, default=20.0,
                    help="admission policy: flush a non-full bucket after "
                         "its oldest request waited this long")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline, mapped to an effort budget "
                         "via api.budget.deadline_to_budget")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the content-hash result cache")
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device every tier solves on (default cuda; "
                         "pass cpu to serve from the host)")
    ap.add_argument("--chaos", type=float, default=None, metavar="RATE",
                    help="arm deterministic fault injection at this per-call "
                         "rate (e.g. 0.1) with the full degradation ladder "
                         "(retry -> bisect -> breaker -> fallback, watchdog "
                         "hedging, float64 validation); seeded by --chaos-seed")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="fault schedule seed (same seed = same chaos run)")
    ap.add_argument("--fallback", default="tabu-jax,ode-jax,sa-numpy",
                    help="comma-separated degradation chain tried after the "
                         "primary solver when --chaos is set (ode-jax — the "
                         "analog device-physics tier — rides the chain as a "
                         "dynamics-diverse rung: a poisoned flush that "
                         "crashes the discrete paths re-solves on the "
                         "continuous integrator; sa-numpy, the last rung, "
                         "answers on the host, marked degraded)")
    args = ap.parse_args(argv)

    sizes = [int(s) for s in args.sizes.split(",")]
    pool = build_pool(sizes, args.density, args.pool, seed=args.seed)
    deadline_s = (args.deadline_ms / 1e3
                  if args.deadline_ms is not None else None)

    resilience = fault_plan = None
    if args.chaos is not None:
        fallback = tuple(s for s in args.fallback.split(",") if s)
        resilience = ResiliencePolicy(
            fallback=fallback, flush_timeout_s=1.0, min_timeout_s=0.5,
            breaker_cooldown_s=2.0)
        # a fleet's chaos sites are worker-namespaced (process kills,
        # lease expiries, router drops); a single service draws at the
        # solve/cache sites
        fault_plan = (FaultPlan.for_fleet(seed=args.chaos_seed,
                                          rate=args.chaos,
                                          n_workers=args.workers)
                      if args.workers > 1 else
                      FaultPlan.from_rates(seed=args.chaos_seed,
                                           rate=args.chaos))

    common = dict(solver=args.solver, runs=args.runs, seed=args.seed,
                  max_batch=args.max_batch,
                  max_wait_s=args.max_wait_ms / 1e3,
                  cache=not args.no_cache,
                  resilience=resilience, fault_plan=fault_plan,
                  torch_device=args.torch_device)
    rep = raw = None
    if args.workers > 1:
        with IsingFleet(workers=args.workers, **common) as fleet:
            raw = run_load(fleet, pool, args.clients, args.duration,
                           deadline_s=deadline_s, seed=args.seed + 1,
                           qos=args.qos)
    else:
        with IsingService(**common) as svc:
            raw = run_load(svc, pool, args.clients, args.duration,
                           deadline_s=deadline_s, seed=args.seed + 1,
                           qos=args.qos)
            rep = svc.report()
    stats = _live_view(raw)
    print(f"\n-- final: {stats['completed']} solved "
          f"({stats['problems_per_s']:.1f}/s sustained), "
          f"p50 {stats['p50_latency_s'] * 1e3:.1f} ms / "
          f"p95 {stats['p95_latency_s'] * 1e3:.1f} ms, "
          f"cache hit {stats['cache_hit_rate']:.1%}, "
          f"{stats['flushes']} flushes -> {stats['dispatches']} dispatches")
    if args.workers > 1:
        _print_fleet_ledger(raw)
    else:
        _print_resilience("resilience", raw["resilience"])
    if args.chaos is not None:
        print(f"-- chaos: injected {stats['faults']['injected']}")
    if rep is not None:
        print(rep.summary())


if __name__ == "__main__":
    main()
