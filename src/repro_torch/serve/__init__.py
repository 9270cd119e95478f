"""repro_torch.serve — the continuous-batching Ising solve service (the
reference's ``serve``, on the port's solvers).

    from repro_torch.serve import IsingService

    with IsingService(solver="engine", runs=64, max_batch=32,
                      max_wait_s=0.02, torch_device="cuda") as svc:
        tickets = [svc.submit(p) for p in problems]     # non-blocking
        results = [t.result() for t in tickets]         # (R,) energies each
        print(svc.stats())                              # p50/p95, problems/s

The service keeps the array continuously busy the way the chip does:
requests queue while a dispatch is in flight, the dynamic batcher coalesces
everything waiting into pad buckets (the same ``api.batching`` planner the
offline suite path uses), and each bucket costs exactly one device
dispatch. Every flush runs supervised (``serve.resilience``): bounded
retry, bisection failure isolation, circuit breaker + fallback chain,
watchdog/hedging, and float64 result validation — with a deterministic
chaos harness (``serve.faults``) to prove it. SERVE.md describes the
architecture, admission policies and failure model, which the port keeps.

Scale-out: :class:`~repro_torch.serve.fleet.IsingFleet` runs N such workers
behind a rendezvous-hashing router with a crash-tolerant work-ownership
ledger (per-flush epoch leases, reaper-driven reclaim — a worker dying
mid-flush loses zero tickets) and sharded shared result stores; QoS
classes (``serve.qos``) layer priorities on the deadline→budget mapping
so overload sheds low-priority work first.
"""
from .faults import (FAULT_KINDS, FLEET_FAULT_KINDS, FaultInjector,
                     FaultPlan, FaultySolver, InjectedFault,
                     InjectedWorkerCrash)
from .fleet import FleetWorker, IsingFleet, WorkerKilled, WorkLedger
from .qos import DEFAULT_QOS, QOS_CLASSES, QoSClass, resolve_qos
from .resilience import (CircuitBreaker, FlushExecutor, FlushFailed,
                         FlushTimeout, Overloaded, RequestCancelled,
                         ResiliencePolicy, SolverCrash, validate_row)
from .service import (DEFAULT_FALLBACK_CHAIN, IsingService, ServeResult,
                      ServeTicket, batch_key, budget_tier,
                      solver_for_deadline)

__all__ = [
    "IsingService", "ServeResult", "ServeTicket",
    "DEFAULT_FALLBACK_CHAIN", "solver_for_deadline",
    "batch_key", "budget_tier",
    "IsingFleet", "FleetWorker", "WorkLedger", "WorkerKilled",
    "QoSClass", "QOS_CLASSES", "DEFAULT_QOS", "resolve_qos",
    "ResiliencePolicy", "Overloaded", "RequestCancelled", "SolverCrash",
    "FlushTimeout", "FlushFailed", "CircuitBreaker", "FlushExecutor",
    "validate_row",
    "FaultPlan", "FaultInjector", "FaultySolver", "FAULT_KINDS",
    "FLEET_FAULT_KINDS", "InjectedFault", "InjectedWorkerCrash",
]
