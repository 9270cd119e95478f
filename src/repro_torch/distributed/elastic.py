"""Fleet membership for the serve tier (``WorkerSet``,
``rendezvous_route``) and the mesh rebuild after a membership change
(``largest_mesh_shape``, ``remesh``): the reference's
``distributed.elastic``.

A ``WorkerSet`` tracks live solve workers (join / leave / mark_dead) and
``rendezvous_route`` picks the owner of each batch key by highest-random-
weight (rendezvous) hashing: when a worker leaves, only the keys it owned
move, so the batcher's cross-worker coalescing survives membership churn
(consistent-hash rings move O(K/N) keys too but need virtual nodes for
balance; HRW is balanced by construction at fleet sizes of 2–16).
"""
from __future__ import annotations

import hashlib
import logging
import threading
from typing import List, Sequence

import numpy as np
import torch

from .sharding import Mesh, mesh_of_processes, virtual_mesh

log = logging.getLogger("repro_torch.elastic")


def rendezvous_route(key: str, members: Sequence[str]) -> str:
    """Owner of ``key`` among ``members`` by highest-random-weight hashing.

    Deterministic in (key, member set) and independent of member order,
    so every router replica agrees without coordination, and removing one
    member reassigns only the keys that member owned.
    """
    if not members:
        raise ValueError("rendezvous_route: no live members")
    return max(members, key=lambda m: hashlib.sha1(
        f"{m}\x00{key}".encode()).digest())


class WorkerSet:
    """Thread-safe live-membership registry for the serve fleet.

    Workers ``join`` at startup and ``leave`` on graceful shutdown;
    ``mark_dead`` records a crash (the reaper uses the distinction: dead
    workers' leases are reclaimed immediately, departed workers drained
    theirs first). ``version`` bumps on every change so routers can cheaply
    check for membership churn without copying the member list.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._live: set = set()
        self._dead: set = set()
        self.version = 0

    def join(self, worker_id: str) -> None:
        with self._lock:
            self._live.add(worker_id)
            self._dead.discard(worker_id)
            self.version += 1

    def leave(self, worker_id: str) -> None:
        with self._lock:
            self._live.discard(worker_id)
            self.version += 1

    def mark_dead(self, worker_id: str) -> None:
        with self._lock:
            if worker_id in self._live:
                self._live.discard(worker_id)
                self._dead.add(worker_id)
                self.version += 1

    def live(self) -> List[str]:
        with self._lock:
            return sorted(self._live)

    def dead(self) -> List[str]:
        with self._lock:
            return sorted(self._dead)

    def is_live(self, worker_id: str) -> bool:
        with self._lock:
            return worker_id in self._live


def largest_mesh_shape(n_devices: int, model_parallel: int,
                       pods: int = 1) -> tuple:
    """Keep TP fixed (it's bound to weight shapes), shrink/grow data."""
    per_pod = n_devices // pods
    data = max(per_pod // model_parallel, 1)
    shape = (pods, data, model_parallel) if pods > 1 else (data, model_parallel)
    return shape


def remesh(available_devices: Sequence, model_parallel: int, pods: int = 1,
           torch_device: str | torch.device = "cuda") -> Mesh:
    """The largest mesh of ``largest_mesh_shape`` over the first of
    ``available_devices``, with the reference's axis names. Over the ranks
    of an initialised ``torch.distributed`` world (``available_devices``
    are ranks) it is a mesh of processes; without a world, a virtual mesh
    of that shape on ``torch_device``."""
    import torch.distributed as dist
    n = len(available_devices)
    shape = largest_mesh_shape(n, model_parallel, pods)
    used = int(np.prod(shape))
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    log.info("elastic remesh: %d devices -> mesh %s (%d used)", n, shape, used)
    mesh = virtual_mesh(shape, axes, torch_device)
    if not dist.is_initialized():
        return mesh
    return mesh_of_processes(axes, shape, mesh.torch_device,
                             available_devices[:used])
