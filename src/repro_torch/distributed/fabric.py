"""Virtual mega-fabric: checkerboard LNS over K virtual dies at thousands of
spins (the reference's ``distributed.fabric``).

``core.engine.BlockLNS`` breaks the 64-spin die limit by clamping all but
one sub-block and annealing the free block on the die, every block of an
outer sweep in one dispatch. This module is the software analogue of tiling
many 64-spin chips into a larger fabric:

* :class:`FabricLayout` blocks the spin index into contiguous tiles of at
  most ``free_block`` (= 63) spins, 2-colors them checkerboard-style (tile
  parity) and assigns tiles round-robin, by rank within each color class,
  to the ``K`` dies. All tiles of one color share no free spins, so one
  color phase anneals all of them in one batched engine dispatch.

* :class:`FieldExchange` keeps the coupling matrix resident on the device,
  split into K column tiles (die ``k`` holds ``J[:, cols_k]``), and
  computes the clamped-spin boundary fields as the sum, in die order, of
  each die's partial product: the halo exchange of a chip fabric. J and
  sigma are integer valued (DAC levels x +-1), so the float32 partial sums
  are exact and the fields are bit-identical for every K.

* :class:`FabricLNS` runs the checkerboard sweep: per color phase, fields
  are exchanged once, every (die, tile, restart) sub-instance (a tile plus
  one boundary-field ancilla, exactly one die program) is written into a
  batch template built once per solve, and the whole color class anneals
  as ONE engine dispatch, laid out die-aligned. Candidates are then
  accepted by exact float64 delta energy against an incrementally kept
  field ledger, in CANONICAL ``(problem, tile)`` order, never in the
  die-major slot order of the batch: same-color tiles are still coupled
  through J, so each acceptance shifts the fields later tiles see, and a
  mesh-dependent order would make the result depend on ``n_dies``. With
  the canonical order the mesh decides only where a candidate is made.

The dies are virtual: all K of them live in one process on one torch
device, the counterpart of the reference's XLA forced host devices
(``--xla_force_host_platform_device_count``), and the reference's
``shard_map`` + ``psum`` becomes K partial products summed in die order.
The acceptance loop runs once, on the host, as in the reference's single
controller. So there is no device count to exceed and the reference's
"more dies than devices" refusal has no counterpart; dies placed on
several cards wait for a machine that has them. The reference's cache of
jitted exchange functions has nothing to cache here and is left out.

Dispatch ledger: ``colors x outer_sweeps`` engine dispatches per solve,
plus ``problems x colors x outer_sweeps`` field exchanges, reported apart.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device

#: the fabric mesh axis name: one entry per virtual die
FABRIC_AXIS = "fabric"


@dataclasses.dataclass(frozen=True)
class FabricMesh:
    """``n_dies`` virtual dies, all on ``torch_device``."""
    n_dies: int
    torch_device: torch.device


def fabric_mesh(n_dies: Optional[int] = None,
                torch_device: str | torch.device = "cuda") -> FabricMesh:
    """A fabric of ``n_dies`` virtual dies (default one) on one device.

    The dies are the counterpart of XLA's forced host devices: K dies in one
    process share ``torch_device``, which runs every color phase as one
    batch. Placing dies on several cards waits for a machine that has them.
    """
    k = 1 if n_dies is None else int(n_dies)
    if k < 1:
        raise ValueError(f"fabric mesh needs >= 1 die, got {k}")
    return FabricMesh(k, resolve_device(torch_device))


@dataclasses.dataclass(frozen=True)
class FabricLayout:
    """Tile grid of one problem over a ``n_dies``-die fabric.

    Tiles are the contiguous balanced blocks of
    :func:`repro_torch.core.engine.lns_blocks` (at most ``free_block``
    spins each, so tile + boundary ancilla fits one die), colored by parity
    and assigned round-robin within each color class, so every color phase
    spreads its tiles evenly across all ``n_dies`` dies.
    """
    n: int
    n_dies: int
    free_block: int
    tiles: tuple                      # tuple[np.ndarray] spin-index blocks

    @classmethod
    def build(cls, n: int, n_dies: int,
              free_block: int = 63) -> "FabricLayout":
        from ..core.engine import lns_blocks
        if n_dies < 1:
            raise ValueError(f"n_dies must be >= 1, got {n_dies}")
        return cls(n=int(n), n_dies=int(n_dies), free_block=int(free_block),
                   tiles=tuple(lns_blocks(n, free_block)))

    @property
    def n_tiles(self) -> int:
        return len(self.tiles)

    @property
    def n_colors(self) -> int:
        """2-coloring (checkerboard) once there is anything to alternate."""
        return min(2, self.n_tiles)

    def color_of(self, t: int) -> int:
        return t % self.n_colors

    def die_of(self, t: int) -> int:
        # round-robin by rank WITHIN the color class, not by raw tile
        # index: ``t % n_dies`` would alias with the parity coloring on
        # even meshes and pile a whole color phase onto same-parity dies
        return (t // self.n_colors) % self.n_dies

    def color_tiles(self, color: int) -> list:
        return [t for t in range(self.n_tiles) if self.color_of(t) == color]

    def die_color_tiles(self, color: int) -> list:
        """Per-die tile lists for one color phase: ``[(die, [t, ...])]``
        for every die (possibly empty: an idle die in this phase)."""
        per_die: list = [[] for _ in range(self.n_dies)]
        for t in self.color_tiles(color):
            per_die[self.die_of(t)].append(t)
        return list(enumerate(per_die))

    def occupancy(self, color: int) -> dict:
        """The phase's die-occupancy ledger: how many tiles each die
        anneals, how many dies idle, and the per-die padding the batched
        dispatch needs to stay die-aligned."""
        counts = [len(ts) for _, ts in self.die_color_tiles(color)]
        peak = max(counts) if counts else 0
        return {
            "tiles": int(sum(counts)),
            "dies_busy": int(sum(1 for c in counts if c)),
            "dies_idle": int(sum(1 for c in counts if not c)),
            "max_tiles_per_die": int(peak),
            "pad_tiles": int(sum(peak - c for c in counts)),
        }


class FieldExchange:
    """Device-resident boundary-field computation for one problem.

    The coupling matrix, padded to ``n_pad = ceil(n / K) * K``, stays on the
    mesh's device as K column tiles (die ``k`` holds ``J[:, cols_k]``), and
    ``fields(s)`` returns the full local field ``h = s @ J`` as the sum, in
    die order, of each die's partial ``s[:, cols_k] @ J[:, cols_k]^T``. One
    call = one halo exchange; J never moves again after placement.

    On one device the K partials give the bits of one product of the padded
    J; they stand for the reference's per-die ``psum`` and cost K product
    launches a call (timed beside K = 1 by ``chip_smoke.py``, PERF.md §6).
    They become per-card products once dies sit on several cards.
    """

    def __init__(self, J_levels: np.ndarray, mesh: FabricMesh):
        J = np.asarray(J_levels, dtype=np.float32)
        if J.ndim != 2 or J.shape[0] != J.shape[1]:
            raise ValueError(f"FieldExchange takes one (N, N) coupling "
                             f"matrix, got {J.shape}")
        self.mesh = mesh
        self.n = J.shape[0]
        k = mesh.n_dies
        self.n_pad = -(-self.n // k) * k
        Jp = torch.zeros((self.n_pad, self.n_pad), dtype=torch.float32)
        Jp[:self.n, :self.n] = torch.from_numpy(J)
        self._cols = [slice(d * self.n_pad // k, (d + 1) * self.n_pad // k)
                      for d in range(k)]
        self._J = [Jp[:, c].contiguous().to(mesh.torch_device)
                   for c in self._cols]
        self.exchanges = 0

    def fields(self, s: np.ndarray) -> np.ndarray:
        """``h = s @ J`` for ±1 states ``s (R, N)`` -> ``(R, N)`` float32.

        Exact: J is integer DAC levels and s is ±1, so every partial sum is
        an integer of magnitude at most 15·N (127·N for int8 levels), below
        2^24: float32 loses nothing, TF32 (whose 10-bit mantissa holds these
        operands exactly and which accumulates in float32) neither, and the
        order of the die sum cannot change a bit. So the products may stay
        ``torch.matmul``, in whatever order the library sums.
        """
        s = np.asarray(s, dtype=np.float32)
        if s.ndim != 2 or s.shape[-1] != self.n:
            raise ValueError(f"state has shape {s.shape}, expected (R, "
                             f"{self.n})")
        st = torch.zeros((s.shape[0], self.n_pad), dtype=torch.float32)
        st[:, :self.n] = torch.from_numpy(s)
        st = st.to(self.mesh.torch_device)
        h = None
        for cols, J_loc in zip(self._cols, self._J):
            part = st[:, cols] @ J_loc.T          # this die's (R, n_pad)
            h = part if h is None else h + part   # the psum, in die order
        self.exchanges += 1
        return h[:, :self.n].cpu().numpy()


class FabricLNS:
    """Checkerboard large-neighborhood search over a virtual-die mesh.

    Same contract as :class:`repro_torch.core.engine.BlockLNS`: ``solve``
    minimizes level-space ``H = -0.5 s'Js`` and returns per-problem
    ``(energies (R,), sigma (R, N), init_energies (R,))`` plus the engine
    dispatch count. All tiles of a color phase anneal in one dispatch (on
    the card: one anneal-kernel launch), per-sweep dispatches are
    ``n_colors``, and the boundary fields come from the
    :class:`FieldExchange`. Acceptance is sequential, float64-exact and in
    canonical (problem, tile) order whichever die made each candidate, so
    the mesh size cannot change the result, only where the work runs.

    After ``solve``, ``self.ledger`` holds the occupancy / timing record
    the registry surfaces as ``meta['fabric']``; each sweep's record also
    names the anneal-kernel variant (``j_dtypes``) each color phase ran.
    """

    def __init__(self, engine, mesh: Optional[FabricMesh] = None,
                 chip_block: int = 64, inner_runs: int = 8):
        self.engine = engine
        self.mesh = (mesh if mesh is not None else
                     fabric_mesh(torch_device=engine.torch_device))
        if self.mesh.torch_device.type != engine.torch_device.type:
            raise ValueError(f"the mesh's dies sit on "
                             f"{self.mesh.torch_device}, the engine on "
                             f"{engine.torch_device}")
        self.chip_block = chip_block
        self.inner_runs = inner_runs
        self.n_dies = self.mesh.n_dies
        self.ledger: dict = {}

    # -- per-solve precompute, hoisted out of the sweeps -------------------
    def _plan(self, Js: Sequence[np.ndarray]):
        """Everything sweep-invariant, computed once: layouts, field
        exchangers, per-tile couplings, and the slot plan of each color
        (reference ``_plan``)."""
        cb = self.chip_block
        layouts = [FabricLayout.build(J.shape[0], self.n_dies, cb - 1)
                   for J in Js]
        exchangers = [FieldExchange(J, self.mesh) for J in Js]
        n_colors = max(l.n_colors for l in layouts)
        colors = []
        for c in range(n_colors):
            # die-aligned row order: die 0's tiles (every problem), then
            # die 1's, ... padded per die to the fabric-wide peak so the
            # batch splits into equal contiguous per-die chunks
            per_die: list = [[] for _ in range(self.n_dies)]
            for p, lay in enumerate(layouts):
                if c >= lay.n_colors:
                    continue
                for d, ts in lay.die_color_tiles(c):
                    per_die[d].extend((p, t) for t in ts)
            peak = max(len(x) for x in per_die)
            if peak == 0:
                colors.append(None)
                continue
            slots = []                       # (p, t) or None (idle pad)
            for d in range(self.n_dies):
                slots.extend(per_die[d])
                slots.extend([None] * (peak - len(per_die[d])))
            colors.append({"slots": slots, "peak": peak,
                           "occupancy": [
                               lay.occupancy(c) if c < lay.n_colors else None
                               for lay in layouts]})
        tiles = {}
        for p, lay in enumerate(layouts):
            J = Js[p]
            for t, blk in enumerate(lay.tiles):
                lo, hi = int(blk[0]), int(blk[-1]) + 1   # contiguous
                Jbb64 = J[lo:hi, lo:hi]
                tiles[(p, t)] = (lo, hi, Jbb64, Jbb64.astype(np.float32),
                                 np.ascontiguousarray(J[lo:hi, :]))
        return layouts, exchangers, colors, tiles

    def _template(self, color_plan, tiles, restarts):
        """(S, cb, cb) float32 batch with the J_tile blocks stamped; rows
        are (die-slot, restart)-major and idle-pad slots stay all-zero.
        ``accept`` is the same spans sorted into canonical (problem, tile)
        order: acceptance must NOT follow the die-major batch order, which
        depends on n_dies (reference ``_template``)."""
        cb = self.chip_block
        S = len(color_plan["slots"]) * restarts
        batch = np.zeros((S, cb, cb), dtype=np.float32)
        spans = []
        for k, slot in enumerate(color_plan["slots"]):
            rows = slice(k * restarts, (k + 1) * restarts)
            if slot is None:
                spans.append((None, rows))
                continue
            lo, hi, _, Jbb32, _ = tiles[slot]
            m = hi - lo
            batch[rows, 1:m + 1, 1:m + 1] = Jbb32
            spans.append((slot, rows))
        accept = sorted((sp for sp in spans if sp[0] is not None),
                        key=lambda sp: sp[0])
        return batch, spans, accept

    # -- the solve loop ----------------------------------------------------
    def solve(self, J_list, restarts: int, outer_sweeps: int, seed: int = 0):
        from ..core.lfsr import lfsr_voltage_inits
        cb = self.chip_block
        rng = np.random.default_rng(seed)
        Js = [np.asarray(J, dtype=np.float64) for J in J_list]
        # the init stream of BlockLNS: seed-equal solves start equal
        states = [rng.choice([-1.0, 1.0], size=(restarts, J.shape[0]))
                  for J in Js]

        def energies(p):
            S = states[p]
            return -0.5 * np.einsum("ri,ij,rj->r", S, Js[p], S)

        init_e = [energies(p) for p in range(len(Js))]

        t_plan0 = time.perf_counter()
        layouts, exchangers, colors, tiles = self._plan(Js)
        templates = [None if cp is None else
                     self._template(cp, tiles, restarts) for cp in colors]
        # exact float64 full-field ledger F = s @ J, kept incrementally
        # under acceptance (the host-side counterpart of the exchange)
        F = [states[p] @ Js[p] for p in range(len(Js))]
        t_plan = time.perf_counter() - t_plan0

        dispatches = 0
        sweeps_ledger = []
        for sweep in range(outer_sweeps):
            rec = {"t_fields": 0.0, "t_assemble": 0.0, "t_engine": 0.0,
                   "t_accept": 0.0, "j_dtypes": []}
            t_sweep0 = time.perf_counter()
            for c, (cplan, tmpl) in enumerate(zip(colors, templates)):
                if cplan is None:
                    continue
                batch, spans, accept = tmpl

                # 1) halo exchange: per-die partial products, summed (exact)
                t0 = time.perf_counter()
                h_all = [exchangers[p].fields(states[p])
                         if any(s is not None and s[0] == p
                                for s, _ in spans) else None
                         for p in range(len(Js))]
                rec["t_fields"] += time.perf_counter() - t0

                # 2) stamp the ancilla boundary row/col into the template
                t0 = time.perf_counter()
                for slot, rows in spans:
                    if slot is None:
                        continue
                    p, t = slot
                    lo, hi, Jbb64, _, _ = tiles[slot]
                    m = hi - lo
                    Sb = states[p][:, lo:hi]
                    h = h_all[p][:, lo:hi].astype(np.float64) - Sb @ Jbb64
                    batch[rows, 0, 1:m + 1] = h
                    batch[rows, 1:m + 1, 0] = h
                v0 = torch.as_tensor(lfsr_voltage_inits(
                    cb, self.inner_runs,
                    seed=seed + 7919 * (sweep + 1) + 104729 * (c + 1)))
                rec["t_assemble"] += time.perf_counter() - t0

                # 3) ONE engine dispatch of the die-aligned color class:
                # every die sits on the engine's device, so on the card
                # this is one anneal-kernel launch
                t0 = time.perf_counter()
                batch_dev = torch.as_tensor(batch).to(
                    self.engine.torch_device)
                res = self.engine.run(
                    batch_dev, v0.expand((batch.shape[0],) + v0.shape))
                e = res.energy.cpu().numpy()           # (S, inner_runs)
                sig = res.sigma.cpu().numpy()          # (S, inner, cb)
                rec["t_engine"] += time.perf_counter() - t0
                rec["j_dtypes"].append(res.j_dtype)
                dispatches += 1

                # 4) sequential EXACT acceptance (monotone incumbents) in
                # canonical (problem, tile) order, NOT die-major batch
                # order, so results cannot depend on the mesh size
                t0 = time.perf_counter()
                best = e.argmin(axis=1)
                cand_all = np.take_along_axis(
                    sig, best[:, None, None], axis=1)[:, 0]
                for slot, rows in accept:
                    p, t = slot
                    lo, hi, Jbb64, _, Jrows64 = tiles[slot]
                    m = hi - lo
                    cand = cand_all[rows]
                    # gauge-fix the boundary ancilla to +1, trim to tile
                    cand = (cand[:, 1:m + 1] *
                            cand[:, :1]).astype(np.float64)
                    cur = states[p][:, lo:hi]
                    h = F[p][:, lo:hi] - cur @ Jbb64   # exact current field
                    e_new = -np.einsum("rm,rm->r", h, cand) \
                        - 0.5 * np.einsum("rm,mk,rk->r", cand, Jbb64, cand)
                    e_old = -np.einsum("rm,rm->r", h, cur) \
                        - 0.5 * np.einsum("rm,mk,rk->r", cur, Jbb64, cur)
                    acc = np.flatnonzero(e_new < e_old - 1e-9)
                    if len(acc):
                        F[p][acc] += (cand[acc] - cur[acc]) @ Jrows64
                        states[p][np.ix_(acc, np.arange(lo, hi))] = cand[acc]
                rec["t_accept"] += time.perf_counter() - t0
            rec["t_total"] = time.perf_counter() - t_sweep0
            sweeps_ledger.append(rec)

        self.ledger = {
            "mesh_devices": self.n_dies,
            "n_colors": max(l.n_colors for l in layouts),
            "n_tiles": [l.n_tiles for l in layouts],
            # fabric-wide tiles-per-die peak of each color phase (idle pads
            # ride along but anneal zero-J tiles)
            "color_peaks": [cp["peak"] for cp in colors if cp],
            "restarts": restarts,
            "inner_runs": self.inner_runs,
            "occupancy": [
                {"color": c, **{f"p{p}": o for p, o in
                                enumerate(cp["occupancy"]) if o}}
                for c, cp in enumerate(colors) if cp],
            "field_exchanges": int(sum(x.exchanges for x in exchangers)),
            "plan_s": t_plan,
            "per_sweep": sweeps_ledger,
            "dispatches": dispatches,
        }
        out = []
        for p in range(len(Js)):
            out.append((energies(p), states[p].astype(np.int8), init_e[p]))
        return out, dispatches
