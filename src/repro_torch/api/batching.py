"""One shared pad-bucket planner for every batched solve path.

The chip embeds a small instance on the 64-spin die by zero-coupling the
unused nodes; software mirrors that by zero-padding each problem up to a
multiple of the chip block and stacking same-pad problems into one
``(P, n_pad, n_pad)`` device batch. Suite stacking
(``ProblemSuite.buckets``) and the registry's trim/reorder of bucket
results (``_bucketed_report``) both route through this module (numpy,
copied from the reference):

  * :func:`plan_buckets` — pure planning: group problem indices by padded
    size into a :class:`BatchPlan` (no arrays touched). The number of
    groups is the number of device dispatches a batched solver owes the
    suite.
  * :func:`pad_stack` — the one padding kernel: stack ``(m, m)`` matrices
    (or pre-batched ``(R, m, m)`` stacks) into a zero-padded float32
    ``(P, n_pad, n_pad)`` batch.
  * :meth:`BatchPlan.materialize` — plan + matrices -> :class:`Bucket`
    list, exactly what a batched solver dispatches.
  * :meth:`BatchPlan.scatter` — per-bucket ``(energies, spins)`` back into
    original suite order, spins trimmed to each problem's true size.

Padding is exact: padded spins have zero couplings in both directions, so
they contribute nothing to any real spin's dynamics nor to the energy.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

#: one chip die — the default padding block.
CHIP_BLOCK = 64


def padded_size(n: int, block: int = CHIP_BLOCK) -> int:
    """Smallest multiple of ``block`` holding ``n`` spins (>= block)."""
    return max(block, -(-n // block) * block)


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One stacked device batch: all planned problems padding to ``n_pad``."""
    n_pad: int
    indices: tuple[int, ...]          # positions in the planned collection
    J: np.ndarray                     # (P, n_pad, n_pad) float32 LEVEL space

    @property
    def num_problems(self) -> int:
        return len(self.indices)


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """Which problems ride which pad bucket — arrays not yet touched.

    ``groups`` is sorted by ``n_pad``; within a group, indices keep the
    original collection order (this pins bucket row order, and therefore
    per-row RNG streams, bit-identical to the pre-refactor bucketing).
    """
    block: int
    sizes: tuple[int, ...]                         # true spin counts
    groups: tuple[tuple[int, tuple[int, ...]], ...]  # (n_pad, indices)

    @property
    def num_buckets(self) -> int:
        return len(self.groups)

    #: device dispatches a batched solver owes this plan — one per bucket.
    num_dispatches = num_buckets

    def materialize(self, mats: Sequence[np.ndarray]) -> list[Bucket]:
        """Stack the planned groups of ``mats`` (aligned with ``sizes``)
        into zero-padded device batches."""
        return [Bucket(n_pad=n_pad, indices=idx,
                       J=pad_stack([mats[i] for i in idx], n_pad))
                for n_pad, idx in self.groups]

    def scatter(self, bucket_outputs):
        """Reorder per-bucket solver outputs back into collection order.

        ``bucket_outputs`` aligns with ``groups``: per bucket, ``(e, s)``
        with ``e (P, R)`` level-space energies and ``s (P, R, n_pad)``
        spins. Returns ``(energies, sigmas)`` lists in original order —
        energies as float64 ``(R,)`` rows, sigmas the argmin run's spins
        trimmed to the true problem size (int8).
        """
        energies = [None] * len(self.sizes)
        sigmas = [None] * len(self.sizes)
        for (n_pad, idx), (e, s) in zip(self.groups, bucket_outputs):
            e = np.asarray(e, dtype=np.float64)
            s = np.asarray(s)
            for k, i in enumerate(idx):
                best = int(np.argmin(e[k]))
                energies[i] = e[k]
                sigmas[i] = s[k, best, :self.sizes[i]].astype(np.int8)
        return energies, sigmas


def plan_buckets(sizes: Sequence[int], block: int = CHIP_BLOCK) -> BatchPlan:
    """Group problem indices by padded size. Pure planning — cheap enough
    to re-run per service flush; materialization is where the bytes move."""
    groups: dict[int, list[int]] = {}
    for i, n in enumerate(sizes):
        groups.setdefault(padded_size(n, block), []).append(i)
    return BatchPlan(
        block=block, sizes=tuple(int(n) for n in sizes),
        groups=tuple((n_pad, tuple(groups[n_pad]))
                     for n_pad in sorted(groups)))


def pad_stack(mats: Sequence[np.ndarray], n_pad: int) -> np.ndarray:
    """Zero-pad square matrices into one float32 ``(P, n_pad, n_pad)`` batch.

    Each element of ``mats`` is either one ``(m, m)`` coupling matrix
    (contributes one batch row — the suite path) or an ``(R, m, m)`` stack
    (contributes R rows — the chip-lns sub-instance path, where every
    restart carries its own boundary field). ``m <= n_pad``; the padded
    region stays exactly zero.
    """
    rows = []
    for mat in mats:
        mat = np.asarray(mat)
        if mat.ndim == 2:
            mat = mat[None]
        if mat.ndim != 3 or mat.shape[-1] != mat.shape[-2]:
            raise ValueError(f"pad_stack takes (m, m) or (R, m, m) square "
                             f"matrices, got {mat.shape}")
        if mat.shape[-1] > n_pad:
            raise ValueError(f"matrix of size {mat.shape[-1]} cannot pad "
                             f"down to {n_pad}")
        rows.append(mat)
    P = sum(r.shape[0] for r in rows)
    out = np.zeros((P, n_pad, n_pad), dtype=np.float32)
    k = 0
    for r in rows:
        m = r.shape[-1]
        out[k:k + r.shape[0], :m, :m] = r
        k += r.shape[0]
    return out
