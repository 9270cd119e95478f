"""The yardstick of the kernels: the work a cell asks for, and the card's
published peaks.

Work is counted from the cell's problems as drawn, whatever implements
it: two operations (a multiply and an add) per nonzero coupling per run
per step, over the real spins only, since a zero coupling or a padded
spin adds nothing that a correct kernel has to compute; the anneal's
steps count only the columns whose schedule scale is nonzero (a column
whose rails were gated off adds nothing). Bytes are each coupling's
value and column index read once and each run's state read and written
once. The peaks are the NVIDIA H100 SXM data sheet's dense rates at its
700 W limit; each kernel is held to the highest rate that any correct
implementation of its work could use. So the least time is a true lower
bound and no correct kernel reads over 100%.
"""
from __future__ import annotations

import functools

import numpy as np

#: HBM3 bandwidth, bytes/s
PEAK_BYTES = 3.35e12
#: dense peaks, operations/s
PEAK_OPS = {"int8": 1979e12, "bfloat16": 989e12, "float32": 67e12}
#: a nonzero coupling's float32 value and int32 column index
COUPLING_BYTES = 8


@functools.lru_cache(maxsize=None)
def _active_steps(chip: tuple, pert: tuple, n: int) -> np.ndarray:
    """(n,) int64: the number of the anneal's steps at which column j's
    schedule scale is nonzero."""
    from cardbench.reference.anneal import schedule
    s = schedule(dict(chip), dict(pert), n, "cpu")
    return (s != 0).sum(0).numpy().astype(np.int64)


def anneal_work(problems, runs: int, chip: dict,
                pert: dict) -> tuple[float, float]:
    """(operations, bytes) of one call of the anneal: of every problem,
    2 R a nonzero coupling J[i, j] a step at which column j's scale is
    nonzero; J's nonzeros read, v0 (float32) read and v written."""
    ops = nbytes = 0.0
    for J in problems:
        n = J.shape[0]
        per_col = np.count_nonzero(J, axis=0)
        steps = _active_steps(tuple(sorted(chip.items())),
                              tuple(sorted(pert.items())), n)
        ops += 2.0 * runs * float(per_col @ steps)
        nbytes += COUPLING_BYTES * float(per_col.sum()) + 8.0 * runs * n
    return ops, nbytes


def sb_work(problems, runs: int, steps: int) -> tuple[float, float]:
    """(operations, bytes) of one call of SB: of every problem, 2 R a
    nonzero coupling a step; Jc's nonzeros, x0 and y0 read, x written
    (float32)."""
    ops = nbytes = 0.0
    for J in problems:
        nnz = float(np.count_nonzero(J))
        ops += 2.0 * runs * nnz * steps
        nbytes += COUPLING_BYTES * nnz + 12.0 * runs * J.shape[0]
    return ops, nbytes


def bound_s(ops: float, nbytes: float, peak: str) -> float:
    """The least time the card could take: the larger of the operations
    over the ``peak`` rate and the bytes over the bandwidth."""
    return max(ops / PEAK_OPS[peak], nbytes / PEAK_BYTES)


def kernel_share(ctx, kernels, work: tuple[float, float], peak: str):
    """(share %, kernel seconds, launches) of a traced window: the least
    time the card could take for the window's calls (``work``, the
    (operations, bytes) of one call, against ``peak``) over the device
    time of the activities whose name holds one of ``kernels``; share
    None where no such kernel ran."""
    secs, launches = (0.0, 0) if ctx.trace is None else \
        ctx.trace.device_seconds(lambda n: any(k in n for k in kernels))
    if secs <= 0:
        return None, secs, launches
    return (100.0 * len(ctx.calls) * bound_s(*work, peak) / secs,
            secs, launches)
