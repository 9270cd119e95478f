"""Retry and straggler detection for supervised device work (the
reference's ``distributed.fault_tolerance``, with torch's and the port's
error types).

* ``resilient_step`` runs a step under a retry wrapper: a failed step
  (device error, non-finite loss) triggers ``restore_fn`` and a replay.
* ``StragglerDetector`` is an EWMA step-time monitor; the serve tier's
  watchdog reads its mean flush time.

Only genuine runtime / device failures are worth a restore-and-replay
cycle (``RETRYABLE_ERRORS``): ``StepFailure`` (the wrapper's own verdicts,
e.g. a NaN loss), ``KernelLaunchError`` (a hand-written kernel's launch
failed on the card), torch's CUDA out-of-memory error and, where the
installed torch has it, ``torch.AcceleratorError``. A bare
``RuntimeError``, a ``ValueError`` and a kernel wrapper's refusal of a
launch plan are programming errors: they propagate at once, since
retrying a deterministic bug only hides it and multiplies its cost.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import numpy as np
import torch

from ..kernels.build import KernelLaunchError

log = logging.getLogger("repro_torch.ft")


@dataclasses.dataclass
class StragglerDetector:
    """EWMA step-time monitor. z > threshold for `patience` consecutive
    steps flags a straggler."""
    alpha: float = 0.1
    threshold: float = 3.0
    patience: int = 5
    mean: float = 0.0
    var: float = 0.0
    count: int = 0
    strikes: int = 0
    warmup: int = 3
    _m2: float = 0.0                 # Welford accumulator (warmup only)

    def observe(self, dt: float) -> bool:
        if self.count < self.warmup:  # warmup (kernel build, first calls)
            # Welford over the warmup window seeds BOTH moments, so the
            # first post-warmup z-score has a real baseline spread
            self.count += 1
            delta = dt - self.mean
            self.mean += delta / self.count
            self._m2 += delta * (dt - self.mean)
            if self.count == self.warmup:
                self.var = self._m2 / self.warmup
            return False
        z = (dt - self.mean) / max(np.sqrt(self.var), 1e-6, 0.05 * self.mean)
        self.count += 1
        if z > self.threshold:
            # freeze the baseline on outliers — otherwise a persistent
            # straggler drags the EWMA up and is never flagged
            self.strikes += 1
        else:
            self.strikes = 0
            self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = ((1 - self.alpha) * self.var
                        + self.alpha * (dt - self.mean) ** 2)
        if self.strikes >= self.patience:
            log.warning("straggler detected: step %.3fs vs mean %.3fs",
                        dt, self.mean)
            self.strikes = 0
            return True
        return False


class StepFailure(RuntimeError):
    pass


RETRYABLE_ERRORS: tuple = (
    StepFailure, KernelLaunchError, torch.cuda.OutOfMemoryError,
    *((torch.AcceleratorError,) if hasattr(torch, "AcceleratorError")
      else ()))


def resilient_step(step_fn: Callable, restore_fn: Callable,
                   max_retries: int = 3, nan_guard: bool = True):
    """Wrap a step with restore-and-retry semantics.

    step_fn() -> (state, metrics) raising on device failure; restore_fn()
    -> state rebuilds from the latest checkpoint. A non-finite loss counts
    as a failure.
    """
    def run(state, *args, **kwargs):
        last_err = None
        for attempt in range(max_retries + 1):
            try:
                new_state, metrics = step_fn(state, *args, **kwargs)
                if nan_guard and not np.isfinite(
                        float(metrics.get("loss", 0.0))):
                    raise StepFailure("non-finite loss")
                return new_state, metrics
            except RETRYABLE_ERRORS as e:
                last_err = e
                log.warning("step failed (attempt %d/%d): %s",
                            attempt + 1, max_retries, e)
                state = restore_fn()
        raise StepFailure(f"step failed after {max_retries} retries: "
                          f"{last_err}")
    return run
