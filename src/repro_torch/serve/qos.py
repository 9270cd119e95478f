"""``repro_torch.serve.qos`` — priority classes layered on deadline→budget.

The deadline→budget mapping (``api/budget.deadline_to_budget``) decides
how much search effort a request gets; QoS classes decide *whose*
requests survive overload. Three classes, highest priority first:

* ``interactive`` — user-facing, latency-sensitive. Last to degrade,
  last to shed: its thresholds are scaled UP (it tolerates a deeper
  queue before the admission ladder touches it).
* ``normal`` — the default. Factor 1.0 everywhere, so a service or
  fleet that never mentions QoS behaves exactly as before this module
  existed.
* ``batch`` — throughput work with no latency contract. First to
  degrade, first to shed: its thresholds are scaled DOWN, so under
  overload batch work absorbs the degradation and shedding before a
  single normal or interactive request is touched.

Mechanically a class is two multipliers on the admission ladder's
pending-depth thresholds (``degrade_pending`` / ``shed_pending`` in
``ResiliencePolicy``): request class ``c`` starts degrading at
``degrade_pending * c.degrade_factor`` and sheds at
``shed_pending * c.shed_factor``. With the default factors and a shed
threshold of 64, batch sheds at 32 while interactive holds to 128 —
a strict priority ordering without a separate queue per class.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class QoSClass:
    """One priority class. ``rank`` orders classes (lower = more
    important); the factors scale the degrade/shed pending thresholds."""
    name: str
    rank: int
    degrade_factor: float
    shed_factor: float


QOS_CLASSES: Mapping[str, QoSClass] = {
    "interactive": QoSClass("interactive", rank=0,
                            degrade_factor=1.5, shed_factor=2.0),
    "normal": QoSClass("normal", rank=1,
                       degrade_factor=1.0, shed_factor=1.0),
    "batch": QoSClass("batch", rank=2,
                      degrade_factor=0.5, shed_factor=0.5),
}

DEFAULT_QOS = "normal"


def resolve_qos(name: str) -> QoSClass:
    try:
        return QOS_CLASSES[name]
    except KeyError:
        raise ValueError(
            f"unknown QoS class {name!r}; one of {sorted(QOS_CLASSES)}"
        ) from None
