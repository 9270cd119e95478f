"""repro_torch.physics — the continuous-time analog device-dynamics tier.

What the paper's single die cannot answer — how landscape perturbation's
success-rate advantage survives coupling mismatch, leakage spread and
refresh jitter — this package sweeps across thousands of virtual chips in
one batched call: BRIM-style coupled nodal ODEs (``dynamics``) driven by
the discrete engine's own refresh/perturbation schedule, over
variation-model parameter draws (``variation``). Registered behind the
uniform solver surface as ``ode-jax`` (``repro_torch.api``), the
reference's name.
"""
from .dynamics import (DEFAULT_PHYSICS, DISCRETE_LIMIT, FleetResult,
                       PhysicsParams, dispatch_count, fleet_anneal,
                       reset_dispatch_count)
from .variation import (NOMINAL_VARIATION, ChipVariation, VariationModel,
                        fingerprint)

__all__ = [
    "DEFAULT_PHYSICS", "DISCRETE_LIMIT", "FleetResult", "PhysicsParams",
    "dispatch_count", "fleet_anneal", "reset_dispatch_count",
    "NOMINAL_VARIATION", "ChipVariation", "VariationModel", "fingerprint",
]
