"""Number partitioning as bias-free Ising (a classic QUBO family).

Minimize (sum_i a_i s_i)^2 = sum_i a_i^2 + 2 sum_{i<j} a_i a_j s_i s_j
-> H = -sum_{i<j} J_ij s_i s_j with J_ij = -2 a_i a_j (constant dropped).
Perfect partitions reach H = -sum_{i<j} |2 a_i a_j| only if balanced; we
report the residue |sum a_i s_i| as the natural quality metric.
"""
from __future__ import annotations


def number_partitioning(values, max_level: int = 15):
    """Deprecated shim — prefer ``repro_torch.api.Problem.partition``.

    Returns (J, residue_fn). J is normalized through ``Problem``: integer
    DAC levels (exact for integer inputs whose couplings fit +-max_level,
    proportionally quantized otherwise — the chip's own resolution limit),
    materialized to float32 once. Previously J was continuously rescaled to
    the full +-max_level range and re-quantized downstream.
    """
    from ..api import Problem
    p = Problem.partition(values, max_level)
    return p.J, p.partition_residue
