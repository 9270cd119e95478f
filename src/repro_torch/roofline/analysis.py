"""Roofline terms of one step, from ``op_cost.analyze``'s count (the
reference's ``roofline.analysis``).

Three terms per step, all in seconds:

    compute    = FLOPs / peak FLOP/s
    memory     = bytes / HBM bytes/s
    collective = sum(collective bytes) / link bytes/s

where each collective is charged the larger of its operand and its result
(an all-gather its gathered result), as the reference's ``hlo_cost``
charges it.

The count comes from a ``Cost`` (``op_cost.analyze`` of one run) in place
of the reference's compiled executable. The reference also kept XLA's
builtin ``cost_analysis`` figures as ``xla_*_unscaled``; torch eager has
no such second count, so those keys are gone.

Hardware model: one NVIDIA H100 SXM, NVIDIA's published dense figures:
989 TFLOP/s bf16, 3.35 TB/s HBM, NVLink 450 GB/s a direction (the
reference's ``ici_bw`` field holds it), 80 GiB. Each collective's per-device
payload is charged against one link; ring algorithms move ~2x bytes for
all-reduce, which is folded in.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..pytree import SEP, flatten_with_paths
from .op_cost import Cost


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12          # bf16 dense, per card
    hbm_bw: float = 3.35e12             # bytes/s per card
    ici_bw: float = 450e9               # NVLink bytes/s, one direction
    hbm_bytes: float = 80 * 2**30       # HBM capacity


def collective_bytes(cost: Cost) -> dict[str, int]:
    """Per-collective-kind summed bytes (per device), each collective
    charged max(operand, result): the reference's ``hlo_cost.analyze``
    ``collectives``, which its ``roofline_report`` reads, from the op
    record."""
    return {k: int(v) for k, v in cost.collectives.items()}


def roofline_report(cost: Cost, hw: HW = HW(), *, chips: int | None = None,
                    model_flops_total: float | None = None) -> dict:
    """The three terms of one step from its ``Cost``, the dominant one and
    the bound; with ``model_flops_total`` and ``chips``, the useful share
    of the counted FLOPs and the roofline fraction."""
    flops = float(cost.flops)
    bytes_accessed = float(cost.bytes)
    coll = collective_bytes(cost)
    # all-reduce moves ~2x its payload in a ring (reduce-scatter+all-gather)
    coll_bytes = sum(v * (2 if k == "all-reduce" else 1)
                     for k, v in coll.items())
    t_compute = flops / hw.peak_flops
    t_memory = bytes_accessed / hw.hbm_bw
    t_coll = coll_bytes / hw.ici_bw
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    report = {
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_accessed,
        "collective_bytes_per_device": coll_bytes,
        "collective_breakdown": coll,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_step_s": max(t_compute, t_memory, t_coll),
    }
    if model_flops_total is not None and chips:
        useful_per_dev = model_flops_total / chips
        report["model_flops_total"] = model_flops_total
        report["useful_flops_ratio"] = (useful_per_dev / flops) if flops else 0.0
        # roofline fraction: useful work per device over the bound step time
        denom = max(t_compute, t_memory, t_coll)
        report["roofline_fraction"] = (
            (useful_per_dev / hw.peak_flops) / denom if denom > 0 else 0.0)
    return report


# --------------------------------------------------------------------------
# MODEL_FLOPS (the 6ND / 2ND yardstick)
# --------------------------------------------------------------------------

def count_params(params_tree) -> int:
    return int(sum(np.prod(tuple(leaf.shape))
                   for _, leaf in flatten_with_paths(params_tree)))


def active_params(cfg, params_tree) -> float:
    """For MoE: experts contribute top_k/n_experts of their weights."""
    total = 0.0
    for path, leaf in flatten_with_paths(params_tree):
        keys = path.split(SEP)
        n = float(np.prod(tuple(leaf.shape)))
        if cfg.n_experts and "ffn" in keys and any(
                k in ("wi", "wg", "wo") for k in keys):
            n *= cfg.top_k / cfg.n_experts
        total += n
    return total


def model_flops(cfg, shape, params_tree) -> float:
    """Paper-standard useful FLOPs for the whole step (all chips).

    train:   6 * N_active * tokens
    prefill: 2 * N_active * tokens
    decode:  2 * N_active * batch   (one token per sequence)
    """
    n_active = active_params(cfg, params_tree)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch
