"""AdamW over trees of tensors (the reference's ``optim.adamw``).

Plain functions, written op by op in the reference's order:
``m / bc1 / (sqrt(v / bc2) + eps)``, then ``-lr * (u + wd * p)``, then
``(p + u)`` cast to the parameter's dtype. ``torch.optim.AdamW`` is not
used: its foreach and fused paths round in another order
(``sqrt(v) / sqrt(bc2) + eps``, the decay applied before the step).
Nothing is updated in place: every function returns new tensors, so a
caller that keeps the old state (a retry after a failed step) still has
it.
"""
from __future__ import annotations

import dataclasses

import torch

from ..pytree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def init_opt_state(params):
    """Zero moments shaped like ``params`` and a 0-d int32 step, on the
    parameters' device."""
    device = leaves(params)[0].device
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw(grads, opt_state, params, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (updates, new_opt_state). ``lr_scale``: the schedule's
    multiplier (a float or a 0-d tensor)."""
    step = opt_state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, opt_state["m"], grads)
    v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                 opt_state["v"], grads)
    t = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)
    lr = cfg.lr * lr_scale

    def upd(m, v, p):
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        return -lr * (u + cfg.weight_decay * p)

    updates = tree_map(upd, m, v, params)
    return updates, {"m": m, "v": v, "step": step}


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
