"""Global-norm gradient clipping (the reference's ``optim.clipping``)."""
from __future__ import annotations

import torch

from ..pytree import leaves, tree_map


def global_norm(tree):
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    added one by one in the reference's leaf order."""
    total = 0
    for leaf in leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float = 1.0):
    """(grads scaled so their global norm is at most ``max_norm``, the
    global norm before scaling)."""
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    return tree_map(lambda x: x * scale, grads), g
