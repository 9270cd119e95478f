"""Trees of tensors as the reference's ``jax.tree_util`` sees them.

A tree is nested dicts, lists, tuples and dataclasses (``TrainState``)
whose leaves are tensors, arrays or scalars. Leaves come in the
reference's order: dict keys sorted, dataclass fields in declaration
order, sequences by index. A leaf's path is spelled as the reference's
checkpointer spells it: a dict key as itself, a dataclass field as
``.name``, a sequence index as its number, joined by ``|`` (so
``'.params|blocks|attn|wq'``, ``'.step'``).

``eval_shape`` is ``jax.eval_shape``'s counterpart: a tree's shapes and
dtypes without its storage, as meta tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

SEP = "|"


def _children(tree):
    """[(path part, child)] of a node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [("." + f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def flatten_with_paths(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """[(path, leaf)] in the reference's leaf order."""
    kids = _children(tree)
    if kids is None:
        return [(SEP.join(prefix), tree)]
    out = []
    for part, child in kids:
        out.extend(flatten_with_paths(child, prefix + (part,)))
    return out


def leaves(tree) -> list:
    """The leaves in the reference's order (``jax.tree.leaves``)."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(template, new_leaves):
    """``template``'s structure with ``new_leaves`` (in leaf order)."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            new = {k: build(node[k]) for k in sorted(node)}
            return {k: new[k] for k in node}
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: build(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)
    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of trees of one structure (``jax.tree.map``);
    dicts keep the first tree's key order, dataclasses are rebuilt with
    ``dataclasses.replace``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def eval_shape(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``'s tree with every tensor leaf a meta tensor
    of its shape and dtype. ``fn`` runs under ``FakeTensorMode``: it draws
    nothing and allocates nothing, so a full-size model's ``init`` (which
    keeps its CPU generator) takes seconds and leaves host memory flat."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        out = fn(*args, **kwargs)
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta")
                    if isinstance(t, torch.Tensor) else t, out)
