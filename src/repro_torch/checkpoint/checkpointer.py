"""Atomic checkpointing in the reference's format (its
``checkpoint.checkpointer``), so a checkpoint that either package writes
restores in the other.

Format: one ``.npz`` per save holding the tree's leaves as host numpy
arrays, keyed by their paths in the reference's spelling
(``pytree.flatten_with_paths``: ``'.params|blocks|attn|wq'``, ...,
``'.step'``), plus ``<file>.meta.json`` (step, data-iterator step, ...).
Save writes to a temp file and renames it, so a crash mid-save never
corrupts the latest checkpoint; ``latest_step`` takes the newest save
whose manifest is complete.

Restore loads numpy arrays and checks every key and shape against a
template tree; a tensor leaf of the template gets its array back as a
tensor on the template leaf's device, any other leaf as the numpy array.
With ``shardings`` (a tree of ``distributed.sharding.NamedSharding`` of
the template's structure, as ``param_shardings`` gives) each tensor is
then placed by its sharding against the CURRENT mesh: copied to the mesh's
device on a one-device or virtual mesh, distributed over the ranks on a
mesh of processes. The format carries no device, which is what lets a
checkpoint saved on one mesh restore onto another.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from ..distributed.sharding import place_tree
from ..pytree import flatten_with_paths, unflatten


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in flatten_with_paths(tree)}


def _unflatten(template, flat: dict[str, np.ndarray]):
    out = []
    for key, leaf in flatten_with_paths(template):
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(np.shape(leaf))}")
        if isinstance(leaf, torch.Tensor):
            arr = torch.from_numpy(arr).to(leaf.device)
        out.append(arr)
    return unflatten(template, out)


def save_pytree(path: str, tree, metadata: Optional[dict] = None):
    """Write ``tree`` to ``path`` (.npz) and ``metadata`` to
    ``path + '.meta.json'``, each through a temp file and a rename."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    tmp_fd, tmp_name = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                        suffix=".tmp.npz")
    os.close(tmp_fd)
    try:
        np.savez(tmp_name, **flat)
        # np.savez may append .npz
        actual = tmp_name if os.path.exists(tmp_name) else tmp_name + ".npz"
        os.replace(actual, path)
        if metadata is not None:
            mtmp = path + ".meta.tmp"
            with open(mtmp, "w") as f:
                json.dump(metadata, f)
            os.replace(mtmp, path + ".meta.json")
    finally:
        for f in (tmp_name, tmp_name + ".npz"):
            if os.path.exists(f):
                os.remove(f)


def load_pytree(path: str, template, shardings=None):
    """The tree saved at ``path``, in ``template``'s structure, each tensor
    placed by ``shardings`` when given; raises ``KeyError`` for a missing
    key, ``ValueError`` for a shape mismatch."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten(template, flat)
    if shardings is not None:
        tree = place_tree(tree, shardings)
    return tree


class Checkpointer:
    """Step-numbered checkpoints with retention and a crash-safe latest."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def save(self, step: int, tree, metadata: Optional[dict] = None):
        meta = dict(metadata or {})
        meta["step"] = int(step)
        save_pytree(self._path(step), tree, meta)
        self._gc()

    def latest_step(self) -> Optional[int]:
        steps = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(".npz"):
                s = int(f[5:13])
                if os.path.exists(self._path(s) + ".meta.json"):
                    steps.append(s)
        return max(steps) if steps else None

    def restore(self, template, step: Optional[int] = None, shardings=None):
        """(tree, manifest) of ``step`` (default the latest), each tensor
        placed by ``shardings`` when given, or (None, None) when there is
        no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        tree = load_pytree(self._path(step), template, shardings)
        with open(self._path(step) + ".meta.json") as f:
            meta = json.load(f)
        return tree, meta

    def _gc(self):
        steps = sorted(s for s in (
            int(f[5:13]) for f in os.listdir(self.dir)
            if f.startswith("ckpt_") and f.endswith(".npz")))
        for s in steps[:-self.keep]:
            for suffix in ("", ".meta.json"):
                p = self._path(s) + suffix
                if os.path.exists(p):
                    os.remove(p)
