"""Partition-spec rules for every parameter / batch / cache tree (the
reference's ``distributed.sharding``).

Philosophy: megatron-style tensor parallelism over the 'model' axis,
batch-like axes over ('pod', 'data'). Rules are path + shape based and
left-padded with None for stacked (scan) leading axes, so the same rule
covers a single block and an (L, ...) stack.

A spec is the reference's ``PartitionSpec`` spelled as a tuple, one entry
per dimension: None (replicated), an axis name, or a tuple of axis names
(sharded over their product, major to minor). Entries are normalised as
``PartitionSpec`` normalises them (a one-name tuple is the name, an empty
one None), so ``tuple(reference_spec) == port_spec`` case for case. The
rules are pure functions: a ``mesh`` argument is anything with a ``shape``
mapping of axis name to size (a :class:`Mesh`, or a plain object holding a
dict), so they run without devices or a process group.

A :class:`Mesh` names its axes and their sizes and holds one
``torch_device``, in the style of ``distributed.fabric.FabricMesh``. Two
kinds:

* a virtual mesh: every rank lives in this process on ``torch_device``,
  the counterpart of the reference's XLA forced host devices. Sharding
  constraints are the identity on it, and code that needs the ranks'
  partials (MoE's F slices) computes them one after another and sums them
  in rank order. ``virtual_mesh`` and ``launch.mesh.make_host_mesh`` (the
  card's (1, 1)) build these.
* a mesh of processes: ``device_mesh`` is a torch ``DeviceMesh`` over the
  ranks of an initialised ``torch.distributed`` world, with one dimension
  per ``device_axes`` entry ('pod' and 'data' together are one), and
  tensors on it are DTensors. ``mesh_of_processes`` builds these, for
  ``launch.mesh.make_production_mesh`` and ``distributed.elastic.remesh``
  over a world.

``activate_mesh(mesh)`` makes a mesh ambient (``ACTIVE_MESH``) for
``models.common``'s ``active_mesh`` / ``logical`` / ``shard``.

``NamedSharding`` pairs a mesh with a spec and names the torch placements
(``Shard(i)`` / ``Replicate()`` per ``DeviceMesh`` dimension) that a
``DeviceMesh`` takes.
The reference's ``shard_map`` shim is JAX-only; the port's counterpart is
the virtual-slice sum in ``models.moe``.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..pytree import SEP, flatten_with_paths, leaves, unflatten

#: the ambient mesh, set by ``activate_mesh`` (a context variable, so each
#: thread and task sees its own)
ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_active_mesh", default=None)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes of ``sizes`` ranks over ``torch_device``; ``device_mesh``
    is set when the ranks are processes of a ``torch.distributed`` world."""
    axis_names: tuple
    sizes: tuple
    torch_device: torch.device
    device_mesh: Optional[Any] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")
        if any(int(n) < 1 for n in self.sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {self.sizes}")

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def device_axes(self) -> tuple:
        """The axes each dimension of ``device_mesh`` spans
        (``device_axes``)."""
        return device_axes(self.axis_names)


#: the batch-like axes, in mesh order
BATCH_AXES = ("pod", "data")


def device_axes(axis_names) -> tuple:
    """The axes each dimension of a mesh of processes' ``DeviceMesh``
    spans, major to minor: the batch-like axes present are one dimension,
    every other axis is its own. The reference's partition treats 'pod' as
    more data (a batch is split over ``('pod', 'data')`` and nothing is
    split over one of them alone), so one dimension is the same layout;
    and it keeps DTensor's planning on two dimensions, where on three it
    searches a graph of layouts for every new pair of placements."""
    batch = tuple(a for a in axis_names if a in BATCH_AXES)
    out = []
    for a in axis_names:
        if a not in BATCH_AXES:
            out.append((a,))
        elif a == batch[0]:
            out.append(batch)
    return tuple(out)


def mesh_of_processes(axes, shape, torch_device, ranks) -> Mesh:
    """A :class:`Mesh` of ``shape`` over the ranks ``ranks`` (in mesh order)
    of an initialised ``torch.distributed`` world, with a ``DeviceMesh`` of
    one dimension per ``device_axes`` entry (named by its axes joined with
    '_')."""
    from torch.distributed.device_mesh import DeviceMesh
    axes, shape = tuple(axes), tuple(int(n) for n in shape)
    size = dict(zip(axes, shape))
    dims = device_axes(axes)
    dev = resolve_device(torch_device)
    grid = torch.as_tensor(np.asarray(ranks, dtype=np.int64).reshape(
        [math.prod(size[a] for a in g) for g in dims]))
    return Mesh(axes, shape, dev, DeviceMesh(
        dev.type, grid, mesh_dim_names=tuple("_".join(g) for g in dims)))


def virtual_mesh(shape, axes, torch_device: str | torch.device = "cuda"
                 ) -> Mesh:
    """A mesh of ``shape`` with ``axes`` whose ranks all live in this process
    on ``torch_device``: the one-device counterpart of the reference's
    forced host devices."""
    return Mesh(tuple(axes), tuple(int(n) for n in shape),
                resolve_device(torch_device))


@contextlib.contextmanager
def activate_mesh(mesh: Mesh):
    """Within the block, ``mesh`` is the ambient mesh. On a mesh of
    processes the block also runs under DTensor's
    ``implicit_replication``: a plain tensor every rank makes alike (a
    model's mask, a schedule table) counts as replicated where it meets a
    DTensor."""
    token = ACTIVE_MESH.set(mesh)
    try:
        if mesh.device_mesh is None:
            yield mesh
        else:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication():
                yield mesh
    finally:
        ACTIVE_MESH.reset(token)


def spec(*entries) -> tuple:
    """A spec with ``PartitionSpec``'s normalisation of tuple entries."""
    out = []
    for e in entries:
        if isinstance(e, tuple):
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    return tuple(out)


def batch_axes(mesh) -> tuple:
    if mesh is None:
        return ()
    return tuple(a for a in BATCH_AXES if a in mesh.shape)


def data_size(mesh) -> int:
    return math.prod(int(mesh.shape[a]) for a in batch_axes(mesh))


def tp_size(mesh) -> int:
    return int(mesh.shape.get("model", 1))


def _pad(base: tuple, ndim: int) -> tuple:
    return spec(*((None,) * (ndim - len(base)) + base))


def fit_spec(s: tuple, shape: tuple, mesh) -> tuple:
    """Drop sharded axes whose dimension isn't divisible by the axis size
    (granite's vocab 49155 and hubert's 504 otherwise reject the
    vocab-parallel spec)."""
    out = []
    for i, entry in enumerate(s):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = math.prod(int(mesh.shape[a]) for a in axes)
        out.append(entry if size and shape[i] % size == 0 else None)
    return spec(*out)


def param_spec(path: tuple, shape: tuple, cfg: ModelConfig, tp: int
               ) -> tuple:
    """Spec for one parameter leaf of ``shape``; ``path`` is the tuple of
    dict keys."""
    name = path[-1]
    nd = len(shape)

    # --- embeddings / head ------------------------------------------------
    if name == "embed":
        return spec("model", None)                    # vocab-parallel
    if name == "head":
        return spec(None, "model")

    # --- MoE (leaf rank 3 base: (E, D, F) / (E, F, D)): the F axis over
    # 'model', the layout of models.moe's slices summed after the combine
    if cfg.n_experts and "ffn" in path and name in ("wi", "wg", "wo"):
        if name in ("wi", "wg"):
            return _pad((None, None, "model"), nd)
        return _pad((None, "model", None), nd)
    if name == "router":
        return _pad((None, None), nd)

    # --- attention (head-major: wq (D,H,dh), wo (H,dh,D)) -------------------
    if name == "wq":
        return _pad((None, "model", None), nd)        # shard the head axis
    if name in ("wk", "wv", "bk", "bv"):
        return _pad((), nd)                           # KV replicated (GQA)
    if name == "bq":
        return _pad(("model", None), nd)
    if name == "wo" and "attn" in path:
        return _pad(("model", None, None), nd)        # heads row-parallel

    # --- dense / recurrent mlps ---------------------------------------------
    if name in ("wi", "wg", "in_proj", "Wr", "Wk", "Wv", "Wg", "conv_w",
                "wA"):
        if "cmix" in path and name == "Wv":           # (F, D) row-parallel
            return _pad(("model", None), nd)
        return _pad((None, "model"), nd)              # column-parallel
    if name in ("wo", "out_proj", "Wo"):
        return _pad(("model", None), nd)              # row-parallel
    if name == "wB":                                   # rwkv decay lora out
        return _pad((None, None), nd)
    if name == "w" and "pos_conv" in path:
        return _pad((None, None, "model"), nd)

    # everything else (norms, scalars, biases, mus) replicated
    return _pad((), nd)


def batch_spec(mesh, ndim: int, batch_size: int) -> tuple:
    """Token-like arrays: leading batch dim over ('pod','data') if
    divisible."""
    ax = batch_axes(mesh)
    if ax and batch_size % data_size(mesh) == 0:
        return spec(ax, *([None] * (ndim - 1)))
    return spec(*([None] * ndim))


def cache_spec(path: tuple, shape: tuple, mesh, cfg: ModelConfig,
               batch: int) -> tuple:
    """KV caches / recurrent states for decode, for a leaf of ``shape``."""
    name = path[-1]
    nd = len(shape)
    ax = batch_axes(mesh)
    b_ok = ax and batch % data_size(mesh) == 0
    tp = tp_size(mesh)
    bspec = ax if b_ok else None

    if name in ("k", "v"):                   # (L|G, B, S, Hkv, Dh)
        if b_ok:
            return spec(None, bspec, "model", None, None)
        # batch too small (long-context): shard the sequence everywhere
        return spec(None, None, tuple(ax) + ("model",), None, None)
    if name in ("h", "S"):       # (L, B, H, dh, ds) / (L, B, H, N, N)
        h_ax = "model" if shape[2] % tp == 0 else None
        return spec(None, bspec, h_ax, None, None)
    if name == "conv":                       # (L, B, K, C)
        return spec(None, bspec, None,
                    "model" if shape[3] % tp == 0 else None)
    if name in ("tmix_x", "cmix_x"):         # (L, B, 1, D)
        return spec(None, bspec, None, None)
    if name == "pos":
        return ()
    return spec(*([None] * nd))


def placements(s: tuple, axes: tuple) -> list:
    """The torch placements of spec ``s`` on a mesh of processes whose
    ``DeviceMesh`` dimensions span ``axes`` (``Mesh.device_axes``):
    ``Shard(i)`` on each dimension whose axes dimension i's entry names,
    ``Replicate()`` on the others. A spec that names some but not all of
    a dimension's axes has no placement."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for i, entry in enumerate(s):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                dim_of[a] = i
    out = []
    for g in axes:
        dims = {dim_of.get(a) for a in g}
        if len(dims) > 1:
            raise ValueError(f"spec {s} splits the mesh dimension over {g}")
        d = dims.pop()
        out.append(Replicate() if d is None else Shard(d))
    return out


class NamedSharding:
    """A :class:`Mesh` and a spec (the reference's
    ``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh, spec: tuple):
        self.mesh, self.spec = mesh, tuple(spec)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and self.spec == other.spec)

    def __repr__(self):
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec})"

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh.device_axes)

    def place(self, t):
        """``t`` (a whole tensor) laid out on the mesh: copied to its device
        on a virtual mesh, distributed over its ranks on a mesh of
        processes."""
        t = t.to(self.mesh.torch_device)
        if self.mesh.device_mesh is None:
            return t
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh.device_mesh, self.placements)


def _shardings(tree, rule):
    """``tree``'s structure with ``rule(path keys, shape)`` at every leaf."""
    return unflatten(tree, [rule(tuple(path.split(SEP)),
                                 tuple(np.shape(leaf)))
                            for path, leaf in flatten_with_paths(tree)])


def param_shardings(mesh, cfg: ModelConfig, params_tree):
    """A ``NamedSharding`` for every leaf of ``params_tree`` (a parameter
    tree, or a train state: the moments follow their parameters' rule and
    the step is replicated)."""
    tp = tp_size(mesh)
    return _shardings(params_tree, lambda keys, shape: NamedSharding(
        mesh, fit_spec(param_spec(keys, shape, cfg, tp), shape, mesh)))


def cache_shardings(mesh, cfg: ModelConfig, cache_tree, batch: int):
    return _shardings(cache_tree, lambda keys, shape: NamedSharding(
        mesh, fit_spec(cache_spec(keys, shape, mesh, cfg, batch), shape,
                       mesh)))


def place_tree(tree, shardings):
    """``tree`` with every tensor leaf placed by its sharding in the tree of
    the same structure ``shardings``."""
    return unflatten(tree, [s.place(t) if isinstance(t, torch.Tensor) else t
                            for t, s in zip(leaves(tree), leaves(shardings))])
