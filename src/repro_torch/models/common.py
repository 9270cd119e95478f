"""Shared building blocks for the model zoo: the ambient mesh and its
logical axes, norms, activations, RoPE, inits (the reference's
``models.common``).

Parameters are plain nested dicts of tensors. Every init function takes an
explicit CPU ``torch.Generator`` and draws on the CPU; a family's
``init_params`` copies each drawn layer to its ``torch_device``. torch's
CPU and CUDA generators give different numbers for one seed, so drawing
on the CPU is what makes one seed give the same weights, bit for bit, on
every device (as the reference's ``PRNGKey`` does on every backend).
Dtype policy: params fp32, activations cast to ``config.dtype`` (bf16 by
default), norms computed in fp32.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..distributed.sharding import (ACTIVE_MESH, BATCH_AXES, batch_axes,
                                    data_size, placements, spec)


# --------------------------------------------------------------------------
# Sharding helpers: logical axes resolved against the active mesh.
# --------------------------------------------------------------------------

MODEL_AXIS = "model"


def active_mesh():
    """The ambient mesh (``distributed.sharding.ACTIVE_MESH``, set by
    ``activate_mesh``), or None."""
    mesh = ACTIVE_MESH.get()
    return mesh if (mesh is not None and mesh.axis_names) else None


def _active_axis_names():
    mesh = active_mesh()
    return tuple(mesh.axis_names) if mesh is not None else ()


def logical(*axes) -> tuple:
    """Logical axis names as a spec (a tuple, one entry per dimension)
    against the ACTIVE mesh.

    'batch' -> every present axis of BATCH_AXES ('data' alone when it is
    the only one, as the reference's ``PartitionSpec`` spells it), 'model'
    -> MODEL_AXIS if present, None stays None. Unknown names pass through.
    """
    present = _active_axis_names()
    out = []
    for a in axes:
        if a == "batch":
            ax = tuple(x for x in BATCH_AXES if x in present)
            out.append(ax if len(ax) > 1 else (ax[0] if ax else None))
        elif a == "model":
            out.append(MODEL_AXIS if MODEL_AXIS in present else None)
        else:
            out.append(a)
    return tuple(out)


def process_mesh():
    """The active mesh when its ranks are processes (tensors on it are
    DTensors), else None."""
    mesh = active_mesh()
    return mesh if mesh is not None and mesh.device_mesh is not None else None


def shard(x, *axes):
    """``x`` laid out as ``logical(*axes)`` on the active mesh (a leading
    'batch' as ``batch_rows`` lays out x's rows).

    The identity when no mesh is active and on a virtual mesh (all ranks
    on one device), as a sharding constraint is on a one-device mesh in
    XLA. On a mesh whose ranks are processes, ``x`` is redistributed to
    the spec's placements; so is its gradient, as
    ``with_sharding_constraint`` constrains the cotangent too (a gradient
    that arrives partial is reduced here, not carried further back)."""
    mesh = process_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError("shard: on a mesh of processes x must be a DTensor, "
                        f"got {type(x).__name__}")
    dm = mesh.device_mesh
    s = logical(*axes)
    if axes and axes[0] == "batch":
        s = (batch_rows(x.shape[0], mesh),) + s[1:]
    want = placements(s, mesh.device_axes)
    y = x.redistribute(dm, want)
    if y.requires_grad:
        y.register_hook(lambda g: g.redistribute(dm, want))
    return y


def batch_rows(n: int, mesh):
    """The spec entry of ``n`` rows on ``mesh``: the batch axes where they
    divide the rows, else None. One sequence decoding is whole on every
    rank, as the reference's ``batch_spec`` and ``cache_spec`` lay out its
    tokens and state; split, a rank would hold it and the others nothing,
    and each use gather it back."""
    if mesh is None or n % data_size(mesh):
        return None
    return logical("batch")[0]


def replicated(x):
    """``x``, a plain tensor every rank makes alike (positions, a table),
    as a replicated DTensor on a mesh of processes; else ``x`` itself."""
    mesh = process_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    dm = mesh.device_mesh
    return DTensor.from_local(x, dm, [Replicate()] * dm.ndim,
                              run_check=False)


def local_shard(t, mesh, s: tuple, *, split=True):
    """The DTensor ``t`` laid out as spec ``s`` on ``mesh`` (a mesh of
    processes), as this rank's local tensor: the entry to code that runs
    per rank, as the body of the reference's ``shard_map``. The local
    tensor's gradient keeps ``t``'s shards. Over a mesh axis ``s``
    replicates ``t`` on, it is partial where the ranks split the work
    (each adds its share, as ``shard_map`` transposes an input it does not
    map) and replicated where they compute the same: ``split`` is True
    (every such axis splits), False (none does) or the axes that do.
    With ``mesh`` None (no mesh of processes) ``t`` itself, as are the
    other per-rank helpers' results: the per-rank code is then the whole
    computation."""
    from torch.distributed.tensor import DTensor, Partial
    if mesh is None:
        return t
    if not isinstance(t, DTensor):
        raise TypeError("on a mesh of processes the per-rank code takes "
                        f"DTensors, got {type(t).__name__}")
    want = placements(s, mesh.device_axes)
    return t.redistribute(mesh.device_mesh, want).to_local(grad_placements=[
        Partial() if not p.is_shard() and (
            split is True or (split and _spans(g, split))) else p
        for g, p in zip(mesh.device_axes, want)])


def _spans(g: tuple, axes) -> bool:
    """Whether ``axes`` name every axis of the mesh dimension ``g`` (a
    dimension is reduced or split whole, never over part of its axes)."""
    hit = [a in axes for a in g]
    if any(hit) and not all(hit):
        raise ValueError(f"{tuple(axes)} names part of the mesh dimension "
                         f"over {g}")
    return all(hit)


def psum(t, mesh, axes: tuple, op: str = "sum", *, split: bool = False):
    """This rank's ``t`` reduced over the mesh ``axes`` (an all-reduce, the
    reference's ``psum``); the ranks of the other axes hold their own.
    Where the ranks use the sum for their own shares of the work
    (``split``), its gradient is their sum as well."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if mesh is None or not axes:
        return t
    pl = [Partial(op) if _spans(g, axes) else Replicate()
          for g in mesh.device_axes]
    return DTensor.from_local(t, mesh.device_mesh, pl, run_check=False
                              ).redistribute(mesh.device_mesh, [
                                  Replicate()] * len(pl)).to_local(
        grad_placements=[p if split else Replicate() for p in pl])


def psum_scatter(t, mesh, axes: tuple, dim: int):
    """This rank's ``t`` summed over the mesh ``axes``, of which this rank
    keeps its share of dimension ``dim`` (a reduce-scatter, the
    reference's ``psum_scatter``); the gradient is all-gathered."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if mesh is None or not axes:
        return t
    spans = [_spans(g, axes) for g in mesh.device_axes]
    return DTensor.from_local(
        t, mesh.device_mesh, [Partial() if s else Replicate() for s in spans],
        run_check=False).redistribute(mesh.device_mesh, [
            Shard(dim) if s else Replicate() for s in spans]).to_local()


def gather(t, mesh, s: tuple, dim: int, shape, *, split=True):
    """This rank's ``t``, laid out as spec ``s`` (which splits dimension
    ``dim`` over 'model') in a tensor of global ``shape``, whole along
    ``dim`` on every rank of 'model' (an all-gather). Where the ranks use
    the whole for their own shares of the work (``split``), the gradient
    is their sum, of which each keeps its own slice (a reduce-scatter);
    else each keeps its slice of its own."""
    whole = list(s)
    whole[dim] = None
    return local_shard(from_local(t, mesh, s, shape), mesh, spec(*whole),
                       split=(MODEL_AXIS,) if split else False)


def whole(t, mesh, split: tuple = ()):
    """The DTensor parameter ``t`` whole on this rank, for per-rank code
    that uses all of it. Its gradient is summed over the mesh axes in
    ``split``, whose ranks use it on their own tokens (batch axes) or for
    their own parts of the work (model axes). A parameter split over
    'model' is gathered, and its gradient reduce-scattered back before the
    batch axes reduce it, so no rank reduces more than its own slice
    there."""
    if mesh is None:
        return t
    s = spec(*(shard_axes(t, mesh, i) for i in range(t.dim())))
    dims = [i for i, e in enumerate(s) if e is not None]
    if not dims:
        return local_shard(t, mesh, s, split=tuple(split))
    i, = dims
    return gather(local_shard(t, mesh, s, split=tuple(
        a for a in split if a in BATCH_AXES)), mesh, s, i, t.shape,
        split=MODEL_AXIS in split)


def model_axes(mesh, *dims: int) -> tuple:
    """('model',) where the mesh has that axis and its size divides every
    one of ``dims``, else () (also with ``mesh`` None)."""
    if mesh is None or MODEL_AXIS not in mesh.shape:
        return ()
    tp = mesh.shape[MODEL_AXIS]
    return (MODEL_AXIS,) if all(n % tp == 0 for n in dims) else ()


def own_range(n: int, mesh) -> tuple:
    """This rank's [lo, hi) of ``n`` heads split over 'model' as DTensor
    splits an uneven dimension: chunks of ceil(n / tp), the last ones
    short or empty (40 heads on 16 ranks: 3 on each of ranks 0-12, 1 on
    rank 13, none on 14 and 15). All of them with ``mesh`` None."""
    return model_ranges(n, mesh)(model_rank(mesh))


def own_part(t, mesh, dim: int, lo: int, hi: int, split: tuple):
    """Entries [lo, hi) of dimension ``dim`` of the parameter ``t``, for
    this rank's share of the work, which the ranks of the mesh axes
    ``split`` divide: ``t`` itself where that is all of it (always with
    ``mesh`` None); where they are this rank's even share of ``dim`` over
    'model', ``t`` split so (its gradient gathered back); else sliced from
    ``whole(t, mesh, split)``."""
    n = t.shape[dim]
    if MODEL_AXIS in split and n % mesh.shape[MODEL_AXIS] == 0:
        c = n // mesh.shape[MODEL_AXIS]
        if (lo, hi) == (mesh.device_mesh.get_local_rank(MODEL_AXIS) * c,
                        lo + c):
            s = [None] * t.dim()
            s[dim] = MODEL_AXIS
            return local_shard(t, mesh, spec(*s), split=tuple(
                a for a in split if a in BATCH_AXES))
    w = whole(t, mesh, split)
    return w if (lo, hi) == (0, n) else w.narrow(dim, lo, hi - lo)


def from_local(t, mesh, s: tuple, shape):
    """This rank's result ``t`` as the DTensor of global ``shape``
    (contiguous) laid out as spec ``s``: the exit of per-rank code."""
    from torch.distributed.tensor import DTensor
    if mesh is None:
        return t
    shape = tuple(shape)
    return DTensor.from_local(
        t, mesh.device_mesh, placements(s, mesh.device_axes), run_check=False,
        shape=shape, stride=tuple(math.prod(shape[i + 1:])
                                  for i in range(len(shape))))


def model_rank(mesh) -> int:
    """This rank's place on 'model' (0 with ``mesh`` None)."""
    if mesh is None or MODEL_AXIS not in mesh.shape:
        return 0
    return mesh.device_mesh.get_local_rank(MODEL_AXIS)


def _chunk(n: int, parts: int, i: int) -> tuple:
    """The [lo, hi) of chunk ``i`` of ``n`` entries split in ``parts`` as
    DTensor splits them: ceil(n / parts) each, the last ones short or
    empty."""
    c = -(-n // parts)
    return min(i * c, n), min(i * c + c, n)


def model_ranges(n: int, mesh, split: bool = True):
    """rank -> its [lo, hi) of ``n`` entries that 'model' splits
    (``own_range``'s chunks of ceil(n / tp)); every rank's is all of them
    with ``mesh`` None, or where ``split`` is false."""
    if mesh is None or not split:
        return lambda r: (0, n)
    return functools.partial(_chunk, n, mesh.shape.get(MODEL_AXIS, 1))


def recut(t, mesh, held, want) -> list:
    """Pieces of the last dimension of this rank's ``t`` after moving them
    between the ranks of 'model': rank r's ``t`` holds the columns
    ``held(r)`` (its [lo, hi) of a dimension they split, or all of it on
    every rank), and gets the columns of each range of ``want(r)``, one
    tensor a range. Only the columns that change rank move, in one
    all-to-all (the collective-permutes XLA compiles where the reference
    slices a split dimension off its split); none moves with ``mesh``
    None, where the pieces are slices of ``t``."""
    g = 1 if mesh is None else mesh.shape.get(MODEL_AXIS, 1)
    r = model_rank(mesh)

    def pieces(s: int, j: int) -> list:
        """(range of j's, lo, hi): the columns rank s gives rank j."""
        a, b = held(s)
        if s != j and held(j) == (a, b):
            return []                   # j holds them too
        return [(i, max(a, lo), min(b, hi)) for i, (lo, hi)
                in enumerate(want(j)) if min(b, hi) > max(a, lo)]
    a = held(r)[0]
    out = [[] for _ in want(r)]
    for i, lo, hi in pieces(r, r):
        out[i].append((lo, t[..., lo - a:hi - a]))
    if any(pieces(s, j) for s in range(g) for j in range(g) if s != j):
        from torch.distributed._functional_collectives import (
            all_to_all_single_autograd as all_to_all_single)
        local = t.movedim(-1, 0)
        sent = [[local[lo - a:hi - a] for _, lo, hi in pieces(r, j)]
                if j != r else [] for j in range(g)]
        inp = torch.cat([p for ps in sent for p in ps] or [local[:0]])
        theirs = [pieces(s, r) if s != r else [] for s in range(g)]
        got = [sum(hi - lo for _, lo, hi in ps) for ps in theirs]
        recv = all_to_all_single(inp, got, [sum(p.shape[0] for p in ps)
                                            for ps in sent],
                                 (mesh.device_mesh,
                                  mesh.device_mesh.mesh_dim_names.index(
                                      MODEL_AXIS)))
        for ps, chunk in zip(theirs, torch.split(recv, got)):
            for (i, lo, hi), p in zip(ps, torch.split(
                    chunk, [hi - lo for _, lo, hi in ps])):
                out[i].append((lo, p.movedim(0, -1)))
        # every rank's result depends on what it received, if nothing, so
        # that every rank runs the all-to-all's backward
        out[0].append((-1, recv.movedim(0, -1)[..., :0]))
    return [t[..., :0] if not parts else parts[0][1] if len(parts) == 1
            else torch.cat([p for _, p in sorted(parts, key=lambda x: x[0])],
                           dim=-1) for parts in out]


@functools.lru_cache(maxsize=None)
def _crossing(n: int, sizes: tuple, me: tuple) -> tuple:
    """What the rank at coordinates ``me`` of two mesh dimensions of
    ``sizes`` sends and gets when a last dimension of ``n`` columns, split
    over the first (``_chunk``) and alike on the ranks of the second,
    moves to a split over the second, alike on the ranks of the first:
    (sent, got), each ((the other rank's coordinates, lo, hi), ...) in
    column order. The rank at (i, j) takes its chunk j from the ranks
    that hold it whose second coordinate is (i * r + j % r) % sizes[1],
    r = max(sizes[1] // sizes[0], 1): a transposition where the sizes are
    equal, each rank swapping its chunk with one other. What it holds
    itself is in ``got`` and not in ``sent``."""
    a, b = sizes
    r = max(b // a, 1)

    def sources(i, j):
        lo, hi = _chunk(n, b, j)
        return [((k, (i * r + j % r) % b), max(lo, s), min(hi, e))
                for k in range(a) for s, e in [_chunk(n, a, k)]
                if min(hi, e) > max(lo, s)]
    sent = tuple((dst, lo, hi) for dst in ((i, j) for i in range(a)
                                           for j in range(b)) if dst != me
                 for src, lo, hi in sources(*dst) if src == me)
    return sent, tuple(sources(*me))


def _cross(t, mesh, n: int, dims: tuple):
    """This rank's ``t``, whose last dimension is its chunk of ``n``
    columns split over the ``DeviceMesh`` dimension ``dims[0]``, as its
    chunk of them split over ``dims[1]`` (``_crossing``), in one
    all-to-all over the ranks of the two dimensions."""
    from torch.distributed import get_group_rank
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd as all_to_all_single)
    dm = mesh.device_mesh
    sizes = tuple(dm.size(d) for d in dims)
    me = tuple(dm.get_local_rank(d) for d in dims)
    sent, got = _crossing(n, sizes, me)
    held = _chunk(n, sizes[0], me[0])[0]
    # DeviceMesh has no public group over several of its dimensions
    group = dm[tuple(dm.mesh_dim_names[d] for d in sorted(dims))
               ]._flatten().get_group()
    coords = list(dm.get_coordinate())

    def peer(c) -> int:
        for d, i in zip(dims, c):
            coords[d] = i
        return get_group_rank(group, int(dm.mesh[tuple(coords)]))
    local = t.movedim(-1, 0)
    size = group.size()
    ins, outs = [[] for _ in range(size)], [0] * size
    for dst, lo, hi in sent:
        ins[peer(dst)].append(local[lo - held:hi - held])
    for src, lo, hi in got:
        if src != me:
            outs[peer(src)] += hi - lo
    recv = all_to_all_single(
        torch.cat([p for ps in ins for p in ps] or [local[:0]]), outs,
        [sum(p.shape[0] for p in ps) for ps in ins], group)
    chunks = list(torch.split(recv, outs))
    taken = [0] * size
    pieces = []
    for src, lo, hi in got:
        if src == me:
            pieces.append(local[lo - held:hi - held])
        else:
            g = peer(src)
            pieces.append(chunks[g][taken[g]:taken[g] + hi - lo])
            taken[g] += hi - lo
    return torch.cat(pieces).movedim(0, -1)


class _Cross(torch.autograd.Function):
    """``_cross``, whose gradient crosses back."""

    @staticmethod
    def forward(ctx, t, mesh, n, dims):
        ctx.back = (mesh, n, dims[::-1])
        return _cross(t, mesh, n, dims)

    @staticmethod
    def backward(ctx, g):
        return _cross(g, *ctx.back), None, None, None


def model_to_batch(t, mesh, n: int):
    """This rank's ``t``, whose last dimension is its 'model' chunk of
    ``n`` columns (the ranks of the batch axes alike), as its chunk of
    them split over the batch axes (the ranks of 'model' alike). DTensor
    would gather the columns over 'model' for that; here each rank takes
    its chunk from the one or few ranks that hold it and are paired with
    it (``_crossing``), as XLA compiles the reference's move to
    collective-permutes, in one all-to-all over the mesh. The gradient
    moves back the same way, so each rank's columns get it once. ``t``
    itself with ``mesh`` None."""
    if mesh is None:
        return t
    names = mesh.device_mesh.mesh_dim_names
    return _Cross.apply(t, mesh, n, (
        names.index(MODEL_AXIS), names.index("_".join(batch_axes(mesh)))))


def first_columns(t, n: int):
    """``t[..., :n]``. Where ``t`` is a DTensor whose last dimension
    'model' splits evenly (a vocab-parallel head's padded logits), the
    result keeps that split, in DTensor's chunks of ``n``: each rank keeps
    the columns of its chunk it holds and receives the others
    (``recut``), as XLA compiles the reference's slice to a
    collective-permute of them. DTensor's own slice would gather every
    column onto every rank."""
    from torch.distributed.tensor import DTensor
    mesh = process_mesh()
    d = t.dim() - 1
    if mesh is None or n == t.shape[d] or \
            shard_axes(t, mesh, d) != (MODEL_AXIS,) or \
            any(p.is_partial() for p in t.placements):
        return t[..., :n]
    take = model_ranges(n, mesh)
    out, = recut(t.to_local(), mesh, model_ranges(t.shape[d], mesh),
                 lambda j: [take(j)])
    shape = tuple(t.shape[:d]) + (n,)
    return DTensor.from_local(
        out.contiguous(), mesh.device_mesh, t.placements, run_check=False,
        shape=shape,
        stride=tuple(math.prod(shape[i + 1:]) for i in range(len(shape))))


def shard_index(t, mesh, dim: int) -> int:
    """This rank's place among the shards of the DTensor ``t``'s dimension
    ``dim`` (its mesh axes cut it major to minor)."""
    i, dm = 0, mesh.device_mesh
    for k, p in enumerate(t.placements):
        if p.is_shard(dim):
            i = i * dm.size(k) + dm.get_local_rank(k)
    return i


def shard_axes(t, mesh, dim: int) -> tuple:
    """The mesh axes that split the DTensor ``t``'s dimension ``dim``,
    major to minor."""
    return tuple(a for g, p in zip(mesh.device_axes, t.placements)
                 if p.is_shard(dim) for a in g)


def heads_over_ranks(mesh, n_heads: int):
    """The spec entry of a decode state's head axis on ``mesh``: 'model'
    when its size divides ``n_heads``, else None (``cache_spec``
    replicates the state then)."""
    tp = mesh.shape.get(MODEL_AXIS, 1)
    return MODEL_AXIS if n_heads % tp == 0 else None


# --------------------------------------------------------------------------
# Norms / activations
# --------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-5, mesh=None, axes: tuple = (),
             n: int = 0):
    """RMSNorm over the last dimension; where the ranks of the mesh
    ``axes`` each hold their own channels of it (``n`` in all), its mean
    adds their sums."""
    dt = x.dtype
    x = x.float()
    ms = (torch.mean(x * x, dim=-1, keepdim=True) if not axes else
          psum(torch.sum(x * x, dim=-1, keepdim=True), mesh, axes,
               split=True) / n)
    x = x * torch.rsqrt(ms + eps)
    return (x * weight.float()).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5, mesh=None,
               axes: tuple = (), n: int = 0):
    """LayerNorm over the last dimension; where the ranks of the mesh
    ``axes`` each hold their own channels of it (``n`` in all), its mean
    and variance add their sums."""
    dt = x.dtype
    x = x.float()

    def mean(t):
        return (torch.mean(t, dim=-1, keepdim=True) if not axes else
                psum(torch.sum(t, dim=-1, keepdim=True), mesh, axes,
                     split=True) / n)
    mu = mean(x)
    var = mean(torch.square(x - mu))
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dt)


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


# --------------------------------------------------------------------------
# RoPE (full / partial fraction, as chatglm's 2d rope applies rotary to half
# the head dims)
# --------------------------------------------------------------------------

def rope_freqs(d_rot: int, theta: float = 10000.0,
               device: str | torch.device = "cpu"):
    return 1.0 / (theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                                         device=device) / d_rot))


def apply_rope(x, positions, *, fraction: float = 1.0,
               theta: float = 10000.0):
    """x: (..., S, H, D); positions: broadcastable to (..., S) integers.

    Rotates the first ``fraction`` of head dims (interleaved-pairs layout);
    the remainder passes through (chatglm3 partial rotary = 0.5).
    """
    d = x.shape[-1]
    d_rot = int(d * fraction)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    freqs = rope_freqs(d_rot, theta, x.device)             # (d_rot/2,)
    ang = positions[..., None].float() * freqs              # (..., S, d_rot/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x_rot, x_pass = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    x_rot = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([x_rot.to(x.dtype), x_pass], dim=-1)


# --------------------------------------------------------------------------
# Initializers
# --------------------------------------------------------------------------

def cpu_generator(gen: torch.Generator) -> torch.Generator:
    """``gen``, which must be a CPU generator: weights are drawn on the CPU
    whatever device they go to."""
    if gen.device.type != "cpu":
        raise ValueError(
            f"weights are drawn on a CPU torch.Generator, got one on "
            f"{gen.device}; pass torch.Generator().manual_seed(seed) and "
            "the target device separately")
    return gen


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=cpu_generator(gen),
                       dtype=torch.float32) * scale


def embed_init(gen: torch.Generator, vocab: int, d: int):
    return torch.randn((vocab, d), generator=cpu_generator(gen),
                       dtype=torch.float32) * 0.02
