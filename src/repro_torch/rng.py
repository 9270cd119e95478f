"""Counter-based random draws: Threefry-2x32 in integer torch ops.

Every seeded draw of the port comes from here. A draw is a pure function
of its key and its counter:

  * the key is ``key(seed, *path)``: the seed folded with a path of
    integers (problem, stream, chip, ...), one Threefry block a fold;
  * the counter is two 32-bit words, by convention (step, index): the
    sweep, iteration or Euler step, and the element's flat index within
    that step's draw.

Threefry-2x32 (20 rounds, the variant ``jax.random`` uses) needs only
32-bit add, rotate and xor. Here the words are held in int64 tensors and
masked to 32 bits after every add and shift, which both devices compute
exactly, so one key gives the same bits on the CPU and on the card. The
same functions take Python ints, which is how keys are folded on the
host.

On top of the bits:

  * ``uniform``: the top 24 bits times 2^-24, float32 in [0, 1) (exact);
  * ``spins``: the top bit as ±1 float32;
  * ``permutation``: an argsort of the keys ``bits * 2^b + position``,
    which no two elements share, so the order never depends on how a
    device breaks ties;
  * ``index``: ``floor(u * n)`` in integer arithmetic;
  * ``normal``: Box–Muller, ``sqrt(-2 log u1) * cos(2 pi u2)`` in float32.
    ``log`` and ``cos`` are the device's own, so normals made on the card
    and on the CPU may differ by a few ULP (``NORMAL_ULP_BOUND``). Draws
    that must be the same everywhere (the physics tier's chip variation)
    are made on the host and moved.
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TWO_PI = float(2.0 * math.pi)

#: the largest difference, in float32 ULP of the larger magnitude, between
#: a normal drawn on the card and the same normal drawn on the CPU (CUDA's
#: logf and cosf are within 1 and 2 ULP of the exact value, the host's
#: within 1; sqrt and the multiplies round once on both)
NORMAL_ULP_BOUND = 8


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds: key words (k0, k1), counter words
    (x0, x1) -> two words. Each argument is a Python int or an int64
    tensor holding values in [0, 2^32); tensors broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _words(d):
    """(low, high) 32-bit words of a 64-bit integer or int64 tensor."""
    if isinstance(d, torch.Tensor):
        return d & M32, (d >> 32) & M32
    d = int(d) % (1 << 64)
    return d & M32, d >> 32


def fold(k, d):
    """The key ``k`` folded with ``d``: one Threefry block of ``k`` on the
    counter (low, high) of ``d``. ``d`` may be an int64 tensor, giving a
    key per element."""
    lo, hi = _words(d)
    return threefry2x32(k[0], k[1], lo, hi)


def key(seed: int, *path: int):
    """The key of ``seed`` followed by the integers of ``path``, as two
    Python ints."""
    k = _words(seed)
    for d in path:
        k = fold(k, d)
    return k


def keys(seed: int, first, *path: int, device="cpu", ndim: int = 1):
    """Keys of ``(seed, f, *path)`` for every ``f`` in the sequence
    ``first``, as two int64 tensors of shape (len(first),) + (1,) * (ndim -
    1) on ``device``, ready to broadcast against a draw's other axes."""
    f = torch.as_tensor(list(first), dtype=torch.int64).reshape(
        (-1,) + (1,) * (ndim - 1))
    k = fold(key(seed), f)
    for d in path:
        k = fold(k, d)
    return tuple(w.to(device) for w in k)


def bits(k, step, index: torch.Tensor):
    """Two random 32-bit words (int64 tensors) for counter (step, index):
    ``step`` an int (or tensor) below 2^32, ``index`` an int64 tensor of
    flat indices below 2^32; the key words broadcast against them."""
    step = step & M32 if isinstance(step, torch.Tensor) else int(step) & M32
    return threefry2x32(k[0], k[1], step, index)


def counters(shape, device) -> torch.Tensor:
    """Flat indices 0..prod(shape)-1 in ``shape``, int64 on ``device``;
    refuses more than 2^32 (the counter's index word)."""
    n = math.prod(shape)
    if n > 1 << 32:
        raise ValueError(f"a draw of {n} elements exceeds the 2^32 "
                         f"counters of one step")
    return torch.arange(n, dtype=torch.int64, device=device).view(shape)


def uniform(w: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1): the top 24 bits of ``w`` times 2^-24 (exact)."""
    return (w >> 8).to(torch.float32) * 2.0 ** -24


def spins(w: torch.Tensor) -> torch.Tensor:
    """±1 float32 from the top bit of ``w``."""
    return ((w >> 31) * 2 - 1).to(torch.float32)


def index(w: torch.Tensor, n) -> torch.Tensor:
    """int64 ``floor(u * n)`` with u the top 24 bits of ``w`` over 2^24, in
    integer arithmetic; ``n`` (an int or an int64 tensor that broadcasts)
    at most 2^31."""
    return ((w >> 8) * n) >> 24


def permutation(w: torch.Tensor) -> torch.Tensor:
    """A random permutation of the last axis, int64: the argsort of the
    keys ``w * 2^b + position``, all distinct."""
    n = w.shape[-1]
    b = max(1, (n - 1).bit_length())
    pos = torch.arange(n, dtype=torch.int64, device=w.device)
    return torch.argsort((w << b) | pos, dim=-1, stable=True)


def normal(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """Standard normals, float32, by Box–Muller on two words: u1 in (0, 1]
    from ``w0``, u2 in [0, 1) from ``w1``."""
    u1 = ((w0 >> 8) + 1).to(torch.float32) * 2.0 ** -24
    u2 = uniform(w1)
    r = torch.sqrt(torch.log(u1) * -2.0)
    return r * torch.cos(u2 * _TWO_PI)
