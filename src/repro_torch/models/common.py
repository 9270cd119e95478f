"""Shared building blocks for the model zoo: norms, activations, RoPE, inits
(the reference's ``models.common``).

Parameters are plain nested dicts of tensors. Every init function takes an
explicit ``torch.Generator``, whose device is the device of what it makes.
Dtype policy: params fp32, activations cast to ``config.dtype`` (bf16 by
default), norms computed in fp32.

The reference's sharding helpers (``active_mesh``, ``logical``, ``shard``)
place tensors on a JAX mesh; they have no counterpart yet and go with
``distributed/sharding.py`` to a later slice (ROADMAP queue 1, step 5).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# Norms / activations
# --------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
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

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def embed_init(gen: torch.Generator, vocab: int, d: int):
    return torch.randn((vocab, d), generator=gen, device=gen.device,
                       dtype=torch.float32) * 0.02
