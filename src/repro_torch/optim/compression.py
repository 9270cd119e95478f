"""Gradient compression for data parallelism (the reference's
``optim.compression``).

int8 symmetric quantization with per-tensor scales and an error-feedback
residual: the all-reduce payload drops 4x (float32 -> int8), and the
residual keeps the long-run estimate unbiased.

``compressed_psum`` reduces over K replicas held as one stacked (K, ...)
tensor on one device, the virtual-die design of ``distributed.fabric``:
the reference's ``pmax`` of the scales is a max over the leading axis,
its ``psum`` of the int32 payload a sum over it (exact in any order).
A reduction across processes or cards (``torch.distributed``) waits for
the sharding slice and a machine with more than one card.
"""
from __future__ import annotations

import torch


def int8_compress(x):
    """(q int8, scale float32 0-d): q = round(x / scale) within +-127."""
    scale = torch.amax(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum(x, residual=None):
    """All-reduce the K replicas of ``x`` (K, ...) in int8 with error
    feedback. Returns (the mean over replicas (...), the new residuals
    (K, ...)). Every replica quantizes with the largest replica scale, so
    dequantization is consistent; the payload is widened to int32 only
    for the sum. The residual is the exact quantization error rounded
    once."""
    if residual is not None:
        x = x + residual
    k = x.shape[0]
    flat = torch.abs(x).reshape(k, -1)
    scale = torch.amax(torch.amax(flat, dim=1) / 127.0 + 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    # x - q * scale rounded once, as the compiled reference computes it
    # (XLA contracts it into one fused multiply-add); in float64 the
    # product (7 x 24 bits) and the difference of two nearby values are
    # exact
    new_residual = (x.double() - q.double() * scale.double()).float()
    summed = torch.sum(q.to(torch.int32), dim=0)
    return summed.to(torch.float32) * scale / k, new_residual
