"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

The CUDA sources live in ``csrc/`` and are compiled with ``nvcc`` at first
use (``kernels/build.py``); importing this package builds nothing.
"""
from . import ops
from .ising_anneal import fused_anneal_kernel, fused_anneal_torch
from .ref import fused_anneal_ref
from .sb_kernel import fused_sb_kernel, sb_reference

__all__ = ["ops", "fused_anneal_kernel", "fused_anneal_torch",
           "fused_anneal_ref", "fused_sb_kernel", "sb_reference"]
