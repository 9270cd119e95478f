"""repro_torch — the PyTorch/CUDA port of the 64-spin Ising machine stack.

Same subpackage layout and module names as the JAX package ``repro``; each
ported module has one counterpart there. Entry points take ``torch_device``
(default ``"cuda"``; see ``repro_torch.device``). The fused anneal runs as a
hand-written CUDA kernel (``kernels/csrc/ising_anneal.cu``) built at first
use with ``nvcc``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
