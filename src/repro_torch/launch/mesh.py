"""Mesh constructors (the reference's ``launch.mesh``). Functions, not module
constants: importing this module touches no device and no process group.

``Mesh``, ``virtual_mesh`` and ``activate_mesh`` live beside the sharding
rules in ``distributed.sharding`` (so that no lower layer imports this
entry-point layer) and are re-exported here under the reference's names.
"""
from __future__ import annotations

import math

import torch

from ..distributed.sharding import (Mesh, activate_mesh, mesh_of_processes,
                                    virtual_mesh)

__all__ = ["Mesh", "PRODUCTION_SHAPES", "activate_mesh", "make_host_mesh",
           "make_production_mesh", "virtual_mesh"]

#: the reference's production meshes: one v5e-256 pod, or two
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_host_mesh(torch_device: str | torch.device = "cuda") -> Mesh:
    """This process's devices as (n, 1) ``("data", "model")``. The port runs
    one device a process, so (1, 1) on ``torch_device``; no process group
    is needed. Raises without CUDA unless given ``"cpu"``."""
    return virtual_mesh((1, 1), ("data", "model"), torch_device)


def make_production_mesh(*, multi_pod: bool = False,
                         torch_device: str | torch.device = "cuda") -> Mesh:
    """(16, 16) ``("data", "model")`` over a world of 256 ranks, or (2, 16, 16)
    ``("pod", "data", "model")`` over 512 with ``multi_pod``. The world must
    be initialised (``torch.distributed.init_process_group``); raises
    otherwise, or if its size is not the mesh's."""
    import torch.distributed as dist
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"make_production_mesh needs an initialised "
                           f"world of {need} ranks; none is")
    if dist.get_world_size() != need:
        raise RuntimeError(f"make_production_mesh{shape} needs {need} ranks, "
                           f"the world has {dist.get_world_size()}")
    return mesh_of_processes(axes, shape, torch_device, range(need))
