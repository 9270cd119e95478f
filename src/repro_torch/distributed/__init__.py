"""repro_torch.distributed — the LM sharding rules (``sharding``), the
serve tier's fault tolerance and fleet membership (``fault_tolerance``,
``elastic``, whose ``remesh`` rebuilds a mesh) and the mega-fabric
(``fabric``: checkerboard LNS over virtual dies, ``fabric-jax``)."""
from .elastic import largest_mesh_shape, remesh
from .fabric import (FABRIC_AXIS, FabricLayout, FabricLNS, FabricMesh,
                     FieldExchange, fabric_mesh)
from .fault_tolerance import StepFailure, StragglerDetector, resilient_step
from .sharding import (batch_axes, batch_spec, cache_shardings, data_size,
                       param_shardings, tp_size)

__all__ = ["param_shardings", "cache_shardings", "batch_spec", "batch_axes",
           "data_size", "tp_size", "StragglerDetector", "resilient_step",
           "StepFailure", "remesh", "largest_mesh_shape", "FABRIC_AXIS",
           "FabricLayout", "FabricLNS", "FabricMesh", "FieldExchange",
           "fabric_mesh"]
