"""repro_torch.distributed — the serve tier's fault tolerance and fleet
membership (``fault_tolerance``, ``elastic``) and the mega-fabric
(``fabric``: checkerboard LNS over virtual dies, ``fabric-jax``). The
reference package's LM sharding (``sharding``, ``remesh``,
``largest_mesh_shape``) is not ported yet (ROADMAP queue 1, step 5)."""
from .fabric import (FabricLayout, FabricLNS, FabricMesh, FieldExchange,
                     fabric_mesh)

__all__ = ["FabricLayout", "FabricLNS", "FabricMesh", "FieldExchange",
           "fabric_mesh"]
