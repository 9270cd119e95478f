"""repro_torch.distributed — the serve tier's fault tolerance and fleet
membership (``fault_tolerance``, ``elastic``). The reference package's mesh
pieces (sharding, remesh, the fabric) are not ported yet."""
