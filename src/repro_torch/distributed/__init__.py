"""The mesh's sharding rules and its gradient sync (the reference's
``repro.distributed``)."""
from repro_torch.distributed.sharding import (
    constrain, current_mesh, logical_axis_rules, mesh_context,
    partition_specs, spec_for_path,
)

__all__ = [
    "logical_axis_rules", "partition_specs", "constrain", "mesh_context",
    "current_mesh", "spec_for_path",
]
