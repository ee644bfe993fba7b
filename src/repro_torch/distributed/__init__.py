"""Distribution: process groups and device meshes (``group``), logical-axis
sharding rules and DTensor placement (``sharding``)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    AbstractMesh, AxisRules, MeshSharding, logical_to_mesh,
    make_param_shardings, param_sharding_rules, set_axis_rules,
    to_placements)
