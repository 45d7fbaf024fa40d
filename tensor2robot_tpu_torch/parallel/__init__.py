"""Parallelism (port of `parallel/`): the single-device attention
oracle, the MoE layer on one device (`moe`), the sharding rules seam
(`rules`), and the data and stage axes over a process group:
`distributed` (the gloo group and a mesh's subgroups), `mesh`,
`collectives` (global-batch moments, gradient sums and averages, the
stage ring's hops), `pipeline` (the GPipe schedule and its sequential
fallback) and `sharding` (the "pipeline" and "replicated" placements).
The other mesh axes, the ring, expert parallelism and the other
sharding strategies wait for ROADMAP A11 rest."""

from tensor2robot_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
)
from tensor2robot_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    STAGE_AXIS,
    create_mesh,
)
from tensor2robot_tpu_torch.parallel.pipeline import (
    init_stage_params,
    pipeline_apply,
    stage_sharding,
)
from tensor2robot_tpu_torch.parallel.sharding import state_sharding
from tensor2robot_tpu_torch.parallel.moe import (
    MoEMLP,
    collect_aux_losses,
    expert_capacity,
    moe_mlp,
    top_k_routing,
)
from tensor2robot_tpu_torch.parallel.ring_attention import (
    attention_reference,
)
from tensor2robot_tpu_torch.parallel.rules import (
    FAMILY_RULES,
    ColumnParallel,
    MeshShape,
    PartitionSpec,
    Replicate,
    ShardLargest,
    ShardLeading,
    family_rules,
    match_partition_rules,
    match_state_rules,
)

__all__ = [
    "DATA_AXIS", "STAGE_AXIS", "create_mesh", "init_stage_params",
    "maybe_initialize_distributed", "pipeline_apply", "stage_sharding",
    "state_sharding",
    "FAMILY_RULES", "ColumnParallel", "MeshShape", "MoEMLP", "PartitionSpec",
    "Replicate", "ShardLargest", "ShardLeading", "attention_reference",
    "collect_aux_losses", "expert_capacity", "family_rules",
    "match_partition_rules", "match_state_rules", "moe_mlp", "top_k_routing",
]
