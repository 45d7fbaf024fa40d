"""Parallelism (port of `parallel/`): the single-device attention
oracle, the MoE layer on one device (`moe`) and the sharding rules seam
(`rules`). The mesh, the ring, expert parallelism and placing tensors
on a mesh wait for ROADMAP A11."""

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
    "FAMILY_RULES", "ColumnParallel", "MeshShape", "MoEMLP", "PartitionSpec",
    "Replicate", "ShardLargest", "ShardLeading", "attention_reference",
    "collect_aux_losses", "expert_capacity", "family_rules",
    "match_partition_rules", "match_state_rules", "moe_mlp", "top_k_routing",
]
