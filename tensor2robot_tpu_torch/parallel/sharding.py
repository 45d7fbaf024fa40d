"""Placements of a train state over the mesh (port of the "pipeline" and
"replicated" strategies of `parallel/sharding.py`).

A strategy is an ordered (path regex → placement) table over
`parallel.rules`' engine. The port's state is a flat
``{path: tensor}`` (`utils.checkpoints.flatten_state`: ``params/...``,
``opt_state/0/mu/...``), its paths torch names joined by '/' and '.';
the tables match them with the dots read as '/', so a leaf under a
``stages`` module (`layers.pipelined_transformer.STAGE_PARAMS_NAME`) and
its Adam mirrors match `rules.STAGE_STACK_RE`.

  * "pipeline": stage-stacked leaves put their leading dim on `stage`
    (`ShardLeading`, which raises on an indivisible dim); every other
    leaf is replicated. JAX's table sends the rest to its fsdp rules,
    which replicate on a mesh without an `fsdp` axis, as the pipeline
    gin's mesh is.
  * "replicated": every leaf replicated.

The other strategies ("fsdp", "tp", "ep") raise, naming ROADMAP A11
rest. `shard_state` / `stage_slice` take a rank's slices of the
one-device layout; `utils.checkpoints` gathers them back.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import torch

from tensor2robot_tpu_torch.parallel.rules import (
    STAGE_AXIS,
    STAGE_STACK_RE,
    MeshShape,
    PartitionSpec,
    Replicate,
    ShardLeading,
    match_partition_rules,
)

STRATEGIES = ("pipeline", "replicated")


def _rule_path(path: str) -> str:
  return path.replace(".", "/")


def is_stage_stacked(path: str) -> bool:
  """Whether a state path names a stage-stacked leaf (or its mirror)."""
  return re.search(STAGE_STACK_RE, _rule_path(path)) is not None


def state_sharding(mesh, tree: Mapping[str, Any],
                   strategy: str = "pipeline",
                   min_size_to_shard: int = 2 ** 10
                   ) -> Dict[str, PartitionSpec]:
  """{path: PartitionSpec} for a flat state in the one-device layout
  (leaves need only a `.shape`) under `strategy`."""
  if strategy not in STRATEGIES:
    raise NotImplementedError(
        f"sharding_strategy={strategy!r}: the port places states by the "
        f"{' and '.join(repr(s) for s in STRATEGIES)} strategies only "
        "(ROADMAP A11 rest)")
  rules = (((STAGE_STACK_RE, ShardLeading(STAGE_AXIS)),)
           if strategy == "pipeline" else ()) + ((r".*", Replicate()),)
  specs = match_partition_rules(
      rules, {_rule_path(k): v for k, v in tree.items()},
      MeshShape(mesh.shape), min_size_to_shard=min_size_to_shard)
  return {k: specs[_rule_path(k)] for k in tree}


def stage_slice(leaf: torch.Tensor, mesh) -> torch.Tensor:
  """This rank's slice of a stage-stacked leaf's leading dim."""
  size = mesh.shape[STAGE_AXIS]
  per = leaf.shape[0] // size
  index = mesh.axis_index(STAGE_AXIS)
  return leaf[index * per:(index + 1) * per]


def shard_state(flat: Mapping[str, Any], mesh,
                strategy: str = "pipeline") -> Dict[str, Any]:
  """This rank's slices of a flat one-device-layout state: each leaf
  placed on `stage` sliced on its leading dim, the rest as it is."""
  shapes = {k: v for k, v in flat.items() if hasattr(v, "shape")}
  specs = state_sharding(mesh, shapes, strategy)
  return {k: stage_slice(v, mesh)
          if specs.get(k) == PartitionSpec(STAGE_AXIS) else v
          for k, v in flat.items()}
