"""The regex-rules sharding seam, one table per model family (port of
`parallel/rules.py`).

Sharding decisions live in ordered ``(param-path regex, placement)``
tables. A placement resolves against a mesh and a leaf's shape to a
`PartitionSpec` (one entry per dim: a mesh axis name or None; the empty
spec is replicated):

  * ``Replicate()``: always the empty spec;
  * ``ShardLargest(axis)``: the largest axis-divisible dim on `axis`;
    replicated when the axis is absent, the leaf is under
    ``min_size_to_shard`` elements, or nothing divides;
  * ``ColumnParallel()``: 2-D and larger kernels split their output dim
    on `model` (and their input dim on `fsdp` when it divides); without
    a `model` axis this is ``ShardLargest(fsdp)``;
  * ``ShardLeading(axis)``: stacked weights (MoE experts, pipeline
    stages) on their leading dim, raising on an indivisible one; without
    the axis, ``ShardLargest(fsdp)``;
  * a literal `PartitionSpec`, used as it is.

Rules are first-match-wins (`re.search`) over a leaf's '/'-joined flax
param path with flax's leaf names (``.../kernel``, ``.../scale``,
``moe_expert_*``): the tables are the JAX package's, so they read the
JAX names. The port's state is keyed by torch names
(``q_head.dense_0.weight``); `models.convert.flax_param_paths` gives
each its flax path, and `match_state_rules` matches a state's params
through it.

A mesh is described by its axis names and sizes (`MeshShape`), which is
all the placements read. Placing tensors on a mesh (DTensor) is
ROADMAP A11; on one card the rules seam resolves placements, and on a
pod-only mesh every placement of the family tables is the replicated
spec.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Sequence, Tuple, Union

import numpy as np

# The mesh axis names of the JAX package (`parallel/mesh.py` and the
# Anakin pod axis of `envs/rollout.py`).
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
STAGE_AXIS = "stage"
POD_AXIS = "pod"


class PartitionSpec(tuple):
  """A leaf's placement: per dim a mesh axis name or None; the empty spec
  is replicated. A tuple, so it compares equal to the JAX spec with the
  same entries."""

  def __new__(cls, *entries):
    return super().__new__(cls, entries)

  def __repr__(self) -> str:
    return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class MeshShape:
  """A mesh as the placements read it: ordered axis names and sizes."""

  def __init__(self, axes: Mapping[str, int]):
    self.shape: Dict[str, int] = {str(k): int(v) for k, v in axes.items()}

  @property
  def axis_names(self) -> Tuple[str, ...]:
    return tuple(self.shape)

  def __repr__(self) -> str:
    return f"MeshShape({self.shape})"


@dataclasses.dataclass(frozen=True)
class Replicate:
  """Every shard holds the whole leaf."""

  def spec(self, mesh: MeshShape, shape, min_size: int, path: str) -> P:
    del mesh, shape, min_size, path
    return P()


@dataclasses.dataclass(frozen=True)
class ShardLargest:
  """The largest axis-divisible dim on `axis` (ties to the lowest dim);
  replicated when the axis is absent, the leaf has fewer than
  `min_size` elements, or no dim divides."""

  axis: str = FSDP_AXIS

  def spec(self, mesh: MeshShape, shape, min_size: int, path: str) -> P:
    del path
    if self.axis not in mesh.axis_names:
      return P()
    size = mesh.shape[self.axis]
    if not shape or int(np.prod(shape)) < min_size:
      return P()
    for dim in sorted(range(len(shape)), key=lambda i: -shape[i]):
      if shape[dim] % size == 0:
        entries = [None] * len(shape)
        entries[dim] = self.axis
        return P(*entries)
    return P()


@dataclasses.dataclass(frozen=True)
class ColumnParallel:
  """Megatron-style column parallel: the output (last) dim on
  `model_axis` when it divides, the input dim on `fsdp_axis` too when
  present and divisible; without `model_axis`, ``ShardLargest(
  fsdp_axis)``."""

  model_axis: str = MODEL_AXIS
  fsdp_axis: str = FSDP_AXIS

  def spec(self, mesh: MeshShape, shape, min_size: int, path: str) -> P:
    if self.model_axis not in mesh.axis_names:
      return ShardLargest(self.fsdp_axis).spec(mesh, shape, min_size, path)
    tp = mesh.shape[self.model_axis]
    if not shape or int(np.prod(shape)) < min_size:
      return P()
    if len(shape) >= 2 and shape[-1] % tp == 0:
      entries = [None] * len(shape)
      entries[-1] = self.model_axis
      if (self.fsdp_axis in mesh.axis_names
          and shape[-2] % mesh.shape[self.fsdp_axis] == 0):
        entries[-2] = self.fsdp_axis
      return P(*entries)
    if shape[-1] % tp == 0:
      return P(*([None] * (len(shape) - 1)), self.model_axis)
    return P()


@dataclasses.dataclass(frozen=True)
class ShardLeading:
  """Stacked weights: the leading dim on `axis`, raising when it does
  not divide; without the axis, ``ShardLargest(fallback_axis)``."""

  axis: str
  fallback_axis: str = FSDP_AXIS

  def spec(self, mesh: MeshShape, shape, min_size: int, path: str) -> P:
    if self.axis not in mesh.axis_names:
      return ShardLargest(self.fallback_axis).spec(mesh, shape, min_size,
                                                   path)
    size = mesh.shape[self.axis]
    if not shape or shape[0] % size != 0:
      raise ValueError(
          f"stacked weight {path!r} has leading dim {tuple(shape[:1])} not "
          f"divisible by {self.axis!r} axis size {size}")
    return P(self.axis)


Placement = Union[Replicate, ShardLargest, ColumnParallel, ShardLeading, P]
Rules = Sequence[Tuple[str, Placement]]


def _resolve(placement: Placement, mesh: MeshShape, shape, min_size: int,
             path: str) -> P:
  if not hasattr(placement, "spec"):  # a literal spec (a JAX one too)
    return P(*placement)
  return placement.spec(mesh, tuple(shape), min_size, path)


def match_partition_rules(rules: Rules, params: Mapping[str, Any],
                          mesh: MeshShape,
                          min_size_to_shard: int = 2 ** 10
                          ) -> Dict[str, P]:
  """{flax path: PartitionSpec} for `params` keyed by '/'-joined flax
  param paths (leaves need only a `.shape`): the first rule whose regex
  searches the path wins, and its placement resolves against the mesh
  and the leaf's shape. A leaf no rule matches raises."""
  compiled = [(re.compile(pattern), placement)
              for pattern, placement in rules]
  out = {}
  for name, leaf in params.items():
    shape = tuple(getattr(leaf, "shape", ()))
    for regex, placement in compiled:
      if regex.search(name):
        out[name] = _resolve(placement, mesh, shape, min_size_to_shard,
                             name)
        break
    else:
      raise ValueError(
          f"no partition rule matched param {name!r} "
          f"(table has {len(compiled)} rules; add a catch-all)")
  return out


def match_state_rules(rules: Rules, params: Mapping[str, Any], network,
                      mesh: MeshShape, min_size_to_shard: int = 2 ** 10
                      ) -> Dict[str, P]:
  """{port param name: PartitionSpec} for a state's `params` (torch
  names of `network`'s parameters), each matched on its flax path with
  its flax shape, so each spec is JAX's for that param, its entries in
  flax's dim order (kernels ``[in, out]``, HWIO)."""
  from tensor2robot_tpu_torch.models.convert import (
      flax_param_paths,
      flax_param_shapes,
  )
  paths = flax_param_paths(network)
  shapes = flax_param_shapes(network)
  specs = match_partition_rules(
      rules, {paths[name]: np.empty(shapes[name], np.bool_)
              for name in params}, mesh,
      min_size_to_shard=min_size_to_shard)
  return {name: specs[paths[name]] for name in params}


# Stacked-expert weights (the `moe_expert_` prefix is owned by
# `parallel.moe.MoEMLP`) and stage-stacked pipeline weights.
EXPERT_STACK_RE = r"(^|/)moe_expert_[^/]*$"
STAGE_STACK_RE = r"(^|/)stages(/|$)"

# One table per research family, the JAX package's, most specific first;
# each ends in a ShardLargest catch-all.
FAMILY_RULES: Dict[str, Rules] = {
    "qtopt": (
        (r"(^|/)(torso|head)_conv_[0-9]+/kernel$",
         ShardLargest(FSDP_AXIS)),
        (r"(^|/)(torso|head)_bn_[0-9]+/(bias|scale)$", Replicate()),
        (r"(^|/)action_embed_[0-9]+/kernel$", ColumnParallel()),
        (r"(^|/)q_head/dense_[0-9]+/kernel$", ColumnParallel()),
        (r"/bias$", Replicate()),
        (r".*", ShardLargest(FSDP_AXIS)),
    ),
    "pose_env": (
        (r"(^|/)tower/conv_[0-9]+/kernel$", ShardLargest(FSDP_AXIS)),
        (r"(^|/)tower/bn_[0-9]+/(bias|scale)$", Replicate()),
        (r"(^|/)ssoftmax/log_temperature$", Replicate()),
        (r"(^|/)head/dense_[0-9]+/kernel$", ColumnParallel()),
        (r"(^|/)proj/kernel$", ColumnParallel()),
        (r"/bias$", Replicate()),
        (r".*", ShardLargest(FSDP_AXIS)),
    ),
    "grasp2vec": (
        (r"(^|/)trunk/conv_init/kernel$", ShardLargest(FSDP_AXIS)),
        (r"(^|/)stage[0-9]+_block[0-9]+/(conv[0-9]+|proj)/kernel$",
         ShardLargest(FSDP_AXIS)),
        (r"(^|/)(bn_init|bn[0-9]+|bn_proj)/(bias|scale)$", Replicate()),
        (r"(^|/)embed/kernel$", ColumnParallel()),
        (r"/bias$", Replicate()),
        (r".*", ShardLargest(FSDP_AXIS)),
    ),
    "vrgripper": (
        (EXPERT_STACK_RE, ShardLeading(EXPERT_AXIS)),
        (STAGE_STACK_RE, ShardLeading(STAGE_AXIS)),
        (r"(^|/)moe/router$", Replicate()),
        (r"(^|/)attn/(qkv|proj)/kernel$", ColumnParallel()),
        (r"(^|/)mlp_(in|out)/kernel$", ColumnParallel()),
        (r"(^|/)ln_[a-z0-9_]+/(bias|scale)$", Replicate()),
        (r"(^|/)positions$", Replicate()),
        (r"(^|/)tower/conv_[0-9]+/kernel$", ShardLargest(FSDP_AXIS)),
        (r"(^|/)ssoftmax/log_temperature$", Replicate()),
        (r"(^|/)(proj|joint_proj|embed|action_head)/kernel$",
         ColumnParallel()),
        (r"(^|/)trunk/dense_[0-9]+/kernel$", ColumnParallel()),
        (r"/bias$", Replicate()),
        (r".*", ShardLargest(FSDP_AXIS)),
    ),
    "meta_learning": (
        (r"(^|/)inner_lr_log$", Replicate()),
        (r"(^|/)tower/conv_[0-9]+/kernel$", ShardLargest(FSDP_AXIS)),
        (r"(^|/)tower/bn_[0-9]+/(bias|scale)$", Replicate()),
        (r"(^|/)ssoftmax/log_temperature$", Replicate()),
        (r"(^|/)head/dense_[0-9]+/kernel$", ColumnParallel()),
        (r"(^|/)proj/kernel$", ColumnParallel()),
        (r"/bias$", Replicate()),
        (r".*", ShardLargest(FSDP_AXIS)),
    ),
}


def family_rules(family: str) -> Rules:
  """The rules table of `family`; an unknown name raises ValueError."""
  try:
    return FAMILY_RULES[family]
  except KeyError:
    raise ValueError(
        f"unknown model family {family!r}; known: "
        f"{', '.join(sorted(FAMILY_RULES))}") from None
