"""Pipeline parallelism: layer stages over the `stage` mesh axis (port of
`parallel/pipeline.py`).

Stage parameters live stacked with a leading stage dim (`stages` leaves
of `layers.pipelined_transformer`). Without a mesh, or without a `stage`
axis above 1, `pipeline_apply` runs the stages one after the other over
the same stacked leaves (the sequential fallback, JAX's `lax.scan`), so a
checkpoint in the one-device layout serves on one device.

Over a `stage` axis of S gloo ranks (`parallel.mesh`), each rank holds
one stage's leaves (a leading dim of 1) and runs the GPipe schedule of M
microbatches over M + S − 1 ticks, as JAX's `_pipeline_local` does: at
tick t stage s applies its layers to microbatch t − s, and its output
hops to stage s + 1 (`collectives.StageShift`); the last stage collects
the finished microbatches, and `collectives.StageBroadcast` sums them
over the ring so every stage rank holds the trunk's output, as JAX's
`psum` over the stage axis does. The backward is the hops run in reverse
(each hop an `autograd.Function`: the cotangents flow back up the ring)
and `collectives.StageReplicate` sums the input's cotangent over the
ring. Which ticks a rank computes: a rank skips its bubble ticks (a tick
where it holds no microbatch, t − s outside [0, M)), whose results JAX
computes and never collects, and hops only where a microbatch moves, so
no clamped re-feed is ever computed or sent. Per step a stage rank
applies its stage M times forward and M times backward: with b blocks a
stage, M·b flash forward launches and M·b of each backward kernel (2·M·b
forward launches with `remat`, which recomputes the forward in the
backward).

The batch: JAX reshapes the global `[B, ...]` to `[M, B/M, ...]` and
shards dim 1 over `data`, so a data rank's rows are not a contiguous
block of the batch (ROADMAP trap 61): `data_rows` gives them. A rank
passes its own rows (ordered microbatch by microbatch) to
`pipeline_apply`, which reshapes them to `[M, rows/M, ...]`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel.mesh import DATA_AXIS, STAGE_AXIS

Params = Dict[str, torch.Tensor]


def init_stage_params(init_fn: Callable[[torch.Generator], Params],
                      generator: torch.Generator, num_stages: int) -> Params:
  """Stacks per-stage params: `init_fn(generator)` called once per stage
  (stage-major draws), every leaf gaining a leading [S] dim (the dim
  `stage_sharding` places on `stage`)."""
  stages = [init_fn(generator) for _ in range(num_stages)]
  return {k: torch.stack([s[k] for s in stages]) for k in stages[0]}


def stage_sharding(mesh, tree: Params) -> Dict[str, Any]:
  """{leaf: placement}: every leaf's leading stage dim on `stage`
  (`parallel.rules.PartitionSpec`), a scalar replicated."""
  from tensor2robot_tpu_torch.parallel.rules import PartitionSpec as P
  return {k: P(STAGE_AXIS) if getattr(v, "ndim", 0) else P()
          for k, v in tree.items()}


def is_pipelined(mesh) -> bool:
  """Whether `mesh` runs the GPipe schedule: a `stage` axis above 1."""
  return (mesh is not None and STAGE_AXIS in mesh.axis_names
          and mesh.shape[STAGE_AXIS] > 1)


def data_rows(batch: int, num_microbatches: int, data_size: int,
              data_index: int) -> np.ndarray:
  """The global batch rows data rank `data_index` holds: the global
  `[B]` reshaped to `[M, B/M]` with dim 1 split into `data_size` blocks,
  in microbatch order (with B = 16, M = 2 and data 2, rank 0 holds rows
  0–3 and 8–11). Raises JAX's error when B does not divide."""
  if batch % (num_microbatches * data_size):
    raise ValueError(
        f"Batch {batch} must be a multiple of num_microbatches="
        f"{num_microbatches} × data axis {data_size}.")
  per = batch // num_microbatches
  block = per // data_size
  return np.concatenate([
      np.arange(m * per + data_index * block,
                m * per + (data_index + 1) * block)
      for m in range(num_microbatches)])


def _stage_fn(apply_fn, remat: bool):
  if not remat:
    return apply_fn

  def fn(params, h):
    keys = list(params)

    def inner(h, *leaves):
      return apply_fn(dict(zip(keys, leaves)), h)

    return torch.utils.checkpoint.checkpoint(
        inner, h, *params.values(), use_reentrant=False)

  return fn


def pipeline_apply(apply_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                   stage_params: Params, x: torch.Tensor, *, mesh,
                   num_microbatches: int, remat: bool = False
                   ) -> torch.Tensor:
  """Runs x through the stages of `apply_fn`.

  Args:
    apply_fn: (one stage's params, activation [mb, ...]) → same-shape
      activation.
    stage_params: leaves with a leading stage dim: all S stages (the
      sequential fallback), or this rank's one stage on a stage axis.
    x: [B, ...] this rank's rows (its data rows, `data_rows`, ordered
      microbatch by microbatch); B must divide into `num_microbatches`.
    mesh: a `parallel.mesh.Mesh` with a `stage` axis, or None.
    num_microbatches: M; the bubble is (S − 1)/(M + S − 1).
    remat: recompute each stage's activations in the backward
      (`torch.utils.checkpoint` around each stage application).

  Returns [B, ...] on every stage rank.
  """
  fn = _stage_fn(apply_fn, remat)
  if not is_pipelined(mesh):
    num = next(iter(stage_params.values())).shape[0]
    for i in range(num):
      x = fn({k: v[i] for k, v in stage_params.items()}, x)
    return x
  num_stages = mesh.shape[STAGE_AXIS]
  data_size = mesh.axis_size(DATA_AXIS)
  batch = x.shape[0]
  if batch % num_microbatches:
    raise ValueError(
        f"Batch {batch * data_size} must be a multiple of num_microbatches="
        f"{num_microbatches} × data axis {data_size}.")
  lead = next(iter(stage_params.values())).shape[0]
  if lead != 1:
    raise ValueError(
        f"a stage rank holds one stage's leaves (leading dim 1), got "
        f"{lead}: build the trunk with the mesh")
  params = {k: v[0] for k, v in stage_params.items()}
  ring = mesh.axis_ranks(STAGE_AXIS)
  s = mesh.axis_index(STAGE_AXIS)
  group = mesh.group(STAGE_AXIS)
  m_count = num_microbatches
  x = collectives.StageReplicate.apply(x, group)
  micro = x.reshape((m_count, batch // m_count) + tuple(x.shape[1:]))
  ticks = m_count + num_stages - 1
  h = micro[0]
  collected = []
  for t in range(ticks):
    y = fn(params, h) if 0 <= t - s < m_count else h
    if s == num_stages - 1 and t - s >= 0:
      collected.append(y)
    if t == ticks - 1:
      h = y
      break
    sends = s < num_stages - 1 and 0 <= t - s < m_count
    receives = s > 0 and 0 <= t + 1 - s < m_count
    if s == 0 and t + 1 < m_count:
      fallback = micro[t + 1]  # stage 0 ingests the next microbatch
    else:
      fallback = y
    if sends or receives:
      h = collectives.StageShift.apply(
          y, fallback, ring[s + 1] if sends else None,
          ring[s - 1] if receives else None)
    else:
      h = fallback
  if s == num_stages - 1:
    out = torch.stack(collected)
  else:
    out = torch.zeros_like(micro)
  out = collectives.StageBroadcast.apply(out, h, group)
  return out.reshape(x.shape)
