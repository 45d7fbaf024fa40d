"""Causal transformer trunk whose blocks run as pipeline stages (port of
`layers/pipelined_transformer.py`).

The trunk's depth splits into `num_stages` equal stages of
`depth / num_stages` pre-LN blocks (`_StageBlocks`); the stage weights
live stacked under one ``stages`` subtree, every leaf with a leading
stage dim (`STAGE_PARAMS_NAME`, the name `parallel.sharding`'s
"pipeline" strategy keys on), and `parallel.pipeline.pipeline_apply`
runs them. Without a mesh (or without a `stage` axis above 1) the
stacked leaves hold all S stages and run one after the other (the
sequential fallback): a checkpoint in that one-device layout serves on
one device. With a mesh whose `stage` axis has `num_stages` ranks, a
rank's trunk holds only its own stage (a leading dim of 1) and runs the
GPipe schedule over the stage ring.

State paths are flax's: ``embed``, ``positions``,
``stages.block{i}.{ln_attn,attn.qkv,attn.proj,ln_mlp,mlp_in,mlp_out}``
(each leaf ``[S, ...]`` in torch's layout per stage: a Linear's weight
``[S, out, in]``) and ``ln_out``. Embedding, positions and the final
LayerNorm are `layers.transformer.CausalTransformer`'s.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from tensor2robot_tpu_torch.layers.core import dense
from tensor2robot_tpu_torch.layers.transformer import (
    LayerNorm,
    TransformerBlock,
)
from tensor2robot_tpu_torch.parallel import pipeline
from tensor2robot_tpu_torch.parallel.mesh import STAGE_AXIS

STAGE_PARAMS_NAME = "stages"


class _StageBlocks(nn.Module):
  """One pipeline stage: `blocks_per_stage` pre-LN transformer blocks."""

  def __init__(self, width: int, blocks_per_stage: int, num_heads: int,
               head_dim: int, attention_impl: str, dtype: torch.dtype):
    super().__init__()
    self.blocks_per_stage = blocks_per_stage
    for i in range(blocks_per_stage):
      self.add_module(f"block{i}", TransformerBlock(
          width, num_heads, head_dim, attention_impl=attention_impl,
          dtype=dtype))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i in range(self.blocks_per_stage):
      x, _ = getattr(self, f"block{i}")(x)
    return x


def _stack_parameters(module: nn.Module, count: int) -> None:
  """Gives every parameter of `module` a leading dim of `count`, and
  marks its submodules `stage_stacked` (their weights are initialized by
  the trunk, per stage)."""
  for sub in module.modules():
    sub.stage_stacked = True
    for name, param in list(sub._parameters.items()):
      if param is not None:
        sub._parameters[name] = nn.Parameter(
            param.new_empty((count,) + tuple(param.shape)))


def _get(module: nn.Module, dotted: str) -> torch.Tensor:
  for part in dotted.split("."):
    module = getattr(module, part)
  return module


class PipelinedCausalTransformer(nn.Module):
  """Embedding + positions + (depth / num_stages blocks) × num_stages +
  final LN: [B, T, F] → [B, T, width] f32, as `CausalTransformer`.

  With `mesh` carrying a `stage` axis of exactly `num_stages` ranks this
  rank's trunk holds stage `mesh.axis_index("stage")` only. B (this
  rank's rows) must divide into `num_microbatches` there.
  """

  def __init__(self, in_features: int, width: int, depth: int,
               num_heads: int, max_len: int, num_stages: int,
               num_microbatches: int = 2, remat: bool = False,
               attention_impl: str = "reference", mesh=None,
               dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    if width % num_heads:
      raise ValueError(
          f"width {width} must divide evenly into {num_heads} heads.")
    if num_stages < 1 or depth % num_stages:
      raise ValueError(
          f"depth {depth} must split into num_stages={num_stages} equal "
          "shape-preserving stages.")
    if attention_impl in ("ring", "ring_flash"):
      raise ValueError(
          "attention_impl='ring'/'ring_flash' (sequence parallelism) "
          "cannot run inside pipeline stages; use 'flash', 'reference', "
          "or 'auto' for the pipelined trunk.")
    self.max_len = max_len
    self.dtype = dtype
    self.num_stages = num_stages
    self.num_microbatches = num_microbatches
    self.remat = remat
    self.mesh = mesh if pipeline.is_pipelined(mesh) else None
    if self.mesh is not None and self.mesh.shape[STAGE_AXIS] != num_stages:
      raise ValueError(
          f"num_stages={num_stages} must equal the mesh's {STAGE_AXIS!r} "
          f"axis size {self.mesh.shape[STAGE_AXIS]}.")
    # The stages this trunk holds: all of them, or this rank's one.
    self.first_stage = (self.mesh.axis_index(STAGE_AXIS)
                        if self.mesh is not None else 0)
    self.local_stages = 1 if self.mesh is not None else num_stages
    self.embed = nn.Linear(in_features, width)
    self.positions = nn.Parameter(torch.zeros(max_len, width))
    self.stages = _StageBlocks(width, depth // num_stages, num_heads,
                               width // num_heads, attention_impl, dtype)
    self._stage_shapes: Dict[str, Tuple[int, ...]] = {
        name: tuple(p.shape) for name, p in self.stages.named_parameters()}
    _stack_parameters(self.stages, self.local_stages)
    self.ln_out = LayerNorm(width, dtype)

  def init_raw_parameters(self, generator: torch.Generator) -> None:
    """flax's initializers: the position table normal(0.02); each stage
    (all S drawn, stage-major, whatever this trunk holds) lecun-normal
    Linear kernels, zero biases, unit LayerNorm scales. A stage rank
    keeps its stage's draws, so its leaves equal that stage's slice of
    the one-device init."""
    modules = dict(self.stages.named_modules())
    with torch.no_grad():
      self.positions.normal_(0.0, 0.02, generator=generator)
      for stage in range(self.num_stages):
        keep = stage - self.first_stage
        for name, shape in self._stage_shapes.items():
          module_path, _, leaf = name.rpartition(".")
          module = modules[module_path]
          if isinstance(module, nn.Linear) and leaf == "weight":
            fan_in = int(math.prod(shape[1:]))
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            value = torch.empty(shape)
            nn.init.trunc_normal_(value, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
          elif leaf == "weight":
            value = torch.ones(shape)
          else:
            value = torch.zeros(shape)
          if 0 <= keep < self.local_stages:
            _get(self.stages, name)[keep].copy_(value)

  def stage_params(self) -> Dict[str, torch.Tensor]:
    """{name under `stages`: stacked leaf} as the module holds them now
    (the substituted tensors under `functional_call`)."""
    return {name: _get(self.stages, name) for name in self._stage_shapes}

  def _apply_stage(self, params: Dict[str, torch.Tensor],
                   h: torch.Tensor) -> torch.Tensor:
    return torch.func.functional_call(self.stages, params, (h,),
                                      strict=True)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    t = x.shape[1]
    if t > self.max_len:
      raise ValueError(f"sequence length {t} > max_len {self.max_len}")
    x = dense(self.embed, x, self.dtype)
    x = x + self.positions[:t].to(self.dtype)[None]
    x = pipeline.pipeline_apply(
        self._apply_stage, self.stage_params(), x, mesh=self.mesh,
        num_microbatches=self.num_microbatches, remat=self.remat)
    return self.ln_out(x).float()

