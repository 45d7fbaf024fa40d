"""Causal transformer trunk (port of `layers/transformer.py`).

Causal self-attention only (the one use so far). Attention backends
behind `attention_impl`, all EXACT attention, so a checkpoint serves
under any of them:

  * "reference": materialized f32 softmax attention
    (`parallel.attention_reference`);
  * "flash": the flash wrapper (`ops.flash_attention`): the CUDA kernel
    on a CUDA tensor, its plain version on a CPU tensor;
  * "auto": flash on a CUDA tensor, reference on the CPU (the JAX rule
    is "flash on TPU");
  * "ring" / "ring_flash" and MoE blocks wait for ROADMAP A11.

Numerics follow flax: parameters are f32 masters cast to the compute
dtype per layer; LayerNorm takes its statistics in f32 with eps 1e-6
and returns the compute dtype; `nn.gelu` is the tanh approximation;
the residual stream stays in the compute dtype and the final LayerNorm
output goes to f32. Module names mirror flax's (``block0.attn.qkv``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.core import dense
from tensor2robot_tpu_torch.ops.flash_attention import flash_attention
from tensor2robot_tpu_torch.parallel.ring_attention import (
    attention_reference,
)

_LN_EPS = 1e-6  # flax nn.LayerNorm default (torch's is 1e-5)
_IMPLS = ("auto", "flash", "reference")


def _attend(q, k, v, *, impl: str) -> torch.Tensor:
  """Causal [B, T, H, D] attention on the chosen backend (`impl` was
  checked by `MultiHeadAttention`)."""
  if impl == "auto":
    impl = "flash" if q.device.type == "cuda" else "reference"
  if impl == "flash":
    return flash_attention(q, k, v, causal=True)
  return attention_reference(q, k, v, causal=True)


class LayerNorm(nn.Module):
  """flax `nn.LayerNorm(dtype=dtype)` over the last axis.

  mean = E[x], var = max(E[x²] − E[x]², 0) in f32 (flax's fast
  variance), y = (x − mean)·(rsqrt(var + 1e-6)·weight) + bias in f32,
  cast to `dtype`. flax's ``scale`` is torch's ``weight``.
  """

  def __init__(self, features: int, dtype: torch.dtype):
    super().__init__()
    self.dtype = dtype
    self.weight = nn.Parameter(torch.ones(features))
    self.bias = nn.Parameter(torch.zeros(features))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + _LN_EPS) * self.weight
    return ((x - mean) * mul + self.bias).to(self.dtype)


class MultiHeadAttention(nn.Module):
  """QKV projection (no bias) → exact causal attention → output
  projection."""

  def __init__(self, width: int, num_heads: int, head_dim: int,
               attention_impl: str = "reference",
               dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    if attention_impl in ("ring", "ring_flash"):
      raise NotImplementedError(
          f"attention_impl={attention_impl!r}: ring attention is not "
          "ported yet (ROADMAP A11).")
    if attention_impl not in _IMPLS:
      raise ValueError(f"Unknown attention impl: {attention_impl!r}")
    self.num_heads = num_heads
    self.head_dim = head_dim
    self.attention_impl = attention_impl
    self.dtype = dtype
    self.qkv = nn.Linear(width, 3 * num_heads * head_dim, bias=False)
    self.proj = nn.Linear(num_heads * head_dim, width)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b, t, _ = x.shape
    h, d = self.num_heads, self.head_dim
    qkv = dense(self.qkv, x, self.dtype)
    # reshape(b, t, 3h, d) then split on axis 2: q is the first h·d
    # output columns, k the next, v the last. The splits are strided
    # views the flash kernel reads in place.
    q, k, v = qkv.reshape(b, t, 3 * h, d).split(h, dim=2)
    out = _attend(q, k, v, impl=self.attention_impl)
    return dense(self.proj, out.reshape(b, t, h * d), self.dtype)


class TransformerBlock(nn.Module):
  """Pre-LN block: x + MHA(LN(x)); x + MLP(LN(x)), a 4×-wide tanh-gelu
  MLP (flax's default `mlp_ratio`)."""

  def __init__(self, width: int, num_heads: int, head_dim: int,
               attention_impl: str = "reference",
               dtype: torch.dtype = torch.bfloat16, moe_experts: int = 0):
    super().__init__()
    if moe_experts:
      raise NotImplementedError(
          f"moe_experts={moe_experts}: MoE blocks are not ported yet "
          "(ROADMAP A11).")
    self.dtype = dtype
    self.ln_attn = LayerNorm(width, dtype)
    self.attn = MultiHeadAttention(width, num_heads, head_dim,
                                   attention_impl=attention_impl,
                                   dtype=dtype)
    self.ln_mlp = LayerNorm(width, dtype)
    self.mlp_in = nn.Linear(width, width * 4)
    self.mlp_out = nn.Linear(width * 4, width)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = x + self.attn(self.ln_attn(x))
    y = dense(self.mlp_in, self.ln_mlp(x), self.dtype)
    y = F.gelu(y, approximate="tanh")
    return x + dense(self.mlp_out, y, self.dtype)


class CausalTransformer(nn.Module):
  """Embedding + learned positions + `depth` blocks + final LN.

  [B, T, F] per-step features → [B, T, width] f32. Torch needs the
  input width `in_features` up front.
  """

  def __init__(self, in_features: int, width: int, depth: int,
               num_heads: int, max_len: int,
               attention_impl: str = "reference",
               dtype: torch.dtype = torch.bfloat16, moe_experts: int = 0):
    super().__init__()
    if width % num_heads:
      raise ValueError(
          f"width {width} must divide evenly into {num_heads} heads (got "
          f"remainder {width % num_heads}); attention would silently run "
          "at reduced capacity otherwise.")
    self.max_len = max_len
    self.dtype = dtype
    self.embed = nn.Linear(in_features, width)
    self.positions = nn.Parameter(torch.zeros(max_len, width))
    for i in range(depth):
      self.add_module(f"block{i}", TransformerBlock(
          width, num_heads, width // num_heads,
          attention_impl=attention_impl, dtype=dtype,
          moe_experts=moe_experts))
    self.depth = depth
    self.ln_out = LayerNorm(width, dtype)

  def init_raw_parameters(self, generator: torch.Generator) -> None:
    """flax `nn.initializers.normal(0.02)` for the position table."""
    with torch.no_grad():
      self.positions.normal_(0.0, 0.02, generator=generator)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    t = x.shape[1]
    if t > self.max_len:
      raise ValueError(f"sequence length {t} > max_len {self.max_len}")
    x = dense(self.embed, x, self.dtype)
    x = x + self.positions[:t].to(self.dtype)[None]
    for i in range(self.depth):
      x = getattr(self, f"block{i}")(x)
    return self.ln_out(x).float()
