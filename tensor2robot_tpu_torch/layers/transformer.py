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
  * "ring": sequence parallelism over the `mesh`'s `seq` ranks
    (`parallel.ring_attention`; requires `mesh`): flash blocks on a CUDA
    tensor, as JAX's ring runs them on a TPU, reference blocks on the
    CPU; the layer's rows are already the rank's data rows, so only the
    time axis splits;
  * "ring_flash": the ring with flash blocks forced (the plain flash
    version on the CPU).

MoE blocks (`moe_experts > 0`): every `moe_every`-th block, counted from
1, swaps its dense MLP for a `parallel.moe.MoEMLP` of that many routed
experts, on one device. Each MoE block returns its load-balance loss
beside its output, and `CausalTransformer.forward(x, return_aux=True)`
returns their f32 sum (None for a trunk without MoE), so the loss
reaches the model through return values, as flax's sown collection
reaches `collect_aux_losses`.

Numerics follow flax: parameters are f32 masters cast to the compute
dtype per layer; LayerNorm takes its statistics in f32 with eps 1e-6
and returns the compute dtype; `nn.gelu` is the tanh approximation;
the residual stream stays in the compute dtype and the final LayerNorm
output goes to f32. Module names mirror flax's (``block0.attn.qkv``).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.core import dense
from tensor2robot_tpu_torch.ops.flash_attention import (
    flash_attention,
    load_libraries as load_flash_libraries,
)
from tensor2robot_tpu_torch.parallel.moe import MoEMLP, collect_aux_losses
from tensor2robot_tpu_torch.parallel.ring_attention import (
    attention_reference,
    ring_attention,
)
from tensor2robot_tpu_torch.utils import profiling

_LN_EPS = 1e-6  # flax nn.LayerNorm default (torch's is 1e-5)
_IMPLS = ("auto", "flash", "reference", "ring", "ring_flash")


def _counted(q, k, v, count) -> torch.Tensor:
  """Under `utils.profiling.counting_attention`: the call's analytic
  FLOPs go to `count` (the backward's when it runs), and a stand-in
  without products stands for the output, with gradients to q, k and
  v."""
  b, t, h, d = q.shape
  forward = profiling.analytic_flops("attention", b=b, heads=h, d=d, t=t,
                                     causal=True)
  count.flops += forward
  out = q + k + v
  if out.requires_grad:

    def on_backward(grad):
      count.flops += profiling.ATTENTION_BACKWARD_FACTOR * forward

    out.register_hook(on_backward)
  return out


def _attend(q, k, v, *, impl: str, mesh=None) -> torch.Tensor:
  """Causal [B, T, H, D] attention on the chosen backend (`impl` was
  checked by `MultiHeadAttention`)."""
  count = profiling.attention_count()
  if count is not None:
    return _counted(q, k, v, count)
  on_card = q.device.type == "cuda"
  if impl == "auto":
    impl = "flash" if on_card else "reference"
  if impl == "flash":
    return flash_attention(q, k, v, causal=True)
  if impl in ("ring", "ring_flash"):
    if mesh is None:
      raise ValueError(
          f"attention_impl={impl!r} needs a device mesh with a "
          "'seq' axis; pass mesh= (models: the mesh constructor "
          "argument) or use 'flash'/'reference' single-device.")
    use_flash = on_card or impl == "ring_flash"
    return ring_attention(q, k, v, mesh=mesh, causal=True, shard_batch=False,
                          block_impl="flash" if use_flash else "reference")
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
  projection. `mesh`: the ring's mesh ("ring" / "ring_flash"); no
  parameters depend on it."""

  def __init__(self, width: int, num_heads: int, head_dim: int,
               attention_impl: str = "reference",
               dtype: torch.dtype = torch.bfloat16, mesh=None):
    super().__init__()
    if attention_impl not in _IMPLS:
      raise ValueError(f"Unknown attention impl: {attention_impl!r}")
    self.num_heads = num_heads
    self.head_dim = head_dim
    self.attention_impl = attention_impl
    self.mesh = mesh
    self.dtype = dtype
    self.qkv = nn.Linear(width, 3 * num_heads * head_dim, bias=False)
    self.proj = nn.Linear(num_heads * head_dim, width)

  def kernel_libraries(self, device: torch.device) -> Dict[str, Callable]:
    """{name: loader} of the kernel libraries this layer launches on
    `device` (a trainer's startup loads them before the first step)."""
    if device.type == "cuda" and self.attention_impl != "reference":
      return {"flash_attention": load_flash_libraries}
    return {}

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b, t, _ = x.shape
    h, d = self.num_heads, self.head_dim
    qkv = dense(self.qkv, x, self.dtype)
    # reshape(b, t, 3h, d) then split on axis 2: q is the first h·d
    # output columns, k the next, v the last. The splits are strided
    # views the flash kernel reads in place.
    q, k, v = qkv.reshape(b, t, 3 * h, d).split(h, dim=2)
    out = _attend(q, k, v, impl=self.attention_impl, mesh=self.mesh)
    return dense(self.proj, out.reshape(b, t, h * d), self.dtype)


class TransformerBlock(nn.Module):
  """Pre-LN block: x + MHA(LN(x)); x + MLP(LN(x)), a 4×-wide tanh-gelu
  MLP (flax's default `mlp_ratio`), or with `moe_experts` > 0 a MoE layer
  of that many experts of the same hidden width (module ``moe``).
  `forward` returns ``(x, aux)``: the MoE layer's load-balance loss, or
  None for a dense block."""

  def __init__(self, width: int, num_heads: int, head_dim: int,
               attention_impl: str = "reference",
               dtype: torch.dtype = torch.bfloat16, moe_experts: int = 0,
               moe_k: int = 2, moe_capacity_factor: float = 2.0,
               mesh=None):
    super().__init__()
    self.dtype = dtype
    self.ln_attn = LayerNorm(width, dtype)
    self.attn = MultiHeadAttention(width, num_heads, head_dim,
                                   attention_impl=attention_impl,
                                   dtype=dtype, mesh=mesh)
    self.ln_mlp = LayerNorm(width, dtype)
    if moe_experts:
      self.moe = MoEMLP(width, moe_experts, width * 4, k=moe_k,
                        capacity_factor=moe_capacity_factor, mesh=mesh,
                        dtype=dtype)
    else:
      self.mlp_in = nn.Linear(width, width * 4)
      self.mlp_out = nn.Linear(width * 4, width)

  def forward(self, x: torch.Tensor):
    x = x + self.attn(self.ln_attn(x))
    y = self.ln_mlp(x)
    if hasattr(self, "moe"):
      y, aux = self.moe(y)
      return x + y, aux
    y = F.gelu(dense(self.mlp_in, y, self.dtype), approximate="tanh")
    return x + dense(self.mlp_out, y, self.dtype), None


class CausalTransformer(nn.Module):
  """Embedding + learned positions + `depth` blocks + final LN.

  [B, T, F] per-step features → [B, T, width] f32. Torch needs the
  input width `in_features` up front. With `moe_experts` > 0, block i is
  a MoE block when ``(i + 1) % max(moe_every, 1) == 0`` (the GShard
  convention: every other block at `moe_every` 2).
  """

  def __init__(self, in_features: int, width: int, depth: int,
               num_heads: int, max_len: int,
               attention_impl: str = "reference",
               dtype: torch.dtype = torch.bfloat16, moe_experts: int = 0,
               moe_every: int = 2, moe_k: int = 2,
               moe_capacity_factor: float = 2.0, mesh=None):
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
      is_moe = moe_experts > 0 and (i + 1) % max(moe_every, 1) == 0
      self.add_module(f"block{i}", TransformerBlock(
          width, num_heads, width // num_heads,
          attention_impl=attention_impl, dtype=dtype,
          moe_experts=moe_experts if is_moe else 0, moe_k=moe_k,
          moe_capacity_factor=moe_capacity_factor, mesh=mesh))
    self.depth = depth
    self.ln_out = LayerNorm(width, dtype)

  def init_raw_parameters(self, generator: torch.Generator) -> None:
    """flax `nn.initializers.normal(0.02)` for the position table."""
    with torch.no_grad():
      self.positions.normal_(0.0, 0.02, generator=generator)

  def forward(self, x: torch.Tensor, return_aux: bool = False):
    """[B, T, width] f32, or with `return_aux` ``(that, aux)``: the sum
    of the MoE blocks' load-balance losses in flax's collection order
    (None without a MoE block)."""
    t = x.shape[1]
    if t > self.max_len:
      raise ValueError(f"sequence length {t} > max_len {self.max_len}")
    x = dense(self.embed, x, self.dtype)
    x = x + self.positions[:t].to(self.dtype)[None]
    losses = {}
    for i in range(self.depth):
      name = f"block{i}"
      x, aux = getattr(self, name)(x)
      if aux is not None:
        losses[name] = aux
    out = self.ln_out(x).float()
    if not return_aux:
      return out
    # flax collects the sown losses in its tree's (sorted key) order.
    aux = (collect_aux_losses(losses[name] for name in sorted(losses))
           if losses else None)
    return out, aux
