"""SNAIL building blocks: causal temporal convolutions and attention
(port of `layers/snail.py`).

Layout is the JAX module's at every public call: (B, T, C). A causal
conv pads the time axis on the left by `dilation · (k − 1)` and runs
`conv1d` over NCW (flax's NWC kernel ``[k, in, out]`` is torch's
``[out, in, k]``, `models/convert.py`). The attention is plain torch
ops, as the JAX block is plain XLA: logits in the compute dtype, cast to
f32 before the causal mask (−1e30, not −inf) and the softmax, the
weights cast back before `@ V`. Each concat promotes as
`jnp.concatenate` does (`torch.cat`'s type promotion). Parameter names
are flax's (``attn_0.query``, ``tc_0.dense_1.gate.Conv_0``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.core import dense

_MASK_VALUE = -1e30


def num_tc_layers(seq_len: int) -> int:
  """DenseBlocks in a TCBlock: dilations 1, 2, 4, ... covering seq_len."""
  return max(1, int(math.ceil(math.log2(max(seq_len, 2)))))


class CausalConv1D(nn.Module):
  """Dilated causal 1D conv over (B, T, C) via left-padding."""

  def __init__(self, in_channels: int, features: int, kernel_size: int = 2,
               dilation: int = 1, dtype: torch.dtype = torch.float32):
    super().__init__()
    self.kernel_size = kernel_size
    self.dilation = dilation
    self.dtype = dtype
    self.Conv_0 = nn.Conv1d(in_channels, features, kernel_size,
                            dilation=dilation)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    pad = self.dilation * (self.kernel_size - 1)
    xt = F.pad(x.to(self.dtype).transpose(1, 2), (pad, 0))
    y = F.conv1d(xt, self.Conv_0.weight.to(self.dtype),
                 dilation=self.dilation)
    y = y + self.Conv_0.bias.to(self.dtype)[:, None]
    return y.transpose(1, 2)


class DenseBlock(nn.Module):
  """Gated activation causal conv whose output concats onto the input."""

  def __init__(self, in_channels: int, filters: int, dilation: int,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.filter = CausalConv1D(in_channels, filters, dilation=dilation,
                               dtype=dtype)
    self.gate = CausalConv1D(in_channels, filters, dilation=dilation,
                             dtype=dtype)
    self.out_channels = in_channels + filters

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    activations = torch.tanh(self.filter(x)) * torch.sigmoid(self.gate(x))
    return torch.cat([x, activations], dim=-1)


class TCBlock(nn.Module):
  """Stack of DenseBlocks with dilations 1, 2, 4, ... covering seq_len."""

  def __init__(self, in_channels: int, seq_len: int, filters: int,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.num_layers = num_tc_layers(seq_len)
    channels = in_channels
    for i in range(self.num_layers):
      self.add_module(f"dense_{i}", DenseBlock(channels, filters, 2 ** i,
                                               dtype=dtype))
      channels += filters
    self.out_channels = channels

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i in range(self.num_layers):
      x = getattr(self, f"dense_{i}")(x)
    return x


class AttentionBlock(nn.Module):
  """Single-head causal attention whose output concats onto the input."""

  def __init__(self, in_channels: int, key_size: int, value_size: int,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.key_size = key_size
    self.dtype = dtype
    self.query = nn.Linear(in_channels, key_size)
    self.key = nn.Linear(in_channels, key_size)
    self.value = nn.Linear(in_channels, value_size)
    self.out_channels = in_channels + value_size

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    t = x.shape[1]
    q = dense(self.query, x, self.dtype)
    k = dense(self.key, x, self.dtype)
    v = dense(self.value, x, self.dtype)
    logits = torch.einsum("btk,bsk->bts", q, k) / math.sqrt(self.key_size)
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    logits = torch.where(mask[None], logits.float(),
                         torch.full((), _MASK_VALUE, device=x.device))
    weights = torch.softmax(logits, dim=-1).to(self.dtype)
    out = torch.einsum("bts,bsv->btv", weights, v)
    return torch.cat([x, out.to(x.dtype)], dim=-1)


class SNAIL(nn.Module):
  """The canonical SNAIL trunk: attn -> TC -> attn -> TC -> attn -> proj.

  (B, T, in_channels) -> (B, T, out_channels) f32."""

  def __init__(self, in_channels: int, seq_len: int, filters: int = 32,
               key_size: int = 64, value_size: int = 32,
               output_size: Optional[int] = None,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    self.attn_0 = AttentionBlock(in_channels, key_size, value_size, dtype)
    self.tc_0 = TCBlock(self.attn_0.out_channels, seq_len, filters, dtype)
    self.attn_1 = AttentionBlock(self.tc_0.out_channels, key_size,
                                 value_size, dtype)
    self.tc_1 = TCBlock(self.attn_1.out_channels, seq_len, filters, dtype)
    self.attn_2 = AttentionBlock(self.tc_1.out_channels, key_size,
                                 value_size, dtype)
    channels = self.attn_2.out_channels
    self.proj = None
    if output_size is not None:
      self.proj = nn.Linear(channels, output_size)
      channels = output_size
    self.out_channels = channels

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = self.attn_0(x)
    x = self.tc_0(x)
    x = self.attn_1(x)
    x = self.tc_1(x)
    x = self.attn_2(x)
    if self.proj is not None:
      x = dense(self.proj, x, self.dtype)
    return x.float()
