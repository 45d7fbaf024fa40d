"""Ring attention (port of `parallel/ring_attention.py`).

Only `attention_reference`, the materialized exactness oracle, is
ported; the ring itself (sequence parallelism over a device mesh)
waits for ROADMAP A11.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30  # finite sentinel, as in the JAX package


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
  """Plain softmax attention in f32: q, k, v [B, T, H, D] → [B, T, H, D]
  in q's dtype. The probabilities stay f32 (no rounding to v's dtype)."""
  scale = 1.0 / math.sqrt(q.shape[-1])
  s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
  if causal:
    t = q.shape[1]
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, _NEG_INF)
  p = torch.softmax(s, dim=-1)
  out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
  return out.to(q.dtype)
