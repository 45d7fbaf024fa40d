"""Grasp2Vec metric-learning losses and retrieval metrics (port of
`research/grasp2vec/losses.py`).

The N-pairs loss is one (B, B) similarity product and a softmax per
direction, in f32. Duplicate object ids in a batch are multi-label
targets (each row's matches share its probability mass), as in the JAX
package. Retrieval top-1 takes the first of tied maxima, as
`jnp.argmax` does (`torch.argmax` documents the same).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def npairs_loss(
    anchor: torch.Tensor,
    positive: torch.Tensor,
    object_ids: Optional[torch.Tensor] = None,
    reg_lambda: float = 0.002,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  """Symmetric N-pairs loss between two (B, D) embedding sets: `anchor[i]`
  should score highest against `positive[i]` (and every row sharing its
  `object_ids` entry), and vice versa. Returns (loss, metrics) with the
  cross-entropy, the L2 regularizer and in-batch retrieval top-1."""
  anchor = anchor.float()
  positive = positive.float()
  logits = anchor @ positive.t()
  batch = anchor.shape[0]
  if object_ids is None:
    same = torch.eye(batch, dtype=torch.float32, device=anchor.device)
  else:
    ids = object_ids.reshape(-1)
    same = (ids[:, None] == ids[None, :]).float()
  targets = same / same.sum(dim=1, keepdim=True).clamp_min(1.0)

  def directional(lg):
    log_probs = torch.log_softmax(lg, dim=1)
    return -(targets * log_probs).sum(dim=1).mean()

  xent = 0.5 * (directional(logits) + directional(logits.t()))
  reg = reg_lambda * 0.5 * (anchor.square().sum(dim=1).mean()
                            + positive.square().sum(dim=1).mean())
  loss = xent + reg
  top1 = logits.argmax(dim=1)
  correct = same.gather(1, top1[:, None])[:, 0]
  metrics = {
      "npairs_xent": xent,
      "embedding_reg": reg,
      "retrieval_top1": correct.mean(),
  }
  return loss, metrics


def cosine_similarity(a: torch.Tensor, b: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
  """Row-wise cosine similarity between two (B, D) tensors, in f32."""
  a = a.float()
  b = b.float()
  num = (a * b).sum(dim=-1)
  den = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(
      b, dim=-1)
  return num / den.clamp_min(eps)


def goal_similarity_reward(
    pregrasp_embedding: torch.Tensor,
    postgrasp_embedding: torch.Tensor,
    goal_embedding: torch.Tensor,
) -> torch.Tensor:
  """Self-supervised grasp reward: cos(φ(pre) − φ(post), ψ(goal))."""
  return cosine_similarity(pregrasp_embedding - postgrasp_embedding,
                           goal_embedding)
