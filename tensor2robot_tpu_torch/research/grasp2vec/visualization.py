"""Goal localization heatmaps from Grasp2Vec embeddings (port of
`research/grasp2vec/visualization.py`): the goal embedding ψ(goal)
correlated against the scene tower's pre-pool map."""

from __future__ import annotations

from typing import Tuple

import torch


def goal_localization_heatmap(
    scene_spatial: torch.Tensor,
    goal_embedding: torch.Tensor,
    temperature: float = 1.0,
) -> torch.Tensor:
  """(B, H, W, D) scene features and (B, D) goal embeddings → (B, H, W)
  softmax heatmaps (each sums to 1), in f32; a lower `temperature`
  sharpens the peaks."""
  scene = scene_spatial.float()
  goal = goal_embedding.float()
  scores = torch.einsum("bhwd,bd->bhw", scene, goal)
  b, h, w = scores.shape
  flat = scores.reshape(b, h * w) / max(float(temperature), 1e-6)
  return torch.softmax(flat, dim=-1).reshape(b, h, w)


def heatmap_argmax(heatmap: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Peak (row, col) per heatmap (the first of tied maxima)."""
  b, h, w = heatmap.shape
  idx = heatmap.reshape(b, h * w).argmax(dim=-1)
  return idx // w, idx % w
