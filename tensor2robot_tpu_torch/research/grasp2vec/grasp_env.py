"""Synthetic grasping scenes for Grasp2Vec: collect + retrieval eval
(port of `research/grasp2vec/grasp_env.py`).

Scenes with grasping's causal structure: the postgrasp image is the
pregrasp image with exactly the target object removed, so embedding
arithmetic has real compositional signal to learn. The scene generator
is the JAX module's numpy code, draw for draw (`np.random.default_rng`
in the same order), so both packages render the same triplets bit for
bit; `collect_grasp_triplets` writes them through the port's TFRecord
writer (JPEG frames by the port's codec, TensorFlow's bytes).

Objects are distinct-colored square patches from a fixed palette;
distractor objects stay in place across pre/post so φ(pre) − φ(post)
must isolate the removed object, not the scene.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Tuple

import numpy as np

from tensor2robot_tpu_torch import config as gin

# Maximally-spread hues; index = object id.
_PALETTE = np.array([
    [220, 40, 40], [40, 200, 40], [60, 60, 230], [230, 210, 40],
    [210, 50, 210], [40, 210, 210], [240, 140, 30], [140, 70, 200],
    [120, 200, 120], [200, 120, 120], [90, 130, 220], [180, 180, 80],
], np.uint8)

NUM_OBJECT_TYPES = len(_PALETTE)


class GraspSceneGenerator:
  """Renders (pregrasp, postgrasp, goal) triplets with shared layout."""

  def __init__(self,
               image_size: int = 64,
               num_object_types: int = 6,
               num_distractors: int = 2,
               patch_fraction: float = 0.22,
               noise: float = 0.02,
               seed: int = 0):
    if num_object_types > NUM_OBJECT_TYPES:
      raise ValueError(
          f"num_object_types <= {NUM_OBJECT_TYPES} (palette size)")
    self._size = image_size
    self._num_types = num_object_types
    self._num_distractors = num_distractors
    self._patch = max(2, int(patch_fraction * image_size))
    self._noise = noise
    self._rng = np.random.default_rng(seed)

  def _background(self) -> np.ndarray:
    size = self._size
    image = np.full((size, size, 3), 96, np.float64)
    image += self._rng.normal(0, 255 * self._noise, (size, size, 3))
    return image

  def _paint(self, image: np.ndarray, object_id: int,
             center: Tuple[int, int]) -> None:
    half = self._patch // 2
    cx, cy = center
    x0, x1 = max(0, cx - half), min(self._size, cx + half + 1)
    y0, y1 = max(0, cy - half), min(self._size, cy + half + 1)
    image[y0:y1, x0:x1] = _PALETTE[object_id]

  def _random_center(self) -> Tuple[int, int]:
    half = self._patch // 2
    lo, hi = half, self._size - half - 1
    return (int(self._rng.integers(lo, hi + 1)),
            int(self._rng.integers(lo, hi + 1)))

  def sample(self) -> Dict[str, np.ndarray]:
    """One triplet: {pregrasp_image, postgrasp_image, goal_image,
    object_id, target_center}."""
    target = int(self._rng.integers(self._num_types))
    distractors = [
        int(t) for t in self._rng.choice(
            [t for t in range(self._num_types) if t != target],
            size=min(self._num_distractors, self._num_types - 1),
            replace=False)
    ] if self._num_types > 1 and self._num_distractors > 0 else []

    base = self._background()
    post = base.copy()
    placed = []
    for obj in distractors:
      center = self._random_center()
      placed.append((obj, center))
    target_center = self._random_center()

    pre = base.copy()
    for obj, center in placed:
      self._paint(pre, obj, center)
      self._paint(post, obj, center)
    self._paint(pre, target, target_center)  # target only in pregrasp

    goal = np.full((self._size, self._size, 3), 20, np.float64)
    goal += self._rng.normal(0, 255 * self._noise,
                             (self._size, self._size, 3))
    self._paint(goal, target, (self._size // 2, self._size // 2))

    clip = lambda x: np.clip(x, 0, 255).astype(np.uint8)
    return {
        "pregrasp_image": clip(pre),
        "postgrasp_image": clip(post),
        "goal_image": clip(goal),
        "object_id": np.int64(target),
        "target_center": np.array(target_center, np.int64),
    }

  def goal_gallery(self) -> np.ndarray:
    """One canonical goal image per object type: (K, S, S, 3) uint8."""
    images = []
    for obj in range(self._num_types):
      goal = np.full((self._size, self._size, 3), 20, np.float64)
      self._paint(goal, obj, (self._size // 2, self._size // 2))
      images.append(np.clip(goal, 0, 255).astype(np.uint8))
    return np.stack(images)


@gin.configurable
def collect_grasp_triplets(
    output_path: str,
    num_episodes: int = 256,
    image_size: int = 64,
    num_object_types: int = 6,
    num_distractors: int = 2,
    seed: int = 0,
) -> str:
  """Writes spec-conforming TFRecords of grasping triplets."""
  from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
  from tensor2robot_tpu_torch.data.tfrecord_input_generator import (
      write_tfrecord,
  )
  from tensor2robot_tpu_torch.research.grasp2vec.grasp2vec_model import (
      Grasp2VecModel,
  )

  gen = GraspSceneGenerator(
      image_size=image_size, num_object_types=num_object_types,
      num_distractors=num_distractors, seed=seed)
  model = Grasp2VecModel(image_size=image_size)
  examples = []
  for _ in range(num_episodes):
    triplet = gen.sample()
    examples.append({k: triplet[k] for k in
                     ("pregrasp_image", "postgrasp_image", "goal_image",
                      "object_id")})
  os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
  write_tfrecord(
      output_path, examples,
      model.get_feature_specification(Mode.TRAIN),
      model.get_label_specification(Mode.TRAIN))
  return output_path


@gin.configurable
def evaluate_retrieval(
    predict_fn: Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]],
    num_queries: int = 50,
    image_size: int = 64,
    num_object_types: int = 6,
    num_distractors: int = 2,
    seed: int = 1,
    batch_size: int = 16,
) -> Dict[str, float]:
  """Goal-conditioned retrieval: does φ(pre)−φ(post) find its object?

  Embeds a K-image goal gallery with ψ, then for `num_queries` held-out
  scene pairs retrieves argmax_k <φ(pre)−φ(post), ψ(gallery_k)>.
  Returns top-1 accuracy (chance = 1/K) and the mean matched-goal
  cosine similarity.
  """
  from tensor2robot_tpu_torch.research.grasp2vec.grasp2vec_model import (
      GOAL_EMBEDDING,
      POSTGRASP_EMBEDDING,
      PREGRASP_EMBEDDING,
  )

  gen = GraspSceneGenerator(
      image_size=image_size, num_object_types=num_object_types,
      num_distractors=num_distractors, seed=seed)
  gallery_images = gen.goal_gallery()
  k = gallery_images.shape[0]
  # ψ over the gallery: scene inputs are dummies for this pass.
  dummy_scene = np.zeros_like(gallery_images)
  out = predict_fn({
      "pregrasp_image": dummy_scene,
      "postgrasp_image": dummy_scene,
      "goal_image": gallery_images,
  })
  gallery = np.asarray(out[GOAL_EMBEDDING], np.float32)  # (K, D)

  correct = 0
  sims: List[float] = []
  for start in range(0, num_queries, batch_size):
    triplets = [gen.sample()
                for _ in range(min(batch_size, num_queries - start))]
    batch = {
        key: np.stack([t[key] for t in triplets])
        for key in ("pregrasp_image", "postgrasp_image", "goal_image")
    }
    out = predict_fn(batch)
    diff = (np.asarray(out[PREGRASP_EMBEDDING], np.float32)
            - np.asarray(out[POSTGRASP_EMBEDDING], np.float32))
    scores = diff @ gallery.T  # (B, K)
    picks = scores.argmax(axis=1)
    for t, pick, row, d in zip(triplets, picks, scores, diff):
      target = int(t["object_id"])
      correct += int(pick == target)
      denom = (np.linalg.norm(d) *
               np.linalg.norm(gallery[target])) or 1.0
      sims.append(float(row[target] / denom))
  return {
      "retrieval_top1": correct / float(num_queries),
      "chance_top1": 1.0 / k,
      "matched_goal_cosine": float(np.mean(sims)),
      "num_queries": float(num_queries),
  }
