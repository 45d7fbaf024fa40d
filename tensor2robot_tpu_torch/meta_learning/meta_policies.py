"""Demonstration-conditioned serving policies over meta models (port
of `meta_learning/meta_policies.py`).

The on-robot wrapper around a meta model's predictor: hold the current
task's demonstrations, assemble each control step's meta feature batch
(condition split = demos, inference split = the live observation), call
the predictor, hand back the adapted prediction. It serves both
adaptation mechanisms the port ships, gradient adaptation (MAML) and
in-context conditioning (SNAIL), over the layout the MAML preprocessor
defines:

  condition/<feature keys>        [B_tasks, N_cond, ...]
  inference/<feature keys>        [B_tasks, N_inf, ...]
  condition_labels/<label keys>   [B_tasks, N_cond, ...]   (demos)
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np

from tensor2robot_tpu_torch.meta_learning.maml_model import (
    CONDITION,
    CONDITION_LABELS,
    INFERENCE,
)

log = logging.getLogger(__name__)


def _fit_to(array: np.ndarray, n: int) -> np.ndarray:
  """Cycles/truncates the leading (sample) dim to exactly n entries.

  Robots rarely record exactly the meta-trained demos-per-task count;
  cycling preserves every demonstration's influence, truncation keeps
  the earliest n (deterministic either way).
  """
  array = np.asarray(array)
  if array.shape[0] == n:
    return array
  if array.shape[0] > n:
    return array[:n]
  reps = -(-n // array.shape[0])  # ceil
  return np.concatenate([array] * reps, axis=0)[:n]


class MetaPolicy:
  """Holds a task's demonstrations; serves adapted predictions.

  Usage (one task episode):
      policy = MetaPolicy(predictor)
      policy.set_task(demo_features, demo_labels)   # condition data
      out = policy.predict(observation)             # adapted
      policy.reset_task()                           # back to zero-shot

  `demo_features` / `demo_labels`: flat dicts of [N_demos, ...] arrays
  keyed by the BASE model's feature/label keys. `observation`: a flat
  dict of single (unbatched) base feature arrays.

  Zero-shot (no demonstrations) requires a predictor whose serving path
  treats condition labels as optional, as `CheckpointPredictor` does; an
  exported program takes fixed inputs, so exported serving
  (`SavedModelPredictor`) always conditions (`set_task` first).
  """

  def __init__(self, predictor):
    self._predictor = predictor
    flat = predictor.get_feature_specification().to_flat_dict()
    self._condition_keys = sorted(
        k[len(CONDITION) + 1:] for k in flat
        if k.startswith(CONDITION + "/"))
    self._inference_keys = sorted(
        k[len(INFERENCE) + 1:] for k in flat
        if k.startswith(INFERENCE + "/"))
    self._label_keys = sorted(
        k[len(CONDITION_LABELS) + 1:] for k in flat
        if k.startswith(CONDITION_LABELS + "/"))
    if not self._condition_keys or not self._inference_keys:
      raise ValueError(
          "Predictor does not serve a meta model: feature spec has no "
          f"{CONDITION}/ + {INFERENCE}/ splits: {sorted(flat)}")
    self._num_condition = flat[
        f"{CONDITION}/{self._condition_keys[0]}"].shape[0]
    self._num_inference = flat[
        f"{INFERENCE}/{self._inference_keys[0]}"].shape[0]
    self._demo_features: Optional[Dict[str, np.ndarray]] = None
    self._demo_labels: Optional[Dict[str, np.ndarray]] = None

  @property
  def num_condition(self) -> int:
    return self._num_condition

  @property
  def num_inference(self) -> int:
    return self._num_inference

  @property
  def task_is_set(self) -> bool:
    return self._demo_features is not None

  def set_task(self,
               demo_features: Dict[str, np.ndarray],
               demo_labels: Optional[Dict[str, np.ndarray]] = None
               ) -> None:
    """Stores the current task's demonstrations (condition data)."""
    missing = set(self._condition_keys) - set(demo_features)
    if missing:
      raise ValueError(f"demo_features missing keys: {sorted(missing)}")
    self._demo_features = {
        k: _fit_to(demo_features[k], self._num_condition)
        for k in self._condition_keys}
    if demo_labels is not None:
      missing = set(self._label_keys) - set(demo_labels)
      if missing:
        raise ValueError(f"demo_labels missing keys: {sorted(missing)}")
      self._demo_labels = {
          k: _fit_to(demo_labels[k], self._num_condition)
          for k in self._label_keys}
    else:
      self._demo_labels = None

  def reset_task(self) -> None:
    """Clears demonstrations: subsequent predictions are zero-shot."""
    self._demo_features = None
    self._demo_labels = None

  def predict(self, observation: Dict[str, np.ndarray]
              ) -> Dict[str, Any]:
    """One adapted prediction for a single observation.

    Assembles the meta feature batch (task dim 1), runs the predictor,
    and returns the LAST inference slot of every output, unbatched —
    every slot holds the same live observation, and for causal
    in-context models the last slot attends to the most context.
    """
    missing = set(self._inference_keys) - set(observation)
    if missing:
      raise ValueError(f"observation missing keys: {sorted(missing)}")
    obs = {k: np.asarray(observation[k]) for k in self._inference_keys}

    features: Dict[str, np.ndarray] = {}
    for key in self._inference_keys:
      tiled = np.broadcast_to(
          obs[key][None], (self._num_inference,) + obs[key].shape)
      features[f"{INFERENCE}/{key}"] = np.ascontiguousarray(
          tiled)[None]
    if self.task_is_set:
      for key in self._condition_keys:
        features[f"{CONDITION}/{key}"] = self._demo_features[key][None]
      if self._demo_labels is not None:
        for key in self._label_keys:
          features[f"{CONDITION_LABELS}/{key}"] = \
              self._demo_labels[key][None]
    else:
      # Zero-shot: the condition slots still need tensors (the specs
      # are required); the live observation stands in, and with no
      # condition_labels the model skips adaptation.
      log.debug("MetaPolicy.predict with no task set: zero-shot.")
      for key in self._condition_keys:
        tiled = np.broadcast_to(
            obs[key][None], (self._num_condition,) + obs[key].shape)
        features[f"{CONDITION}/{key}"] = np.ascontiguousarray(
            tiled)[None]

    outputs = self._predictor.predict(features)
    result: Dict[str, Any] = {}
    for key, value in outputs.items():
      value = np.asarray(value)
      # [1 task, N_inf, ...] -> last inference slot; anything else
      # (per-task scalars etc.) just drops the task dim.
      if value.ndim >= 2 and value.shape[:1] == (1,):
        value = value[0]
        if value.ndim >= 1 and value.shape[0] == self._num_inference:
          value = value[-1]
      result[key] = value
    return result

  __call__ = predict
