"""Meta-batch construction (port of `meta_learning/meta_data.py`).

Host-side numpy transforms, the JAX module's code: the meta-batch
layout is a reshape of a flat batch, so any input generator becomes a
meta generator by wrapping it, and the streams equal the JAX ones.
"""

from __future__ import annotations

import logging
from typing import Iterator, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.abstract_input_generator import (
    AbstractInputGenerator,
    Mode,
)
from tensor2robot_tpu_torch.data.tfexample import SEQUENCE_LENGTH_KEY
from tensor2robot_tpu_torch.meta_learning.maml_model import (
    CONDITION,
    INFERENCE,
)
from tensor2robot_tpu_torch.specs import TensorSpecStruct, as_sequence_specs

log = logging.getLogger(__name__)


def make_meta_batch(features: TensorSpecStruct,
                    labels: Optional[TensorSpecStruct],
                    num_condition: int,
                    num_inference: int
                    ) -> Tuple[TensorSpecStruct,
                               Optional[TensorSpecStruct]]:
  """Reshapes a flat batch [B, ...] into a meta batch.

  B must be divisible by (num_condition + num_inference); the result has
  B / (num_condition + num_inference) tasks. Consecutive samples are
  assigned to the same task (callers wanting task coherence should feed
  episode-grouped batches, as the reference's episode_to_transitions
  pipelines did).
  """
  per_task = num_condition + num_inference

  def nest(struct):
    if struct is None:
      return None
    flat = struct.to_flat_dict()
    out = {}
    for key, value in flat.items():
      batch = value.shape[0]
      if batch % per_task:
        raise ValueError(
            f"Batch {batch} not divisible by condition+inference = "
            f"{per_task} (key {key!r}).")
      tasks = value.reshape((batch // per_task, per_task) +
                            value.shape[1:])
      out[f"{CONDITION}/{key}"] = tasks[:, :num_condition]
      out[f"{INFERENCE}/{key}"] = tasks[:, num_condition:]
    return TensorSpecStruct.from_flat_dict(out)

  return nest(features), nest(labels)


def meta_batch_from_episodes(features: TensorSpecStruct,
                             labels: Optional[TensorSpecStruct],
                             num_condition: int,
                             num_inference: int,
                             context_keys: Tuple[str, ...] = (),
                             ) -> Tuple[TensorSpecStruct,
                                        Optional[TensorSpecStruct]]:
  """Episode batch [B, T, ...] → meta batch; each episode is one task.

  The first `num_condition` timesteps become the condition set, the
  next `num_inference` the inference set — the reference's episode
  semantics (demonstration prefix conditions, later steps evaluate).
  Episodes whose TRUE length (the parser's `sequence_length` feature,
  when present) is < num_condition + num_inference are DROPPED with a
  logged warning — zero-padded timesteps must never masquerade as data,
  and real ragged datasets shouldn't abort the iterator over one short
  episode. If every episode in the batch is too short, raises (that is
  a config error, not raggedness). Keys in `context_keys` are
  per-episode (no time axis); they are tiled across the per-task sample
  dim of both splits. The `sequence_length` key itself is consumed
  here, not forwarded.
  """
  need = num_condition + num_inference
  flat_f = features.to_flat_dict()
  true_lengths = flat_f.get(SEQUENCE_LENGTH_KEY)
  keep = None
  if true_lengths is not None:
    short = np.asarray(true_lengths) < need
    if np.all(short):
      raise ValueError(
          f"Every episode in the batch is shorter than condition+"
          f"inference = {need} (true lengths "
          f"{np.asarray(true_lengths).tolist()}); splitting them would "
          f"train on zero padding. Lower num_condition/num_inference or "
          f"collect longer episodes.")
    if np.any(short):
      log.warning(
          "Dropping %d/%d episode(s) shorter than condition+inference "
          "= %d (true lengths %s).", int(short.sum()), short.size, need,
          np.asarray(true_lengths)[short].tolist())
      keep = ~short

  def nest(struct):
    if struct is None:
      return None
    out = {}
    for key, value in struct.to_flat_dict().items():
      if key == SEQUENCE_LENGTH_KEY:
        continue
      if keep is not None:
        value = value[keep]
      if key in context_keys:
        cond = np.repeat(value[:, None], num_condition, axis=1)
        inf = np.repeat(value[:, None], num_inference, axis=1)
        out[f"{CONDITION}/{key}"] = cond
        out[f"{INFERENCE}/{key}"] = inf
        continue
      if value.ndim < 2 or value.shape[1] < need:
        raise ValueError(
            f"Episode key {key!r} has shape {value.shape}; need a time "
            f"axis of at least condition+inference = {need}. Per-episode "
            f"(non-sequence) keys must be listed in context_keys.")
      out[f"{CONDITION}/{key}"] = value[:, :num_condition]
      out[f"{INFERENCE}/{key}"] = value[:, num_condition:need]
    return TensorSpecStruct.from_flat_dict(out)

  return nest(features), nest(labels)


@gin.configurable
class EpisodeMetaInputGenerator(AbstractInputGenerator):
  """Turns an episode generator's [B, T, ...] batches into meta batches.

  Each episode is a task; its timestep prefix conditions the inner
  loop.
  `batch_size` counts TASKS (= episodes).
  """

  def __init__(self,
               episode_generator: AbstractInputGenerator,
               num_condition_samples_per_task: int = 4,
               num_inference_samples_per_task: int = 4,
               batch_size: int = 8):
    super().__init__(batch_size=batch_size)
    self._episodes = episode_generator
    self._num_condition = num_condition_samples_per_task
    self._num_inference = num_inference_samples_per_task

  def set_specification_from_model(self, model, mode: Mode) -> None:
    base_model = getattr(model, "base_model", None)
    if base_model is None:
      raise ValueError(
          "EpisodeMetaInputGenerator requires a meta model exposing "
          "`base_model` (e.g. MAMLModel).")
    # The episode wire carries the BASE specs per timestep.
    base_feat = base_model.get_feature_specification(mode)
    base_label = base_model.get_label_specification(mode)
    self._episodes.set_specification(
        as_sequence_specs(base_feat),
        as_sequence_specs(base_label)
        if base_label is not None else None)
    self.set_specification(
        model.preprocessor.get_in_feature_specification(mode),
        model.preprocessor.get_in_label_specification(mode))

  def _create_dataset(self, mode: Mode, batch_size: int
                      ) -> Iterator[Tuple[TensorSpecStruct,
                                          Optional[TensorSpecStruct]]]:
    # Per-episode (non-sequence) keys carry no time axis and must be
    # tiled, not sliced.
    context_keys = tuple(
        k for k, s in self._episodes.feature_spec.to_flat_dict().items()
        if not s.is_sequence)
    # Short episodes are filtered HERE, buffering survivors across
    # episode batches, so every emitted meta batch carries exactly
    # `batch_size` tasks: a ragged dataset must neither abort the
    # iterator (all-short batch) nor shrink the task dim (each distinct
    # task count would capture another train-step graph).
    need = self._num_condition + self._num_inference
    buf_f: dict = {}
    buf_l: Optional[dict] = None
    dropped = 0

    def emit_from(joined_f, joined_l):
      feats = TensorSpecStruct.from_flat_dict(joined_f)
      labs = (TensorSpecStruct.from_flat_dict(joined_l)
              if joined_l is not None else None)
      return meta_batch_from_episodes(
          feats, labs, self._num_condition, self._num_inference,
          context_keys=context_keys)

    for features, labels in self._episodes.create_dataset(
        mode, batch_size=batch_size):
      flat_f = features.to_flat_dict()
      lengths = flat_f.get(SEQUENCE_LENGTH_KEY)
      if lengths is not None:
        keep = np.asarray(lengths) >= need
        if not np.all(keep):
          dropped += int((~keep).sum())
          log.warning(
              "Dropped %d episode(s) shorter than condition+inference "
              "= %d (%d dropped so far).", int((~keep).sum()), need,
              dropped)
          flat_f = {k: v[keep] for k, v in flat_f.items()}
          if labels is not None:
            labels = TensorSpecStruct.from_flat_dict(
                {k: v[keep] for k, v in labels.to_flat_dict().items()})
          if not int(keep.sum()):
            continue
      for k, v in flat_f.items():
        buf_f.setdefault(k, []).append(v)
      if labels is not None:
        buf_l = buf_l or {}
        for k, v in labels.to_flat_dict().items():
          buf_l.setdefault(k, []).append(v)
      count = sum(a.shape[0] for a in buf_f[next(iter(buf_f))])
      while count >= batch_size:
        joined_f = {k: np.concatenate(v) for k, v in buf_f.items()}
        joined_l = ({k: np.concatenate(v) for k, v in buf_l.items()}
                    if buf_l else None)
        out_f = {k: v[:batch_size] for k, v in joined_f.items()}
        out_l = ({k: v[:batch_size] for k, v in joined_l.items()}
                 if joined_l is not None else None)
        buf_f = {k: [v[batch_size:]] for k, v in joined_f.items()}
        if joined_l is not None:
          buf_l = {k: [v[batch_size:]] for k, v in joined_l.items()}
        count -= batch_size
        yield emit_from(out_f, out_l)


@gin.configurable
class MetaExampleInputGenerator(AbstractInputGenerator):
  """Wraps a flat generator into meta-example batches.

  `batch_size` counts TASKS; the inner generator is driven at
  tasks × (num_condition + num_inference) samples per step.
  """

  def __init__(self,
               base_generator: AbstractInputGenerator,
               num_condition_samples_per_task: int = 4,
               num_inference_samples_per_task: int = 4,
               batch_size: int = 8):
    super().__init__(batch_size=batch_size)
    self._base = base_generator
    self._num_condition = num_condition_samples_per_task
    self._num_inference = num_inference_samples_per_task

  def set_specification_from_model(self, model, mode: Mode) -> None:
    # The model is a MAMLModel: its specs are the nested meta specs;
    # the BASE generator needs the base model's flat specs.
    base_model = getattr(model, "base_model", None)
    if base_model is not None:
      self._base.set_specification_from_model(base_model, mode)
      self.set_specification(
          model.preprocessor.get_in_feature_specification(mode),
          model.preprocessor.get_in_label_specification(mode))
    else:
      raise ValueError(
          "MetaExampleInputGenerator requires a meta model exposing "
          "`base_model` (e.g. MAMLModel); a flat model would declare "
          "flat specs while this generator yields nested meta batches.")

  def _create_dataset(self, mode: Mode, batch_size: int
                      ) -> Iterator[Tuple[TensorSpecStruct,
                                          Optional[TensorSpecStruct]]]:
    per_task = self._num_condition + self._num_inference
    flat_batch = batch_size * per_task
    for features, labels in self._base.create_dataset(
        mode, batch_size=flat_batch):
      yield make_meta_batch(features, labels, self._num_condition,
                            self._num_inference)
