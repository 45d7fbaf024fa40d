"""Episode → transition munging for behavioural cloning (port of
`research/vrgripper/episode_to_transitions.py`).

Host-side numpy only, the JAX module's code: padding is masked out with
the parser's true episode lengths (a zero-padded timestep never becomes
a training transition), and flat transitions are re-batched to the
trainer's batch size, shuffled by `np.random.default_rng(seed)` exactly
as the JAX generator shuffles, so the two streams are equal. The device
never sees ragged data.
"""

from __future__ import annotations

import warnings
from typing import Iterator, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.abstract_input_generator import (
    AbstractInputGenerator,
    Mode,
)
from tensor2robot_tpu_torch.data.tfexample import SEQUENCE_LENGTH_KEY
from tensor2robot_tpu_torch.specs import TensorSpecStruct, as_sequence_specs


def episode_batch_to_transitions(
    features: TensorSpecStruct,
    labels: Optional[TensorSpecStruct],
    sequence_keys: Optional[frozenset] = None,
) -> Tuple[TensorSpecStruct, Optional[TensorSpecStruct]]:
  """Flattens [B, T, ...] episode batches into [N, ...] transitions.

  Only real timesteps survive: the `sequence_length` feature (true
  pre-pad lengths from the episode parser) masks out padding. Without
  it, every timestep is assumed real. Keys without a time axis
  (per-episode context) are repeated across their episode's timesteps.

  Args:
    features: [B, T, ...] episode feature batch.
    labels: matching label batch, or None.
    sequence_keys: flat keys known (from specs) to carry a time axis.
      When given, the time axis comes from a sequence key and context vs
      sequence classification is exact. When None, the time axis falls
      back to the first rank>=2 value — ambiguous if a [B, D] context
      key precedes every sequence key — and a RuntimeWarning fires so
      the guess never goes unnoticed. Spec-aware callers (derive the
      set from `get_feature_specification(...).is_sequence`, as
      `TransitionInputGenerator` does) should always pass it.
  """
  flat_f = features.to_flat_dict()
  lengths = flat_f.pop(SEQUENCE_LENGTH_KEY, None)
  anchor = None
  if sequence_keys:
    anchor = next((v for k, v in flat_f.items() if k in sequence_keys),
                  None)
    if labels is not None and anchor is None:
      anchor = next((v for k, v in labels.to_flat_dict().items()
                     if k in sequence_keys), None)
  if anchor is None:
    anchor_key, anchor = next(
        ((k, v) for k, v in flat_f.items() if v.ndim >= 2),
        next(iter(flat_f.items())))
    if sequence_keys:
      reason = (f"sequence_keys={sorted(sequence_keys)!r} matched no "
                f"feature/label key (present: {sorted(flat_f)!r}) — "
                "likely a flat-name mismatch")
    else:
      reason = "called without sequence_keys"
    warnings.warn(
        f"episode_batch_to_transitions {reason}: guessing the time "
        f"axis from {anchor_key!r} (first rank>=2 value). A [B, D] "
        "per-episode context key ahead of the sequence keys makes "
        "this guess WRONG silently — pass sequence_keys derived from "
        "the model's specs (spec.is_sequence).",
        RuntimeWarning, stacklevel=2)
  batch, time = anchor.shape[0], anchor.shape[1] if anchor.ndim > 1 else 1
  if lengths is None:
    mask = np.ones((batch, time), bool)
  else:
    mask = (np.arange(time)[None, :]
            < np.asarray(lengths).reshape(batch, 1))
  mask_flat = mask.reshape(-1)

  def flatten(struct_flat):
    out = {}
    for key, value in struct_flat.items():
      is_seq = (key in sequence_keys if sequence_keys is not None
                else value.ndim >= 2 and value.shape[:2] == (batch, time))
      if is_seq:
        if value.shape[:2] != (batch, time):
          raise ValueError(
              f"{key!r} declared a sequence but has shape {value.shape}; "
              f"expected leading dims {(batch, time)}.")
        flat = value.reshape((batch * time,) + value.shape[2:])
      else:
        # Per-episode context: repeat across the episode's timesteps.
        flat = np.repeat(value, time, axis=0)
      out[key] = flat[mask_flat]
    return TensorSpecStruct.from_flat_dict(out)

  out_labels = None
  if labels is not None:
    out_labels = flatten(labels.to_flat_dict())
  return flatten(flat_f), out_labels


@gin.configurable
class TransitionInputGenerator(AbstractInputGenerator):
  """Re-batches an episode generator's output into transition batches.

  Wraps any episode generator ([B, T, ...] batches + true lengths); yields
  flat [batch_size, ...] transition batches, buffering across episode
  boundaries so every batch is full (static shapes: one CUDA graph).
  """

  def __init__(self,
               episode_generator: AbstractInputGenerator,
               batch_size: int = 32,
               shuffle_transitions: bool = True,
               seed: Optional[int] = None):
    super().__init__(batch_size=batch_size)
    self._episodes = episode_generator
    self._shuffle = shuffle_transitions
    self._seed = seed
    self._sequence_keys: Optional[frozenset] = None

  def set_specification_from_model(self, model, mode: Mode) -> None:
    # The model consumes flat transitions; the wire carries episodes of
    # the same keys, so the episode generator gets the specs lifted to
    # sequences.
    preprocessor = getattr(model, "preprocessor", None)
    if preprocessor is not None:
      feat = preprocessor.get_in_feature_specification(mode)
      label = preprocessor.get_in_label_specification(mode)
    else:
      feat = model.get_feature_specification(mode)
      label = model.get_label_specification(mode)
    self._episodes.set_specification(
        as_sequence_specs(feat),
        as_sequence_specs(label) if label is not None else None)
    self._sequence_keys = frozenset(feat.to_flat_dict()) | frozenset(
        label.to_flat_dict() if label is not None else ())
    self.set_specification(feat, label)

  def _create_dataset(self, mode: Mode, batch_size: int
                      ) -> Iterator[Tuple[TensorSpecStruct,
                                          Optional[TensorSpecStruct]]]:
    rng = np.random.default_rng(self._seed)
    buf_f: dict = {}
    buf_l: Optional[dict] = None
    episode_batch = max(1, batch_size // 4)
    for ep_features, ep_labels in self._episodes.create_dataset(
        mode, batch_size=episode_batch):
      features, labels = episode_batch_to_transitions(
          ep_features, ep_labels, sequence_keys=self._sequence_keys)
      flat_f = features.to_flat_dict()
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
        if self._shuffle:
          perm = rng.permutation(count)
          joined_f = {k: v[perm] for k, v in joined_f.items()}
          if joined_l is not None:
            joined_l = {k: v[perm] for k, v in joined_l.items()}
        out_f = {k: v[:batch_size] for k, v in joined_f.items()}
        out_l = ({k: v[:batch_size] for k, v in joined_l.items()}
                 if joined_l is not None else None)
        buf_f = {k: [v[batch_size:]] for k, v in joined_f.items()}
        if joined_l is not None:
          buf_l = {k: [v[batch_size:]] for k, v in joined_l.items()}
        count -= batch_size
        yield (TensorSpecStruct.from_flat_dict(out_f),
               TensorSpecStruct.from_flat_dict(out_l)
               if out_l is not None else None)
