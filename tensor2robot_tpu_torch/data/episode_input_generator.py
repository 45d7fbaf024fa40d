"""Episode batches from episodes held in memory.

The batch contract of `TFRecordEpisodeInputGenerator` (and of
`tfexample.graph_parse_sequence_example`), fed from episode dicts
instead of records: tests and timing runs use it where no record file
is wanted.

  * sequence specs (`is_sequence=True`) come out `[B, sequence_length,
    ...]`: each episode's first `sequence_length` steps, zero-padded;
  * other specs come out `[B, ...]`;
  * the true lengths, clipped to `sequence_length` (the longest over the
    sequence keys), come out int32 `[B]` under `SEQUENCE_LENGTH_KEY` in
    the features;
  * batches are dropped at the remainder; in TRAIN mode the stream
    repeats and is shuffled (when asked) with a numpy generator made
    from `seed`, a new permutation per pass; other modes read the
    episodes once, in order."""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from tensor2robot_tpu_torch.data.abstract_input_generator import (
    AbstractInputGenerator,
    Batch,
    Mode,
)
from tensor2robot_tpu_torch.data.tfexample import SEQUENCE_LENGTH_KEY
from tensor2robot_tpu_torch.specs import TensorSpecStruct


class EpisodeInputGenerator(AbstractInputGenerator):
  """Streams padded episode batches from a list of episode dicts (flat
  spec keys → `[T_i, ...]` arrays for sequence keys)."""

  def __init__(self, episodes: Sequence[Mapping[str, np.ndarray]],
               sequence_length: int = 16, batch_size: int = 32,
               shuffle: bool = True, repeat: bool = True,
               seed: Optional[int] = None):
    super().__init__(batch_size=batch_size)
    self._episodes = list(episodes)
    if not self._episodes:
      raise ValueError("EpisodeInputGenerator needs at least one episode")
    self._sequence_length = int(sequence_length)
    self._shuffle = shuffle
    self._repeat = repeat
    self._seed = seed

  def _order(self, mode: Mode) -> Iterator[int]:
    train = mode == Mode.TRAIN
    rng = np.random.default_rng(self._seed)
    n = len(self._episodes)
    while True:
      yield from (rng.permutation(n) if self._shuffle and train
                  else range(n))
      if not (self._repeat and train):
        return

  def _fit(self, episodes: List[Mapping[str, np.ndarray]],
           specs: Dict) -> Dict[str, np.ndarray]:
    """One batch of the parser's output over `episodes`."""
    seq_len = self._sequence_length
    out = {}
    lengths = np.zeros(len(episodes), np.int32)
    for key, spec in specs.items():
      if spec.is_sequence:
        value = np.zeros((len(episodes), seq_len) + spec.shape, spec.dtype)
        for i, ep in enumerate(episodes):
          steps = np.asarray(ep[key])[:seq_len]
          value[i, :len(steps)] = steps.reshape((len(steps),) + spec.shape)
          lengths[i] = max(lengths[i], len(steps))
      else:
        value = np.stack([np.asarray(ep[key], spec.dtype).reshape(spec.shape)
                          for ep in episodes])
      out[key] = value
    out[SEQUENCE_LENGTH_KEY] = lengths
    return out

  def _create_dataset(self, mode: Mode, batch_size: int) -> Iterator[Batch]:
    features = self.feature_spec.to_flat_dict()
    labels = (self.label_spec.to_flat_dict()
              if self.label_spec is not None else {})
    if SEQUENCE_LENGTH_KEY in features or SEQUENCE_LENGTH_KEY in labels:
      raise ValueError(
          f"Spec key {SEQUENCE_LENGTH_KEY!r} is reserved: the generator "
          "emits the true episode lengths under it. Rename the feature.")
    merged = {**features, **labels}
    for key in merged:
      missing = sum(key not in ep for ep in self._episodes)
      if missing:
        raise KeyError(f"{missing} episodes lack spec key {key!r}")
    feature_keys = list(features) + [SEQUENCE_LENGTH_KEY]
    chosen: List[Mapping[str, np.ndarray]] = []
    for index in self._order(mode):
      chosen.append(self._episodes[index])
      if len(chosen) < batch_size:
        continue
      flat = self._fit(chosen, merged)
      chosen = []
      yield (TensorSpecStruct.from_flat_dict(
                 {k: flat[k] for k in feature_keys}),
             TensorSpecStruct.from_flat_dict({k: flat[k] for k in labels})
             if self.label_spec is not None else None)
