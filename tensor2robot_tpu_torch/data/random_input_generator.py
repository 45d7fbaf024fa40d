"""Random spec-conforming input generator (port of
`data/random_input_generator.py`): random batches conforming to the
model's specs, forever, the same numpy draws as the JAX package's for
the same seed."""

from __future__ import annotations

from typing import Iterator

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.abstract_input_generator import (
    AbstractInputGenerator,
    Batch,
    Mode,
)
from tensor2robot_tpu_torch.specs import make_random_tensors


@gin.configurable
class RandomInputGenerator(AbstractInputGenerator):
  """Yields random batches conforming to the bound specs, forever."""

  def __init__(self, batch_size: int = 32, sequence_length: int = 3,
               seed: int = 0):
    super().__init__(batch_size=batch_size)
    self._sequence_length = sequence_length
    self._seed = seed

  def _create_dataset(self, mode: Mode, batch_size: int) -> Iterator[Batch]:
    feature_spec, label_spec = self.feature_spec, self.label_spec
    step = 0
    while True:
      features = make_random_tensors(
          feature_spec, batch_size=batch_size,
          sequence_length=self._sequence_length,
          seed=self._seed + step, include_optional=False)
      labels = None
      if label_spec is not None:
        labels = make_random_tensors(
            label_spec, batch_size=batch_size,
            sequence_length=self._sequence_length,
            seed=self._seed + step + 7919, include_optional=False)
      yield features, labels
      step += 1
