"""Abstract input generator: model specs → batched host data streams
(port of `data/abstract_input_generator.py`).

A generator yields `(features, labels)` pairs of `TensorSpecStruct`s of
numpy arrays on the host; the trainer moves each batch to the device.
"""

from __future__ import annotations

import abc
import enum
from typing import Any, Iterator, Optional, Tuple

from tensor2robot_tpu_torch.specs import packing
from tensor2robot_tpu_torch.specs.tensorspec import TensorSpecStruct

Batch = Tuple[TensorSpecStruct, Optional[TensorSpecStruct]]


class Mode(str, enum.Enum):
  """Train/eval/predict modes (reference: tf.estimator.ModeKeys)."""

  TRAIN = "train"
  EVAL = "eval"
  PREDICT = "predict"


def _flat_specs(spec_structure: Any) -> TensorSpecStruct:
  """A flat struct of specs; raises `SpecValidationError` on a leaf that
  is not a spec."""
  flat = packing.flatten_spec_structure(spec_structure)
  packing.assert_valid_spec_structure(flat)
  return flat


class AbstractInputGenerator(abc.ABC):
  """Produces spec-conforming batches for a model.

  Lifecycle (mirrors the reference):
    1. `set_specification_from_model(model, mode)` copies the model's
       wire-side (preprocessor-in) feature/label specs into the
       generator.
    2. `create_dataset(mode, batch_size)` returns an iterator of
       `(features, labels)` TensorSpecStructs of numpy arrays.
  """

  def __init__(self, batch_size: int = 32):
    self._batch_size = batch_size
    self._feature_spec: Optional[TensorSpecStruct] = None
    self._label_spec: Optional[TensorSpecStruct] = None

  @property
  def batch_size(self) -> int:
    return self._batch_size

  @batch_size.setter
  def batch_size(self, value: int):
    self._batch_size = int(value)

  def fix_seed(self, seed: int) -> None:
    """Makes a generator whose shuffle seed was left None (a fresh one
    per process) draw from `seed`, so that every rank of a group, each
    reading from its own generator, reads the same global batches; a
    generator with a seed keeps it. A generator whose batch order does
    not follow its seed raises (`train_eval` also compares each step's
    global batch across the ranks)."""
    if getattr(self, "_seed", 0) is None:
      self._seed = int(seed)

  @property
  def feature_spec(self) -> TensorSpecStruct:
    if self._feature_spec is None:
      raise ValueError(
          "Input generator has no specs; call "
          "set_specification_from_model(model, mode) first.")
    return self._feature_spec

  @property
  def label_spec(self) -> Optional[TensorSpecStruct]:
    return self._label_spec

  def set_specification_from_model(self, model, mode: Mode) -> None:
    """Adopts the model's preprocessor-in (wire) specs; a model without
    a preprocessor gives its own."""
    preprocessor = getattr(model, "preprocessor", None)
    if preprocessor is not None:
      self.set_specification(
          preprocessor.get_in_feature_specification(mode),
          preprocessor.get_in_label_specification(mode))
    else:
      self.set_specification(model.get_feature_specification(mode),
                             model.get_label_specification(mode))

  def set_specification(self, feature_spec: Any,
                        label_spec: Optional[Any] = None) -> None:
    self._feature_spec = _flat_specs(feature_spec)
    if label_spec is not None:
      self._label_spec = _flat_specs(label_spec)

  def create_dataset(self, mode: Mode,
                     batch_size: Optional[int] = None) -> Iterator[Batch]:
    """Returns an iterator of (features, labels) numpy batches."""
    if self._feature_spec is None:
      raise ValueError(
          "set_specification_from_model must be called before "
          "create_dataset.")
    return self._create_dataset(mode, batch_size or self._batch_size)

  @abc.abstractmethod
  def _create_dataset(self, mode: Mode, batch_size: int) -> Iterator[Batch]:
    ...
