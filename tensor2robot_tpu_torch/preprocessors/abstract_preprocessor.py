"""Preprocessor protocol: declared in/out spec transforms (port of
`preprocessors/abstract_preprocessor.py`).

`preprocess(features, labels, mode, generator)` maps wire-side batches
(tensors already on the device) to model-side batches inside the
model's train, eval and predict steps, so under a captured step it is
part of the graph. Anything that is not tensor arithmetic (image
decoding) belongs to the data layer, on the host. Where the JAX step
passes a `jax.random` key, the port passes a `torch.Generator` or None.
"""

from __future__ import annotations

import abc
from typing import Callable, Optional, Tuple

import torch

from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.specs import packing
from tensor2robot_tpu_torch.specs.tensorspec import TensorSpecStruct

SpecFn = Callable[[Mode], Optional[TensorSpecStruct]]


class AbstractPreprocessor(abc.ABC):
  """Transforms wire-side batches into model-side batches, on the device.

  Spec contract (the reference's):
    * `get_in_*_specification(mode)`: what the data layer must deliver;
    * `get_out_*_specification(mode)`: what the model receives.
  """

  def __init__(self, model_feature_specification_fn: Optional[SpecFn] = None,
               model_label_specification_fn: Optional[SpecFn] = None):
    """Args are mode → spec callables, usually the model's spec getters."""
    self._model_feature_specification_fn = model_feature_specification_fn
    self._model_label_specification_fn = model_label_specification_fn

  def model_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    if self._model_feature_specification_fn is None:
      raise ValueError("No model feature specification bound.")
    return packing.flatten_spec_structure(
        self._model_feature_specification_fn(mode))

  def model_label_specification(self,
                                mode: Mode) -> Optional[TensorSpecStruct]:
    if self._model_label_specification_fn is None:
      return None
    spec = self._model_label_specification_fn(mode)
    return None if spec is None else packing.flatten_spec_structure(spec)

  @abc.abstractmethod
  def get_in_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    ...

  @abc.abstractmethod
  def get_in_label_specification(self,
                                 mode: Mode) -> Optional[TensorSpecStruct]:
    ...

  @abc.abstractmethod
  def get_out_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    ...

  @abc.abstractmethod
  def get_out_label_specification(self,
                                  mode: Mode) -> Optional[TensorSpecStruct]:
    ...

  @abc.abstractmethod
  def preprocess(self, features, labels, mode: Mode,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[object, object]:
    """Tensor arithmetic from in-specs to out-specs (no host reads, so a
    captured step can hold it)."""
    ...
