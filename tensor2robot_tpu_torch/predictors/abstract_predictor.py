"""Predictor protocol: the on-robot inference API (port of
`predictors/abstract_predictor.py`).

A robot process constructs a predictor, calls `restore()` (blocking
until the trainer publishes a checkpoint), then calls `predict` with
raw numpy features each control tick; inputs are validated against the
declared feature spec.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Optional

import numpy as np

from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.specs import TensorSpecStruct


class AbstractPredictor(abc.ABC):
  """Loads trained parameters and serves `predict` on the host/robot."""

  @abc.abstractmethod
  def predict(self, features: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Runs inference on a batch of raw (wire-spec) numpy features."""

  @abc.abstractmethod
  def restore(self, timeout_secs: Optional[float] = None) -> bool:
    """Loads the newest available parameters; returns success."""

  def init_randomly(self) -> None:
    """Initializes parameters randomly (testing without a trainer)."""
    raise NotImplementedError(
        f"{type(self).__name__} does not support random init.")

  @property
  @abc.abstractmethod
  def feature_specification(self) -> TensorSpecStruct:
    """The wire feature spec `predict` inputs must conform to."""

  @property
  def label_specification(self) -> Optional[TensorSpecStruct]:
    return None

  @property
  @abc.abstractmethod
  def model_version(self) -> int:
    """Monotonic version (the global step); -1 if none is loaded."""

  def get_feature_specification(self) -> TensorSpecStruct:
    """Method alias of `feature_specification`."""
    return self.feature_specification

  def assert_is_loaded(self) -> None:
    if self.model_version < 0:
      raise ValueError(
          f"{type(self).__name__} has no restored model; call restore() "
          f"or init_randomly() first.")

  def _validate(self, features: Dict[str, np.ndarray],
                batched: bool = True) -> TensorSpecStruct:
    struct = features if isinstance(features, TensorSpecStruct) else \
        TensorSpecStruct.from_flat_dict(dict(features))
    return specs_lib.validate_and_pack(
        self.feature_specification, struct, ignore_batch=batched)

  def close(self) -> None:
    """Releases resources; predictors are also context managers."""

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
    return False
