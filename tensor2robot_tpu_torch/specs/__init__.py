"""Tensor specifications and spec-driven random data."""

from tensor2robot_tpu_torch.specs.random_data import make_random_tensors
from tensor2robot_tpu_torch.specs.tensorspec import (
    ExtendedTensorSpec,
    TensorSpec,
    TensorSpecStruct,
)

__all__ = ["ExtendedTensorSpec", "TensorSpec", "TensorSpecStruct",
           "make_random_tensors"]
