"""Network building blocks."""

from tensor2robot_tpu_torch.layers.core import MLP, dense, flatten_and_concat

__all__ = ["MLP", "dense", "flatten_and_concat"]
