"""Preprocessors: declared in/out spec transforms between the data layer
and the model."""

from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    AbstractPreprocessor,
)
from tensor2robot_tpu_torch.preprocessors.noop_preprocessor import (
    NoOpPreprocessor,
)

__all__ = ["AbstractPreprocessor", "NoOpPreprocessor"]
