"""Preprocessors: declared in/out spec transforms between the data layer
and the model."""

from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    AbstractPreprocessor,
)
from tensor2robot_tpu_torch.preprocessors.noop_preprocessor import (
    NoOpPreprocessor,
)
from tensor2robot_tpu_torch.preprocessors.image_preprocessor import (
    ImagePreprocessor,
    TPUCompatPreprocessorWrapper,
)
from tensor2robot_tpu_torch.preprocessors import image_transformations

__all__ = ["AbstractPreprocessor", "ImagePreprocessor", "NoOpPreprocessor",
           "TPUCompatPreprocessorWrapper", "image_transformations"]
