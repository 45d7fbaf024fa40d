"""Predictors: on-robot inference (port of `predictors/`).
`CheckpointPredictor` serves a model class from the trainer's
checkpoints; `SavedModelPredictor` serves the newest export
(`export/`) without the model class."""

from tensor2robot_tpu_torch.predictors.abstract_predictor import (
    AbstractPredictor,
)
from tensor2robot_tpu_torch.predictors.checkpoint_predictor import (
    CheckpointPredictor,
)
from tensor2robot_tpu_torch.predictors.saved_model_predictor import (
    SavedModelPredictor,
)

__all__ = ["AbstractPredictor", "CheckpointPredictor", "SavedModelPredictor"]
