"""Predictors: on-robot inference over trained checkpoints (port of
`predictors/`). `SavedModelPredictor` waits for the port's export
(ROADMAP A12)."""

from tensor2robot_tpu_torch.predictors.abstract_predictor import (
    AbstractPredictor,
)
from tensor2robot_tpu_torch.predictors.checkpoint_predictor import (
    CheckpointPredictor,
)

__all__ = ["AbstractPredictor", "CheckpointPredictor"]
