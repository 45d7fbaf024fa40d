"""Model bases."""

from tensor2robot_tpu_torch.models.abstract_model import (
    AbstractT2RModel,
    TrainState,
)
from tensor2robot_tpu_torch.models.critic_model import Q_VALUE, CriticModel

__all__ = ["AbstractT2RModel", "CriticModel", "Q_VALUE", "TrainState"]
