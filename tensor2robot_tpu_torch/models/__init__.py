"""Model bases."""

from tensor2robot_tpu_torch.models.abstract_model import (
    AbstractT2RModel,
    TrainState,
)
from tensor2robot_tpu_torch.models.classification_model import (
    LOGITS,
    ClassificationModel,
)
from tensor2robot_tpu_torch.models.critic_model import Q_VALUE, CriticModel
from tensor2robot_tpu_torch.models.optimizers import (
    create_lr_schedule,
    create_optimizer,
)
from tensor2robot_tpu_torch.models.regression_model import (
    INFERENCE_OUTPUT,
    RegressionModel,
)

__all__ = ["AbstractT2RModel", "ClassificationModel", "CriticModel",
           "INFERENCE_OUTPUT", "LOGITS", "Q_VALUE",
           "RegressionModel", "TrainState", "create_lr_schedule",
           "create_optimizer"]
