"""QT-Opt: grasping Q-network, CEM and the learner's acting policy."""

from tensor2robot_tpu_torch.models.convert import convert_variables
from tensor2robot_tpu_torch.research.qtopt.networks import GraspingQNetwork
from tensor2robot_tpu_torch.research.qtopt.qtopt_learner import (
    QTOptLearner,
    QTOptState,
)
from tensor2robot_tpu_torch.research.qtopt.t2r_models import GraspingQModel

__all__ = ["GraspingQModel", "GraspingQNetwork", "QTOptLearner",
           "QTOptState", "convert_variables"]
