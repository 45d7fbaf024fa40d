"""QT-Opt: grasping Q-network, CEM, the learner (acting and Bellman
training), its replay buffer and training loop."""

from tensor2robot_tpu_torch.models.convert import convert_variables
from tensor2robot_tpu_torch.research.qtopt.networks import GraspingQNetwork
from tensor2robot_tpu_torch.research.qtopt.qtopt_learner import (
    QTOptLearner,
    QTOptState,
)
from tensor2robot_tpu_torch.research.qtopt.replay_buffer import ReplayBuffer
from tensor2robot_tpu_torch.research.qtopt.t2r_models import GraspingQModel
from tensor2robot_tpu_torch.research.qtopt.train_qtopt import train_qtopt

__all__ = ["GraspingQModel", "GraspingQNetwork", "QTOptLearner",
           "QTOptState", "ReplayBuffer", "convert_variables", "train_qtopt"]
