"""QT-Opt: grasping Q-network, CEM, the learner (acting and Bellman
training), its replay buffer and training loop, and the online half:
the toy grasping env, its success evaluation and the grasp actor."""

from tensor2robot_tpu_torch.models.convert import convert_variables
from tensor2robot_tpu_torch.research.qtopt.actor import (
    ActorStateRefreshHook,
    GraspActor,
)
from tensor2robot_tpu_torch.research.qtopt.grasping_env import (
    ToyGraspEnv,
    evaluate_grasp_policy,
)
from tensor2robot_tpu_torch.research.qtopt.networks import GraspingQNetwork
from tensor2robot_tpu_torch.research.qtopt.qtopt_learner import (
    QTOptLearner,
    QTOptState,
)
from tensor2robot_tpu_torch.research.qtopt.replay_buffer import ReplayBuffer
from tensor2robot_tpu_torch.research.qtopt.t2r_models import GraspingQModel
from tensor2robot_tpu_torch.research.qtopt.train_qtopt import train_qtopt

__all__ = ["ActorStateRefreshHook", "GraspActor", "GraspingQModel",
           "GraspingQNetwork", "QTOptLearner", "QTOptState", "ReplayBuffer",
           "ToyGraspEnv", "convert_variables", "evaluate_grasp_policy",
           "train_qtopt"]
