"""pose_env: the numpy pose task, its random-episode collection and
evaluation, the pose regression model and the grasp bandit over it
and the physics-backed `MuJoCoPoseEnv` (port of `research/pose_env/`;
`mujoco` is imported only when a `MuJoCoPoseEnv` is built)."""

from tensor2robot_tpu_torch.research.pose_env.grasp_bandit import (
    PoseGraspBandit,
    grade_grasp,
)
from tensor2robot_tpu_torch.research.pose_env.mujoco_pose_env import (
    MuJoCoPoseEnv,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env import (
    PoseEnv,
    collect_random_episodes,
    evaluate_pose_model,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env_models import (
    PoseEnvRegressionModel,
)

__all__ = ["MuJoCoPoseEnv", "PoseEnv", "PoseEnvRegressionModel",
           "PoseGraspBandit", "collect_random_episodes",
           "evaluate_pose_model", "grade_grasp"]
