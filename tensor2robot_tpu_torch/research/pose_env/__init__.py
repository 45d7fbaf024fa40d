"""pose_env: the numpy pose task, its random-episode collection and
evaluation, the pose regression model and the grasp bandit over it
(port of `research/pose_env/`). `MuJoCoPoseEnv` is ROADMAP A10a."""

from tensor2robot_tpu_torch.research.pose_env.grasp_bandit import (
    PoseGraspBandit,
    grade_grasp,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env import (
    PoseEnv,
    collect_random_episodes,
    evaluate_pose_model,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env_models import (
    PoseEnvRegressionModel,
)

__all__ = ["PoseEnv", "PoseEnvRegressionModel", "PoseGraspBandit",
           "collect_random_episodes", "evaluate_pose_model", "grade_grasp"]
