"""pose_env: the numpy pose task, its evaluation and the pose regression
model (port of `research/pose_env/`). `MuJoCoPoseEnv`, `PoseGraspBandit`
(ROADMAP A10a) and `collect_random_episodes` (A9) are not ported."""

from tensor2robot_tpu_torch.research.pose_env.pose_env import (
    PoseEnv,
    evaluate_pose_model,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env_models import (
    PoseEnvRegressionModel,
)

__all__ = ["PoseEnv", "PoseEnvRegressionModel", "evaluate_pose_model"]
