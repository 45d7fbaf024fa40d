"""VRGripper: the long-context transformer policy, its observation
encoder and the numpy gripper env it is evaluated in."""

from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env import (
    VRGripperEnv,
    collect_demo_episodes,
    collect_expert_episode,
    evaluate_gripper_policy,
)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_models import (
    ACTION,
    GripperObsEncoder,
)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_transformer_models import (  # noqa: E501
    EpisodeContextPolicy,
    VRGripperTransformerModel,
)

__all__ = ["ACTION", "EpisodeContextPolicy", "GripperObsEncoder",
           "VRGripperEnv", "VRGripperTransformerModel",
           "collect_demo_episodes", "collect_expert_episode",
           "evaluate_gripper_policy"]
