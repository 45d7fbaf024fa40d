"""VRGripper: behavioural cloning from demonstrations (plain and MDN
policies), episode → transition munging, meta-BC (MAML and SNAIL),
Watch-Try-Learn trial-conditioned policies, the long-context
transformer policy, and the numpy gripper env they are evaluated in."""

from tensor2robot_tpu_torch.research.vrgripper.episode_to_transitions import (
    TransitionInputGenerator,
    episode_batch_to_transitions,
)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env import (
    VRGripperEnv,
    collect_demo_episodes,
    collect_expert_episode,
    evaluate_gripper_policy,
    sample_wtl_meta_batch,
)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_models import (
    ACTION,
    GripperObsEncoder,
    VRGripperRegressionModel,
)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_meta_models import (
    VRGripperMAMLModel,
    VRGripperSNAILModel,
)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_transformer_models import (  # noqa: E501
    EpisodeContextPolicy,
    VRGripperTransformerModel,
)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_wtl_models import (
    VRGripperWTLModel,
)

__all__ = ["ACTION", "EpisodeContextPolicy", "GripperObsEncoder",
           "TransitionInputGenerator", "VRGripperEnv", "VRGripperMAMLModel",
           "VRGripperRegressionModel", "VRGripperSNAILModel",
           "VRGripperTransformerModel", "VRGripperWTLModel",
           "collect_demo_episodes", "collect_expert_episode",
           "episode_batch_to_transitions", "evaluate_gripper_policy",
           "sample_wtl_meta_batch"]
