"""Meta-learning: MAML over any base model, meta batches from flat or
episode streams, and demonstration-conditioned serving policies."""

from tensor2robot_tpu_torch.meta_learning.maml_model import (
    CONDITION,
    CONDITION_LABELS,
    INFERENCE,
    MAMLModel,
)
from tensor2robot_tpu_torch.meta_learning.meta_policies import MetaPolicy
from tensor2robot_tpu_torch.meta_learning.meta_data import (
    EpisodeMetaInputGenerator,
    MetaExampleInputGenerator,
    make_meta_batch,
    meta_batch_from_episodes,
)

__all__ = ["CONDITION", "CONDITION_LABELS", "EpisodeMetaInputGenerator",
           "INFERENCE", "MAMLModel", "MetaExampleInputGenerator",
           "MetaPolicy", "make_meta_batch", "meta_batch_from_episodes"]
