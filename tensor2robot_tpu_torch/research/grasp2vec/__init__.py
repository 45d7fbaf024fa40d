"""Grasp2Vec (port of `research/grasp2vec/`): the embedding model, its
losses, goal heatmaps, the synthetic grasp scenes with collect and
retrieval evaluation, and the goal-conditioned QT-Opt relabeler.
`Grasp2VecModel`, `collect_grasp_triplets` and `evaluate_retrieval` are
configurables of the port's registry under their JAX names."""

from tensor2robot_tpu_torch.research.grasp2vec.grasp2vec_model import (
    GOAL_EMBEDDING,
    GOAL_REWARD,
    Grasp2VecModel,
    POSTGRASP_EMBEDDING,
    PREGRASP_EMBEDDING,
    SCENE_SPATIAL,
)
from tensor2robot_tpu_torch.research.grasp2vec.goal_reward import (
    GOAL_EMBEDDING_FEATURE,
    make_grasp2vec_reward_fn,
    relabel_transitions,
)
from tensor2robot_tpu_torch.research.grasp2vec.grasp_env import (
    GraspSceneGenerator,
    collect_grasp_triplets,
    evaluate_retrieval,
)
from tensor2robot_tpu_torch.research.grasp2vec.losses import (
    cosine_similarity,
    goal_similarity_reward,
    npairs_loss,
)
from tensor2robot_tpu_torch.research.grasp2vec.visualization import (
    goal_localization_heatmap,
    heatmap_argmax,
)

__all__ = ["GOAL_EMBEDDING", "GOAL_EMBEDDING_FEATURE", "GOAL_REWARD",
           "Grasp2VecModel", "GraspSceneGenerator", "POSTGRASP_EMBEDDING",
           "PREGRASP_EMBEDDING", "SCENE_SPATIAL", "collect_grasp_triplets",
           "cosine_similarity", "evaluate_retrieval", "goal_similarity_reward",
           "goal_localization_heatmap", "heatmap_argmax",
           "make_grasp2vec_reward_fn", "npairs_loss", "relabel_transitions"]
