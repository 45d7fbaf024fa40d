"""The QT-Opt Bellman-training configuration the card runs.

One place for what `chip_smoke.py` trains and what
`python -m tensor2robot_tpu_torch.bin.profile_policy --model qtopt_train`
profiles: `GraspingQModel()` at its full width (64×64 images, action 4,
torso (32, 64), head (64, 64), dense (64, 64), bf16, batch norm, Adam
at 1e-4) under the bench's learner (`bench.py:257-270`: CEM 2 × 64
samples, 6 elites, with its fused-select lever on; γ 0.9 and τ 0.05, the
learner's defaults) at batch 256,
and a synthetic grasping bandit to train it on (`tests/test_qtopt.py`'s,
sized for a 4-dim action): seeded images, actions uniform in [−1, 1]⁴,
reward 1 iff ‖a − a*‖ < 1.0 (24% of the actions; the test's radius
0.4 would reward under 1% in 4-D), every episode one step long.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from tensor2robot_tpu_torch.research.qtopt.qtopt_learner import QTOptLearner
from tensor2robot_tpu_torch.research.qtopt.t2r_models import GraspingQModel
from tensor2robot_tpu_torch.specs import make_random_tensors

BATCH_SIZE = 256
A_STAR = np.array([0.4, -0.2, 0.4, -0.2], np.float32)
REWARD_RADIUS = 1.0


def bellman_learner(device=None, cem_inference: str = "bf16",
                    cem_select: str = "fused", **model_kwargs
                    ) -> QTOptLearner:
  """The bench's learner over `GraspingQModel(**model_kwargs)`, on
  `device` (None = the CUDA card); `cem_inference="int8"` is the JAX
  bench's flagship tower (`bench.py:210`, `qtopt_int8.gin`)."""
  return QTOptLearner(GraspingQModel(**model_kwargs), gamma=0.9,
                      target_update_tau=0.05, cem_iterations=2,
                      cem_population=64, cem_elites=6,
                      cem_inference=cem_inference, cem_select=cem_select,
                      device=device)


def bandit_transitions(learner: QTOptLearner, n: int,
                       seed: int) -> Dict[str, np.ndarray]:
  """`n` one-step grasping-bandit transitions in the learner's
  transition spec, all drawn from `seed`."""
  flat = make_random_tensors(learner.transition_specification(),
                             batch_size=n, seed=seed).to_flat_dict()
  rng = np.random.default_rng(seed)
  actions = rng.uniform(-1, 1, (n, A_STAR.size)).astype(np.float32)
  flat["action"] = actions
  flat["reward"] = (np.linalg.norm(actions - A_STAR, axis=-1)
                    < REWARD_RADIUS).astype(np.float32)[:, None]
  flat["done"] = np.ones((n, 1), np.float32)
  return flat
