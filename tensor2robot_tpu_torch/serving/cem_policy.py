"""CEM action-selection service (port of `serving/cem_policy.py`): the
QT-Opt policy behind the micro-batcher.

`QTOptLearner.build_policy` runs the whole CEM loop on the device; this
wraps it for deployment: bucketed batches (a robot fleet's request
sizes all hit warmed-up shapes), each bucket's CEM dispatch one CUDA
graph replay, device-resident params that checkpoint refreshes
hot-swap, and a micro-batcher so N concurrent robots cost ~one CEM
dispatch instead of N.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.serving.engine import BucketedServingEngine
from tensor2robot_tpu_torch.serving.microbatcher import MicroBatcher
from tensor2robot_tpu_torch.specs import TensorSpecStruct, make_random_tensors


def _struct(observations) -> TensorSpecStruct:
  return (observations if isinstance(observations, TensorSpecStruct)
          else TensorSpecStruct.from_flat_dict(dict(observations)))


@gin.configurable
class CEMPolicyServer:
  """Serves batched CEM action selection for a QTOptLearner."""

  def __init__(self,
               learner,
               state: Any,
               max_batch: int = 8,
               max_wait_us: int = 200,
               cem_population: Optional[int] = None,
               cem_iterations: Optional[int] = None,
               seed: int = 0,
               warmup: bool = True,
               device=None,
               graphs: bool = True):
    """Args:
      learner: a `QTOptLearner` (provides the CEM policy).
      state: acting params — a critic `TrainState` or a `QTOptState`.
      max_batch: largest coalesced dispatch; buckets cover 1..max_batch.
      max_wait_us: micro-batch deadline (0 = never hold a request).
      cem_population / cem_iterations: serving-side CEM overrides.
      seed: base seed of the per-dispatch CEM noise generators.
      warmup: capture and run every bucket now; `warmup_seconds`
        records it.
      device: where the params live and the policy runs; None = CUDA.
      graphs: one CUDA graph per bucket (default); False dispatches the
        policy eagerly.
    """
    self._learner = learner
    # An int8 learner that was never calibrated on real data calibrates
    # on a spec-random batch here, before the engine captures its
    # buckets (they read the scales).
    learner.ensure_calibrated(state)
    policy = learner.build_policy(cem_population=cem_population,
                                  cem_iterations=cem_iterations)
    example = make_random_tensors(
        learner.observation_specification(), batch_size=1, seed=0)
    self._engine = BucketedServingEngine(
        policy, state, example, max_batch=max_batch, takes_rng=True,
        device=device, graphs=graphs)
    self.warmup_seconds = self._engine.warmup() if warmup else 0.0
    self._batcher = MicroBatcher(self._engine, max_wait_us=max_wait_us,
                                 seed=seed)

  @property
  def engine(self) -> BucketedServingEngine:
    return self._engine

  @property
  def batcher(self) -> MicroBatcher:
    return self._batcher

  @property
  def params_version(self) -> int:
    """Monotonic params-publication counter (engine hot-swap count)."""
    return self._engine.params_version

  @property
  def params_learner_step(self) -> int:
    """Learner step stamped on the currently-served params."""
    return self._engine.params_learner_step

  def update_state(self, state: Any,
                   learner_step: Optional[int] = None) -> None:
    """Hot-swaps the acting params (checkpoint-refresh entry point)."""
    self._engine.swap_state(state, learner_step=learner_step)

  def select_actions(self,
                     observations: Dict[str, np.ndarray]) -> np.ndarray:
    """Blocking batched action selection — one call per control tick.

    `observations`: flat numpy dict conforming to the learner's
    observation spec, with a leading batch dim. Thread-safe: concurrent
    callers coalesce into shared dispatches.
    """
    return np.asarray(self._batcher.predict(_struct(observations)))

  def select_actions_direct(self, observations, generator=None
                            ) -> np.ndarray:
    """Engine-direct selection (no batcher), for latency measurements."""
    return np.asarray(self._engine.predict(_struct(observations),
                                           generator=generator))

  def close(self) -> None:
    self._batcher.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
    return False
