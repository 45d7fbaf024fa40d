"""Per-checkpoint closed-loop success evaluation (port of
`hooks/success_eval_hook.py`).

The trainer drives the hook after each checkpoint, and a `success_rate`
line lands in `metrics_<tag>.jsonl` next to the train metrics.

  * `SuccessEvalHook` wraps any `eval_fn(predict_fn, **kwargs)` protocol
    (e.g. `research.vrgripper.evaluate_gripper_policy`): the hook builds
    the batched `predict(numpy dict) -> numpy dict` from the in-memory
    train state, on the state's device, so no checkpoint round-trip is
    paid.
  * `QTOptSuccessEvalHook` wraps `evaluate_grasp_policy(learner, state,
    ...)`: the CEM policy needs the learner, not `predict_step`.
  * `ScenarioSuccessEvalHook` runs `envs.evaluate_scenarios`, the
    seeded procedural sweep, for the Anakin trainer.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.hooks.hook import Hook


def _write_metrics(model_dir: str, tag: str, step: int,
                   metrics: Dict[str, float]) -> None:
  from tensor2robot_tpu_torch.train_eval import MetricLogger  # lazy: cycle

  logger = MetricLogger(model_dir)
  try:
    logger.write(tag, step, metrics)
  finally:
    logger.close()


def _to_numpy(outputs: Any) -> Dict[str, np.ndarray]:
  if hasattr(outputs, "to_flat_dict"):
    outputs = outputs.to_flat_dict()
  elif not isinstance(outputs, Mapping):
    outputs = {"output": outputs}
  return {k: v.detach().float().cpu().numpy()
          if isinstance(v, torch.Tensor) else np.asarray(v)
          for k, v in outputs.items()}


@gin.configurable
class SuccessEvalHook(Hook):
  """Runs `eval_fn(predict_fn, **eval_kwargs)` after each checkpoint.

  Args:
    eval_fn: e.g. `evaluate_gripper_policy`; receives a batched
      `predict(features: numpy dict) -> numpy dict` plus `eval_kwargs`
      (episode counts, held-out seeds: the protocol lives in these).
    eval_kwargs: forwarded verbatim.
    tag: metrics file suffix (metrics_<tag>.jsonl).
    every_n_checkpoints: thin out when eval is expensive.
  """

  def __init__(self,
               eval_fn: Callable[..., Dict[str, float]],
               eval_kwargs: Optional[Dict[str, Any]] = None,
               tag: str = "success_eval",
               every_n_checkpoints: int = 1):
    self._eval_fn = eval_fn
    self._eval_kwargs = dict(eval_kwargs or {})
    self._tag = tag
    self._every = max(1, every_n_checkpoints)
    self._model = None
    self._checkpoints_seen = 0

  def begin(self, model, model_dir: str) -> None:
    self._model = model
    self._checkpoints_seen = 0

  def after_checkpoint(self, step: int, state: Any,
                       model_dir: str) -> None:
    self._checkpoints_seen += 1
    if (self._checkpoints_seen - 1) % self._every:
      return
    from tensor2robot_tpu_torch.specs import TensorSpecStruct

    device = next(iter(state.params.values())).device

    def predict(features: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
      packed = TensorSpecStruct.from_flat_dict(
          {k: torch.as_tensor(np.asarray(v), device=device)
           for k, v in features.items()})
      return _to_numpy(self._model.predict_step(state, packed))

    metrics = self._eval_fn(predict, **self._eval_kwargs)
    _write_metrics(model_dir, self._tag, step, metrics)


@gin.configurable
class ScenarioSuccessEvalHook(Hook):
  """Per-checkpoint procedural-scenario robustness sweep (envs family).

  After each checkpoint it runs `envs.evaluate_scenarios` (the seeded
  procgen sweep of `run_success_protocol envs`: success grouped by
  scenario bucket, the distractor count, with the random-policy baseline
  on the SAME scenarios) against the checkpointed critic, then

    * logs the headline metrics (overall and per-bucket success, the
      random baseline) to ``metrics_<tag>.jsonl`` next to the train
      metrics,
    * appends one success-protocol record per checkpoint to
      ``artifacts_path`` (default
      ``<model_dir>/success_protocol/scenarios_by_checkpoint.jsonl``).

  The sweep is seeded: every checkpoint is scored on the same scenarios.
  `train_anakin` hands hooks the critic `TrainState`, which
  `build_policy` takes directly.
  """

  def __init__(self,
               learner=None,
               env=None,
               num_scenarios: int = 256,
               seed: int = 0,
               cem_population: Optional[int] = None,
               cem_iterations: Optional[int] = None,
               tag: str = "scenario_eval",
               every_n_checkpoints: int = 1,
               artifacts_path: Optional[str] = None):
    self._learner = learner
    self._env = env
    self._num_scenarios = int(num_scenarios)
    self._seed = int(seed)
    self._cem_population = cem_population
    self._cem_iterations = cem_iterations
    self._tag = tag
    self._every = max(1, every_n_checkpoints)
    self._artifacts_path = artifacts_path
    self._checkpoints_seen = 0

  def begin(self, model, model_dir: str) -> None:
    self._checkpoints_seen = 0

  def after_checkpoint(self, step: int, state: Any,
                       model_dir: str) -> None:
    self._checkpoints_seen += 1
    if (self._checkpoints_seen - 1) % self._every:
      return
    from tensor2robot_tpu_torch.envs import evaluate_scenarios

    sweep = evaluate_scenarios(
        self._learner, state, env=self._env,
        num_scenarios=self._num_scenarios, seed=self._seed,
        cem_population=self._cem_population,
        cem_iterations=self._cem_iterations)
    metrics = {
        "success_rate": sweep["success_rate"],
        "random_baseline_success_rate":
            sweep["random_baseline_success_rate"],
        "num_scenarios": sweep["num_scenarios"],
    }
    for bucket, stats in sorted(sweep["per_bucket"].items()):
      if stats["success_rate"] is not None:
        metrics[f"bucket_{bucket}_success_rate"] = stats["success_rate"]
    _write_metrics(model_dir, self._tag, step, metrics)

    path = self._artifacts_path or os.path.join(
        model_dir, "success_protocol", "scenarios_by_checkpoint.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    record = {
        "phase": "checkpoint_sweep",
        "step": int(step),
        "scenario_family": (type(self._env).__name__
                            if self._env is not None else "procgen"),
        **{k: sweep[k] for k in (
            "success_rate", "random_baseline_success_rate",
            "num_scenarios", "per_bucket", "action_digest",
            "scenario_digest")},
    }
    with open(path, "a") as f:
      f.write(json.dumps(record) + "\n")


@gin.configurable
class QTOptSuccessEvalHook(Hook):
  """CEM-policy grasp success per checkpoint (QT-Opt loop).

  `train_qtopt` hands hooks the critic `TrainState`; the CEM policy
  reads exactly that (the target network never acts), so the hook
  passes it straight to `evaluate_grasp_policy`.
  """

  def __init__(self,
               learner=None,
               eval_kwargs: Optional[Dict[str, Any]] = None,
               tag: str = "success_eval",
               every_n_checkpoints: int = 1):
    self._learner = learner
    self._eval_kwargs = dict(eval_kwargs or {})
    self._tag = tag
    self._every = max(1, every_n_checkpoints)
    self._checkpoints_seen = 0

  def begin(self, model, model_dir: str) -> None:
    self._checkpoints_seen = 0

  def after_checkpoint(self, step: int, state: Any,
                       model_dir: str) -> None:
    self._checkpoints_seen += 1
    if (self._checkpoints_seen - 1) % self._every:
      return
    from tensor2robot_tpu_torch.research.qtopt.grasping_env import (
        evaluate_grasp_policy,
    )

    metrics = evaluate_grasp_policy(self._learner, state,
                                    **self._eval_kwargs)
    _write_metrics(model_dir, self._tag, step, metrics)
