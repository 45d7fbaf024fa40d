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

`ScenarioSuccessEvalHook` needs the on-device envs (ROADMAP A8).
"""

from __future__ import annotations

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
