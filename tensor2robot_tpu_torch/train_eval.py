"""train_eval_model: the training loop (port of the training half of
`train_eval.py`).

The model's `train_step` runs eagerly on the device: pull a numpy batch
from the input generator, move it to the device, step, and log the
metrics every `log_every_steps` steps (one host read per log) to
`<model_dir>/metrics_train.jsonl` in the telemetry envelope.

Not ported yet (ROADMAP A12): evaluation, checkpoints and resume,
exporters, hooks, meshes and sharding strategies, K-step dispatch and
AOT startup. `train_eval_model` takes none of their arguments.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

import torch

from tensor2robot_tpu_torch.data.abstract_input_generator import (
    AbstractInputGenerator,
    Mode,
)
from tensor2robot_tpu_torch.device import DeviceLike, resolve_device
from tensor2robot_tpu_torch.models.abstract_model import (
    AbstractT2RModel,
    TrainState,
)
from tensor2robot_tpu_torch.telemetry import records

log = logging.getLogger(__name__)


class MetricLogger:
  """Scalar metric sink: log line + one JSONL file per tag (train, ...),
  each record the telemetry envelope (`telemetry.records`)."""

  def __init__(self, model_dir: str):
    self._model_dir = model_dir
    os.makedirs(model_dir, exist_ok=True)
    self._files: Dict[str, Any] = {}

  def write(self, tag: str, step: int, metrics: Dict[str, Any]) -> None:
    scalars = {k: float(v) for k, v in metrics.items()}
    if tag not in self._files:
      self._files[tag] = open(
          os.path.join(self._model_dir, f"metrics_{tag}.jsonl"), "a")
    record = records.make_record(step, scalars)
    self._files[tag].write(json.dumps(record) + "\n")
    self._files[tag].flush()
    rendered = ", ".join(f"{k}={v:.5g}" for k, v in scalars.items())
    log.info("[%s] step %d: %s", tag, step, rendered)

  def close(self) -> None:
    for f in self._files.values():
      f.close()
    self._files.clear()


def _to_device(batch, device: torch.device) -> Optional[Dict[str, Any]]:
  """A numpy (or torch) batch struct as a flat dict of device tensors."""
  if batch is None:
    return None
  flat = batch.to_flat_dict() if hasattr(batch, "to_flat_dict") else batch
  return {k: torch.as_tensor(v).to(device) for k, v in flat.items()}


def train_eval_model(model: AbstractT2RModel,
                     model_dir: str,
                     input_generator_train: AbstractInputGenerator,
                     max_train_steps: int = 1000,
                     batch_size: Optional[int] = None,
                     log_every_steps: int = 100,
                     seed: int = 0,
                     device: DeviceLike = None) -> TrainState:
  """Trains `model` for `max_train_steps` steps from a fresh state made
  from `seed`, on `device` (None = the CUDA card; raises without one).

  Each logged record holds the step's metrics (`loss`, `grad_norm` and
  the model's scalars) and `steps_per_sec` over the interval. Returns
  the final `TrainState`.
  """
  device = resolve_device(device)
  logger = MetricLogger(model_dir)
  input_generator_train.set_specification_from_model(model, Mode.TRAIN)
  state = model.create_train_state(seed=seed, device=device)
  stream = input_generator_train.create_dataset(Mode.TRAIN,
                                                batch_size=batch_size)
  step = 0
  steps_since_log = 0
  t_last = time.time()
  try:
    for features, labels in stream:
      if step >= max_train_steps:
        break
      state, metrics = model.train_step(state, _to_device(features, device),
                                        _to_device(labels, device))
      step += 1
      steps_since_log += 1
      if step % log_every_steps == 0 or step == max_train_steps:
        scalars = {k: v.item() for k, v in metrics.items()}
        dt = time.time() - t_last
        scalars["steps_per_sec"] = steps_since_log / max(dt, 1e-9)
        logger.write("train", step, scalars)
        t_last = time.time()
        steps_since_log = 0
  finally:
    close = getattr(stream, "close", None)
    if close is not None:
      close()
    logger.close()
  return state
