"""Checkpoint-backed predictor: the model class + the trainer's own
checkpoints (port of `predictors/checkpoint_predictor.py`).

`restore()` polls `checkpoint_dir` for a step newer than the one loaded
and reads its params and batch statistics (`utils.checkpoints.
restore_variables`: the port's checkpoints, not orbax's). `predict` runs
the model's `predict_step` on the device (None = the CUDA card; raises
without one), one captured graph per batch shape
(`utils.step_graph.GraphCache`, as `train_eval`'s evaluator runs its
eval step): a restore loads the new state into the graphs' buffers and
recaptures nothing. On the CPU the same step runs eagerly over the same
buffers.

Serving mode (`max_batch` set): `predict` goes through a `MicroBatcher`
over a `BucketedServingEngine` (powers-of-two buckets, one graph each,
two params slots that `restore()` swaps), so concurrent callers share
dispatches; `warmup` captures the buckets at construction, on a thread
when `overlap_startup` (joined by `restore()` and `warmup_seconds`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.device import DeviceLike, resolve_device
from tensor2robot_tpu_torch.models.abstract_model import TrainState
from tensor2robot_tpu_torch.predictors.abstract_predictor import (
    AbstractPredictor,
)
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib
from tensor2robot_tpu_torch.utils.step_graph import GraphCache


def _host(value) -> np.ndarray:
  """An output as a host numpy array (bf16, which numpy lacks, as f32)."""
  if not isinstance(value, torch.Tensor):
    return np.asarray(value)
  if value.dtype == torch.bfloat16:
    value = value.float()
  return value.detach().cpu().numpy()


@gin.configurable
class CheckpointPredictor(AbstractPredictor):
  """Serves a model directly from its training checkpoints."""

  def __init__(self, model, checkpoint_dir: Optional[str] = None,
               init_batch_size: int = 1,
               max_batch: Optional[int] = None,
               max_wait_us: int = 200,
               warmup: bool = True,
               overlap_startup: bool = True,
               device: DeviceLike = None):
    """The JAX constructor's arguments, plus `device` (None = the CUDA
    card). `init_batch_size` is accepted for the JAX signature: the port
    builds networks from their specs."""
    from tensor2robot_tpu_torch.startup import compile_cache
    compile_cache.configure_compilation_cache()
    del init_batch_size
    self._device = resolve_device(device)
    self._model = model
    self._checkpoint_dir = checkpoint_dir
    # Inference-only state: no optimizer moments on the robot.
    self._state = model.create_inference_state(seed=0, device=self._device)
    self._restored_step = -1
    self._feature_spec = specs_lib.flatten_spec_structure(
        model.preprocessor.get_in_feature_specification(Mode.PREDICT))
    step = lambda state, features, generators: (  # noqa: E731
        state, model.predict_step(state, features))
    self._graphs = GraphCache(step, self._state, self._device,
                              carries=False)
    self._engine = None
    self._batcher = None
    if max_batch is not None:
      from tensor2robot_tpu_torch.serving import (
          BucketedServingEngine,
          MicroBatcher,
      )
      example = specs_lib.make_random_tensors(
          self._feature_spec, batch_size=1, seed=0)
      self._engine = BucketedServingEngine(
          model.predict_step, self._state, example, max_batch=max_batch,
          device=self._device)
      if warmup and overlap_startup:
        self._engine.warmup_async()
      elif warmup:
        self._engine.warmup()
      self._batcher = MicroBatcher(self._engine, max_wait_us=max_wait_us)

  @property
  def device(self) -> torch.device:
    return self._device

  @property
  def warmup_seconds(self) -> float:
    """Wall seconds the engine spent capturing buckets (joins an
    in-flight async warmup first); 0 without an engine."""
    if self._engine is None:
      return 0.0
    self._engine.wait_warmup()
    return self._engine.warmup_seconds

  @property
  def feature_specification(self) -> TensorSpecStruct:
    return self._feature_spec

  @property
  def label_specification(self):
    return self._model.preprocessor.get_in_label_specification(
        Mode.PREDICT)

  @property
  def model_version(self) -> int:
    return self._restored_step

  def init_randomly(self) -> None:
    self._restored_step = 0

  def restore(self, timeout_secs: Optional[float] = None) -> bool:
    """Loads the newest params and batch statistics; blocks up to
    `timeout_secs` for a checkpoint newer than the one loaded."""
    if self._checkpoint_dir is None:
      raise ValueError("CheckpointPredictor needs a checkpoint_dir.")
    last = self._restored_step if self._restored_step > 0 else None
    step = ckpt_lib.wait_for_new_checkpoint(
        self._checkpoint_dir, last_step=last, timeout_secs=timeout_secs)
    if step is None:
      if self._engine is not None:
        self._engine.wait_warmup()
      return self._restored_step >= 0
    # Params AND batch statistics: serving with fresh-init moving
    # averages silently degrades a batch-norm model.
    variables = ckpt_lib.restore_variables(
        self._checkpoint_dir,
        like={"params": self._state.params,
              "batch_stats": self._state.batch_stats},
        step=step)
    self._state = TrainState(step=step, params=variables["params"],
                             batch_stats=variables["batch_stats"])
    self._restored_step = step
    self._graphs.load(self._state)
    if self._engine is not None:
      # Published only after the whole restore succeeded: a dispatch
      # in flight keeps the old slot, the next reads the new one.
      self._engine.swap_state(self._state)
      self._engine.wait_warmup()
    return True

  def predict(self, features: Dict[str, np.ndarray]) -> Dict[str, Any]:
    self.assert_is_loaded()
    packed = self._validate(features).to_flat_dict()
    if self._batcher is not None:
      outputs = self._batcher.predict(
          {k: np.asarray(v) for k, v in packed.items()})
    else:
      outputs = self._graphs.replay(
          {k: torch.as_tensor(np.asarray(v), device=self._device)
           for k, v in packed.items()})
    if isinstance(outputs, TensorSpecStruct):
      outputs = outputs.to_flat_dict()
    if not isinstance(outputs, dict):
      outputs = {"output": outputs}
    return {k: _host(v) for k, v in outputs.items()}

  @property
  def serving_engine(self):
    """The serving-mode engine (None on the per-call path)."""
    return self._engine

  def close(self) -> None:
    if self._batcher is not None:
      self._batcher.close()
