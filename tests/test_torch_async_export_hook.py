"""The port's `AsyncExportHook` and `train_eval_model`'s exporters on the
CPU: the JAX hook's cases (`tests/test_export_predict.py`: exports on
checkpoint, the cadence), its drop-the-older-request worker, the host
snapshot, `create_exporters_fn` after training, and the gin binding
`train_eval_model.create_exporters_fn = @create_default_exporters`
through the port's trainer binary.
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensor2robot_tpu import train_eval as jax_train_eval  # noqa: E402
from tensor2robot_tpu.data.random_input_generator import (  # noqa: E402
    RandomInputGenerator as JaxRandomInputGenerator,
)
from tensor2robot_tpu.hooks import Hook as JaxHook  # noqa: E402
from tensor2robot_tpu.utils.mocks import MockT2RModel as JaxMock  # noqa: E402
from tensor2robot_tpu_torch import config as gin  # noqa: E402
from tensor2robot_tpu_torch import specs  # noqa: E402
from tensor2robot_tpu_torch import train_eval  # noqa: E402
from tensor2robot_tpu_torch.bin import run_t2r_trainer  # noqa: E402
from tensor2robot_tpu_torch.data import RandomInputGenerator  # noqa: E402
from tensor2robot_tpu_torch.export import (  # noqa: E402
    AbstractExportGenerator,
    SavedModelExportGenerator,
    latest_export_dir,
)
from tensor2robot_tpu_torch.hooks import AsyncExportHook  # noqa: E402
from tensor2robot_tpu_torch.models.abstract_model import (  # noqa: E402
    TrainState,
)
from tensor2robot_tpu_torch.predictors import SavedModelPredictor  # noqa: E402
from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib  # noqa: E402
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel  # noqa: E402

_CPU = dict(device="cpu")
_TIMEOUT_S = 60.0


def _generator(**kwargs):
  return SavedModelExportGenerator(platforms=("cpu",), **kwargs)


def _train(model_dir, hooks=(), **kwargs):
  kwargs.setdefault("max_train_steps", 2)
  kwargs.setdefault("save_checkpoints_steps", 2)
  return train_eval.train_eval_model(
      model=MockT2RModel(), model_dir=str(model_dir),
      input_generator_train=RandomInputGenerator(batch_size=8),
      hooks=list(hooks), **kwargs, **_CPU)


def test_hook_exports_on_checkpoint(tmp_path):
  hook = AsyncExportHook(_generator(), block=True)
  _train(tmp_path / "hooked", hooks=[hook])
  assert len(hook.export_paths) == 1
  assert latest_export_dir(str(tmp_path / "hooked" / "export")) == (
      hook.export_paths[0])


class _CountingJaxHook(JaxHook):
  """Counts the checkpoints the JAX trainer hands its hooks."""

  def __init__(self):
    self.count = 0

  def after_checkpoint(self, step, state, model_dir):
    self.count += 1


def test_hook_cadence_as_jax(tmp_path):
  """4 checkpoints (+ the final one deduped) at an every-2 cadence: 2
  exports, as the JAX hook counts the same trainer's checkpoints."""
  hook = AsyncExportHook(_generator(), export_every_n_checkpoints=2,
                         block=True)
  _train(tmp_path / "cadence", hooks=[hook], max_train_steps=4,
         save_checkpoints_steps=1)
  jax_hook = _CountingJaxHook()
  jax_train_eval.train_eval_model(
      model=JaxMock(), model_dir=str(tmp_path / "jax"),
      input_generator_train=JaxRandomInputGenerator(batch_size=8),
      max_train_steps=4, save_checkpoints_steps=1, hooks=[jax_hook])
  assert len(hook.export_paths) == jax_hook.count // 2 == 2


def test_export_dir_base_override(tmp_path):
  hook = AsyncExportHook(_generator(), export_dir_base=str(tmp_path / "x"),
                         block=True)
  _train(tmp_path / "m", hooks=[hook])
  assert latest_export_dir(str(tmp_path / "x")) == hook.export_paths[0]
  assert not os.path.exists(tmp_path / "m" / "export")


class _GatedGenerator(AbstractExportGenerator):
  """Records each export's step; the first export waits on a gate."""

  def __init__(self):
    super().__init__()
    self.gate = threading.Event()
    self.started = threading.Event()
    self.steps = []
    self.threads = set()

  def export(self, model, state, model_dir):
    self.threads.add(threading.current_thread().name)
    self.started.set()
    assert self.gate.wait(_TIMEOUT_S)
    self.steps.append(int(state.step))
    return f"{model_dir}/{int(state.step)}"


def _state(step, value=0.0):
  return TrainState(step=step, params={"w": torch.full((2,), value)},
                    batch_stats={}, opt_state={"mu": torch.zeros(2)})


def test_the_worker_drops_the_older_request_and_end_drains():
  generator = _GatedGenerator()
  hook = AsyncExportHook(generator)
  hook.begin(None, "m")
  hook.after_checkpoint(1, _state(1), "m")
  assert generator.started.wait(_TIMEOUT_S)  # step 1 is exporting
  hook.after_checkpoint(2, _state(2), "m")   # pending
  hook.after_checkpoint(3, _state(3), "m")   # replaces step 2
  generator.gate.set()
  hook.end(3, _state(3), "m")
  assert generator.steps == [1, 3]
  assert hook.export_paths == ["m/1", "m/3"]
  assert generator.threads == {"async-export"}


def test_the_snapshot_is_a_host_copy_without_optimizer_state():
  seen = []

  class Recording(AbstractExportGenerator):

    def export(self, model, state, model_dir):
      seen.append(state)
      return "path"

  hook = AsyncExportHook(Recording(), block=True)
  state = _state(5, value=1.0)
  hook.after_checkpoint(5, state, "m")
  state.params["w"].add_(41.0)  # the trainer's buffers move on
  (snapshot,) = seen
  assert snapshot.step == 5 and snapshot.opt_state is None
  assert snapshot.params["w"].device == torch.device("cpu")
  assert snapshot.params["w"].data_ptr() != state.params["w"].data_ptr()
  np.testing.assert_array_equal(snapshot.params["w"].numpy(), [1.0, 1.0])


def test_a_failed_export_does_not_stop_training(tmp_path, caplog):
  class Failing(AbstractExportGenerator):

    def export(self, model, state, model_dir):
      raise RuntimeError("disk full")

  hook = AsyncExportHook(Failing())
  state = _train(tmp_path / "m", hooks=[hook], max_train_steps=4)
  assert state.step == 4 and hook.export_paths == []
  assert "Async export failed" in caplog.text


def test_create_exporters_fn_exports_after_training(tmp_path):
  """`train_eval_model(create_exporters_fn=...)` exports the final state,
  as the JAX trainer does; the export serves what the state computes."""
  model_dir = tmp_path / "m"
  seen = []

  def exporters(model):
    seen.append(model)
    return [_generator()]

  state = _train(model_dir, max_train_steps=3, save_checkpoints_steps=3,
                 create_exporters_fn=exporters)
  assert len(seen) == 1 and isinstance(seen[0], MockT2RModel)
  predictor = SavedModelPredictor(str(model_dir / "export"), device="cpu")
  assert predictor.restore(timeout_secs=0)
  assert predictor.global_step == 3
  x = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
  want = MockT2RModel().predict_step(state, {"x": torch.from_numpy(x)})
  np.testing.assert_array_equal(
      predictor.predict({"x": x})["inference_output"],
      want["inference_output"].numpy())
  saved = ckpt_lib.restore_variables(
      str(model_dir), like={"params": state.params, "batch_stats": {}})
  for key, value in saved["params"].items():
    assert torch.equal(value, state.params[key])


def test_the_default_exporters_bind_through_the_trainer_binary(tmp_path):
  model_dir = str(tmp_path / "m")
  try:
    assert run_t2r_trainer.main([
        "--gin_bindings", "train_eval_model.model = @MockT2RModel()",
        "--gin_bindings",
        "train_eval_model.input_generator_train = @RandomInputGenerator()",
        "--gin_bindings", "RandomInputGenerator.batch_size = 8",
        "--gin_bindings", f"train_eval_model.model_dir = '{model_dir}'",
        "--gin_bindings", "train_eval_model.max_train_steps = 2",
        "--gin_bindings", "train_eval_model.device = 'cpu'",
        "--gin_bindings",
        "train_eval_model.create_exporters_fn = @create_default_exporters",
        "--gin_bindings", "create_default_exporters.platforms = ('cpu',)",
        "--gin_bindings", "create_default_exporters.serving_max_batch = 4",
    ]) == 0
  finally:
    gin.clear_config()
  predictor = SavedModelPredictor(os.path.join(model_dir, "export"),
                                  device="cpu")
  assert predictor.restore(timeout_secs=0)
  assert predictor.global_step == 2
  assert predictor.serving_metadata["bucket_sizes"] == [1, 2, 4]


def test_the_hook_binds_through_the_registry(tmp_path):
  try:
    gin.parse_config(
        "AsyncExportHook.export_generator = "
        "@SavedModelExportGenerator()\n"
        "AsyncExportHook.block = True\n"
        "SavedModelExportGenerator.platforms = ('cpu',)")
    hook = AsyncExportHook()
    _train(tmp_path / "m", hooks=[hook])
  finally:
    gin.clear_config()
  assert len(hook.export_paths) == 1


def test_snapshot_steps_follow_the_trainer(tmp_path):
  """Every export carries its checkpoint's step."""
  hook = AsyncExportHook(_generator(), block=True)
  _train(tmp_path / "m", hooks=[hook], max_train_steps=4,
         save_checkpoints_steps=2)
  steps = [specs.read_assets(os.path.join(
      path, "assets.extra", specs.ASSET_FILENAME))["global_step"]
           for path in hook.export_paths]
  assert steps == [2, 4]
