"""The port's `train_eval_model` and `continuous_eval` against the JAX
package's (`tests/test_train_eval.py`'s cases, one for one, through the
ported `MockT2RModel`), graphed (a `StepGraph` per train and eval step;
on the CPU it runs eagerly over the same buffers) and eager.

The JAX trainer runs once per module, and the port starts from its
initial weights (carried across by `models.convert`, written as a step-0
checkpoint that the port's trainer resumes from).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tensor2robot_tpu import train_eval as jax_train_eval  # noqa: E402
from tensor2robot_tpu.data.random_input_generator import (  # noqa: E402
    RandomInputGenerator as JaxRandomInputGenerator,
)
from tensor2robot_tpu.utils.mocks import MockT2RModel as JaxMock  # noqa: E402
from tensor2robot_tpu_torch import train_eval  # noqa: E402
from tensor2robot_tpu_torch.data.random_input_generator import (  # noqa: E402
    RandomInputGenerator,
)
from tensor2robot_tpu_torch.hooks import Hook  # noqa: E402
from tensor2robot_tpu_torch.models import convert  # noqa: E402
from tensor2robot_tpu_torch.models.abstract_model import (  # noqa: E402
    AbstractT2RModel,
)
from tensor2robot_tpu_torch.telemetry.records import read_records  # noqa: E402
from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib  # noqa: E402
from tensor2robot_tpu_torch.utils import step_graph  # noqa: E402
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel  # noqa: E402

_CPU = dict(device="cpu")


class RecordingHook(Hook):

  def __init__(self):
    self.began = False
    self.steps = []
    self.checkpoints = []
    self.ended = False

  def begin(self, model, model_dir):
    self.began = True

  def after_step(self, step, metrics):
    self.steps.append(step)

  def after_checkpoint(self, step, state, model_dir):
    self.checkpoints.append(step)

  def end(self, step, state, model_dir):
    self.ended = True


# ---- against the JAX trainer ----


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
  """The JAX trainer: 6 steps of MockT2RModel on seeded batches, eval
  every 3 steps and at the end; and its initial state."""
  model_dir = str(tmp_path_factory.mktemp("jax") / "m")
  model = JaxMock()
  init = model.create_train_state(jax.random.PRNGKey(0), batch_size=2)
  state = jax_train_eval.train_eval_model(
      model=model, model_dir=model_dir,
      input_generator_train=JaxRandomInputGenerator(batch_size=8, seed=5),
      input_generator_eval=JaxRandomInputGenerator(batch_size=8, seed=9),
      max_train_steps=6, eval_steps=2, eval_every_steps=3,
      save_checkpoints_steps=6, log_every_steps=3)
  evals = read_records(os.path.join(model_dir, "metrics_eval.jsonl"))
  return (jax.device_get(init.params), jax.device_get(state.params), evals)


def _port_start(model_dir, jax_params):
  """A step-0 checkpoint of the JAX initial params (fresh Adam state)."""
  model = MockT2RModel()
  params = convert.convert_variables({"params": jax_params}).params
  state = model.create_train_state(seed=0, device="cpu")
  state = type(state)(step=0, params=params, batch_stats={},
                      opt_state=model.tx.init(params))
  ckpt_lib.CheckpointWriter(model_dir).save(0, state)
  return model


@pytest.mark.parametrize("graphs,k", [(True, 1), (True, 3), (False, 1)])
def test_training_and_eval_match_the_jax_trainer(tmp_path, jax_run, graphs,
                                                 k):
  init, want, jax_evals = jax_run
  model_dir = str(tmp_path / "m")
  model = _port_start(model_dir, init)
  state = train_eval.train_eval_model(
      model, model_dir, RandomInputGenerator(batch_size=8, seed=5),
      RandomInputGenerator(batch_size=8, seed=9), max_train_steps=6,
      eval_steps=2, eval_every_steps=3, save_checkpoints_steps=6,
      log_every_steps=3, steps_per_dispatch=k, graphs=graphs, **_CPU)
  assert state.step == 6
  got = convert.convert_variables({"params": want}).params
  for key, value in got.items():
    np.testing.assert_allclose(state.params[key].numpy(), value.numpy(),
                               rtol=1e-5, atol=1e-6, err_msg=key)
  evals = read_records(os.path.join(model_dir, "metrics_eval.jsonl"))
  assert [r["step"] for r in evals] == [r["step"] for r in jax_evals]
  for mine, theirs in zip(evals, jax_evals):
    for key in ("loss", "mse", "mae"):
      np.testing.assert_allclose(mine[key], theirs[key], rtol=1e-5,
                                 atol=1e-6, err_msg=key)


def test_eval_step_matches_jax(jax_run):
  init, _, _ = jax_run
  jax_model = JaxMock()
  jax_state = jax_model.create_train_state(jax.random.PRNGKey(0),
                                           batch_size=2)
  gen = JaxRandomInputGenerator(batch_size=8, seed=9)
  gen.set_specification_from_model(jax_model, jax_train_eval.Mode.EVAL)
  features, labels = next(iter(gen.create_dataset(jax_train_eval.Mode.EVAL)))
  want = jax.device_get(jax_model.eval_step(jax_state, features, labels))
  model = MockT2RModel()
  state = model.create_train_state(seed=0, device="cpu")
  state = type(state)(step=0, params=convert.convert_variables(
      {"params": init}).params, batch_stats={})
  got = model.eval_step(
      state, {k: torch.from_numpy(np.asarray(v))
              for k, v in features.to_flat_dict().items()},
      {k: torch.from_numpy(np.asarray(v))
       for k, v in labels.to_flat_dict().items()})
  assert set(got) == set(want)
  for key in want:
    np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-6,
                               err_msg=key)


def test_eval_step_weighs_in_an_auxiliary_loss():
  class AuxNet(torch.nn.Module):
    def __init__(self):
      super().__init__()
      self.w = torch.nn.Parameter(torch.ones(()))

    def forward(self, features):
      return {"y": features["x"] * self.w, "_aux_loss": self.w * 3}

  class AuxModel(AbstractT2RModel):
    def get_feature_specification(self, mode):
      return None

    def get_label_specification(self, mode):
      return None

    def create_network(self):
      return AuxNet()

    def model_train_fn(self, features, labels, outputs, mode):
      assert "_aux_loss" not in outputs
      loss = outputs["y"].mean()
      return loss, {"y_mean": loss}

  model = AuxModel(aux_loss_weight=0.5)
  state = model.create_train_state(device="cpu")
  batch = {"x": torch.full((4,), 2.0)}
  metrics = model.eval_step(state, batch, {})
  assert metrics["aux_loss"].item() == 3.0
  assert metrics["loss"].item() == 2.0 + 0.5 * 3.0
  assert metrics["y_mean"].item() == 2.0
  _, step_metrics = model.train_step(state, batch, {})
  assert step_metrics["loss"].item() == 3.5
  assert step_metrics["aux_loss"].item() == 3.0


# ---- tests/test_train_eval.py's cases ----


def test_train_eval_end_to_end(tmp_path):
  model_dir = str(tmp_path / "m")
  hook = RecordingHook()
  state = train_eval.train_eval_model(
      MockT2RModel(), model_dir,
      input_generator_train=RandomInputGenerator(batch_size=16),
      input_generator_eval=RandomInputGenerator(batch_size=16),
      max_train_steps=20, eval_steps=3, save_checkpoints_steps=10,
      log_every_steps=5, hooks=[hook], **_CPU)
  assert state.step == 20
  assert ckpt_lib.list_steps(model_dir) == [10, 20]
  assert hook.began and hook.ended
  assert hook.checkpoints == [10, 20]
  assert len(hook.steps) == 20
  records = read_records(os.path.join(model_dir, "metrics_train.jsonl"))
  assert records[-1]["step"] == 20
  assert "loss" in records[-1] and "steps_per_sec" in records[-1]
  eval_lines = open(os.path.join(model_dir,
                                 "metrics_eval.jsonl")).readlines()
  assert len(eval_lines) >= 1


def test_resume_from_checkpoint(tmp_path):
  model_dir = str(tmp_path / "m")
  common = dict(input_generator_train=RandomInputGenerator(batch_size=8),
                save_checkpoints_steps=5, log_every_steps=5, **_CPU)
  first = train_eval.train_eval_model(MockT2RModel(), model_dir,
                                      max_train_steps=10, **common)
  kept = step_graph.copy_tree(first)
  assert ckpt_lib.latest_step(model_dir) == 10
  state = train_eval.train_eval_model(MockT2RModel(), model_dir,
                                      max_train_steps=15, **common)
  assert state.step == 15 and 15 in ckpt_lib.list_steps(model_dir)
  assert int(state.opt_state[0].count) == 15
  # The first call's state is a copy that the second call never wrote.
  for a, b in zip(step_graph.tensors(first), step_graph.tensors(kept)):
    assert torch.equal(a, b)


def test_eval_only(tmp_path):
  model_dir = str(tmp_path / "m")
  train_eval.train_eval_model(
      MockT2RModel(), model_dir,
      input_generator_eval=RandomInputGenerator(batch_size=8),
      max_train_steps=0, eval_steps=2, **_CPU)
  eval_lines = open(os.path.join(model_dir,
                                 "metrics_eval.jsonl")).readlines()
  assert len(eval_lines) == 1


def test_train_loss_decreases(tmp_path, jax_run):
  """From the JAX test's initial weights (flax's draw from PRNGKey(0)),
  carried across, on the same batches."""
  model_dir = str(tmp_path / "m")
  train_eval.train_eval_model(
      _port_start(model_dir, jax_run[0]), model_dir,
      input_generator_train=RandomInputGenerator(batch_size=32, seed=3),
      max_train_steps=200, save_checkpoints_steps=200, log_every_steps=10,
      **_CPU)
  records = read_records(os.path.join(model_dir, "metrics_train.jsonl"))
  assert records[-1]["loss"] < records[0]["loss"]


def test_continuous_eval(tmp_path):
  model_dir = str(tmp_path / "m")
  model = MockT2RModel()
  train_eval.train_eval_model(
      model, model_dir,
      input_generator_train=RandomInputGenerator(batch_size=8),
      max_train_steps=10, save_checkpoints_steps=5, **_CPU)
  results = train_eval.continuous_eval(
      model, model_dir, RandomInputGenerator(batch_size=8), eval_steps=2,
      timeout_secs=0.5, poll_interval_secs=0.1, max_evals=5, **_CPU)
  assert 10 in results
  assert "loss" in results[10]
  assert results[10]["restore_and_eval_secs"] >= results[10]["eval_secs"]


def test_steps_per_dispatch_matches_per_step_training(tmp_path):
  def run(k, name, graphs=True):
    return train_eval.train_eval_model(
        MockT2RModel(), str(tmp_path / name),
        input_generator_train=RandomInputGenerator(batch_size=8, seed=5),
        max_train_steps=6, save_checkpoints_steps=6, log_every_steps=3,
        steps_per_dispatch=k, graphs=graphs, **_CPU)

  base = run(1, "k1", graphs=False)
  for name, k in (("k1g", 1), ("k3", 3)):
    other = run(k, name)
    assert other.step == 6
    for a, b in zip(step_graph.tensors(base), step_graph.tensors(other)):
      assert torch.equal(a, b)


def test_steps_per_dispatch_rejects_misaligned_cadence(tmp_path):
  with pytest.raises(ValueError, match="multiple of"):
    train_eval.train_eval_model(
        MockT2RModel(), str(tmp_path / "bad"),
        input_generator_train=RandomInputGenerator(batch_size=8),
        max_train_steps=10, save_checkpoints_steps=5, log_every_steps=5,
        steps_per_dispatch=4, **_CPU)
  with pytest.raises(ValueError, match="eval_every_steps"):
    train_eval.train_eval_model(
        MockT2RModel(), str(tmp_path / "bad"),
        input_generator_train=RandomInputGenerator(batch_size=8),
        max_train_steps=8, save_checkpoints_steps=4, log_every_steps=4,
        eval_every_steps=6, steps_per_dispatch=4, **_CPU)


def test_completed_run_reinvoked_with_k_noops(tmp_path):
  kwargs = dict(input_generator_train=RandomInputGenerator(batch_size=8),
                **_CPU)
  model_dir = str(tmp_path / "m")
  train_eval.train_eval_model(MockT2RModel(), model_dir, max_train_steps=5,
                              save_checkpoints_steps=5, log_every_steps=5,
                              **kwargs)
  state = train_eval.train_eval_model(
      MockT2RModel(), model_dir, max_train_steps=4,
      save_checkpoints_steps=4, log_every_steps=4, steps_per_dispatch=4,
      **kwargs)
  assert state.step == 5


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh=object()), "A11"),
    (dict(sharding_strategy="fsdp"), "A11"),
    (dict(min_size_to_shard=64), "A11"),
])
def test_unported_arguments_raise_naming_the_roadmap_item(tmp_path, kwargs,
                                                          item):
  with pytest.raises(NotImplementedError, match=item):
    train_eval.train_eval_model(MockT2RModel(), str(tmp_path / "m"),
                                max_train_steps=1, **kwargs, **_CPU)
  assert not os.path.exists(tmp_path / "m")


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="cuda"):
    train_eval.train_eval_model(MockT2RModel(), str(tmp_path / "m"))
  with pytest.raises(RuntimeError, match="cuda"):
    train_eval.continuous_eval(MockT2RModel(), str(tmp_path / "m"),
                               RandomInputGenerator(batch_size=8))
