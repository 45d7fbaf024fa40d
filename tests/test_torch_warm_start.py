"""Warm start from the port's checkpoints on the CPU: `restore_params`,
`restore_variables`' `path_or_model_dir` lookup (JAX's
`_find_params_path`: a model_dir's latest step or a given step, a step
directory, a direct file), and `init_from_checkpoint_path` /
`maybe_init_from_checkpoint`, the JAX cases of `tests/test_models.py`
(`TestWarmStart`): params, and batch statistics riding along. The JAX
models' states come through `models/convert.py` and must come back bit
for bit.
"""

import dataclasses
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tensor2robot_tpu.data.abstract_input_generator import (  # noqa: E402
    Mode as JaxMode,
)
from tensor2robot_tpu.research.pose_env import (  # noqa: E402
    PoseEnvRegressionModel as JaxPoseModel,
)
from tensor2robot_tpu.specs import make_random_tensors  # noqa: E402
from tensor2robot_tpu.utils.mocks import MockT2RModel as JaxMock  # noqa: E402
from tensor2robot_tpu_torch import train_eval  # noqa: E402
from tensor2robot_tpu_torch.data import RandomInputGenerator  # noqa: E402
from tensor2robot_tpu_torch.meta_learning import MAMLModel  # noqa: E402
from tensor2robot_tpu_torch.models import convert  # noqa: E402
from tensor2robot_tpu_torch.research.pose_env import (  # noqa: E402
    PoseEnvRegressionModel,
)
from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib  # noqa: E402
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel  # noqa: E402

_POSE = dict(image_size=16, filters=(4,), embedding_size=8,
             hidden_sizes=(8,), use_batch_norm=True)


def _equal(got, want):
  assert set(got) == set(want)
  for key in want:
    assert got[key].dtype == want[key].dtype, key
    assert torch.equal(got[key], want[key]), key


def _jax_mock_state():
  state = jax.jit(JaxMock().create_train_state)(jax.random.PRNGKey(42))
  return convert.convert_variables(
      {"params": jax.tree_util.tree_map(np.asarray, state.params)}, step=0)


@pytest.fixture(scope="module")
def jax_bn_state():
  """The JAX BN pose model after 3 train steps (moving averages moved),
  converted."""
  model = JaxPoseModel(**_POSE)
  state = model.create_train_state(jax.random.PRNGKey(0), batch_size=4)
  batch = make_random_tensors(
      model.preprocessor.get_in_feature_specification(JaxMode.TRAIN),
      batch_size=4, seed=1)
  labels = make_random_tensors(
      model.preprocessor.get_in_label_specification(JaxMode.TRAIN),
      batch_size=4, seed=2)
  step = jax.jit(model.train_step)
  for i in range(3):
    state, _ = step(state, batch, labels, jax.random.PRNGKey(i))
  return convert.convert_variables(jax.tree_util.tree_map(np.asarray, {
      "params": state.params, "batch_stats": state.batch_stats}), step=3)


def test_init_from_checkpoint(tmp_path):
  state = _jax_mock_state()
  ckpt_lib.CheckpointWriter(str(tmp_path)).save(0, state)
  warm = MockT2RModel(init_from_checkpoint_path=str(tmp_path))
  warm_state = warm.create_train_state(seed=7, device="cpu")
  _equal(warm_state.params, state.params)
  # The optimizer starts fresh over the warm params.
  assert warm_state.opt_state is not None
  cold = MockT2RModel().create_train_state(seed=7, device="cpu")
  assert any(not torch.equal(cold.params[k], v)
             for k, v in state.params.items())


def test_warm_start_restores_batch_stats(jax_bn_state, tmp_path):
  assert jax_bn_state.batch_stats, "the model under test carries BN stats"
  ckpt_lib.CheckpointWriter(str(tmp_path)).save(3, jax_bn_state)
  warm = PoseEnvRegressionModel(init_from_checkpoint_path=str(tmp_path),
                                **_POSE)
  state = warm.create_inference_state(seed=9, device="cpu")
  _equal(state.params, jax_bn_state.params)
  _equal(state.batch_stats, jax_bn_state.batch_stats)
  fresh = PoseEnvRegressionModel(**_POSE).create_inference_state(
      seed=9, device="cpu")
  assert any(not torch.equal(fresh.batch_stats[k], v)
             for k, v in jax_bn_state.batch_stats.items())


def test_leaves_take_the_fresh_states_dtype(jax_bn_state, tmp_path):
  """The checkpoint's leaves adopt `like`'s dtype and device."""
  ckpt_lib.CheckpointWriter(str(tmp_path)).save(3, jax_bn_state)
  like = {k: v.double() for k, v in jax_bn_state.params.items()}
  restored = ckpt_lib.restore_params(str(tmp_path), like=like)
  assert all(v.dtype == torch.float64 for v in restored.values())
  for key, value in restored.items():
    assert torch.equal(value, jax_bn_state.params[key].double())


@pytest.mark.parametrize("where", ["model_dir", "step", "step_dir", "file"])
def test_restore_params_finds_the_payload(where, tmp_path):
  states = {s: dataclasses.replace(
      MockT2RModel().create_train_state(seed=s, device="cpu"), step=s)
            for s in (1, 2)}
  writer = ckpt_lib.CheckpointWriter(str(tmp_path))
  for step, state in states.items():
    writer.save(step, state)
  like = states[1].params
  step_dir = os.path.join(str(tmp_path), "ckpt", "1")
  got = {
      "model_dir": lambda: ckpt_lib.restore_params(str(tmp_path), like),
      "step": lambda: ckpt_lib.restore_params(str(tmp_path), like, step=1),
      "step_dir": lambda: ckpt_lib.restore_params(step_dir, like),
      "file": lambda: ckpt_lib.restore_params(
          os.path.join(step_dir, "state.pt"), like),
  }[where]()
  _equal(got, states[2 if where == "model_dir" else 1].params)


def test_no_payload_raises_naming_the_candidates(tmp_path):
  with pytest.raises(FileNotFoundError, match="No params checkpoint"):
    ckpt_lib.restore_params(str(tmp_path / "none"), like={})


def test_restore_variables_takes_a_step_dir(jax_bn_state, tmp_path):
  ckpt_lib.CheckpointWriter(str(tmp_path)).save(3, jax_bn_state)
  variables = ckpt_lib.restore_variables(
      os.path.join(str(tmp_path), "ckpt", "3"),
      like={"params": jax_bn_state.params,
            "batch_stats": jax_bn_state.batch_stats})
  _equal(variables["params"], jax_bn_state.params)
  _equal(variables["batch_stats"], jax_bn_state.batch_stats)


def test_a_bare_params_payload_keeps_the_stats_with_a_warning(
    jax_bn_state, tmp_path, caplog):
  """A payload without batch statistics (the JAX package's legacy
  params-only file) restores the params; the stats stay as they were."""
  path = str(tmp_path / "params.pt")
  torch.save({"leaves": dict(jax_bn_state.params)}, path)
  fresh = PoseEnvRegressionModel(**_POSE).create_inference_state(
      device="cpu")
  with caplog.at_level(logging.WARNING):
    variables = ckpt_lib.restore_variables(
        path, like={"params": fresh.params,
                    "batch_stats": fresh.batch_stats})
  assert "no batch_stats" in caplog.text
  _equal(variables["params"], jax_bn_state.params)
  _equal(variables["batch_stats"], fresh.batch_stats)
  _equal(ckpt_lib.restore_params(path, like=fresh.params),
         jax_bn_state.params)


def test_a_missing_param_raises(tmp_path):
  state = MockT2RModel().create_train_state(device="cpu")
  ckpt_lib.CheckpointWriter(str(tmp_path)).save(0, state)
  like = {**state.params, "extra.weight": torch.zeros(1)}
  with pytest.raises(KeyError, match="extra.weight"):
    ckpt_lib.restore_params(str(tmp_path), like=like)


def test_warm_started_training_continues_from_the_checkpoint(tmp_path):
  """A trainer over a warm-started model starts at step 0 from the
  checkpoint's params (a warm start is not a resume)."""
  source = str(tmp_path / "source")
  trained = train_eval.train_eval_model(
      MockT2RModel(), source,
      input_generator_train=RandomInputGenerator(batch_size=8),
      max_train_steps=3, save_checkpoints_steps=3, device="cpu")
  warm = MockT2RModel(init_from_checkpoint_path=source)
  first = []

  class FirstState:

    def begin(self, model, model_dir):
      pass

    def after_step(self, step, metrics):
      pass

    def after_checkpoint(self, step, state, model_dir):
      first.append(state)

    def end(self, step, state, model_dir):
      pass

  _equal(warm.create_train_state(device="cpu").params, trained.params)
  state = train_eval.train_eval_model(
      warm, str(tmp_path / "warm"),
      input_generator_train=RandomInputGenerator(batch_size=8),
      max_train_steps=1, save_checkpoints_steps=1, device="cpu",
      hooks=[FirstState()])
  assert state.step == 1 and len(first) == 1


def test_meta_models_warm_start_their_base(tmp_path):
  model = MAMLModel(base_model=MockT2RModel(hidden_sizes=(8,)),
                    learn_inner_lr=True)
  state = dataclasses.replace(model.create_train_state(seed=3,
                                                       device="cpu"),
                              step=5)
  ckpt_lib.CheckpointWriter(str(tmp_path)).save(5, state)
  warm = MAMLModel(base_model=MockT2RModel(hidden_sizes=(8,)),
                   learn_inner_lr=True,
                   init_from_checkpoint_path=str(tmp_path))
  _equal(warm.create_inference_state(seed=0, device="cpu").params,
         state.params)


def test_jax_state_round_trips_bit_for_bit(jax_bn_state, tmp_path):
  """The converted JAX state, written as the port's checkpoint and read
  back by a warm start, keeps every f32 bit."""
  ckpt_lib.CheckpointWriter(str(tmp_path)).save(3, jax_bn_state)
  warm = PoseEnvRegressionModel(init_from_checkpoint_path=str(tmp_path),
                                **_POSE)
  state = warm.create_inference_state(device="cpu")
  for key, value in state.params.items():
    np.testing.assert_array_equal(value.numpy(),
                                  jax_bn_state.params[key].numpy())
