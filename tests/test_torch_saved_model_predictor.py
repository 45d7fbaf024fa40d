"""The port's `SavedModelPredictor` on the CPU: the JAX predictor's cases
(`tests/test_export_predict.py`, `tests/test_serving.py`), its version
discipline, and `MetaPolicy` over exported SNAIL and MAML models held
against the JAX models' `predict_step` on the same converted params.

Tolerances: f32; the meta models' outputs agree with JAX's to 1e-5 of
their largest |value| (MAML's two inner steps: 2e-5); a program and the
eager `predict_step` it was traced from agree exactly.
"""

import dataclasses
import functools
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.meta_learning import maml_model as jax_maml  # noqa: E402
from tensor2robot_tpu.research import vrgripper as jax_vr  # noqa: E402
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct  # noqa: E402
from tensor2robot_tpu_torch import config as gin  # noqa: E402
from tensor2robot_tpu_torch import specs  # noqa: E402
from tensor2robot_tpu_torch.export import (  # noqa: E402
    SavedModelExportGenerator,
    latest_export_dir,
)
from tensor2robot_tpu_torch.meta_learning import (  # noqa: E402
    MAMLModel,
    MetaPolicy,
)
from tensor2robot_tpu_torch.models import convert  # noqa: E402
from tensor2robot_tpu_torch.predictors import (  # noqa: E402
    CheckpointPredictor,
    SavedModelPredictor,
)
from tensor2robot_tpu_torch.research import vrgripper as vr  # noqa: E402
from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib  # noqa: E402
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel  # noqa: E402

_CPU = ("cpu",)
_OBS = dict(image_size=12, filters=(2, 4), embedding_size=8)
_META = dict(num_condition_samples_per_task=2,
             num_inference_samples_per_task=3)


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what=""):
  got, want = _np(got), _np(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  np.testing.assert_allclose(
      got, want, atol=tol * max(1e-12, float(np.abs(want).max())), rtol=0,
      err_msg=what)


def _export(model, state, model_dir, **kwargs):
  return SavedModelExportGenerator(platforms=_CPU, **kwargs).export(
      model, state, str(model_dir))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
  """A mock model's state at step 4, exported once."""
  model_dir = tmp_path_factory.mktemp("served")
  model = MockT2RModel()
  state = dataclasses.replace(
      model.create_inference_state(seed=1, device="cpu"), step=4)
  _export(model, state, model_dir)
  return model, state, str(model_dir)


def _restored(model_dir, **kwargs):
  predictor = SavedModelPredictor(os.path.join(model_dir, "export"),
                                  device="cpu", **kwargs)
  assert predictor.restore(timeout_secs=0)
  return predictor


def test_round_trip(exported):
  model, state, model_dir = exported
  predictor = _restored(model_dir)
  assert predictor.model_version > 0
  assert predictor.global_step == 4
  assert predictor.device == torch.device("cpu")
  assert set(predictor.feature_specification.to_flat_dict()) == {"x"}
  assert set(predictor.label_specification.to_flat_dict()) == {"target"}
  batch = specs.make_random_tensors(predictor.feature_specification,
                                    batch_size=3, seed=1).to_flat_dict()
  out = predictor.predict(batch)
  want = model.predict_step(state, {"x": torch.as_tensor(batch["x"])})
  np.testing.assert_array_equal(out["inference_output"],
                                want["inference_output"].numpy())


def test_predictor_validates_inputs(exported):
  predictor = _restored(exported[2])
  batch = specs.make_random_tensors(predictor.feature_specification,
                                    batch_size=2, seed=1).to_flat_dict()
  batch["x"] = batch["x"][..., :-1]  # corrupt trailing dim
  with pytest.raises(specs.SpecValidationError):
    predictor.predict(batch)


def test_unrestored_predictor_raises(tmp_path):
  predictor = SavedModelPredictor(str(tmp_path / "nothing"), device="cpu")
  assert not predictor.restore(timeout_secs=0)
  assert predictor.model_version == -1
  with pytest.raises(ValueError, match="restore"):
    predictor.predict({})


def test_restore_loads_only_a_newer_export(exported, tmp_path):
  model, state, model_dir = exported
  base = str(tmp_path / "export")
  shutil.copytree(os.path.join(model_dir, "export"), base)
  predictor = SavedModelPredictor(base, device="cpu")
  assert predictor.restore(timeout_secs=0)
  version = predictor.model_version
  assert predictor.restore(timeout_secs=0)  # serviceable, nothing newer
  assert predictor.model_version == version
  newer = dataclasses.replace(state, step=9)
  path = SavedModelExportGenerator(platforms=_CPU,
                                   export_dir_base=base).export(
                                       model, newer, "unused")
  assert int(os.path.basename(path)) > version
  assert predictor.restore(timeout_secs=0)
  assert predictor.model_version == int(os.path.basename(path))
  assert predictor.global_step == 9


def test_a_broken_export_leaves_the_previous_version_whole(exported,
                                                           tmp_path):
  model, state, model_dir = exported
  base = str(tmp_path / "export")
  shutil.copytree(os.path.join(model_dir, "export"), base)
  predictor = SavedModelPredictor(base, device="cpu")
  assert predictor.restore(timeout_secs=0)
  version, step = predictor.model_version, predictor.global_step
  x = {"x": np.ones((2, 3), np.float32)}
  before = predictor.predict(x)
  # A newer export whose program is garbage, with valid new assets.
  newer = SavedModelExportGenerator(platforms=_CPU, serving_max_batch=4,
                                    export_dir_base=base).export(
                                        model, dataclasses.replace(
                                            state, step=99), "unused")
  with open(os.path.join(newer, "program.cpu.pt2"), "wb") as f:
    f.write(b"not a program")
  with pytest.raises(Exception):
    predictor.restore(timeout_secs=0)
  assert predictor.model_version == version
  assert predictor.global_step == step
  assert predictor.serving_metadata is None
  after = predictor.predict(x)
  np.testing.assert_array_equal(after["inference_output"],
                                before["inference_output"])


def test_serving_metadata_round_trips_through_export(tmp_path):
  model = MockT2RModel()
  state = model.create_inference_state(device="cpu")
  _export(model, state, tmp_path, serving_max_batch=8)
  meta = _restored(str(tmp_path)).serving_metadata
  assert meta == {"max_batch": 8, "bucket_sizes": [1, 2, 4, 8],
                  "max_wait_us": 200}


def test_no_metadata_without_opt_in(exported):
  assert _restored(exported[2]).serving_metadata is None


def test_an_export_without_the_devices_program_raises(exported, tmp_path):
  base = str(tmp_path / "export")
  shutil.copytree(os.path.join(exported[2], "export"), base)
  os.remove(os.path.join(latest_export_dir(base), "program.cpu.pt2"))
  predictor = SavedModelPredictor(base, device="cpu")
  with pytest.raises(FileNotFoundError, match="program.cpu.pt2"):
    predictor.restore(timeout_secs=0)
  assert predictor.model_version == -1


def test_an_unknown_signature_raises(exported):
  predictor = SavedModelPredictor(os.path.join(exported[2], "export"),
                                  signature="parse_tf_sequence_example",
                                  device="cpu")
  with pytest.raises(ValueError, match="no signature"):
    predictor.restore(timeout_secs=0)


def test_the_default_device_is_the_card(exported, monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="cuda"):
    SavedModelPredictor(os.path.join(exported[2], "export"))


def test_the_predictor_is_in_the_ports_registry(exported):
  try:
    gin.parse_config(
        f"SavedModelPredictor.export_dir_base = "
        f"'{os.path.join(exported[2], 'export')}'\n"
        "SavedModelPredictor.device = 'cpu'")
    predictor = SavedModelPredictor()
    assert predictor.restore(timeout_secs=0)
  finally:
    gin.clear_config()


def test_matches_the_checkpoint_predictor(tmp_path):
  """The two handoffs serve one model alike: the export of a checkpoint
  and the checkpoint itself."""
  model = MockT2RModel()
  model_dir = str(tmp_path)
  state = dataclasses.replace(
      model.create_inference_state(seed=5, device="cpu"), step=3)
  ckpt_lib.CheckpointWriter(model_dir).save(3, state)
  checkpoint = CheckpointPredictor(model, checkpoint_dir=model_dir,
                                   device="cpu")
  assert checkpoint.restore(timeout_secs=0)
  _export(model, state, tmp_path)
  exported_predictor = _restored(model_dir)
  for b in (1, 4):
    x = {"x": np.random.default_rng(b).normal(size=(b, 3)).astype(
        np.float32)}
    np.testing.assert_array_equal(
        exported_predictor.predict(x)["inference_output"],
        checkpoint.predict(x)["inference_output"])


# ---- MetaPolicy over exported meta models, against JAX ----


def _jax_struct(flat):
  return JaxStruct.from_flat_dict({k: jnp.asarray(v) for k, v in
                                   flat.items()})


def _converted(jax_state):
  return convert.convert_variables(
      {"params": jax.tree_util.tree_map(np.asarray, jax_state.params)})


def _obs(rng, lead):
  return {"image": rng.integers(0, 256, lead + (12, 12, 3), dtype=np.uint8),
          "gripper_pose": rng.normal(size=lead + (3,)).astype(np.float32)}


def _policy_batch(demos, demo_actions, observation):
  """The meta feature batch `MetaPolicy.predict` assembles (task dim 1),
  as the JAX predict_step takes it."""
  batch = {f"condition/{k}": v[None] for k, v in demos.items()}
  batch["condition_labels/action"] = demo_actions[None]
  for key, value in observation.items():
    batch[f"inference/{key}"] = np.broadcast_to(
        value[None], (3,) + value.shape)[None].copy()
  return batch


@functools.lru_cache(maxsize=None)
def _jax_snail():
  model = jax_vr.VRGripperSNAILModel(snail_filters=4, **_OBS, **_META)
  model._base._device_dtype = jnp.float32  # noqa: SLF001
  state = jax.jit(model.create_train_state)(jax.random.PRNGKey(0))
  return model, state, jax.jit(model.predict_step)


@functools.lru_cache(maxsize=None)
def _jax_maml():
  model = jax_maml.MAMLModel(
      jax_vr.VRGripperRegressionModel(device_dtype=jnp.float32,
                                      hidden_sizes=(6,), **_OBS),
      num_inner_steps=2, inner_lr=0.3, **_META)
  state = jax.jit(model.create_train_state)(jax.random.PRNGKey(0))
  return model, state, jax.jit(model.predict_step)


def _snail():
  model = vr.VRGripperSNAILModel(snail_filters=4, **_OBS, **_META)
  model._base._device_dtype = torch.float32  # noqa: SLF001
  return model


def _maml():
  return MAMLModel(vr.VRGripperRegressionModel(device_dtype=torch.float32,
                                               hidden_sizes=(6,), **_OBS),
                   num_inner_steps=2, inner_lr=0.3, **_META)


@pytest.mark.parametrize("kind,tol", [("snail", 1e-5), ("maml", 2e-5)])
def test_meta_policy_through_the_export_matches_jax(kind, tol, tmp_path):
  jax_model, jax_state, jax_predict = (_jax_snail if kind == "snail"
                                       else _jax_maml)()
  model = _snail() if kind == "snail" else _maml()
  # MAML's predict_step is recorded at a fixed task batch (make_fx).
  _export(model, _converted(jax_state), tmp_path,
          batch_polymorphic=kind == "snail")
  policy = MetaPolicy(_restored(str(tmp_path)))
  assert (policy.num_condition, policy.num_inference) == (2, 3)
  rng = np.random.default_rng(7)
  demos, observation = _obs(rng, (2,)), _obs(rng, ())
  outputs = []
  for demo_actions in (rng.normal(size=(2, 3)).astype(np.float32),
                       rng.normal(size=(2, 3)).astype(np.float32)):
    policy.set_task(demos, {"action": demo_actions})
    got = policy.predict(observation)
    want = jax_predict(jax_state, _jax_struct(
        _policy_batch(demos, demo_actions, observation)))
    assert set(got) == set(want)
    for key in want:
      _close(got[key], np.asarray(want[key])[0, -1], tol, key)
    outputs.append(got["action"])
  # The demonstrations condition the exported program: other demos,
  # another answer (MAML adapts inside it, SNAIL attends to them).
  assert float(np.abs(outputs[0] - outputs[1]).max()) > 1e-4
  # An exported program takes fixed inputs: exported serving always
  # conditions.
  policy.reset_task()
  with pytest.raises(ValueError, match="set_task"):
    policy.predict(observation)
