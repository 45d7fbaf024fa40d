"""The port's VRGripper BC / SNAIL meta / Watch-Try-Learn family against
the JAX package, and its three shipped gins on the CPU.

Small size: 12×12 images, filters (2, 4), embedding 8, hidden (8,), 3
mixture components, SNAIL at 4 filters; meta batches of 2 tasks with 2
condition, 2 trial and 3 inference samples. flax variables from the JAX
models' own init are converted (`models/convert.py`) and the same numpy
batches go through both packages' `predict_step` and `train_grads`.
The input generators read the same TFRecords in both packages.

Tolerances. f32: outputs, loss and metrics to 1e-5 of their magnitude;
each gradient leaf to 1e-5 of the largest magnitude over all leaves (the
same f32 math in other summation orders). bf16 (the models' default
dtype): outputs and the gradient, all leaves together, by cosine ≥ 0.99;
the loss to 2e-2 of its magnitude. Streams, meta batches and the WTL
sampler: bit for bit.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.data import (  # noqa: E402
    tfrecord_input_generator as jax_gen_lib,
)
from tensor2robot_tpu.data.abstract_input_generator import (  # noqa: E402
    Mode as JaxMode,
)
from tensor2robot_tpu.meta_learning import (  # noqa: E402
    EpisodeMetaInputGenerator as JaxEpisodeMeta,
    MetaPolicy as JaxMetaPolicy,
)
from tensor2robot_tpu.research import vrgripper as jax_vr  # noqa: E402
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct  # noqa: E402
from tensor2robot_tpu.specs import serialization as jax_serial  # noqa: E402
from tensor2robot_tpu_torch import config as gin  # noqa: E402
from tensor2robot_tpu_torch.bin import run_t2r_trainer  # noqa: E402
from tensor2robot_tpu_torch.data import (  # noqa: E402
    Mode,
    TFRecordEpisodeInputGenerator,
)
from tensor2robot_tpu_torch.meta_learning import (  # noqa: E402
    EpisodeMetaInputGenerator,
    MetaPolicy,
)
from tensor2robot_tpu_torch.models import convert  # noqa: E402
from tensor2robot_tpu_torch.research import vrgripper as vr  # noqa: E402
from tensor2robot_tpu_torch.research.vrgripper import (  # noqa: E402
    vrgripper_env,
    vrgripper_models,
)
from tensor2robot_tpu_torch.specs import (  # noqa: E402
    as_sequence_specs,
    serialization,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CONFIGS = os.path.join(_REPO, "tensor2robot_tpu/research/vrgripper/configs")
_OBS = dict(image_size=12, filters=(2, 4), embedding_size=8)
_META = dict(num_condition_samples_per_task=2,
             num_inference_samples_per_task=3)
_TASKS = 2


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=1e-5, what="", scale=None):
  got, want = _np(got), _np(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  scale = float(np.abs(want).max()) if scale is None else scale
  np.testing.assert_allclose(got, want, atol=tol * max(1e-12, scale),
                             rtol=0, err_msg=what)


def _cosine(a, b):
  a, b = _np(a).ravel(), _np(b).ravel()
  return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _flat_grads(grads):
  return np.concatenate([_np(grads[k]).ravel() for k in sorted(grads)])


def _obs(rng, lead):
  return {"image": rng.integers(0, 256, lead + (12, 12, 3), dtype=np.uint8),
          "gripper_pose": rng.normal(size=lead + (3,)).astype(np.float32)}


def _bc_batch(seed=0):
  rng = np.random.default_rng(seed)
  return _obs(rng, (5,)), {"action": rng.normal(size=(5, 3)).astype(
      np.float32)}


def _meta_batch(seed=0, trial=False):
  rng = np.random.default_rng(seed)
  features, labels = {}, {}
  splits = [("condition", 2), ("inference", 3)] + (
      [("trial", 2)] if trial else [])
  for split, n in splits:
    for key, value in _obs(rng, (_TASKS, n)).items():
      features[f"{split}/{key}"] = value
  if trial:
    features["trial/action"] = rng.normal(size=(_TASKS, 2, 3)).astype(
        np.float32)
    features["trial/reward"] = rng.normal(size=(_TASKS, 2, 1)).astype(
        np.float32)
  for split, n in splits[:2]:
    labels[f"{split}/action"] = rng.normal(size=(_TASKS, n, 3)).astype(
        np.float32)
  return features, labels


def _jax_struct(flat):
  return JaxStruct.from_flat_dict({k: jnp.asarray(v) for k, v in
                                   flat.items()})


def _torch(flat):
  return {k: torch.from_numpy(v) for k, v in flat.items()}


def _models(kind, dtype, mdn):
  """(JAX, port) models of one family member at the small size."""
  jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (
      jnp.bfloat16, torch.bfloat16)
  k = 3 if mdn else 0
  if kind == "bc":
    kw = dict(_OBS, hidden_sizes=(8,), num_mixture_components=k)
    return (jax_vr.VRGripperRegressionModel(device_dtype=jdt, **kw),
            vr.VRGripperRegressionModel(device_dtype=tdt, **kw))
  if kind == "snail":
    kw = dict(_OBS, **_META, snail_filters=4, num_mixture_components=k)
    # The SNAIL network computes in its base model's dtype.
    jax_model = jax_vr.VRGripperSNAILModel(**kw)
    model = vr.VRGripperSNAILModel(**kw)
    jax_model._base._device_dtype = jdt  # noqa: SLF001
    model._base._device_dtype = tdt  # noqa: SLF001
    return jax_model, model
  policy = kind.split("_")[1]
  kw = dict(_OBS, **_META, policy_type=policy, hidden_sizes=(8,),
            num_trial_samples_per_task=2, num_mixture_components=k)
  return (jax_vr.VRGripperWTLModel(device_dtype=jdt, **kw),
          vr.VRGripperWTLModel(device_dtype=tdt, **kw))


def _batch(kind, seed=0):
  if kind == "bc":
    return _bc_batch(seed)
  return _meta_batch(seed, trial=kind == "wtl_retrial")


_CASES = [("bc", "f32", False), ("bc", "f32", True), ("bc", "bf16", True),
          ("snail", "f32", False), ("snail", "f32", True),
          ("snail", "bf16", True), ("wtl_trial", "f32", False),
          ("wtl_retrial", "f32", True), ("wtl_retrial", "bf16", True)]


@pytest.mark.parametrize("kind,dtype,mdn", _CASES, ids=[
    f"{k}-{d}-{'mdn' if m else 'mse'}" for k, d, m in _CASES])
def test_forward_and_loss_match_jax(kind, dtype, mdn):
  jax_model, model = _models(kind, dtype, mdn)
  features, labels = _batch(kind)
  jax_state = jax.jit(jax_model.create_train_state)(jax.random.PRNGKey(0))
  state = convert.convert_variables(
      {"params": jax.tree_util.tree_map(np.asarray, jax_state.params)})
  want_grads, _, want_metrics = jax.jit(jax_model.train_grads)(
      jax_state, _jax_struct(features), _jax_struct(labels),
      jax.random.PRNGKey(1))
  grads, _, metrics = model.train_grads(state, _torch(features),
                                        _torch(labels))
  predict_features = dict(features)
  if kind != "bc":  # demonstrations ride in the features at predict time
    predict_features["condition_labels/action"] = labels["condition/action"]
  want_out = jax.jit(jax_model.predict_step)(
      jax_state, _jax_struct(predict_features))
  got_out = model.predict_step(state, _torch(predict_features))
  assert set(got_out) == set(want_out)
  assert ("mdn_logits" in got_out) == mdn
  assert set(metrics) == set(want_metrics)
  want_grads = convert.convert_params(
      jax.tree_util.tree_map(np.asarray, want_grads))
  assert set(grads) == set(want_grads)
  if dtype == "f32":
    for key in want_out:
      _close(got_out[key], want_out[key], what=key)
    for key in want_metrics:
      _close(metrics[key], want_metrics[key], what=key)
    scale = max(float(np.abs(_np(g)).max()) for g in want_grads.values())
    for name, g in grads.items():
      _close(g, want_grads[name], what=name, scale=scale)
  else:
    for key in want_out:
      assert _cosine(got_out[key], want_out[key]) >= 0.99, key
    _close(metrics["loss"], want_metrics["loss"], tol=2e-2, what="loss")
    assert _cosine(_flat_grads(grads), _flat_grads(want_grads)) >= 0.99


@pytest.mark.parametrize("policy", ["trial", "retrial"])
def test_wtl_specs_equal_jax(policy):
  kw = dict(policy_type=policy)
  jax_model, model = jax_vr.VRGripperWTLModel(**kw), vr.VRGripperWTLModel(
      **kw)
  for mode in (Mode.TRAIN, Mode.PREDICT):
    jm = JaxMode(mode.value)
    for got, want in ((model.get_feature_specification(mode),
                       jax_model.get_feature_specification(jm)),
                      (model.get_label_specification(mode),
                       jax_model.get_label_specification(jm))):
      assert serialization.struct_to_dict(got) == \
          jax_serial.struct_to_dict(want)
  with pytest.raises(ValueError, match="policy_type"):
    vr.VRGripperWTLModel(policy_type="replay")


def test_mdn_sample_action_draws_from_a_generator():
  _, model = _models("bc", "f32", True)
  state = model.create_inference_state(device="cpu")
  features = _torch(_bc_batch()[0])
  draw = lambda seed: model.sample_action(  # noqa: E731
      state, features, torch.Generator().manual_seed(seed))
  np.testing.assert_array_equal(_np(draw(0)), _np(draw(0)))
  assert draw(0).shape == (5, 3) and not torch.equal(draw(0), draw(1))
  _, mse = _models("bc", "f32", False)
  mse_state = mse.create_inference_state(device="cpu")
  np.testing.assert_array_equal(
      _np(mse.sample_action(mse_state, features)),
      _np(mse.predict_step(mse_state, features)["action"]))


def test_wtl_meta_batch_sampler_equals_jax():
  kw = dict(num_tasks=2, num_condition=2, num_trial=3, num_inference=2,
            image_size=16, seed=5)
  got = vr.sample_wtl_meta_batch(**kw)
  want = jax_vr.sample_wtl_meta_batch(**kw)
  for g, w in zip(got, want):
    assert sorted(g) == sorted(w)
    for key in w:
      np.testing.assert_array_equal(g[key], w[key], err_msg=key)
  assert got[0]["trial/reward"].shape == (2, 3, 1)


# ---- the input generators over the same TFRecords ----


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
  path = str(tmp_path_factory.mktemp("demos") / "demos.tfrecord")
  return vr.collect_demo_episodes(path, num_episodes=9, image_size=12,
                                  seed=3)


def _flat_batch(batch):
  features, labels = batch
  return {**{"f/" + k: np.asarray(v) for k, v in
             features.to_flat_dict().items()},
          **{"l/" + k: np.asarray(v) for k, v in
             labels.to_flat_dict().items()}}


def _assert_batches_equal(got, want):
  assert len(got) == len(want)
  for g, w in zip(got, want):
    g, w = _flat_batch(g), _flat_batch(w)
    assert sorted(g) == sorted(w)
    for key in w:
      assert g[key].dtype == w[key].dtype, key
      np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _take(stream, n):
  return [next(stream) for _ in range(n)]


def _episode_gens(demos, **kwargs):
  kwargs = dict(dict(file_patterns=demos, sequence_length=12,
                     batch_size=4), **kwargs)
  return (TFRecordEpisodeInputGenerator(**kwargs),
          jax_gen_lib.TFRecordEpisodeInputGenerator(**kwargs))


class _Replay:
  """An episode generator that replays recorded batches, so each
  package's wrapper reads the same episode stream."""

  def __init__(self, batches):
    self._batches = batches
    self.feature_spec = None

  def set_specification(self, feature_spec, label_spec=None):
    self.feature_spec = feature_spec

  def create_dataset(self, mode, batch_size=None):
    return iter(self._batches)


def _sources(demos, source, episode_batch):
  """(port, JAX) episode generators: each package's own over the demos
  in file order, or the port's shuffled stream replayed to both."""
  port, jax = _episode_gens(demos, shuffle=False)
  if source == "files":
    return port, jax
  shuffled, _ = _episode_gens(demos, shuffle=True, seed=4,
                              batch_size=episode_batch)
  model = vr.VRGripperRegressionModel(image_size=12)
  shuffled.set_specification(
      as_sequence_specs(model.get_feature_specification(Mode.TRAIN)),
      as_sequence_specs(model.get_label_specification(Mode.TRAIN)))
  batches = _take(shuffled.create_dataset(Mode.TRAIN), 8)
  return _Replay(batches), _Replay(batches)


@pytest.mark.parametrize("source", ["files", "shuffled episodes"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_transition_stream_equals_jax(demos, shuffle, source):
  """Unshuffled and shuffled (`default_rng(seed).permutation`, seed 7)
  transition streams equal JAX's, from each package's reader in file
  order and from one shuffled episode stream."""
  port_eps, jax_eps = _sources(demos, source, episode_batch=2)
  port = vr.TransitionInputGenerator(port_eps, batch_size=10,
                                     shuffle_transitions=shuffle, seed=7)
  jax = jax_vr.TransitionInputGenerator(jax_eps, batch_size=10,
                                        shuffle_transitions=shuffle, seed=7)
  port.set_specification_from_model(vr.VRGripperRegressionModel(
      image_size=12), Mode.TRAIN)
  jax.set_specification_from_model(jax_vr.VRGripperRegressionModel(
      image_size=12), JaxMode.TRAIN)
  got = _take(port.create_dataset(Mode.TRAIN), 8)  # past one pass
  want = _take(jax.create_dataset(JaxMode.TRAIN), 8)
  _assert_batches_equal(got, want)
  assert got[0][0]["image"].shape == (10, 12, 12, 3)
  # Only real timesteps: every action came from a demo step.
  assert np.abs(got[0][1]["action"]).sum(axis=-1).min() > 0


@pytest.mark.parametrize("source", ["files", "shuffled episodes"])
def test_episode_meta_stream_equals_jax(demos, source):
  port_eps, jax_eps = _sources(demos, source, episode_batch=3)
  port = EpisodeMetaInputGenerator(port_eps, batch_size=3, **_META)
  jax = JaxEpisodeMeta(jax_eps, batch_size=3, **_META)
  port.set_specification_from_model(vr.VRGripperSNAILModel(
      image_size=12, **_META), Mode.TRAIN)
  jax.set_specification_from_model(jax_vr.VRGripperSNAILModel(
      image_size=12, **_META), JaxMode.TRAIN)
  assert serialization.struct_to_dict(port.feature_spec) == \
      jax_serial.struct_to_dict(jax.feature_spec)
  got = _take(port.create_dataset(Mode.TRAIN), 7)
  want = _take(jax.create_dataset(JaxMode.TRAIN), 7)
  _assert_batches_equal(got, want)
  features, labels = got[0]
  assert features["condition/image"].shape == (3, 2, 12, 12, 3)
  assert labels["inference/action"].shape == (3, 3, 3)
  assert "sequence_length" not in features.to_flat_dict()


def test_make_meta_batch_and_short_episodes_as_jax():
  from tensor2robot_tpu.meta_learning import meta_data as jax_meta
  from tensor2robot_tpu_torch.meta_learning import meta_data
  from tensor2robot_tpu_torch.specs import TensorSpecStruct
  rng = np.random.default_rng(0)
  flat = {"x": rng.normal(size=(10, 2)).astype(np.float32)}
  got = meta_data.make_meta_batch(TensorSpecStruct.from_flat_dict(flat),
                                  None, 2, 3)
  want = jax_meta.make_meta_batch(JaxStruct.from_flat_dict(flat), None, 2, 3)
  for key in ("condition/x", "inference/x"):
    np.testing.assert_array_equal(got[0][key], want[0][key])
  episodes = {"x": rng.normal(size=(3, 6, 2)).astype(np.float32),
              "sequence_length": np.array([6, 3, 5], np.int32)}
  got = meta_data.meta_batch_from_episodes(
      TensorSpecStruct.from_flat_dict(episodes), None, 2, 3)
  want = jax_meta.meta_batch_from_episodes(
      JaxStruct.from_flat_dict(episodes), None, 2, 3)
  assert got[0]["condition/x"].shape == (2, 2, 2)  # the short one dropped
  for key in ("condition/x", "inference/x"):
    np.testing.assert_array_equal(got[0][key], want[0][key])


# ---- serving: the meta policy ----


class _Predictor:
  """Records the features it is given; answers a [1, N_inf, 3] action
  whose slots count up."""

  def __init__(self, spec):
    self._spec, self.seen = spec, []

  def get_feature_specification(self):
    return self._spec

  def predict(self, features):
    self.seen.append({k: np.asarray(v) for k, v in features.items()})
    return {"action": np.arange(9, dtype=np.float32).reshape(1, 3, 3)}


def test_meta_policy_assembles_the_batch_as_jax():
  jax_model = jax_vr.VRGripperSNAILModel(image_size=12, **_META)
  model = vr.VRGripperSNAILModel(image_size=12, **_META)
  port = _Predictor(model.get_feature_specification(Mode.PREDICT))
  jax = _Predictor(jax_model.get_feature_specification(JaxMode.PREDICT))
  policies = MetaPolicy(port), JaxMetaPolicy(jax)
  rng = np.random.default_rng(1)
  demo = _obs(rng, (5,))  # 5 demos cycle/truncate to 2
  actions = {"action": rng.normal(size=(5, 3)).astype(np.float32)}
  obs = {k: v[0] for k, v in _obs(rng, (1,)).items()}
  results = []
  for policy in policies:
    assert (policy.num_condition, policy.num_inference) == (2, 3)
    results.append(policy.predict(obs))  # zero-shot
    policy.set_task(demo, actions)
    results.append(policy.predict(obs))
  for got, want in zip(port.seen, jax.seen):
    assert sorted(got) == sorted(want)
    for key in want:
      np.testing.assert_array_equal(got[key], want[key], err_msg=key)
  np.testing.assert_array_equal(results[1]["action"], [6.0, 7.0, 8.0])
  assert "condition_labels/action" in port.seen[1]


# ---- the shipped gins through the trainer binary, on the CPU ----

_SMALL_BINDINGS = {
    "bc": ["VRGripperRegressionModel.image_size = 12",
           "VRGripperRegressionModel.filters = (2, 4)",
           "train/TransitionInputGenerator.batch_size = 8",
           'SuccessEvalHook.eval_kwargs = {"num_episodes": 2, '
           '"image_size": 12, "seed": 1009, "task_offset_scale": 0.2}'],
    "meta": ["VRGripperSNAILModel.image_size = 12",
             "VRGripperSNAILModel.filters = (2, 4)"],
    "maml": ["train_eval_model.model = @VRGripperMAMLModel()",
             "VRGripperMAMLModel.image_size = 12",
             "VRGripperMAMLModel.filters = (2, 4)",
             "VRGripperMAMLModel.num_inner_steps = 2"],
    "wtl": ["VRGripperWTLModel.image_size = 12",
            "VRGripperWTLModel.filters = (2, 4)"],
}


@pytest.mark.parametrize("run", sorted(_SMALL_BINDINGS))
def test_the_shipped_gins_train_on_the_cpu(tmp_path, demos, run):
  config = {"bc": "train_vrgripper_bc.gin", "wtl": "train_vrgripper_wtl.gin"
            }.get(run, "train_vrgripper_meta.gin")
  model_dir = str(tmp_path / "run")
  bindings = [f"train_eval_model.model_dir = '{model_dir}'",
              "train_eval_model.device = 'cpu'",
              "train_eval_model.max_train_steps = 4",
              "train_eval_model.log_every_steps = 2",
              "train_eval_model.save_checkpoints_steps = 4"]
  if run != "wtl":  # the WTL gin trains on random batches
    bindings.append("train/TFRecordEpisodeInputGenerator.file_patterns = "
                    f"'{demos}'")
  bindings += _SMALL_BINDINGS[run]
  argv = ["--gin_configs", os.path.join(_CONFIGS, config)]
  for binding in bindings:
    argv += ["--gin_bindings", binding]
  try:
    assert run_t2r_trainer.main(argv) == 0
  finally:
    gin.clear_config()
  with open(os.path.join(model_dir, "metrics_train.jsonl")) as f:
    records = [json.loads(line) for line in f]
  assert [r["step"] for r in records] == [2, 4]
  assert all(np.isfinite(r["payload"]["loss"]) for r in records)
  if run == "maml":
    assert "post_adaptation_loss" in records[0]["payload"]
  assert os.listdir(os.path.join(model_dir, "ckpt")) == ["4"]
  if run == "bc":
    with open(os.path.join(model_dir, "metrics_success_eval.jsonl")) as f:
      success = [json.loads(line) for line in f]
    assert [r["payload"]["num_episodes"] for r in success] == [2.0]


def test_demo_specs_are_the_regression_models():
  features, labels = vrgripper_env._demo_specs(16)
  model = vrgripper_models.VRGripperRegressionModel(image_size=16)
  assert serialization.struct_to_dict(features) == serialization.\
      struct_to_dict(model.get_feature_specification(Mode.TRAIN))
  assert serialization.struct_to_dict(labels) == serialization.\
      struct_to_dict(model.get_label_specification(Mode.TRAIN))
