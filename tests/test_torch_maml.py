"""The port's MAML (`meta_learning/maml_model.py`) against the JAX
package's.

Small size: `MAMLModel` over an f32 `VRGripperRegressionModel` (10×10
images, filters (2, 4), embedding 6, hidden (6,)); 3 tasks of 2
condition and 3 inference samples. `VRGripperMAMLModel` and
`PoseEnvRegressionModelMAML` build their base networks in bf16 (their
base models' default, in both packages), so they are held by cosine.
flax variables from the JAX model's own init are converted
(`models/convert.py`: the base network nests under ``base_net``, the
learned rate is the scalar ``inner_lr_log``) and the same numpy meta
batch goes through both packages' `loss_fn` and its gradient: first and
second order, K = 1 and 2 inner steps, with and without a learned inner
rate. The port runs each inner step as `torch.func.grad` and the tasks
in a loop; JAX scans `jax.grad` and vmaps.

Tolerances. f32: the meta loss and its metrics to 1e-5 of their
magnitude; each gradient leaf to 1e-5 of the largest magnitude over all
leaves (second-order terms pass twice through the same f32 math in
other summation orders). bf16: the loss to 1e-2 of its magnitude and
the gradient, all leaves together, by cosine ≥ 0.99.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.data.abstract_input_generator import (  # noqa: E402
    Mode as JaxMode,
)
from tensor2robot_tpu.meta_learning import maml_model as jax_maml  # noqa: E402
from tensor2robot_tpu.research.pose_env import (  # noqa: E402
    pose_env_maml_models as jax_pose_maml,
)
from tensor2robot_tpu.research.vrgripper import (  # noqa: E402
    VRGripperMAMLModel as JaxMAML,
    VRGripperRegressionModel as JaxRegression,
)
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct  # noqa: E402
from tensor2robot_tpu.specs import serialization as jax_serial  # noqa: E402
from tensor2robot_tpu_torch.data import Mode  # noqa: E402
from tensor2robot_tpu_torch.meta_learning import MAMLModel  # noqa: E402
from tensor2robot_tpu_torch.meta_learning import maml_model  # noqa: E402
from tensor2robot_tpu_torch.models import convert  # noqa: E402
from tensor2robot_tpu_torch.research.pose_env import (  # noqa: E402
    PoseEnvRegressionModel,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env_maml_models import (  # noqa: E402,E501
    PoseEnvRegressionModelMAML,
)
from tensor2robot_tpu_torch.research.vrgripper import (  # noqa: E402
    VRGripperMAMLModel,
    VRGripperRegressionModel,
)
from tensor2robot_tpu_torch.specs import serialization  # noqa: E402

_TASKS = 3
# (first_order, num_inner_steps, learn_inner_lr): each factor both ways.
_CASES = [(False, 1, False), (True, 1, False), (False, 2, True),
          (True, 2, True), (False, 2, False)]


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


_BASE = dict(image_size=10, filters=(2, 4), embedding_size=6,
             hidden_sizes=(6,))
_META = dict(num_condition_samples_per_task=2,
             num_inference_samples_per_task=3)


def _models(first_order, steps, learn):
  """(JAX, port) `MAMLModel`s over f32 gripper BC bases."""
  kwargs = dict(_META, first_order=first_order, num_inner_steps=steps,
                inner_lr=0.3, learn_inner_lr=learn)
  return (jax_maml.MAMLModel(JaxRegression(device_dtype=jnp.float32,
                                           **_BASE), **kwargs),
          MAMLModel(VRGripperRegressionModel(device_dtype=torch.float32,
                                             **_BASE), **kwargs))


def _cosine(a, b):
  a, b = _np(a).ravel(), _np(b).ravel()
  return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _flat_grads(grads):
  return np.concatenate([_np(grads[k]).ravel() for k in sorted(grads)])


def _meta_batch(seed=0):
  rng = np.random.default_rng(seed)
  features, labels = {}, {}
  for split, n in (("condition", 2), ("inference", 3)):
    features[f"{split}/image"] = rng.integers(
        0, 256, (_TASKS, n, 10, 10, 3), dtype=np.uint8)
    features[f"{split}/gripper_pose"] = rng.normal(
        size=(_TASKS, n, 3)).astype(np.float32)
    labels[f"{split}/action"] = rng.normal(
        size=(_TASKS, n, 3)).astype(np.float32)
  return features, labels


def _jax_struct(flat):
  return JaxStruct.from_flat_dict({k: jnp.asarray(v) for k, v in
                                   flat.items()})


def _torch(flat):
  return {k: torch.from_numpy(v) for k, v in flat.items()}


_JAX_RESULTS = {}


def _jax_case(case):
  """JAX params, loss, metrics and gradients of one case (computed once
  per module run)."""
  if case not in _JAX_RESULTS:
    jax_model, _ = _models(*case)
    state = jax.jit(jax_model.create_train_state)(jax.random.PRNGKey(0))
    features, labels = _meta_batch()

    def loss(params):
      return jax_model.loss_fn(params, {}, _jax_struct(features),
                               _jax_struct(labels), None, JaxMode.TRAIN)

    (value, (metrics, _)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(state.params)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    _JAX_RESULTS[case] = (to_np(state.params), float(value),
                          {k: float(v) for k, v in metrics.items()},
                          convert.convert_params(to_np(grads)))
  return _JAX_RESULTS[case]


@pytest.mark.parametrize("case", _CASES, ids=[
    f"{'first' if f else 'second'}_order-K{k}-{'learned' if lr else 'fixed'}"
    for f, k, lr in _CASES])
def test_meta_loss_and_gradients_match_jax(case):
  params, want_loss, want_metrics, want_grads = _jax_case(case)
  _, model = _models(*case)
  state = convert.convert_variables({"params": params})
  assert ("inner_lr_log" in state.params) == case[2]
  features, labels = _meta_batch()
  grads, _, metrics = model.train_grads(state, _torch(features),
                                        _torch(labels))
  _close(metrics["loss"], want_loss, what="loss")
  assert set(metrics) == set(want_metrics) | {"loss", "grad_norm"}
  assert "post_adaptation_loss" in metrics
  for key, value in want_metrics.items():
    _close(metrics[key], value, what=key)
  assert set(grads) == set(want_grads)
  scale = max(float(np.abs(_np(g)).max()) for g in want_grads.values())
  for name, g in grads.items():
    _close(g, want_grads[name], what=name, scale=scale)


def test_first_order_detaches_the_inner_gradient():
  """The port's first-order grads differ from its second-order ones in
  the base params (the Hessian term is dropped) over the same loss; the
  inner rate gets a gradient in both."""
  params, _, _, _ = _jax_case((False, 2, True))
  state = convert.convert_variables({"params": params})
  features, labels = _torch(_meta_batch()[0]), _torch(_meta_batch()[1])
  (_, second_order), (_, first_order) = (
      _models(first, 2, True) for first in (False, True))
  second, _, m2 = second_order.train_grads(state, features, labels)
  first, _, m1 = first_order.train_grads(state, features, labels)
  _close(m1["loss"], m2["loss"], tol=1e-6)
  key = "base_net.obs_encoder.joint_proj.weight"
  assert float((second[key] - first[key]).abs().max()) > 1e-3 * float(
      second[key].abs().max())
  for grads in (first, second):
    assert float(grads["inner_lr_log"].abs()) > 0


def test_inner_lr_log_initializes_to_log_of_the_rate():
  _, model = _models(False, 1, True)
  state = model.create_inference_state(device="cpu")
  assert abs(float(state.params["inner_lr_log"]) - np.log(0.3)) < 1e-7
  _, fixed = _models(False, 1, False)
  assert "inner_lr_log" not in fixed.create_inference_state(device="cpu").params


def test_eval_reports_pre_and_post_adaptation_loss_as_jax():
  params, _, _, _ = _jax_case((False, 2, True))
  jax_model, model = _models(False, 2, True)
  features, labels = _meta_batch(seed=1)
  jax_state = jax.jit(jax_model.create_train_state)(jax.random.PRNGKey(0))
  want = jax.jit(jax_model.eval_step)(jax_state, _jax_struct(features),
                                      _jax_struct(labels))
  state = convert.convert_variables({"params": params})
  got = model.eval_step(state, _torch(features), _torch(labels))
  assert set(got) == set(want) and "pre_adaptation_loss" in got
  for key in want:
    _close(got[key], want[key], what=key)
  assert float(got["pre_adaptation_loss"]) != float(
      got["post_adaptation_loss"])


@pytest.mark.parametrize("with_demos", [True, False])
def test_predict_adapts_on_condition_labels_as_jax(with_demos):
  params, _, _, _ = _jax_case((False, 2, True))
  jax_model, model = _models(False, 2, True)
  features, labels = _meta_batch(seed=2)
  if with_demos:
    features["condition_labels/action"] = labels["condition/action"]
  jax_state = jax.jit(jax_model.create_train_state)(jax.random.PRNGKey(0))
  want = jax.jit(jax_model.predict_step)(jax_state, _jax_struct(features))
  state = convert.convert_variables({"params": params})
  got = model.predict_step(state, _torch(features))
  assert set(got) == set(want)
  for key in want:
    assert got[key].shape == (_TASKS, 3, 3)
    _close(got[key], want[key], what=key)


@pytest.mark.parametrize("mode", [Mode.TRAIN, Mode.PREDICT])
def test_meta_specs_equal_jax(mode):
  jax_model, model = _models(False, 1, False)
  jax_mode = JaxMode(mode.value)
  for port_spec, jax_spec in (
      (model.get_feature_specification(mode),
       jax_model.get_feature_specification(jax_mode)),
      (model.get_label_specification(mode),
       jax_model.get_label_specification(jax_mode)),
      (model.preprocessor.get_in_feature_specification(mode),
       jax_model.preprocessor.get_in_feature_specification(jax_mode))):
    assert serialization.struct_to_dict(port_spec) == \
        jax_serial.struct_to_dict(jax_spec)
  flat = model.get_feature_specification(mode).to_flat_dict()
  assert flat["condition/image"].data_format is None  # one image a frame
  assert flat["condition/image"].name == "condition_image"
  assert ("condition_labels/action" in flat) == (mode == Mode.PREDICT)


def test_batch_stats_are_refused():
  model = MAMLModel(PoseEnvRegressionModel(image_size=8, filters=(2,),
                                           embedding_size=4,
                                           use_batch_norm=True,
                                           device_dtype=torch.float32))
  state = model.create_inference_state(device="cpu")
  assert state.batch_stats
  with pytest.raises(ValueError, match="batch-stats-free"):
    model.loss_fn(state.params, state.batch_stats, {}, {}, Mode.TRAIN)


def _bf16_case(jax_model, model, features, labels):
  """JAX's and the port's meta loss and gradients from the same params:
  the loss within 1e-2 of its magnitude, the gradients by cosine."""
  jax_state = jax.jit(jax_model.create_train_state)(jax.random.PRNGKey(0))
  (want, _), want_grads = jax.jit(jax.value_and_grad(
      lambda p: jax_model.loss_fn(p, {}, _jax_struct(features),
                                  _jax_struct(labels), None, JaxMode.TRAIN),
      has_aux=True))(jax_state.params)
  state = convert.convert_variables(
      {"params": jax.tree_util.tree_map(np.asarray, jax_state.params)})
  grads, _, metrics = model.train_grads(state, _torch(features),
                                        _torch(labels))
  _close(metrics["loss"], want, tol=1e-2, what="loss")
  want_grads = convert.convert_params(
      jax.tree_util.tree_map(np.asarray, want_grads))
  assert set(grads) == set(want_grads)
  assert _cosine(_flat_grads(grads), _flat_grads(want_grads)) >= 0.99


def test_vrgripper_maml_model_matches_jax_bf16():
  """`VRGripperMAMLModel` as the meta gin binds it: second order, K=2,
  its base network in bf16."""
  kwargs = dict(_BASE, **_META, num_inner_steps=2)
  jax_model, model = JaxMAML(**kwargs), VRGripperMAMLModel(**kwargs)
  assert model.device_dtype == torch.bfloat16
  _bf16_case(jax_model, model, *_meta_batch(seed=4))


def test_pose_env_maml_matches_jax_bf16():
  """`PoseEnvRegressionModelMAML` (a BN-free pose base, bf16): second
  order, K=1."""
  kwargs = dict(image_size=8, filters=(2,), embedding_size=4,
                hidden_sizes=(4,), num_condition_samples_per_task=2,
                num_inference_samples_per_task=2, inner_lr=0.2)
  model = PoseEnvRegressionModelMAML(**kwargs)
  assert isinstance(model, maml_model.MAMLModel)
  rng = np.random.default_rng(3)
  features = {f"{s}/image": rng.integers(0, 256, (2, 2, 8, 8, 3),
                                         dtype=np.uint8)
              for s in ("condition", "inference")}
  labels = {f"{s}/target_pose": rng.normal(size=(2, 2, 2)).astype(
      np.float32) for s in ("condition", "inference")}
  _bf16_case(jax_pose_maml.PoseEnvRegressionModelMAML(**kwargs), model,
             features, labels)
