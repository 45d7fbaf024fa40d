"""The port's MoE VRGripper transformer (`moe_experts`, `moe_every`)
against the JAX model.

`VRGripperTransformerModel(moe_experts=8, moe_every=2)` at width 32,
depth 4 (MoE on blocks 1 and 3), T = 8, f32: the JAX model's own init
is converted and the same numpy batch goes through both packages' train
grads, eval and predict steps. The aux loss is the sum of the two MoE
layers' load-balance losses, weighted in by `aux_loss_weight` (0.01) in
every mode, reported as `aux_loss`, and stripped from `predict_step`.

Tolerances (f32; the same math in other summation orders): loss and
metrics 1e-5 relative; gradients 1e-4 of each leaf's largest |value|.
A dense model's records carry no `aux_loss`.
"""

import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.research.vrgripper import (  # noqa: E402
    VRGripperTransformerModel as JaxModel,
)
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct  # noqa: E402
from tensor2robot_tpu_torch import train_eval  # noqa: E402
from tensor2robot_tpu_torch.data import (  # noqa: E402
    EpisodeInputGenerator,
    Mode,
)
from tensor2robot_tpu_torch.models import convert  # noqa: E402
from tensor2robot_tpu_torch.research.vrgripper import (  # noqa: E402
    VRGripperEnv,
    VRGripperTransformerModel,
    collect_expert_episode,
)

_SMALL = dict(image_size=16, filters=(8,), embedding_size=16, width=32,
              depth=4, num_heads=2, max_context_length=8,
              attention_impl="reference")
_MOE = dict(moe_experts=8, moe_every=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """One intra-op thread: the tensors are small, and the test workers
  share the host's cores."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _episodes(n=6, seed=0):
  env = VRGripperEnv(image_size=16, seed=seed, max_steps=10)
  rng = np.random.default_rng(seed)
  return [collect_expert_episode(env, action_noise=0.1,
                                 min_steps=int(rng.integers(4, 11)),
                                 rng=rng) for _ in range(n)]


def _batch(model):
  gen = EpisodeInputGenerator(_episodes(), sequence_length=8, batch_size=4,
                              seed=1)
  gen.set_specification_from_model(model, Mode.TRAIN)
  return next(gen.create_dataset(Mode.TRAIN))


@functools.lru_cache(maxsize=None)
def _jax():
  model = JaxModel(device_dtype=jnp.float32, **_SMALL, **_MOE)
  state = jax.jit(model.create_train_state)(jax.random.PRNGKey(0))
  return (model, state, jax.jit(model.train_grads), jax.jit(model.eval_step),
          jax.jit(model.predict_step))


def _port():
  jax_state = _jax()[1]
  model = VRGripperTransformerModel(device_dtype=torch.float32, **_SMALL,
                                    **_MOE)
  state = convert.convert_variables(
      {"params": jax.tree_util.tree_map(np.asarray, jax_state.params)})
  return model, state


def _to_jax(struct):
  return JaxStruct.from_flat_dict(
      {k: jnp.asarray(v) for k, v in struct.to_flat_dict().items()})


def _to_torch(struct):
  return {k: torch.from_numpy(np.asarray(v))
          for k, v in struct.to_flat_dict().items()}


def test_moe_params_are_the_jax_models():
  model, state = _port()
  network = model.create_network()
  assert set(dict(network.named_parameters())) == set(state.params)
  assert {k for k in state.params if ".moe." in k} == {
      f"trunk.block{i}.moe.{name}" for i in (1, 3)
      for name in ("router", "moe_expert_w_in", "moe_expert_b_in",
                   "moe_expert_w_out", "moe_expert_b_out")}


def test_train_grads_match_jax():
  _, jax_state, jax_grads, _, _ = _jax()
  model, state = _port()
  features, labels = _batch(model)
  j_grads, _, j_metrics = jax_grads(jax_state, _to_jax(features),
                                    _to_jax(labels), jax.random.PRNGKey(1))
  grads, _, metrics = model.train_grads(state, _to_torch(features),
                                        _to_torch(labels))
  assert set(metrics) == set(j_metrics) == {
      "loss", "grad_norm", "mse", "action_error", "aux_loss"}
  for key in metrics:
    np.testing.assert_allclose(_np(metrics[key]), _np(j_metrics[key]),
                               rtol=1e-5, err_msg=key)
  # The loss carries the weighted aux loss.
  assert float(metrics["loss"]) == pytest.approx(
      float(metrics["mse"]) + 0.01 * float(metrics["aux_loss"]), rel=1e-6)
  assert 0.0 < float(metrics["aux_loss"]) <= 2 * 8
  want = convert.convert_params(jax.device_get(j_grads))
  assert set(grads) == set(want)
  for key, g in grads.items():
    w = _np(want[key])
    np.testing.assert_allclose(_np(g), w, rtol=0,
                               atol=1e-4 * max(1e-12, np.abs(w).max()),
                               err_msg=key)


def test_eval_and_predict_treat_the_aux_loss_as_jax():
  _, jax_state, _, jax_eval, jax_predict = _jax()
  model, state = _port()
  features, labels = _batch(model)
  want = jax_eval(jax_state, _to_jax(features), _to_jax(labels))
  got = model.eval_step(state, _to_torch(features), _to_torch(labels))
  assert set(got) == set(want) == {"loss", "mse", "action_error", "aux_loss"}
  for key in got:
    np.testing.assert_allclose(_np(got[key]), _np(want[key]), rtol=1e-5,
                               err_msg=key)
  want_out = jax_predict(jax_state, _to_jax(features))
  out = model.predict_step(state, _to_torch(features))
  assert set(out) == set(want_out) == {"action", "inference_output"}
  np.testing.assert_allclose(_np(out["action"]), _np(want_out["action"]),
                             atol=1e-5, rtol=0)


def _records(model_dir):
  with open(os.path.join(model_dir, "metrics_train.jsonl")) as f:
    return [json.loads(line)["payload"] for line in f if line.strip()]


@pytest.mark.parametrize("moe", [True, False], ids=["moe", "dense"])
def test_train_eval_records_carry_aux_loss_only_with_moe(tmp_path, moe):
  model = VRGripperTransformerModel(device_dtype=torch.float32, **_SMALL,
                                    **(_MOE if moe else {}))
  train_eval.train_eval_model(
      model, str(tmp_path),
      input_generator_train=EpisodeInputGenerator(
          _episodes(), sequence_length=8, batch_size=4, seed=1),
      max_train_steps=4, log_every_steps=2, save_checkpoints_steps=4,
      device="cpu")
  records = _records(str(tmp_path))
  assert len(records) == 2
  for record in records:
    assert ("aux_loss" in record) == moe
    if moe:
      assert np.isfinite(record["aux_loss"]) and record["aux_loss"] > 0
