"""The port's pose_env against the JAX package's.

  * `PoseEnv`: the same seed gives the same poses and images, bit for
    bit (numpy, one `default_rng` stream in the same order).
  * `evaluate_pose_model`: the same metrics for the same `predict_fn`.
  * `PoseEnvRegressionModel` at a small width (16×16 images, filters
    (4, 8), embedding 8): the flax variables of the JAX model's own
    init, with random batch statistics and temperature, converted by
    `models/convert.py`; the same uint8 images through both forwards,
    and the loss and `pose_error` of each package's outputs. Tolerances:
    f32 1e-5 absolute (the same math in other summation orders); bf16
    2e-2 absolute and relative, as the transformer's bf16 tests take
    (convolutions and dense layers round to bf16 at each layer in both
    packages, at places inside a kernel that differ).
  * `train_pose_env.gin` through the port's `run_t2r_trainer` on the
    CPU at that small size writes its success-eval records.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.data.abstract_input_generator import (  # noqa: E402
    Mode as JaxMode,
)
from tensor2robot_tpu.research.pose_env.pose_env import (  # noqa: E402
    PoseEnv as JaxPoseEnv,
    evaluate_pose_model as jax_evaluate,
)
from tensor2robot_tpu.research.pose_env.pose_env_models import (  # noqa: E402
    PoseEnvRegressionModel as JaxModel,
)
from tensor2robot_tpu.telemetry import records as jax_records  # noqa: E402
from tensor2robot_tpu_torch import config as gin  # noqa: E402
from tensor2robot_tpu_torch.bin import run_t2r_trainer  # noqa: E402
from tensor2robot_tpu_torch.data import Mode  # noqa: E402
from tensor2robot_tpu_torch.models import convert  # noqa: E402
from tensor2robot_tpu_torch.research.pose_env import (  # noqa: E402
    PoseEnv,
    PoseEnvRegressionModel,
    evaluate_pose_model,
)
from tensor2robot_tpu_torch.telemetry import records  # noqa: E402

_SMALL = dict(image_size=16, filters=(4, 8), embedding_size=8)


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("seed,image_size", [(0, 64), (1009, 64), (3, 16)])
def test_pose_env_matches_jax_bit_for_bit(seed, image_size):
  ours = PoseEnv(image_size=image_size, seed=seed)
  theirs = JaxPoseEnv(image_size=image_size, seed=seed)
  for _ in range(6):
    got, want = ours.reset(), theirs.reset()
    assert got["image"].dtype == np.uint8
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(ours.pose, theirs.pose)
  with pytest.raises(RuntimeError, match="reset"):
    PoseEnv().pose


def test_evaluate_pose_model_matches_jax():
  """A deterministic predictor: the image's red-pixel centroid mapped
  into the workspace (some episodes succeed, some do not)."""

  def predict(features):
    image = features["image"][0].astype(np.float32)
    red = (image[..., 0] > 150) & (image[..., 1] < 100)
    ys, xs = np.nonzero(red)
    size = image.shape[0]
    xy = (np.array([xs.mean(), ys.mean()]) + 0.5) / size * 0.8 - 0.4
    return {"inference_output": xy[None].astype(np.float32)}

  kwargs = dict(num_episodes=40, image_size=32, seed=1009,
                success_threshold=0.03)
  got = evaluate_pose_model(predict, **kwargs)
  assert got == jax_evaluate(predict, **kwargs)
  assert 0.0 < got["success_rate"] < 1.0 and got["num_episodes"] == 40.0


def _pair(jdt, tdt, seed=0):
  rng = np.random.default_rng(seed)
  jax_model = JaxModel(device_dtype=jdt, **_SMALL)
  model = PoseEnvRegressionModel(device_dtype=tdt, **_SMALL)
  images = rng.integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
  net = jax_model.create_network()
  variables = jax.tree_util.tree_map(np.asarray, dict(net.init(
      jax.random.PRNGKey(seed), {"image": jnp.asarray(images)})))
  variables["params"]["encoder"]["ssoftmax"]["log_temperature"] = (
      np.float32(0.3))
  for stats in variables["batch_stats"]["encoder"]["tower"].values():
    stats["mean"] = rng.uniform(-0.2, 0.2, stats["mean"].shape).astype(
        np.float32)
    stats["var"] = rng.uniform(0.5, 1.5, stats["var"].shape).astype(
        np.float32)
  labels = rng.uniform(-0.4, 0.4, (3, 2)).astype(np.float32)
  return jax_model, net, variables, model, images, labels


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pose_model_matches_jax(dtype):
  jdt, tdt, tol = ((jnp.float32, torch.float32, dict(atol=1e-5, rtol=0))
                   if dtype == "f32" else
                   (jnp.bfloat16, torch.bfloat16, dict(atol=2e-2, rtol=2e-2)))
  jax_model, net, variables, model, images, labels = _pair(jdt, tdt)
  want = net.apply(variables, {"image": jnp.asarray(images)})
  state = convert.convert_variables(variables)
  got = model.predict_step(state, {"image": torch.from_numpy(images)})
  key = "inference_output"
  assert got[key].dtype == torch.float32 and got[key].shape == (3, 2)
  np.testing.assert_allclose(_np(got[key]), _np(want[key]), **tol)
  j_loss, j_scalars = jax_model.model_train_fn(
      {"image": jnp.asarray(images)}, {"target_pose": jnp.asarray(labels)},
      want, JaxMode.TRAIN)
  loss, scalars = model.model_train_fn(
      {"image": torch.from_numpy(images)},
      {"target_pose": torch.from_numpy(labels)}, got, Mode.TRAIN)
  np.testing.assert_allclose(_np(loss), _np(j_loss), **tol)
  assert set(scalars) == set(j_scalars) == {"mse", "pose_error"}
  for name in scalars:
    np.testing.assert_allclose(_np(scalars[name]), _np(j_scalars[name]),
                               **tol)


def test_pose_model_specs_match_jax():
  for mode, jax_mode in ((Mode.TRAIN, JaxMode.TRAIN),
                         (Mode.PREDICT, JaxMode.PREDICT)):
    for ours, theirs in (
        (PoseEnvRegressionModel().get_feature_specification(mode),
         JaxModel().get_feature_specification(jax_mode)),
        (PoseEnvRegressionModel().get_label_specification(mode),
         JaxModel().get_label_specification(jax_mode))):
      got, want = ours.to_flat_dict(), theirs.to_flat_dict()
      assert list(got) == list(want)
      for key in got:
        assert tuple(got[key].shape) == tuple(want[key].shape)
        assert np.dtype(got[key].dtype) == np.dtype(want[key].dtype)
  assert PoseEnvRegressionModel().device_dtype is torch.bfloat16


def test_train_pose_env_gin_runs_through_the_trainer(tmp_path):
  """The shipped config, as written, plus the bindings that cut it to
  the test size and put it on the CPU."""
  model_dir = str(tmp_path / "pose")
  bindings = [
      f"train_eval_model.model_dir = '{model_dir}'",
      "train_eval_model.device = 'cpu'",
      "train_eval_model.max_train_steps = 4",
      "train_eval_model.save_checkpoints_steps = 2",
      "train_eval_model.log_every_steps = 2",
      "train_eval_model.batch_size = 4",
      "train/RandomInputGenerator.batch_size = 4",
      "eval/RandomInputGenerator.batch_size = 4",
      "PoseEnvRegressionModel.image_size = 16",
      "PoseEnvRegressionModel.filters = (4, 8)",
      "PoseEnvRegressionModel.embedding_size = 8",
      'SuccessEvalHook.eval_kwargs = {"num_episodes": 6, "seed": 1009, '
      '"image_size": 16}',
  ]
  argv = ["--gin_configs",
          "tensor2robot_tpu/research/pose_env/configs/train_pose_env.gin"]
  for binding in bindings:
    argv += ["--gin_bindings", binding]
  try:
    assert run_t2r_trainer.main(argv) == 0
  finally:
    gin.clear_config()
  path = os.path.join(model_dir, "metrics_success_eval.jsonl")
  with open(path) as f:
    raw = [json.loads(line) for line in f]
  assert [r["step"] for r in raw] == [2, 4]
  for record in raw:
    assert records.validate_record(record) == []
    assert jax_records.validate_record(record) == []
    assert set(record["payload"]) == {"success_rate", "mean_pose_error",
                                      "num_episodes"}
    assert record["payload"]["num_episodes"] == 6.0
  train = records.read_records(os.path.join(model_dir,
                                            "metrics_train.jsonl"))
  assert [r["step"] for r in train] == [2, 4]
  assert all(np.isfinite(r["pose_error"]) for r in train)
