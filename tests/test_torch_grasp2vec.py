"""The port's grasp2vec family and checkpoint predictor against the JAX
package.

Small size: 16×16 images, ResNet stage sizes (1, 1) at 8 filters,
embedding 16, batch 6. Flax variables from the JAX model's own init,
every batch-norm scale, bias and running statistic redrawn from a seed
(so no residual branch is the zero-initialized identity), are converted
(`models/convert.py`) and the same numpy inputs go through both
packages.

Tolerances. f32: 1e-5 of the largest magnitude (outputs, losses,
metrics: the same f32 math in other summation orders); one train step:
gradients and new batch statistics to 1e-4 of each leaf's largest
magnitude, and each updated parameter to 2e-6 absolute where its
gradient is not tiny, else within two learning rates (Adam's first step
is ±lr · sign(g) there, and a sign may differ between summation orders).
bf16: embeddings, maps and the loss to 3e-2 of their largest magnitude;
the goal reward (a cosine, in [−1, 1], of the difference of two nearly
equal scene embeddings, which amplifies their bf16 roundings) to 2e-2
absolute, and exactly the cosine of the port's own embeddings; the
gradient's direction: cosine ≥ 0.99 over all leaves together (the BC
slice's bound) and ≥ 0.97 for each leaf. Per leaf, the port's bf16
gradients sit as far from JAX's as each package's bf16 sits from its own
f32 (measured: 0.979 at the least, a stem batch-norm bias of 8 values;
JAX's own bf16 against its f32 on one leaf 0.969). Scene generation,
goal galleries and records: bit for bit.
"""

import dataclasses
import functools
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.data.abstract_input_generator import (  # noqa: E402
    Mode as JaxMode,
)
from tensor2robot_tpu.data.tfrecord_input_generator import (  # noqa: E402
    TFRecordInputGenerator as JaxTFRecordInputGenerator,
)
from tensor2robot_tpu.models import optimizers as jax_opt  # noqa: E402
from tensor2robot_tpu.research import grasp2vec as jax_g2v  # noqa: E402
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct  # noqa: E402
from tensor2robot_tpu_torch import train_eval  # noqa: E402
from tensor2robot_tpu_torch.data import (  # noqa: E402
    Mode,
    TFRecordInputGenerator,
)
from tensor2robot_tpu_torch.models import convert, optimizers  # noqa: E402
from tensor2robot_tpu_torch.predictors import CheckpointPredictor  # noqa: E402
from tensor2robot_tpu_torch.research import grasp2vec as g2v  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import (  # noqa: E402
    GraspingQModel,
    QTOptLearner,
)
from tensor2robot_tpu_torch.telemetry.records import read_records  # noqa: E402

_SMALL = dict(image_size=16, embedding_size=16, stage_sizes=(1, 1),
              num_filters=8)
_LR = 1e-3
_IMAGES = ("pregrasp_image", "postgrasp_image", "goal_image")
_OUTPUTS = (g2v.PREGRASP_EMBEDDING, g2v.POSTGRASP_EMBEDDING,
            g2v.GOAL_EMBEDDING, g2v.SCENE_SPATIAL, g2v.GOAL_REWARD)


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


# ---- losses and heatmaps ----


@pytest.mark.parametrize("ids", [None, "unique", "duplicates"])
def test_npairs_loss_matches_jax(ids):
  rng = np.random.default_rng(0)
  anchor = rng.normal(size=(6, 5)).astype(np.float32)
  positive = rng.normal(size=(6, 5)).astype(np.float32)
  object_ids = {None: None, "unique": np.arange(6),
                "duplicates": np.array([0, 1, 1, 2, 0, 3])}[ids]
  want_loss, want = jax_g2v.npairs_loss(
      jnp.asarray(anchor), jnp.asarray(positive),
      None if object_ids is None else jnp.asarray(object_ids),
      reg_lambda=0.01)
  loss, got = g2v.npairs_loss(
      torch.from_numpy(anchor), torch.from_numpy(positive),
      None if object_ids is None else torch.from_numpy(object_ids),
      reg_lambda=0.01)
  assert set(got) == set(want) == {"npairs_xent", "embedding_reg",
                                   "retrieval_top1"}
  _close(loss, want_loss, 1e-6)
  for key in want:
    _close(got[key], want[key], 1e-6, key)


def test_retrieval_top1_takes_the_first_tied_maximum():
  """Both rows tie against positives 0 and 1: argmax picks column 0, a
  match for row 0 only."""
  anchor = np.array([[1.0, 0.0], [1.0, 0.0]], np.float32)
  positive = np.array([[1.0, 0.0], [1.0, 0.0]], np.float32)
  _, want = jax_g2v.npairs_loss(jnp.asarray(anchor), jnp.asarray(positive))
  _, got = g2v.npairs_loss(torch.from_numpy(anchor),
                           torch.from_numpy(positive))
  assert float(got["retrieval_top1"]) == float(want["retrieval_top1"]) == 0.5


def test_goal_similarity_reward_matches_jax():
  rng = np.random.default_rng(1)
  pre, post, goal = (rng.normal(size=(4, 8)).astype(np.float32)
                     for _ in range(3))
  goal[3] = 0.0  # a zero norm: the eps floor
  want = jax_g2v.goal_similarity_reward(*map(jnp.asarray, (pre, post, goal)))
  got = g2v.goal_similarity_reward(*map(torch.from_numpy, (pre, post, goal)))
  _close(got, want, 1e-6)
  _close(g2v.cosine_similarity(torch.from_numpy(pre), torch.from_numpy(goal)),
         jax_g2v.cosine_similarity(jnp.asarray(pre), jnp.asarray(goal)), 1e-6)


@pytest.mark.parametrize("temperature", [1.0, 0.1])
def test_heatmap_and_argmax_match_jax(temperature):
  rng = np.random.default_rng(2)
  spatial = rng.uniform(0, 1, (3, 5, 6, 4)).astype(np.float32)
  goal = rng.uniform(0, 1, (3, 4)).astype(np.float32)
  spatial[1, 4, 0] = 9.0  # a clear peak at (4, 0) for row 1
  want = jax_g2v.goal_localization_heatmap(
      jnp.asarray(spatial), jnp.asarray(goal), temperature)
  got = g2v.goal_localization_heatmap(
      torch.from_numpy(spatial), torch.from_numpy(goal), temperature)
  _close(got, want, 1e-6)
  np.testing.assert_allclose(_np(got).sum(axis=(1, 2)), 1.0, rtol=1e-5)
  for g, w in zip(g2v.heatmap_argmax(got), jax_g2v.heatmap_argmax(want)):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  rows, cols = g2v.heatmap_argmax(got)
  assert (int(rows[1]), int(cols[1])) == (4, 0)


# ---- scenes and records ----


@pytest.mark.parametrize("seed,distractors", [(0, 2), (5, 0)])
def test_scene_generator_matches_jax_bit_for_bit(seed, distractors):
  kwargs = dict(image_size=24, num_object_types=6,
                num_distractors=distractors, seed=seed)
  ours, theirs = g2v.GraspSceneGenerator(**kwargs), \
      jax_g2v.GraspSceneGenerator(**kwargs)
  for _ in range(5):
    got, want = ours.sample(), theirs.sample()
    assert set(got) == set(want)
    for key in want:
      assert got[key].dtype == want[key].dtype, key
      np.testing.assert_array_equal(got[key], want[key], err_msg=key)
  np.testing.assert_array_equal(ours.goal_gallery(), theirs.goal_gallery())


def _read(generator_cls, mode, model, path):
  gen = generator_cls(file_patterns=path, batch_size=5, shuffle=False,
                      repeat=False)
  gen.set_specification_from_model(model, mode)
  out = []
  for features, labels in gen.create_dataset(mode):
    flat = {**features.to_flat_dict(), **labels.to_flat_dict()}
    out.append({k: np.asarray(v) for k, v in flat.items()})
  return out


def test_records_written_by_either_package_parse_alike(tmp_path):
  """Grasp triplets collected by the JAX package (TF's JPEG) and by the
  port (its own codec) are the same tf.Examples, JPEG bytes included
  (the feature map's wire order may differ); each package's EVAL
  generator parses either file to the same arrays."""
  tf = pytest.importorskip("tensorflow")
  jax_path = jax_g2v.collect_grasp_triplets(
      str(tmp_path / "jax.tfrecord"), num_episodes=12, image_size=16,
      seed=3)
  port_path = g2v.collect_grasp_triplets(
      str(tmp_path / "port.tfrecord"), num_episodes=12, image_size=16,
      seed=3)
  pairs = list(zip(tf.data.TFRecordDataset(jax_path),
                   tf.data.TFRecordDataset(port_path)))
  assert len(pairs) == 12
  for a, b in pairs:
    assert (tf.train.Example.FromString(a.numpy())
            == tf.train.Example.FromString(b.numpy()))
  jax_model = jax_g2v.Grasp2VecModel(image_size=16)
  model = g2v.Grasp2VecModel(image_size=16)
  for path in (jax_path, port_path):
    want = _read(JaxTFRecordInputGenerator, JaxMode.EVAL, jax_model, path)
    got = _read(TFRecordInputGenerator, Mode.EVAL, model, path)
    assert [len(b["object_id"]) for b in got] == [
        len(b["object_id"]) for b in want] == [5, 5]  # remainder dropped
    for g, w in zip(got, want):
      assert set(g) == set(w) == set(_IMAGES) | {"object_id"}
      for key in w:
        assert g[key].dtype == w[key].dtype, key
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)


# ---- the model ----


def _perturbed(variables, seed):
  rng = np.random.default_rng(seed)
  out = jax.tree_util.tree_map(np.asarray, variables)

  def walk(tree, kind):
    for key, value in tree.items():
      if isinstance(value, dict):
        walk(value, kind)
      elif kind == "params" and key == "scale":
        tree[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
      elif kind == "params" and key == "bias" and value.ndim == 1:
        tree[key] = rng.uniform(-0.3, 0.3, value.shape).astype(np.float32)
      elif kind == "batch_stats":
        tree[key] = (rng.uniform(-0.2, 0.2, value.shape) if key == "mean"
                     else rng.uniform(0.5, 1.5, value.shape)
                     ).astype(np.float32)

  walk(out["params"], "params")
  walk(out["batch_stats"], "batch_stats")
  return out


@functools.lru_cache(maxsize=None)
def _jax_model(dtype_name):
  return jax_g2v.Grasp2VecModel(
      device_dtype={"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name],
      create_optimizer_fn=functools.partial(jax_opt.create_optimizer,
                                            learning_rate=_LR), **_SMALL)


@functools.lru_cache(maxsize=None)
def _jax_state(dtype_name):
  """JAX's train state (built once, under jit), every batch-norm leaf
  redrawn; f32 masters whatever the compute dtype."""
  state = jax.jit(_jax_model(dtype_name).create_train_state,
                  static_argnums=1)(jax.random.PRNGKey(0), 2)
  variables = _perturbed({"params": state.params,
                          "batch_stats": state.batch_stats}, 7)
  return state.replace(params=variables["params"],
                       batch_stats=variables["batch_stats"])


def _port(dtype_name, jax_state):
  model = g2v.Grasp2VecModel(
      device_dtype={"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name],
      create_optimizer_fn=functools.partial(optimizers.create_optimizer,
                                            learning_rate=_LR), **_SMALL)
  state = convert.convert_variables(jax.tree_util.tree_map(
      np.asarray, {"params": jax_state.params,
                   "batch_stats": jax_state.batch_stats}))
  return model, dataclasses.replace(state,
                                    opt_state=model.tx.init(state.params))


def _batch(n=6, seed=4):
  gen = g2v.GraspSceneGenerator(image_size=16, num_object_types=4,
                                num_distractors=1, seed=seed)
  triplets = [gen.sample() for _ in range(n)]
  features = {k: np.stack([t[k] for t in triplets]) for k in _IMAGES}
  labels = {"object_id": np.array([t["object_id"] for t in triplets])}
  return features, labels


def _converted_params(tree):
  """A flax params-shaped tree (params, grads) under the port's names:
  batch-norm modules keep `scale` (their statistics name them)."""
  return convert.convert_variables(jax.tree_util.tree_map(np.asarray, {
      "params": tree, "batch_stats": _jax_state("f32").batch_stats})).params


def _jax_struct(flat):
  return JaxStruct.from_flat_dict({k: jnp.asarray(v) for k, v in flat.items()})


def _torch(flat):
  return {k: torch.from_numpy(np.asarray(v)) for k, v in flat.items()}


@pytest.mark.parametrize("dtype_name,tol", [("f32", 1e-5), ("bf16", 3e-2)])
def test_outputs_loss_and_metrics_match_jax(dtype_name, tol):
  jax_model, jax_state = _jax_model(dtype_name), _jax_state(dtype_name)
  model, state = _port(dtype_name, jax_state)
  features, labels = _batch()
  want = jax.jit(jax_model.predict_step)(jax_state, _jax_struct(features))
  got = model.predict_step(state, _torch(features))
  assert set(got) == set(want) == set(_OUTPUTS)
  for key in _OUTPUTS:
    assert got[key].dtype == torch.float32, key
  for key in _OUTPUTS[:4]:
    _close(got[key], want[key], tol, key)
  cosine_tol = 1e-5 if dtype_name == "f32" else 2e-2
  np.testing.assert_allclose(_np(got[g2v.GOAL_REWARD]),
                             _np(want[g2v.GOAL_REWARD]), atol=cosine_tol,
                             rtol=0)
  np.testing.assert_array_equal(
      _np(got[g2v.GOAL_REWARD]), _np(g2v.goal_similarity_reward(
          *(got[k] for k in _OUTPUTS[:3]))))
  want_loss, want_metrics = jax_model.model_train_fn(
      _jax_struct(features), _jax_struct(labels), want, JaxMode.TRAIN)
  loss, metrics = model.model_train_fn(
      _torch(features), _torch(labels), got, Mode.TRAIN)
  assert set(metrics) == set(want_metrics) == {
      "npairs_xent", "embedding_reg", "retrieval_top1", "goal_similarity"}
  _close(loss, want_loss, tol, "loss")
  for key in ("npairs_xent", "embedding_reg"):
    _close(metrics[key], want_metrics[key], tol, key)
  np.testing.assert_allclose(_np(metrics["goal_similarity"]),
                             _np(want_metrics["goal_similarity"]),
                             atol=cosine_tol, rtol=0)


def test_one_f32_train_step_matches_jax():
  """Loss, metrics, gradients, the new batch statistics (one stacked 2B
  pass through the scene tower) and the updated params."""
  jax_model, jax_state = _jax_model("f32"), _jax_state("f32")
  model, state = _port("f32", jax_state)
  features, labels = _batch()
  rng = jax.random.PRNGKey(1)
  j_grads, j_stats, j_metrics = jax.jit(jax_model.train_grads)(
      jax_state, _jax_struct(features), _jax_struct(labels), rng)
  grads, stats, metrics = model.train_grads(state, _torch(features),
                                            _torch(labels))
  assert set(metrics) == set(j_metrics)
  for key in metrics:
    _close(metrics[key], j_metrics[key], 1e-5, key)
  want_grads = _converted_params(j_grads)
  assert set(grads) == set(want_grads)
  for key, g in grads.items():
    _close(g, want_grads[key], 1e-4, key)
  want_stats = convert.convert_batch_stats(jax.device_get(j_stats))
  assert set(stats) == set(want_stats)
  for key, value in stats.items():
    _close(value, want_stats[key], 1e-4, key)
  new_jax = jax.jit(jax_model.apply_gradients)(jax_state, j_grads, j_stats)
  new = model.apply_gradients(state, grads, stats)
  want_params = _converted_params(new_jax.params)
  for key, p in new.params.items():
    diff = np.abs(_np(p) - _np(want_params[key]))
    g = np.abs(_np(grads[key]))
    tiny = g < 1e-4 * g.max()
    assert diff[~tiny].max(initial=0) <= 2e-6, key
    assert diff[tiny].max(initial=0) <= 2 * _LR, key


def test_bf16_gradients_point_the_same_way():
  jax_model, jax_state = _jax_model("bf16"), _jax_state("bf16")
  model, state = _port("bf16", jax_state)
  features, labels = _batch()
  j_grads, _, _ = jax.jit(jax_model.train_grads)(
      jax_state, _jax_struct(features), _jax_struct(labels),
      jax.random.PRNGKey(1))
  grads, _, _ = model.train_grads(state, _torch(features), _torch(labels))
  want = _converted_params(j_grads)
  assert set(grads) == set(want)
  cosine = torch.nn.functional.cosine_similarity
  flat_got, flat_want = [], []
  for key, g in sorted(grads.items()):
    assert g.dtype == torch.float32, key
    w = torch.from_numpy(_np(want[key])).flatten()
    assert cosine(g.flatten(), w, dim=0) >= 0.97, key
    flat_got.append(g.flatten())
    flat_want.append(w)
  assert cosine(torch.cat(flat_got), torch.cat(flat_want), dim=0) >= 0.99


def test_specs_match_jax():
  jax_model, model = jax_g2v.Grasp2VecModel(), g2v.Grasp2VecModel()
  for mode, jax_mode in ((Mode.TRAIN, JaxMode.TRAIN),
                         (Mode.PREDICT, JaxMode.PREDICT)):
    want = jax_model.get_feature_specification(jax_mode).to_flat_dict()
    got = model.get_feature_specification(mode).to_flat_dict()
    assert list(got) == list(want) == list(_IMAGES)
    for key, spec in want.items():
      assert got[key].shape == spec.shape == (64, 64, 3)
      assert got[key].data_format == spec.data_format == "jpeg"
      assert np.dtype(got[key].dtype) == np.dtype(spec.dtype) == np.uint8
  label = model.get_label_specification(Mode.TRAIN).to_flat_dict()
  assert list(label) == ["object_id"]
  assert np.dtype(label["object_id"].dtype) == np.int64
  assert model.get_label_specification(Mode.PREDICT) is None
  assert jax_model.get_label_specification(JaxMode.PREDICT) is None


# ---- the QT-Opt handoff ----


def test_reward_fn_and_relabel_match_jax_and_the_learner_spec():
  jax_model, jax_state = _jax_model("f32"), _jax_state("f32")
  model, state = _port("f32", jax_state)
  features, _ = _batch(n=5, seed=8)
  actions = np.random.default_rng(0).uniform(-1, 1, (5, 4)).astype(
      np.float32)
  want = jax_g2v.relabel_transitions(
      jax_g2v.make_grasp2vec_reward_fn(jax_model, jax_state, binary=False),
      *(features[k] for k in _IMAGES), actions)
  reward_fn = g2v.make_grasp2vec_reward_fn(model, state, binary=False)
  got = g2v.relabel_transitions(reward_fn, *(features[k] for k in _IMAGES),
                                actions)
  assert set(got) == set(want)
  for key in want:
    _close(got[key], want[key], 1e-5, key)
  binary = reward_fn(*(features[k] for k in _IMAGES))
  np.testing.assert_array_equal(
      g2v.make_grasp2vec_reward_fn(model, state, threshold=0.1)(
          *(features[k] for k in _IMAGES))["reward"],
      (binary["similarity"] > 0.1).astype(np.float32))
  learner = QTOptLearner(GraspingQModel(
      image_size=16, extra_state_features={
          g2v.GOAL_EMBEDDING_FEATURE: (16,)}), device="cpu")
  spec = learner.transition_specification().to_flat_dict()
  assert set(got) == set(spec)
  assert "next_goal_embedding" in spec
  for key, value in got.items():
    assert tuple(value.shape[1:]) == tuple(spec[key].shape), key
    assert np.dtype(value.dtype) == np.dtype(spec[key].dtype), key


# ---- the predictor and the whole loop ----


_TINY = dict(image_size=32, embedding_size=32, stage_sizes=(1,),
             num_filters=8)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
  """collect → train_eval_model → checkpoint, as the JAX package's
  end-to-end test runs it (192 triplets, 4 object types, 1 distractor,
  120 steps of 16 at lr 1e-3, bf16)."""
  root = tmp_path_factory.mktemp("g2v")
  data = g2v.collect_grasp_triplets(
      str(root / "train.tfrecord"), num_episodes=192, image_size=32,
      num_object_types=4, num_distractors=1, seed=0)
  model = g2v.Grasp2VecModel(
      create_optimizer_fn=functools.partial(optimizers.create_optimizer,
                                            learning_rate=1e-3), **_TINY)
  model_dir = str(root / "model")
  train_eval.train_eval_model(
      model=model, model_dir=model_dir,
      input_generator_train=TFRecordInputGenerator(
          file_patterns=data, shuffle_buffer_size=192, seed=1),
      input_generator_eval=TFRecordInputGenerator(
          file_patterns=data, shuffle=False, repeat=False),
      max_train_steps=120, eval_steps=2, batch_size=16,
      save_checkpoints_steps=60, log_every_steps=20, device="cpu")
  return model, model_dir


def test_trained_embeddings_retrieve_through_the_predictor(trained):
  model, model_dir = trained
  records = read_records(os.path.join(model_dir, "metrics_train.jsonl"))
  assert records[-1]["loss"] < records[0]["loss"]
  assert read_records(os.path.join(model_dir, "metrics_eval.jsonl"))
  predictor = CheckpointPredictor(model, checkpoint_dir=model_dir,
                                  device="cpu")
  assert predictor.restore(timeout_secs=0)
  assert predictor.model_version == 120
  metrics = g2v.evaluate_retrieval(
      predictor.predict, num_queries=32, image_size=32, num_object_types=4,
      num_distractors=1, seed=9)
  assert metrics["chance_top1"] == pytest.approx(0.25)
  assert metrics["retrieval_top1"] >= 0.6


def test_predictor_contract(trained):
  model, model_dir = trained
  empty = CheckpointPredictor(model, checkpoint_dir=model_dir + "_none",
                              device="cpu")
  assert not empty.restore(timeout_secs=0)
  features, _ = _batch(n=3)
  features = {k: np.repeat(np.repeat(v, 2, 1), 2, 2)
              for k, v in features.items()}
  with pytest.raises(ValueError, match="restore"):
    empty.predict(features)
  empty.init_randomly()
  assert empty.model_version == 0
  assert empty.predict(features)[g2v.GOAL_EMBEDDING].shape == (3, 32)
  assert list(empty.feature_specification.to_flat_dict()) == list(_IMAGES)
  assert empty.label_specification is None
  assert empty.serving_engine is None and empty.warmup_seconds == 0.0
  with pytest.raises(ValueError, match="checkpoint_dir"):
    CheckpointPredictor(model, device="cpu").restore(timeout_secs=0)
  per_call = CheckpointPredictor(model, checkpoint_dir=model_dir,
                                 device="cpu")
  assert per_call.restore(timeout_secs=0)
  assert per_call.restore(timeout_secs=0)  # nothing newer: keeps step 120
  assert per_call.model_version == 120
  with CheckpointPredictor(model, checkpoint_dir=model_dir, device="cpu",
                           max_batch=4) as served:
    assert served.restore(timeout_secs=0)
    assert served.serving_engine is not None
    assert served.warmup_seconds >= 0.0
    want = per_call.predict(features)
    got = served.predict(features)
    assert set(got) == set(_OUTPUTS)
    for key in _OUTPUTS:
      np.testing.assert_allclose(got[key], want[key], atol=1e-6,
                                 err_msg=key)
  with pytest.raises(Exception):
    per_call.predict({"pregrasp_image": features["pregrasp_image"]})


def test_train_grasp2vec_gin_runs_through_the_trainer(tmp_path):
  """The shipped config as written, the record paths through
  `--gin_bindings` as its header says, plus the bindings that cut it to
  the test size and put it on the CPU."""
  from tensor2robot_tpu_torch import config as gin
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  data = g2v.collect_grasp_triplets(str(tmp_path / "train.tfrecord"),
                                    num_episodes=24, image_size=16)
  model_dir = str(tmp_path / "model")
  bindings = [
      f"train_eval_model.model_dir = '{model_dir}'",
      f"TFRecordInputGenerator.file_patterns = '{data}'",
      "train_eval_model.device = 'cpu'",
      "train_eval_model.max_train_steps = 4",
      "train_eval_model.save_checkpoints_steps = 2",
      "train_eval_model.log_every_steps = 2",
      "train_eval_model.batch_size = 8",
      "Grasp2VecModel.image_size = 16",
      "Grasp2VecModel.stage_sizes = (1,)",
      "Grasp2VecModel.num_filters = 8",
      "Grasp2VecModel.embedding_size = 8",
  ]
  argv = ["--gin_configs",
          "tensor2robot_tpu/research/grasp2vec/configs/train_grasp2vec.gin"]
  for binding in bindings:
    argv += ["--gin_bindings", binding]
  try:
    assert run_t2r_trainer.main(argv) == 0
  finally:
    gin.clear_config()
  train = read_records(os.path.join(model_dir, "metrics_train.jsonl"))
  assert [r["step"] for r in train] == [2, 4]
  assert all(np.isfinite(r["loss"]) for r in train)
  evals = read_records(os.path.join(model_dir, "metrics_eval.jsonl"))
  assert [r["step"] for r in evals] == [4]
  assert {"loss", "retrieval_top1", "goal_similarity"} <= set(evals[0])


def test_relabelled_transitions_train_goal_conditioned_qtopt():
  """Phase 40's path at test size on the CPU: grasp2vec labels fill a
  replay buffer and `train_qtopt` takes Bellman steps through the fused
  select's plain version, the goal embedding an extra state feature."""
  from tensor2robot_tpu_torch.research.qtopt import ReplayBuffer
  from tensor2robot_tpu_torch.research.qtopt.train_qtopt import train_qtopt
  jax_state = _jax_state("f32")
  model, state = _port("f32", jax_state)
  features, _ = _batch(n=16, seed=9)
  actions = np.random.default_rng(1).uniform(-1, 1, (16, 4)).astype(
      np.float32)
  transitions = g2v.relabel_transitions(
      g2v.make_grasp2vec_reward_fn(model, state),
      *(features[k] for k in _IMAGES), actions)
  learner = QTOptLearner(
      GraspingQModel(image_size=16, torso_filters=(8,), head_filters=(8,),
                     dense_sizes=(16,), extra_state_features={
                         g2v.GOAL_EMBEDDING_FEATURE: (16,)}),
      cem_iterations=2, cem_population=8, cem_elites=2, cem_select="fused",
      device="cpu")
  replay = ReplayBuffer(learner.transition_specification(), capacity=16,
                        seed=0)
  replay.add(transitions)
  with tempfile.TemporaryDirectory() as model_dir:
    out = train_qtopt(learner, model_dir, replay_buffer=replay,
                      max_train_steps=4, batch_size=8,
                      save_checkpoints_steps=4, log_every_steps=2)
    losses = [r["loss"] for r in read_records(
        os.path.join(model_dir, "metrics_train.jsonl"))]
  assert out.step == 4 and len(losses) == 2
  assert all(np.isfinite(losses))
