"""Port's VRGripper transformer training against the JAX package.

Small size (24×24 images, filters (8, 16), embedding 32, width 48,
depth 2, 2 heads, max_len 64, f32, Adam at lr 1e-3). The JAX model's
own init is converted (`models/convert.py`) and the same numpy batches
go through both packages: the masked BC loss, one and three train steps
(with the reference attention, and with the JAX flash kernels in Pallas
interpret mode patched in as `tests/test_transformer.py` does, against
the port's flash path, whose plain versions run on the CPU), the
optimizer factory and schedules against optax, the random and episode
input generators, and `train_eval_model`'s metrics file.

Tolerances (f32 throughout; the same math in other summation orders):
loss and metrics 1e-5 relative; gradients and Adam's moments 1e-4 of
each leaf's largest |value|; parameters 2e-6 absolute (a few f32 steps
of a weight), except elements whose gradient is below 1e-4 of its
leaf's largest |value| (~6% here). Adam's step, lr·m̂/(√v̂ + 1e-8),
normalizes each element, so it carries the element's relative error,
and summation noise of ~1e-7 of the leaf's largest gradient is ≥ 1e-3
relative there (or flips the sign of a near-zero one): those elements
are held to 2·lr, the most one Adam step can move them.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import tensor2robot_tpu.layers.transformer as jax_tr  # noqa: E402
from tensor2robot_tpu.data.abstract_input_generator import (  # noqa: E402
    Mode as JaxMode,
)
from tensor2robot_tpu.data.random_input_generator import (  # noqa: E402
    RandomInputGenerator as JaxRandomInputGenerator,
)
from tensor2robot_tpu.models import optimizers as jax_opt  # noqa: E402
from tensor2robot_tpu.ops.flash_attention import (  # noqa: E402
    flash_attention as jax_flash_attention,
)
from tensor2robot_tpu.research.vrgripper import (  # noqa: E402
    VRGripperTransformerModel as JaxModel,
)
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct  # noqa: E402
from tensor2robot_tpu.telemetry import records as jax_records  # noqa: E402
from tensor2robot_tpu_torch.data import (  # noqa: E402
    SEQUENCE_LENGTH_KEY,
    EpisodeInputGenerator,
    Mode,
    RandomInputGenerator,
)
from tensor2robot_tpu_torch.models import TrainState, convert  # noqa: E402
from tensor2robot_tpu_torch.models import optimizers  # noqa: E402
from tensor2robot_tpu_torch.research.vrgripper import (  # noqa: E402
    VRGripperEnv,
    VRGripperTransformerModel,
    collect_expert_episode,
)
from tensor2robot_tpu_torch.telemetry.records import read_records  # noqa: E402
from tensor2robot_tpu_torch.train_eval import train_eval_model  # noqa: E402

_SMALL = dict(image_size=24, filters=(8, 16), embedding_size=32, width=48,
              depth=2, num_heads=2, max_context_length=64)
_LR = 1e-3


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
  """|got − want| ≤ tol · max(1e-12, max |want|), per leaf."""
  got, want = _np(got), _np(want)
  assert got.shape == want.shape
  np.testing.assert_allclose(
      got, want, atol=tol * max(1e-12, float(np.abs(want).max())), rtol=0)


def _episodes(n=6, seed=0, max_steps=12):
  env = VRGripperEnv(image_size=24, seed=seed, max_steps=max_steps)
  rng = np.random.default_rng(seed)
  return [collect_expert_episode(env, action_noise=0.1,
                                 min_steps=int(rng.integers(2, max_steps + 1)),
                                 rng=rng) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_fns(impl):
  """The f32 JAX model and its jitted train functions, one set per
  attention path, so each compiles once per module ("flash" traces under
  the interpret patch of the test that first calls it)."""
  jax_model = JaxModel(
      attention_impl="reference", device_dtype=jnp.float32,
      create_optimizer_fn=functools.partial(jax_opt.create_optimizer,
                                            learning_rate=_LR), **_SMALL)
  return (jax_model, jax.jit(jax_model.train_grads),
          jax.jit(jax_model.apply_gradients))


@functools.lru_cache(maxsize=None)
def _jax_init():
  """JAX's initial train state, built once and under jit: flax's eager
  init compiles each op on its own, which takes seconds."""
  return jax.jit(_jax_fns("reference")[0].create_train_state)(
      jax.random.PRNGKey(0))


def _models(impl):
  jax_state = _jax_init()
  model = VRGripperTransformerModel(
      attention_impl=impl, device_dtype=torch.float32,
      create_optimizer_fn=functools.partial(optimizers.create_optimizer,
                                            learning_rate=_LR), **_SMALL)
  state = convert.convert_variables(
      {"params": jax.tree_util.tree_map(np.asarray, jax_state.params)})
  state = dataclasses.replace(state, opt_state=model.tx.init(state.params))
  return jax_state, model, state


def _batches(model, n, sequence_length=16):
  gen = EpisodeInputGenerator(_episodes(8), sequence_length=sequence_length,
                              batch_size=2, seed=1)
  gen.set_specification_from_model(model, Mode.TRAIN)
  stream = gen.create_dataset(Mode.TRAIN)
  return [next(stream) for _ in range(n)]


def _to_jax(struct):
  return JaxStruct.from_flat_dict(
      {k: jnp.asarray(v) for k, v in struct.to_flat_dict().items()})


def _to_torch(struct):
  return {k: torch.from_numpy(np.asarray(v))
          for k, v in struct.to_flat_dict().items()}


# ---- the loss ----


@pytest.mark.parametrize("with_lengths", [True, False])
def test_masked_loss_matches_jax(with_lengths):
  rng = np.random.default_rng(0)
  target = rng.standard_normal((3, 8, 3)).astype(np.float32)
  predicted = rng.standard_normal((3, 8, 3)).astype(np.float32)
  features = {"image": np.zeros((3, 8, 1), np.uint8)}
  if with_lengths:  # 0 and > T included: the denominator's floor, the clip
    features[SEQUENCE_LENGTH_KEY] = np.array([3, 0, 9], np.int32)
  jax_model = JaxModel(**_SMALL)
  want_loss, want = jax_model.model_train_fn(
      JaxStruct.from_flat_dict({k: jnp.asarray(v)
                                for k, v in features.items()}),
      {"action": jnp.asarray(target)}, {"action": jnp.asarray(predicted)},
      JaxMode.TRAIN)
  model = VRGripperTransformerModel(**_SMALL)
  loss, got = model.model_train_fn(
      {k: torch.from_numpy(v) for k, v in features.items()},
      {"action": torch.from_numpy(target)},
      {"action": torch.from_numpy(predicted)}, Mode.TRAIN)
  assert set(got) == set(want) == {"mse", "action_error"}
  np.testing.assert_allclose(_np(loss), _np(want_loss), rtol=1e-6)
  for key in want:
    np.testing.assert_allclose(_np(got[key]), _np(want[key]), rtol=1e-6)


# ---- train steps ----


def _flash_interpret(q, k, v, *, impl, causal, mesh):
  return jax_flash_attention(q, k, v, causal=causal, block_q=8, block_k=8,
                             interpret=True)


def _state_from_jax(jax_state):
  """The port's TrainState holding a JAX state's params and Adam state."""
  convert_tree = lambda tree: convert.convert_params(  # noqa: E731
      jax.device_get(tree))
  adam = jax_state.opt_state[0]
  return TrainState(
      step=int(jax_state.step), params=convert_tree(jax_state.params),
      batch_stats={}, opt_state=(optimizers.ScaleByAdamState(
          torch.tensor(int(adam.count), dtype=torch.int32),
          convert_tree(adam.mu), convert_tree(adam.nu)),
                                 optimizers.EmptyState()))


@pytest.mark.parametrize("steps,impl", [(1, "reference"), (3, "reference"),
                                        (1, "flash")])
def test_train_steps_match_jax(monkeypatch, steps, impl):
  """Loss, metrics, gradients, and after each step the params and Adam's
  moments and count. Each step starts both packages from the same state
  (the port's is converted from JAX's), so steps 2 and 3 hold the moment
  updates and the bias correction at later counts without the first
  step's rounding carried into them. "flash": the JAX trunk runs its
  Pallas kernels (forward and backward) in interpret mode; the port's
  flash path runs its autograd Function, plain versions on the CPU."""
  if impl == "flash":
    monkeypatch.setattr(jax_tr, "_attend", _flash_interpret)
  jax_state, model, state = _models(impl)
  _, jax_grads_fn, jax_apply = _jax_fns(impl)
  rng = jax.random.PRNGKey(1)
  for features, labels in _batches(model, steps):
    j_grads, j_stats, j_metrics = jax_grads_fn(
        jax_state, _to_jax(features), _to_jax(labels), rng)
    grads, stats, metrics = model.train_grads(state, _to_torch(features),
                                              _to_torch(labels))
    assert set(metrics) == set(j_metrics) == {"loss", "grad_norm", "mse",
                                              "action_error"}
    for key in metrics:
      np.testing.assert_allclose(_np(metrics[key]), _np(j_metrics[key]),
                                 rtol=1e-5)
    want_grads = convert.convert_params(jax.device_get(j_grads))
    assert set(grads) == set(want_grads)
    for key, g in grads.items():
      assert g.dtype == torch.float32
      _close(g, want_grads[key], 1e-4)
    jax_state = jax_apply(jax_state, j_grads, j_stats)
    new_state = model.apply_gradients(state, grads, stats)
    want = _state_from_jax(jax_state)
    assert new_state.step == state.step + 1 == want.step
    adam, want_adam = new_state.opt_state[0], want.opt_state[0]
    assert int(adam.count) == int(want_adam.count) == new_state.step
    for moments, want_moments in ((adam.mu, want_adam.mu),
                                  (adam.nu, want_adam.nu)):
      for key, m in moments.items():
        _close(m, want_moments[key], 1e-4)
    for key, p in new_state.params.items():
      diff = np.abs(_np(p) - _np(want.params[key]))
      g = np.abs(_np(grads[key]))
      tiny = g < 1e-4 * g.max()
      assert diff[~tiny].max(initial=0) <= 2e-6, key
      assert diff[tiny].max(initial=0) <= 2 * _LR, key
    state = want


def test_train_step_matches_jax_bf16():
  """bf16 compute, f32 masters: the looser check. Both frameworks round
  every dense, LayerNorm and gelu output to bf16 and carry f32
  cotangents back to the f32 masters, but round at other places inside
  a conv or a gelu, and a gradient summed over the batch's 32 frames ×
  pixels (a conv bias) gathers those roundings. So: loss and metrics to
  1e-2 relative, and each gradient's direction (cosine ≥ 0.99; measured
  ≥ 0.995 here) rather than its elements."""
  jax_model = JaxModel(
      attention_impl="reference",
      create_optimizer_fn=functools.partial(jax_opt.create_optimizer,
                                            learning_rate=_LR), **_SMALL)
  jax_state = _jax_init()  # f32 masters whatever the compute dtype
  model = VRGripperTransformerModel(attention_impl="reference", **_SMALL)
  state = convert.convert_variables(
      {"params": jax.tree_util.tree_map(np.asarray, jax_state.params)})
  (features, labels), = _batches(model, 1)
  j_grads, _, j_metrics = jax.jit(jax_model.train_grads)(
      jax_state, _to_jax(features), _to_jax(labels), jax.random.PRNGKey(1))
  grads, _, metrics = model.train_grads(state, _to_torch(features),
                                        _to_torch(labels))
  for key in metrics:
    np.testing.assert_allclose(_np(metrics[key]), _np(j_metrics[key]),
                               rtol=1e-2)
  want = convert.convert_params(jax.device_get(j_grads))
  for key, g in grads.items():
    assert g.dtype == torch.float32, key
    w = torch.from_numpy(_np(want[key])).flatten()
    cosine = torch.nn.functional.cosine_similarity(g.flatten(), w, dim=0)
    assert cosine >= 0.99, (key, float(cosine))


def test_positions_past_the_batch_get_no_update():
  _, model, state = _models("reference")
  (features, labels), = _batches(model, 1, sequence_length=16)
  new, _ = model.train_step(state, _to_torch(features), _to_torch(labels))
  before, after = state.params["trunk.positions"], new.params[
      "trunk.positions"]
  assert torch.equal(before[16:], after[16:])
  assert not torch.equal(before[:16], after[:16])


def test_unported_training_options_raise_naming_the_roadmap_item():
  """`axis_name` is A11; `remat_policy` is ported (an unknown policy
  raises JAX's ValueError; tests/test_torch_classification.py holds every
  policy to "none")."""
  with pytest.raises(ValueError, match="not in"):
    VRGripperTransformerModel(remat_policy="checkpoint_all", **_SMALL)
  VRGripperTransformerModel(remat_policy="full", **_SMALL)
  _, model, state = _models("reference")
  (features, labels), = _batches(model, 1)
  with pytest.raises(NotImplementedError, match="A11"):
    model.train_step(state, _to_torch(features), _to_torch(labels),
                     axis_name="data")


# ---- the optimizer factory ----


_OPTIMIZERS = [
    dict(optimizer_name="adam"),
    dict(optimizer_name="adam", gradient_clip_norm=0.5,
         gradient_clip_value=0.3, weight_decay=0.01),
    dict(optimizer_name="adamw", weight_decay=0.1),
    dict(optimizer_name="sgd"),
    dict(optimizer_name="momentum", gradient_clip_norm=100.0),
    dict(optimizer_name="adam", use_lr_schedule=True),
]


@pytest.mark.parametrize("kwargs", _OPTIMIZERS,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_create_optimizer_matches_optax(kwargs):
  """Three updates on a small tree: the updates and the new state."""
  rng = np.random.default_rng(2)
  params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}
  jax_tx = jax_opt.create_optimizer(learning_rate=0.05, **kwargs)
  tx = optimizers.create_optimizer(learning_rate=0.05, **kwargs)
  j_params = {k: jnp.asarray(v) for k, v in params.items()}
  t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
  j_state, t_state = jax_tx.init(j_params), tx.init(t_params)
  for _ in range(3):
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    j_updates, j_state = jax_tx.update(
        {k: jnp.asarray(v) for k, v in grads.items()}, j_state, j_params)
    updates, t_state = tx.update(
        {k: torch.from_numpy(v) for k, v in grads.items()}, t_state,
        t_params)
    for key in params:
      np.testing.assert_allclose(_np(updates[key]), _np(j_updates[key]),
                                 rtol=1e-5, atol=1e-7)
    j_params = optax.apply_updates(j_params, j_updates)
    t_params = optimizers.apply_updates(t_params, updates)
  j_leaves = jax.tree_util.tree_leaves(j_state)
  t_leaves = [x for x in jax.tree_util.tree_leaves(
      t_state, is_leaf=lambda x: isinstance(x, torch.Tensor))]
  assert len(j_leaves) == len(t_leaves)
  for j, t in zip(j_leaves, t_leaves):
    np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kwargs", [
    dict(schedule="constant"),
    dict(schedule="exponential_decay", decay_steps=10, staircase=True,
         end_learning_rate=2e-5),
    dict(schedule="exponential_decay", decay_steps=7),
    dict(schedule="cosine_decay", decay_steps=20, end_learning_rate=1e-5,
         warmup_steps=5),
    dict(schedule="linear_decay", decay_steps=30, warmup_steps=3),
])
def test_create_lr_schedule_matches_optax(kwargs):
  want = jax_opt.create_lr_schedule(learning_rate=1e-3, **kwargs)
  got = optimizers.create_lr_schedule(learning_rate=1e-3, **kwargs)
  for count in (0, 1, 3, 5, 9, 10, 25, 40):
    np.testing.assert_allclose(
        _np(torch.as_tensor(got(torch.tensor(count, dtype=torch.int32)))),
        _np(want(jnp.int32(count))), rtol=1e-6)


@pytest.mark.parametrize("name", ["rmsprop", "adagrad", "lamb"])
def test_unported_optimizers_raise_naming_the_roadmap_item(name):
  """rmsprop, adagrad and lamb are ported now: each builds, with
  optax's state layout; a name neither package knows raises."""
  tx = optimizers.create_optimizer(name)
  state = tx.init({"w": torch.ones(3)})
  jax_state = jax_opt.create_optimizer(name).init({"w": jnp.ones(3)})
  assert [type(s).__name__ for s in state] == [
      type(s).__name__ for s in jax_state]
  with pytest.raises(ValueError, match="Unknown optimizer"):
    optimizers.create_optimizer(name + "_nope")


@pytest.mark.parametrize("kwargs", [
    dict(optimizer_name="rmsprop"),
    dict(optimizer_name="rmsprop", use_lr_schedule=True,
         gradient_clip_norm=0.5),
    dict(optimizer_name="adagrad"),
    dict(optimizer_name="adagrad", weight_decay=0.01),
    dict(optimizer_name="lamb"),
    dict(optimizer_name="lamb", weight_decay=0.01, gradient_clip_value=0.3),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_rmsprop_adagrad_lamb_match_optax(kwargs):
  """Five f32 updates on a small tree against the JAX package's optax
  chain, at the Adam-vs-optax test's tolerance (rtol 1e-5, atol 1e-7):
  neither is bit for bit. XLA's CPU rsqrt is not correctly rounded (it
  differs from torch's in the last bit on about a third of f32 inputs),
  and lamb's per-leaf norms sum in another order."""
  rng = np.random.default_rng(11)
  params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "c": rng.standard_normal((16, 9)).astype(np.float32)}
  jax_tx = jax_opt.create_optimizer(learning_rate=0.05, **kwargs)
  tx = optimizers.create_optimizer(learning_rate=0.05, **kwargs)
  j_params = {k: jnp.asarray(v) for k, v in params.items()}
  t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
  j_state, t_state = jax_tx.init(j_params), tx.init(t_params)
  for _ in range(5):
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    j_updates, j_state = jax_tx.update(
        {k: jnp.asarray(v) for k, v in grads.items()}, j_state, j_params)
    updates, t_state = tx.update(
        {k: torch.from_numpy(v) for k, v in grads.items()}, t_state,
        t_params)
    for key in params:
      np.testing.assert_allclose(_np(updates[key]), _np(j_updates[key]),
                                 rtol=1e-5, atol=1e-7)
    j_params = optax.apply_updates(j_params, j_updates)
    t_params = optimizers.apply_updates(t_params, updates)
  for key in params:
    np.testing.assert_allclose(_np(t_params[key]), _np(j_params[key]),
                               rtol=1e-5, atol=1e-7)
  j_leaves = jax.tree_util.tree_leaves(j_state)
  t_leaves = jax.tree_util.tree_leaves(
      t_state, is_leaf=lambda x: isinstance(x, torch.Tensor))
  assert len(j_leaves) == len(t_leaves)
  for j, t in zip(j_leaves, t_leaves):
    np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-7)


# ---- input generators ----


def test_random_input_generator_is_bitwise_that_of_jax():
  jax_gen = JaxRandomInputGenerator(batch_size=2, sequence_length=4, seed=5)
  jax_gen.set_specification_from_model(JaxModel(**_SMALL), JaxMode.TRAIN)
  gen = RandomInputGenerator(batch_size=2, sequence_length=4, seed=5)
  gen.set_specification_from_model(VRGripperTransformerModel(**_SMALL),
                                   Mode.TRAIN)
  jax_stream, stream = (jax_gen.create_dataset(JaxMode.TRAIN),
                        gen.create_dataset(Mode.TRAIN))
  for _ in range(2):
    (jf, jl), (f, lab) = next(jax_stream), next(stream)
    for want, got in ((jf, f), (jl, lab)):
      want, got = want.to_flat_dict(), got.to_flat_dict()
      assert list(got) == list(want)
      for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_episode_input_generator_matches_the_tfrecord_generator(tmp_path):
  """The same episodes through the TFRecord wire (SequenceExample, PNG
  frames, lossless) and through the in-memory generator, no shuffle:
  the same batches, bit for bit, lengths included."""
  pytest.importorskip("tensorflow")
  from tensor2robot_tpu.data.tfrecord_input_generator import (
      TFRecordEpisodeInputGenerator,
      write_episode_tfrecord,
  )
  episodes = _episodes(5, seed=3)  # 2 to 12 steps; the crop is 8
  jax_model = JaxModel(**_SMALL)
  path = str(tmp_path / "episodes.tfrecord")
  write_episode_tfrecord(path, episodes,
                         jax_model.get_feature_specification(JaxMode.TRAIN),
                         jax_model.get_label_specification(JaxMode.TRAIN))
  jax_gen = TFRecordEpisodeInputGenerator(
      sequence_length=8, file_patterns=path, batch_size=2, shuffle=False,
      repeat=False)
  jax_gen.set_specification_from_model(jax_model, JaxMode.TRAIN)
  gen = EpisodeInputGenerator(episodes, sequence_length=8, batch_size=2,
                              shuffle=False, repeat=False)
  gen.set_specification_from_model(VRGripperTransformerModel(**_SMALL),
                                   Mode.TRAIN)
  want = list(jax_gen.create_dataset(JaxMode.TRAIN))
  got = list(gen.create_dataset(Mode.TRAIN))
  assert len(got) == len(want) == 2  # the fifth episode is the remainder
  lengths = []
  for (jf, jl), (f, lab) in zip(want, got):
    for w, g in ((jf, f), (jl, lab)):
      w, g = w.to_flat_dict(), g.to_flat_dict()
      assert sorted(g) == sorted(w)
      for key in w:
        assert g[key].dtype == w[key].dtype, key
        np.testing.assert_array_equal(g[key], w[key])
    lengths += list(f[SEQUENCE_LENGTH_KEY])
  assert min(lengths) < 8 and max(lengths) == 8


def test_episode_input_generator_shuffles_from_its_seed():
  episodes = _episodes(6, seed=4)
  model = VRGripperTransformerModel(**_SMALL)

  def first_poses(seed):
    gen = EpisodeInputGenerator(episodes, sequence_length=4, batch_size=3,
                                seed=seed)
    gen.set_specification_from_model(model, Mode.TRAIN)
    stream = gen.create_dataset(Mode.TRAIN)
    return np.concatenate([next(stream)[0]["gripper_pose"]
                           for _ in range(4)])  # two passes over 6

  a, b = first_poses(0), first_poses(0)
  np.testing.assert_array_equal(a, b)
  assert not np.array_equal(a, first_poses(1))
  assert not np.array_equal(a[:6], a[6:])  # a new permutation per pass


# ---- the training loop ----


def test_train_eval_model_on_the_cpu_writes_the_envelope(tmp_path):
  model = VRGripperTransformerModel(
      create_optimizer_fn=functools.partial(optimizers.create_optimizer,
                                            learning_rate=_LR), **_SMALL)
  gen = EpisodeInputGenerator(_episodes(6), sequence_length=8, batch_size=2,
                              seed=0)
  state = train_eval_model(model, str(tmp_path), gen, max_train_steps=3,
                           log_every_steps=2, seed=0, device="cpu")
  assert state.step == 3 and int(state.opt_state[0].count) == 3
  path = os.path.join(str(tmp_path), "metrics_train.jsonl")
  with open(path) as f:
    raw = [json.loads(line) for line in f]
  assert [r["step"] for r in raw] == [2, 3]
  for record in raw:  # the JAX package's own schema check
    assert jax_records.validate_record(record) == []
    assert record["role"] == "trainer"
    # The step's metrics and the loop's rates, as the JAX trainer
    # writes them, beside the perf plane's gauges.
    payload = set(record["payload"])
    assert {"loss", "grad_norm", "mse", "action_error", "steps_per_sec",
            "stall_fraction", "input_wait_fraction",
            "perf.device_time_fraction", "perf.flops_per_sec",
            "rsrc.host_rss_bytes", "rsrc.host_rss_bytes_peak"} <= payload
    assert all(key.startswith(("rsrc.", "perf.", "compile_cache."))
               for key in payload - {"loss", "grad_norm", "mse",
                                     "action_error", "steps_per_sec",
                                     "stall_fraction",
                                     "input_wait_fraction"})
  flat = read_records(path)
  assert flat == jax_records.read_records(path)
  assert all(np.isfinite(r["loss"]) for r in flat)


def test_train_eval_model_defaults_to_the_card(tmp_path):
  model = VRGripperTransformerModel(**_SMALL)
  gen = EpisodeInputGenerator(_episodes(2), sequence_length=4, batch_size=2)
  with pytest.raises(RuntimeError, match="cuda"):
    train_eval_model(model, str(tmp_path), gen, max_train_steps=1)
