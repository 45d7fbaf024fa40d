"""Port's QT-Opt Bellman training against the JAX package.

The same numpy inputs go through both packages: flax batch norm in
training, the critic loss, the JAX learner's Bellman step (at the size
of `bench.py`'s `_verify_qtopt_metrics`: 16×16 images, torso (8,), head
(8,), dense (16,), action 2, population 8, one CEM iteration, 2 elites,
batch 8) with JAX's own CEM noise injected into the port, the transition
spec, the replay buffer's draws, and `train_qtopt`'s random prefill. The
JAX state is converted (`models/convert.py`) so both start equal.

Tolerances (f32: the same math in other summation orders): batch-norm
outputs and statistics 1e-5; losses and metrics 1e-5 relative;
gradients 1e-4 of each leaf's largest |value|; parameters after Adam
2e-6 absolute, except elements whose gradient is below 1e-4 of its
leaf's largest |value|, held to 2·lr (Adam's first step normalizes each
element, so summation noise there can move it by up to 2·lr); the
Polyak target τ times that, plus 1e-7 for `old + τ·(new − old)` rounded
with or without an FMA. bf16: each gradient's direction (cosine ≥ 0.99)
and the metrics to 2e-2 relative, since the frameworks round to bf16 at
other places inside a conv.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu import specs as jax_specs  # noqa: E402
from tensor2robot_tpu.data.abstract_input_generator import (  # noqa: E402
    Mode as JaxMode,
)
from tensor2robot_tpu.models.critic_model import (  # noqa: E402
    CriticModel as JaxCriticModel,
)
from tensor2robot_tpu.research.qtopt import (  # noqa: E402
    GraspingQModel as JaxGraspingQModel,
)
from tensor2robot_tpu.research.qtopt import (  # noqa: E402
    QTOptLearner as JaxLearner,
)
from tensor2robot_tpu.research.qtopt import (  # noqa: E402
    ReplayBuffer as JaxReplayBuffer,
)
from tensor2robot_tpu_torch.data import Mode  # noqa: E402
from tensor2robot_tpu_torch.data import prefetch  # noqa: E402
from tensor2robot_tpu_torch.hooks import Hook, HookList  # noqa: E402
from tensor2robot_tpu_torch.layers.vision_layers import BatchNorm  # noqa: E402
from tensor2robot_tpu_torch.models import TrainState, convert  # noqa: E402
from tensor2robot_tpu_torch.models import optimizers  # noqa: E402
from tensor2robot_tpu_torch.models.critic_model import CriticModel  # noqa: E402
from tensor2robot_tpu_torch.replay import ReplayStore  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import (  # noqa: E402
    GraspingQModel,
    QTOptLearner,
)
from tensor2robot_tpu_torch.research.qtopt.qtopt_learner import (  # noqa: E402
    QTOptState,
)
from tensor2robot_tpu_torch.research.qtopt.replay_buffer import (  # noqa: E402
    ReplayBuffer,
)
from tensor2robot_tpu_torch.research.qtopt.train_qtopt import (  # noqa: E402
    train_qtopt,
)
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec  # noqa: E402
from tensor2robot_tpu_torch.specs import TensorSpecStruct  # noqa: E402
from tensor2robot_tpu_torch.specs import make_random_tensors  # noqa: E402
from tensor2robot_tpu_torch.telemetry.records import read_records  # noqa: E402
from tensor2robot_tpu_torch.utils import checkpoints  # noqa: E402

_VERIFY = dict(image_size=16, torso_filters=(8,), head_filters=(8,),
               dense_sizes=(16,), action_dim=2)
_CEM = dict(cem_population=8, cem_iterations=1, cem_elites=2)
_LR = 1e-4  # create_optimizer's default, the learner's optimizer


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


# ---- batch norm in training ----


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batch_norm_training_matches_flax(dtype):
  """Output and the new running statistics of flax `nn.BatchNorm(
  momentum=0.9)` with `use_running_average=False`, from a compute-dtype
  input (a conv's output). bf16: the output may round to the other bf16
  neighbour (2^-8 relative); the statistics are f32 on both sides."""
  jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
  rng = np.random.default_rng(0)
  x = np.asarray(jnp.asarray(rng.standard_normal((6, 5, 4, 7)) * 2 + 0.5,
                             jdt).astype(jnp.float32))
  scale = rng.uniform(0.5, 1.5, 7).astype(np.float32)
  bias = rng.uniform(-0.3, 0.3, 7).astype(np.float32)
  mean = rng.uniform(-0.3, 0.3, 7).astype(np.float32)
  var = rng.uniform(0.5, 2.0, 7).astype(np.float32)
  want, updates = fnn.BatchNorm(momentum=0.9, dtype=jdt).apply(
      {"params": {"scale": scale, "bias": bias},
       "batch_stats": {"mean": mean, "var": var}},
      jnp.asarray(x, jdt), use_running_average=False,
      mutable=["batch_stats"])
  bn = BatchNorm(7, tdt)
  with torch.no_grad():
    for t, v in ((bn.scale, scale), (bn.bias, bias), (bn.mean, mean),
                 (bn.var, var)):
      t.copy_(torch.from_numpy(v))
  bn.train()
  got = bn(torch.from_numpy(np.array(x)).to(tdt))
  assert got.dtype == tdt
  rtol = 1e-5 if dtype == "f32" else 2 ** -7
  np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=1e-6)
  for key in ("mean", "var"):
    np.testing.assert_allclose(_np(bn.update[key]),
                               _np(updates["batch_stats"][key]), rtol=1e-5,
                               atol=1e-7)
  # The module's own buffers are left as they were.
  np.testing.assert_array_equal(bn.mean.numpy(), mean)
  np.testing.assert_array_equal(bn.var.numpy(), var)


# ---- the critic's loss and default network ----


class _JaxCritic(JaxCriticModel):

  def get_feature_specification(self, mode):
    st = jax_specs.TensorSpecStruct()
    st.state = jax_specs.ExtendedTensorSpec(shape=(3,), dtype=np.float32,
                                            name="state")
    st.action = jax_specs.ExtendedTensorSpec(shape=(2,), dtype=np.float32,
                                             name="action")
    return st

  def get_label_specification(self, mode):
    st = jax_specs.TensorSpecStruct()
    st.target_q = jax_specs.ExtendedTensorSpec(shape=(1,), dtype=np.float32,
                                               name="target_q")
    return st


class _Critic(CriticModel):

  def get_feature_specification(self, mode):
    st = TensorSpecStruct()
    st.state = ExtendedTensorSpec(shape=(3,), dtype=np.float32, name="state")
    st.action = ExtendedTensorSpec(shape=(2,), dtype=np.float32,
                                   name="action")
    return st

  def get_label_specification(self, mode):
    st = TensorSpecStruct()
    st.target_q = ExtendedTensorSpec(shape=(1,), dtype=np.float32,
                                     name="target_q")
    return st


@pytest.mark.parametrize("sigmoid_q", [True, False])
def test_critic_loss_and_default_network_match_jax(sigmoid_q):
  """`model_train_fn` (sigmoid cross-entropy or MSE, with `q_loss`,
  `q_mean`, `target_q_mean`), then one gradient of the default MLP
  critic on converted weights."""
  rng = np.random.default_rng(1)
  raw = rng.standard_normal(9).astype(np.float32) * 3
  target = rng.uniform(0, 1, (9, 1)).astype(np.float32)
  jax_model = _JaxCritic(hidden_sizes=(8, 8), sigmoid_q=sigmoid_q)
  model = _Critic(hidden_sizes=(8, 8), sigmoid_q=sigmoid_q)
  want_loss, want = jax_model.model_train_fn(
      {}, {"target_q": jnp.asarray(target)}, {"q_value": jnp.asarray(raw)},
      JaxMode.TRAIN)
  loss, got = model.model_train_fn(
      {}, {"target_q": torch.from_numpy(target)},
      {"q_value": torch.from_numpy(raw)}, Mode.TRAIN)
  assert set(got) == set(want) == {"q_loss", "q_mean", "target_q_mean"}
  np.testing.assert_allclose(_np(loss), _np(want_loss), rtol=1e-6)
  for key in want:
    np.testing.assert_allclose(_np(got[key]), _np(want[key]), rtol=1e-6)

  jax_state = jax.jit(jax_model.create_train_state)(jax.random.PRNGKey(0))
  state = convert.convert_variables(
      {"params": jax.device_get(jax_state.params)})
  features = {"state": rng.standard_normal((9, 3)).astype(np.float32),
              "action": rng.uniform(-1, 1, (9, 2)).astype(np.float32)}
  labels = {"target_q": target}
  j_grads, _, j_metrics = jax.jit(jax_model.train_grads)(
      jax_state, jax_specs.TensorSpecStruct.from_flat_dict(
          {k: jnp.asarray(v) for k, v in features.items()}),
      jax_specs.TensorSpecStruct.from_flat_dict(
          {"target_q": jnp.asarray(target)}), jax.random.PRNGKey(2))
  grads, _, metrics = model.train_grads(
      state, {k: torch.from_numpy(v) for k, v in features.items()},
      {k: torch.from_numpy(v) for k, v in labels.items()})
  for key in ("loss", "grad_norm", "q_mean"):
    np.testing.assert_allclose(_np(metrics[key]), _np(j_metrics[key]),
                               rtol=1e-5)
  want_grads = convert.convert_params(jax.device_get(j_grads))
  assert set(grads) == set(want_grads)
  for key, g in grads.items():
    _close(g, want_grads[key], 1e-4)


# ---- the Bellman step ----


@functools.lru_cache(maxsize=None)
def _jax_learner(dtype, cem_select):
  """The JAX learner, its jitted halves and initial state, built once
  per configuration (each compiles once per module)."""
  model = JaxGraspingQModel(device_dtype=dtype, **_VERIFY)
  learner = JaxLearner(model, cem_select=cem_select, **_CEM)
  state = jax.jit(functools.partial(learner.create_state, batch_size=2))(
      jax.random.PRNGKey(0))
  return (learner, jax.jit(learner.train_grads),
          jax.jit(learner.apply_gradients), state)


def _port_state(jax_state) -> QTOptState:
  """The port's learner state holding a JAX state's params, batch
  statistics, Adam moments and target."""
  ts = jax_state.train_state
  stats = jax.device_get(ts.batch_stats)
  modules = {m for m, _ in convert._walk(stats)}
  tree = lambda t: convert.convert_params(  # noqa: E731
      jax.device_get(t), modules)
  adam = ts.opt_state[0]
  return QTOptState(
      train_state=TrainState(
          step=int(ts.step), params=tree(ts.params),
          batch_stats=convert.convert_batch_stats(stats),
          opt_state=(optimizers.ScaleByAdamState(
              torch.tensor(int(adam.count), dtype=torch.int32),
              tree(adam.mu), tree(adam.nu)), optimizers.EmptyState())),
      target_params=tree(jax_state.target_params))


def _transitions(learner, seed, batch=8):
  return jax_specs.make_random_tensors(
      learner.transition_specification(), batch_size=batch, seed=seed)


def _jax_noise(rng, batch, iterations=1, population=8, action_dim=2):
  """The CEM noise JAX's `train_grads` draws from `rng`: its CEM key is
  `split(rng)[0]`, one normal draw per iteration key."""
  keys = jax.random.split(jax.random.split(rng)[0], iterations)
  return torch.from_numpy(np.stack([
      np.asarray(jax.random.normal(k, (batch, population, action_dim)))
      for k in keys]))


def _step_both(dtype, cem_select, steps=2):
  """`steps` Bellman steps in both packages, each starting both from
  JAX's state; yields (port grads, port new state, port metrics, JAX
  grads, JAX new state converted, JAX metrics) per step."""
  jax_dtype, torch_dtype = dtype
  learner, grads_fn, apply_fn, jax_state = _jax_learner(jax_dtype,
                                                        cem_select)
  port = QTOptLearner(GraspingQModel(device_dtype=torch_dtype, **_VERIFY),
                      cem_select=cem_select, device="cpu", **_CEM)
  for i in range(steps):
    batch = _transitions(learner, seed=i)
    rng = jax.random.PRNGKey(1 + i)
    j_grads, j_stats, j_metrics = grads_fn(
        jax_state, jax.tree_util.tree_map(jnp.asarray, batch), rng)
    state = _port_state(jax_state)
    grads, stats, metrics = port.train_grads(
        state, {k: torch.from_numpy(np.array(v))
                for k, v in batch.to_flat_dict().items()},
        noise=_jax_noise(rng, 8))
    new = port.apply_gradients(state, grads, stats)
    jax_state = apply_fn(jax_state, j_grads, j_stats)
    yield (grads, new, metrics,
           convert.convert_params(jax.device_get(j_grads),
                                  {m for m, _ in convert._walk(
                                      jax.device_get(j_stats))}),
           _port_state(jax_state), j_metrics)


_METRICS = {"loss", "grad_norm", "q_loss", "q_mean", "target_q_mean",
            "q_next_mean", "target_mean"}


@pytest.mark.parametrize("cem_select", ["lax", "fused"])
def test_bellman_step_matches_jax_f32(cem_select):
  """Two steps (the second from JAX's state after the first: moved
  batch statistics, a Polyak'd target, Adam's count at 1)."""
  for grads, new, metrics, want_grads, want, j_metrics in _step_both(
      (jnp.float32, torch.float32), cem_select):
    assert set(metrics) == set(j_metrics) == _METRICS
    for key in _METRICS:
      np.testing.assert_allclose(_np(metrics[key]), _np(j_metrics[key]),
                                 rtol=1e-5, err_msg=key)
    assert set(grads) == set(want_grads)
    for key, g in grads.items():
      _close(g, want_grads[key], 1e-4)
    ts, want_ts = new.train_state, want.train_state
    assert ts.step == want_ts.step
    assert set(ts.batch_stats) == set(want_ts.batch_stats)
    for key, s in ts.batch_stats.items():
      np.testing.assert_allclose(_np(s), _np(want_ts.batch_stats[key]),
                                 rtol=1e-5, atol=1e-6, err_msg=key)
    for key, p in ts.params.items():
      g = np.abs(_np(grads[key]))
      tiny = g < 1e-4 * g.max()
      for got, exp, scale in ((p, want_ts.params[key], 1.0),
                              (new.target_params[key],
                               want.target_params[key], 0.05)):
        diff = np.abs(_np(got) - _np(exp))
        assert diff[~tiny].max(initial=0) <= scale * 2e-6 + 1e-7, key
        assert diff[tiny].max(initial=0) <= scale * 2 * _LR + 1e-7, key


def test_bellman_step_matches_jax_bf16():
  for grads, _, metrics, want_grads, _, j_metrics in _step_both(
      (jnp.bfloat16, torch.bfloat16), "lax", steps=1):
    for key in ("loss", "q_next_mean", "target_mean"):
      np.testing.assert_allclose(_np(metrics[key]), _np(j_metrics[key]),
                                 rtol=2e-2, err_msg=key)
    for key, g in grads.items():
      w = torch.from_numpy(_np(want_grads[key])).flatten()
      cosine = torch.nn.functional.cosine_similarity(g.flatten(), w, dim=0)
      assert cosine >= 0.99, (key, float(cosine))


def test_a_step_leaves_the_old_state_as_it_was():
  """Batch statistics, params, Adam's moments and the target are new
  tensors; the old state's are never written."""
  learner = QTOptLearner(GraspingQModel(device_dtype=torch.float32,
                                        **_VERIFY), device="cpu", **_CEM)
  state = learner.create_state(seed=0)
  leaves = checkpoints.flatten_state(state)
  before = {k: v.clone() for k, v in leaves.items()
            if isinstance(v, torch.Tensor)}
  batch = make_random_tensors(learner.transition_specification(),
                              batch_size=8, seed=0).to_flat_dict()
  new, _ = learner.train_step(
      state, {k: torch.from_numpy(v) for k, v in batch.items()},
      generator=torch.Generator().manual_seed(0))
  for key, value in before.items():
    torch.testing.assert_close(leaves[key], value, rtol=0, atol=0)
  assert new.step == 1
  moved = [k for k in new.train_state.batch_stats
           if not torch.equal(new.train_state.batch_stats[k],
                              state.train_state.batch_stats[k])]
  assert len(moved) == len(state.train_state.batch_stats)
  assert not any(t.requires_grad for t in new.train_state.batch_stats.values())


def test_transition_specification_matches_jax():
  kwargs = dict(_VERIFY, extra_state_features={"height": (1,)})
  want = JaxLearner(JaxGraspingQModel(**kwargs)).transition_specification()
  got = QTOptLearner(GraspingQModel(**kwargs),
                     device="cpu").transition_specification()
  want, got = want.to_flat_dict(), got.to_flat_dict()
  assert list(got) == list(want)
  for key in want:
    assert tuple(got[key].shape) == tuple(want[key].shape), key
    assert np.dtype(got[key].dtype) == np.dtype(want[key].dtype), key
    assert got[key].name == want[key].name, key


def test_unported_learner_options_raise_naming_the_roadmap_item():
  model = GraspingQModel(**_VERIFY)
  learner = QTOptLearner(model, device="cpu", **_CEM)
  with pytest.raises(NotImplementedError, match="A11"):
    learner.train_grads(learner.create_state(), {}, axis_name="data")


# ---- replay ----


def _specs():
  learner = _jax_learner(jnp.float32, "lax")[0]
  port = QTOptLearner(GraspingQModel(device_dtype=torch.float32, **_VERIFY),
                      device="cpu", **_CEM)
  return learner.transition_specification(), port.transition_specification()


def test_replay_buffer_samples_the_rows_jax_samples():
  """Same seed and adds (wrapping the ring twice), then the same draws:
  `sample`, the stream, and the buffer's counters."""
  jax_spec, spec = _specs()
  jax_buf = JaxReplayBuffer(jax_spec, capacity=10, seed=3)
  buf = ReplayBuffer(spec, capacity=10, seed=3)
  for i, n in enumerate((4, 5, 6, 12)):
    batch = jax_specs.make_random_tensors(jax_spec, batch_size=n, seed=i)
    jax_buf.add(batch)
    buf.add(batch.to_flat_dict())
    assert len(buf) == len(jax_buf)
  draws = [(jax_buf.sample(7), buf.sample(7)) for _ in range(3)]
  jax_stream, stream = jax_buf.as_stream(5), buf.as_stream(5)
  draws += [(next(jax_stream), next(stream)) for _ in range(3)]
  for want, got in draws:
    want, got = want.to_flat_dict(), got.to_flat_dict()
    assert list(got) == list(want)
    for key in want:
      np.testing.assert_array_equal(np.asarray(got[key]),
                                    np.asarray(want[key]), err_msg=key)
  jax_stats = jax_buf.store.metrics_snapshot()
  for key, value in buf.store.metrics_snapshot().items():
    assert value == jax_stats[key], key
  assert set(buf.metrics_scalars()) == set(jax_buf.metrics_scalars())


def test_replay_staleness_and_errors():
  _, spec = _specs()
  buf = ReplayBuffer(spec, capacity=16, seed=0)
  with pytest.raises(ValueError, match="empty replay buffer"):
    buf.sample(2)
  buf.set_learner_step(3)
  buf.add(make_random_tensors(spec, batch_size=8, seed=0))
  buf.set_learner_step(10)
  stream = buf.as_stream(4)
  next(stream)
  snap = buf.staleness_snapshot()
  assert snap["rows"] == 4 and snap["mean_age_steps"] == 7.0
  assert buf.metrics_scalars()["replay_staleness_max_steps"] == 7.0
  assert buf.wait_until_size(8, timeout_secs=0.0)
  assert not buf.wait_until_size(9, timeout_secs=0.0)


@pytest.mark.parametrize("kwargs", [dict(num_shards=2),
                                    dict(sampling="prioritized"),
                                    dict(sampling="fifo"),
                                    dict(spill_dir="spill")])
def test_unported_replay_options_raise_naming_the_roadmap_item(kwargs,
                                                               tmp_path):
  """The store options that raised until ROADMAP A4b was ported (more
  than one shard, prioritized and FIFO draws, the spill) now build a
  store that samples what the JAX store samples, rows, ages and ids bit
  for bit (tests/test_torch_replay.py covers them in full). The name
  is the one the test had when those options raised, kept so that its
  record runs on unbroken."""
  jax_spec, spec = _specs()
  if "spill_dir" in kwargs:
    kwargs = dict(spill_dir=str(tmp_path / "port"))
    jax_kwargs = dict(spill_dir=str(tmp_path / "jax"))
  else:
    jax_kwargs = kwargs
  store = ReplayStore(spec, capacity=8, seed=1, **kwargs)
  jax_store = JaxReplayBuffer(jax_spec, capacity=8, seed=1,
                              **jax_kwargs).store
  for i, n in enumerate((3, 6, 4)):
    batch = jax_specs.make_random_tensors(jax_spec, batch_size=n, seed=i)
    jax_store.add(batch, priority=float(i))
    store.add(batch.to_flat_dict(), priority=float(i))
  for _ in range(2):
    want, want_ages, want_ids = jax_store.sample_with_ages(5)
    got, ages, ids = store.sample_with_ages(5)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(ages, want_ages)
    for key, value in want.to_flat_dict().items():
      np.testing.assert_array_equal(got.to_flat_dict()[key],
                                    np.asarray(value), err_msg=key)
  assert store.metrics_snapshot() == jax_store.metrics_snapshot()


# ---- the training loop ----


def _learner(**kwargs):
  model = GraspingQModel(device_dtype=torch.float32, **_VERIFY)
  return QTOptLearner(model, device="cpu", **dict(_CEM, **kwargs))


class _Recorder(Hook):

  def __init__(self):
    self.calls = []

  def begin(self, model, model_dir):
    self.calls.append(("begin", None))

  def after_step(self, step, metrics):
    self.calls.append(("after_step", step))

  def after_checkpoint(self, step, state, model_dir):
    self.calls.append(("after_checkpoint", step))

  def end(self, step, state, model_dir):
    self.calls.append(("end", step))


def test_prefill_is_jax_random_fill_and_the_loop_runs(tmp_path):
  """`prefill_random` adds JAX's spec-random fill bit for bit; the loop
  logs the envelope with the replay metrics, saves checkpoints at the
  cadence and at the end, and calls the hooks in order."""
  learner = _learner()
  jax_spec, _ = _specs()
  buf = ReplayBuffer(learner.transition_specification(), capacity=64, seed=0)
  hook = _Recorder()
  model_dir = str(tmp_path / "run")
  state = train_qtopt(learner, model_dir, replay_buffer=buf,
                      max_train_steps=5, batch_size=8,
                      save_checkpoints_steps=2, log_every_steps=2,
                      prefill_random=True, seed=4, hooks=[hook])
  assert state.step == 5
  want = jax_specs.make_random_tensors(jax_spec, batch_size=32, seed=4)
  assert len(buf) == 32
  storage = buf.store._shards[0].storage  # one shard: the whole ring
  for key, value in want.to_flat_dict().items():
    np.testing.assert_array_equal(storage[key][:32], np.asarray(value),
                                  err_msg=key)
  records = read_records(os.path.join(model_dir, "metrics_train.jsonl"))
  assert [r["step"] for r in records] == [2, 4, 5]
  for r in records:
    assert _METRICS <= set(r)
    assert 0.0 <= r["input_wait_fraction"] <= 1.0
    assert r["grad_steps_per_sec"] > 0
    assert r["replay_size"] == 32.0 and "replay_staleness_mean_steps" in r
  assert checkpoints.list_steps(model_dir) == [2, 4, 5]
  assert hook.calls == ([("begin", None)]
                        + [("after_step", 1), ("after_step", 2),
                           ("after_checkpoint", 2), ("after_step", 3),
                           ("after_step", 4), ("after_checkpoint", 4),
                           ("after_step", 5), ("after_checkpoint", 5),
                           ("end", 5)])


def test_checkpoint_and_resume(tmp_path):
  learner = _learner()
  model_dir = str(tmp_path / "run")
  first = train_qtopt(learner, model_dir, max_train_steps=4, batch_size=8,
                      save_checkpoints_steps=4, log_every_steps=2,
                      prefill_random=True)
  assert checkpoints.latest_step(model_dir) == 4
  restored = checkpoints.restore_state(model_dir, like=learner.create_state())
  assert restored.step == 4
  for key, p in first.train_state.params.items():
    torch.testing.assert_close(restored.train_state.params[key], p, rtol=0,
                               atol=0)
  for key, p in first.target_params.items():
    torch.testing.assert_close(restored.target_params[key], p, rtol=0, atol=0)
  adam = restored.train_state.opt_state[0]
  assert int(adam.count) == 4
  again = train_qtopt(learner, model_dir, max_train_steps=6, batch_size=8,
                      save_checkpoints_steps=2, log_every_steps=2,
                      prefill_random=True)
  assert again.step == 6
  assert checkpoints.list_steps(model_dir) == [4, 6]
  leaves = torch.load(os.path.join(model_dir, "ckpt", "6", "state.pt"),
                      weights_only=True)["leaves"]
  assert {f"train_state/params/{k}" for k in again.train_state.params} | {
      f"target_params/{k}" for k in again.target_params} <= set(leaves)


def test_steps_per_dispatch_matches_per_step_training(tmp_path):
  """K stacked batches per dispatch train exactly as K=1: the same
  replay stream and the same per-step noise generator."""

  def run(k):
    learner = _learner()
    buf = ReplayBuffer(learner.transition_specification(), capacity=64,
                       seed=7)
    buf.add(make_random_tensors(learner.transition_specification(),
                                batch_size=64, seed=3))
    return train_qtopt(learner, str(tmp_path / f"k{k}"), replay_buffer=buf,
                       max_train_steps=6, batch_size=8,
                       save_checkpoints_steps=6, log_every_steps=3,
                       steps_per_dispatch=k)

  base, stacked = run(1), run(3)
  assert stacked.step == base.step == 6
  for key, p in base.train_state.params.items():
    torch.testing.assert_close(stacked.train_state.params[key], p, rtol=0,
                               atol=0)


def test_misaligned_cadence_raises_before_any_side_effect(tmp_path):
  model_dir = str(tmp_path / "run")
  with pytest.raises(ValueError, match="multiple of steps_per_dispatch=4"):
    train_qtopt(_learner(), model_dir, max_train_steps=8, batch_size=8,
                save_checkpoints_steps=8, log_every_steps=6,
                steps_per_dispatch=4, prefill_random=True)
  assert not os.path.exists(model_dir)


@pytest.mark.parametrize("kwargs", [dict(mesh=object()),
                                    dict(shard_weight_update=True,
                                         mesh=object())])
def test_unported_loop_options_raise_naming_the_roadmap_item(tmp_path,
                                                             kwargs):
  """A mesh raises, with or without the sharded update (on one process
  without a mesh the sharded update runs: the test below)."""
  with pytest.raises(NotImplementedError, match="A11"):
    train_qtopt(_learner(), str(tmp_path / "run"), **kwargs)


def test_shard_weight_update_on_one_process_is_the_plain_update(tmp_path):
  """`shard_weight_update=True` on one process, no mesh: the plain
  update, as on the JAX package's one-device mesh. Three steps give
  params bit for bit those of `shard_weight_update=False`."""
  finals = {}
  for flag in (False, True):
    state = train_qtopt(_learner(), str(tmp_path / f"swu_{flag}"),
                        max_train_steps=3, batch_size=8,
                        save_checkpoints_steps=3, log_every_steps=3,
                        prefill_random=True, shard_weight_update=flag)
    finals[flag] = state.train_state.params
  assert finals[True].keys() == finals[False].keys()
  for key, value in finals[False].items():
    assert torch.equal(finals[True][key], value), key


def test_shard_weight_update_over_more_than_one_process_raises(
    tmp_path, monkeypatch):
  monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
  monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
  with pytest.raises(NotImplementedError, match="A13.*A11"):
    train_qtopt(_learner(), str(tmp_path / "run"), shard_weight_update=True)
  assert not os.path.exists(tmp_path / "run")


def test_synthetic_bandit_learns():
  """Reward 1 iff the action is near a fixed target (one-step episodes,
  γ = 0): after 60 steps Q ranks the target above a far action
  (`tests/test_qtopt.py`'s bandit)."""
  model = GraspingQModel(
      device_dtype=torch.float32, use_batch_norm=False, **_VERIFY)
  learner = QTOptLearner(model, gamma=0.0, cem_population=16,
                         cem_iterations=2, cem_elites=4, device="cpu")
  state = learner.create_state(seed=0)
  rng = np.random.default_rng(0)
  target_action = np.array([0.4, -0.2], np.float32)
  spec = learner.transition_specification()
  for i in range(60):
    flat = make_random_tensors(spec, batch_size=64,
                               seed=int(rng.integers(1 << 30))).to_flat_dict()
    actions = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    flat["action"] = actions
    flat["reward"] = (np.linalg.norm(actions - target_action, axis=-1)
                      < 0.4).astype(np.float32)[:, None]
    flat["done"] = np.ones((64, 1), np.float32)
    state, _ = learner.train_step(
        state, {k: torch.from_numpy(v) for k, v in flat.items()},
        generator=torch.Generator().manual_seed(i))
  feats = make_random_tensors(model.get_feature_specification(Mode.PREDICT),
                              batch_size=16, seed=7).to_flat_dict()
  q = {}
  for name, a in (("good", target_action), ("bad", [-0.8, 0.8])):
    f = dict(feats, action=np.tile(np.asarray(a, np.float32), (16, 1)))
    q[name] = model.predict_step(
        state.train_state,
        {k: torch.from_numpy(v) for k, v in f.items()})["q_value"]
  assert float(q["good"].mean()) > float(q["bad"].mean())


# ---- loop helpers ----


def test_prefetch_helpers_match_jax():
  from tensor2robot_tpu.data import prefetch as jax_prefetch
  for kwargs in (dict(), dict(online=True), dict(buffer_size=3)):
    assert (prefetch.prefetch_buffer_size(**kwargs)
            == jax_prefetch.prefetch_buffer_size(**kwargs))
  with pytest.raises(ValueError):
    prefetch.prefetch_buffer_size(buffer_size=0)
  assert prefetch.validate_steps_per_dispatch(2, a=4, b=None) == 2
  with pytest.raises(ValueError, match="a=3 must be a multiple"):
    prefetch.validate_steps_per_dispatch(2, a=3)
  batches = [{"x": np.full((2,), i)} for i in range(5)]
  stacked = list(prefetch.stack_batches(iter(batches), 2))
  assert len(stacked) == 2  # the partial tail is dropped
  np.testing.assert_array_equal(stacked[1].to_flat_dict()["x"],
                                [[2, 2], [3, 3]])


def test_device_prefetcher_on_the_cpu_and_the_timer():
  batches = ({"x": np.full((3,), i, np.float32)} for i in range(4))
  fetcher = prefetch.DevicePrefetcher(batches, torch.device("cpu"),
                                      buffer_size=2)
  timed = prefetch.TimedIterator(fetcher)
  got = [b["x"] for b in timed]
  assert [float(x[0]) for x in got] == [0.0, 1.0, 2.0, 3.0]
  assert all(isinstance(x, torch.Tensor) for x in got)
  assert 0.0 <= timed.wait_fraction(1.0) <= 1.0 and timed.wait_secs == 0.0
  fetcher.close()

  def failing():
    yield {"x": np.zeros(1)}
    raise RuntimeError("source failed")

  fetcher = prefetch.DevicePrefetcher(failing(), torch.device("cpu"))
  next(fetcher)
  with pytest.raises(RuntimeError, match="source failed"):
    next(fetcher)
  fetcher.close()


def test_hook_list_fans_out_and_reports_online_collection():
  a, b = _Recorder(), _Recorder()
  b.drives_online_collection = True
  assert not HookList([a]).drives_online_collection
  hooks = HookList([a, b])
  assert hooks.drives_online_collection
  hooks.begin(None, "d")
  hooks.after_step(1, {})
  hooks.end(1, None, "d")
  assert a.calls == b.calls == [("begin", None), ("after_step", 1),
                                ("end", 1)]


def test_checkpoint_writer_keeps_the_newest(tmp_path):
  model_dir = str(tmp_path)
  writer = checkpoints.CheckpointWriter(model_dir, max_to_keep=2)
  state = {"w": torch.arange(3.0), "nested": (torch.ones(2), {"k": 5})}
  for step in (1, 2, 3):
    writer.save(step, state)
  assert checkpoints.list_steps(model_dir) == [2, 3]
  like = dataclasses.replace(_learner().create_state())
  with pytest.raises(FileNotFoundError):
    checkpoints.restore_state(str(tmp_path / "empty"), like=like)
  got = checkpoints.restore_state(model_dir, like=state, step=3)
  torch.testing.assert_close(got["w"], state["w"])
  assert got["nested"][1] == {"k": 5}
