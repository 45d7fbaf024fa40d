"""The port's compiled dispatch on the CPU: the multi-tensor optimizer
against optax and against the per-tensor arithmetic it replaced,
`utils.step_graph.StepGraph`'s buffer threading and launch accounting,
K-step Bellman dispatch (noise, resume), the serving engine's warmup,
capture and slot rules, the context policy over the graph's buffers,
and the flash wrapper's head-dim padding and batch chunking.

On the CPU a `StepGraph` runs its step eagerly over the same static
buffers that a CUDA capture reads, so these tests exercise the state
threading that the card replays; the captures themselves run in
`chip_smoke.py`.
"""

import importlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tensor2robot_tpu_torch.data.random_input_generator import (  # noqa: E402
    RandomInputGenerator,
)
from tensor2robot_tpu_torch.data.abstract_input_generator import (  # noqa: E402
    Mode,
)
from tensor2robot_tpu_torch.models import TrainState  # noqa: E402
from tensor2robot_tpu_torch.models import optimizers  # noqa: E402
from tensor2robot_tpu_torch.ops import counters  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import (  # noqa: E402
    GraspingQModel,
    QTOptLearner,
)
from tensor2robot_tpu_torch.research.qtopt.train_qtopt import (  # noqa: E402
    train_qtopt,
)
from tensor2robot_tpu_torch.serving.engine import (  # noqa: E402
    BucketedServingEngine,
)
from tensor2robot_tpu_torch.specs import make_random_tensors  # noqa: E402
from tensor2robot_tpu_torch.train_eval import train_step_fn  # noqa: E402
from tensor2robot_tpu_torch.utils import step_graph  # noqa: E402
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel  # noqa: E402

# The module, not the package's `flash_attention` wrapper of that name.
fa = importlib.import_module("tensor2robot_tpu_torch.ops.flash_attention")

_VERIFY = dict(image_size=16, torso_filters=(8,), head_filters=(8,),
               dense_sizes=(16,), action_dim=2)
_CEM = dict(cem_population=8, cem_iterations=1, cem_elites=2)


def _tree(seed, shapes=((3, 4), (5,), (2, 3, 2))):
  rng = np.random.default_rng(seed)
  return {f"p{i}": rng.standard_normal(s).astype(np.float32)
          for i, s in enumerate(shapes)}


def _torch(tree):
  return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


# ---- the per-tensor arithmetic the multi-tensor optimizer replaced ----


def _plain_global_norm(tree):
  return torch.sqrt(sum(torch.sum(g * g) for g in tree.values()))


def _plain_adam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
  def update(g, state):
    count, mu, nu = state
    mu = {k: (1 - b1) * x + b1 * mu[k] for k, x in g.items()}
    nu = {k: (1 - b2) * (x * x) + b2 * nu[k] for k, x in g.items()}
    count = count + 1
    c1 = 1 - torch.pow(b1, count).float()
    c2 = 1 - torch.pow(b2, count).float()
    out = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2 + eps_root) + eps)
           for k in g}
    return out, (count, mu, nu)
  return update


def _plain_clip_by_norm(g, norm, max_norm):
  trigger = norm < max_norm
  return {k: torch.where(trigger, x, (x / norm.to(x.dtype)) * max_norm)
          for k, x in g.items()}


@pytest.mark.parametrize("eps_root", [0.0, 1e-8])
def test_multi_tensor_adam_is_the_per_tensor_arithmetic_bit_for_bit(
    eps_root):
  tx = optimizers.scale_by_adam(eps_root=eps_root)
  plain = _plain_adam(eps_root=eps_root)
  params = _torch(_tree(0))
  state = tx.init(params)
  pstate = (torch.zeros((), dtype=torch.int32),
            {k: torch.zeros_like(v) for k, v in params.items()},
            {k: torch.zeros_like(v) for k, v in params.items()})
  for step in range(4):
    grads = _torch(_tree(10 + step))
    out, state = tx.update(grads, state, params)
    want, pstate = plain(grads, pstate)
    for k in params:
      assert torch.equal(out[k], want[k]), k
      assert torch.equal(state.mu[k], pstate[1][k])
      assert torch.equal(state.nu[k], pstate[2][k])
    assert state.count.dtype == torch.int32 and int(state.count) == step + 1
    new = optimizers.apply_updates(params, out)
    for k in params:
      assert torch.equal(new[k], params[k] + out[k])
    params = new


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_multi_tensor_global_norm_and_clip(max_norm):
  """The norm and the clip are the per-tensor arithmetic bit for bit,
  on both sides of the limit."""
  grads = _torch(_tree(3))
  norm = optimizers.global_norm(grads)
  assert torch.equal(norm, _plain_global_norm(grads))
  out, _ = optimizers.clip_by_global_norm(max_norm).update(grads, ())
  want = _plain_clip_by_norm(grads, _plain_global_norm(grads), max_norm)
  for k in grads:
    assert torch.equal(out[k], want[k]), k
  if max_norm > norm:
    assert all(torch.equal(out[k], grads[k]) for k in grads)


@pytest.mark.parametrize("name", ["trace", "decay", "clip", "scale"])
def test_multi_tensor_elementwise_transforms_bit_for_bit(name):
  g, p = _torch(_tree(4)), _torch(_tree(5))
  if name == "trace":
    tx, want = optimizers.trace(0.9), {k: g[k] + 0.9 * 0 for k in g}
    out, state = tx.update(g, tx.init(p))
    out, _ = tx.update(g, state)
    want = {k: g[k] + 0.9 * g[k] for k in g}
  elif name == "decay":
    out, _ = optimizers.add_decayed_weights(0.01).update(g, (), p)
    want = {k: g[k] + 0.01 * p[k] for k in g}
  elif name == "clip":
    out, _ = optimizers.clip(0.3).update(g, ())
    want = {k: g[k].clamp(-0.3, 0.3) for k in g}
  else:
    out, _ = optimizers.scale(-0.05).update(g, ())
    want = {k: -0.05 * g[k] for k in g}
  for k in g:
    assert torch.equal(out[k], want[k]), k


@pytest.mark.parametrize("kwargs", [
    dict(optimizer_name="adam", gradient_clip_norm=0.5),
    dict(optimizer_name="adamw", weight_decay=0.1, gradient_clip_value=0.2),
])
def test_multi_tensor_optimizer_matches_optax(kwargs):
  rng = np.random.default_rng(6)
  params = _tree(7)
  jax_tx = optax.chain(
      *([optax.clip_by_global_norm(kwargs["gradient_clip_norm"])]
        if "gradient_clip_norm" in kwargs else [])
      + ([optax.clip(kwargs["gradient_clip_value"])]
         if "gradient_clip_value" in kwargs else [])
      + ([optax.adamw(0.05, weight_decay=kwargs["weight_decay"])]
         if kwargs["optimizer_name"] == "adamw" else [optax.adam(0.05)]))
  tx = optimizers.create_optimizer(learning_rate=0.05, **kwargs)
  j_params = {k: jnp.asarray(v) for k, v in params.items()}
  t_params = _torch(params)
  j_state, t_state = jax_tx.init(j_params), tx.init(t_params)
  for _ in range(3):
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    j_up, j_state = jax_tx.update({k: jnp.asarray(v) for k, v in
                                   grads.items()}, j_state, j_params)
    t_up, t_state = tx.update(_torch(grads), t_state, t_params)
    j_params = optax.apply_updates(j_params, j_up)
    t_params = optimizers.apply_updates(t_params, t_up)
    for k in params:
      np.testing.assert_allclose(t_up[k].numpy(), np.asarray(j_up[k]),
                                 rtol=1e-5, atol=1e-7)
  for k in params:
    np.testing.assert_allclose(t_params[k].numpy(), np.asarray(j_params[k]),
                               rtol=1e-5, atol=1e-7)
  assert jax.tree_util.tree_leaves(j_state)  # optax kept state too


def test_empty_trees():
  assert optimizers.apply_updates({}, {}) == {}
  assert optimizers.global_norm({}).item() == 0.0
  tx = optimizers.create_optimizer(gradient_clip_norm=1.0)
  assert tx.update({}, tx.init({}), {})[0] == {}


# ---- StepGraph on the CPU ----


def _mock_batches(n, k=1, seed=5):
  model = MockT2RModel()
  gen = RandomInputGenerator(batch_size=8, seed=seed)
  gen.set_specification_from_model(model, Mode.TRAIN)
  stream = gen.create_dataset(Mode.TRAIN)
  out = []
  for _ in range(n):
    f, l = next(stream)
    out.append({"features": {k_: torch.from_numpy(v) for k_, v in
                             f.to_flat_dict().items()},
                "labels": {k_: torch.from_numpy(v) for k_, v in
                           l.to_flat_dict().items()}})
  if k == 1:
    return model, out
  return model, [
      {side: {key: torch.stack([b[side][key] for b in out[i:i + k]])
              for key in out[0][side]} for side in ("features", "labels")}
      for i in range(0, n, k)]


def test_three_replays_equal_three_eager_train_steps():
  model, batches = _mock_batches(3)
  state = model.create_train_state(seed=0, device="cpu")
  graph = step_graph.StepGraph(train_step_fn(model), state, batches[0],
                               "cpu")
  static = {t.data_ptr() for t in step_graph.tensors(graph.carry)}
  static |= {t.data_ptr() for t in step_graph.tensors(graph.inputs)}
  eager = state
  for batch in batches:
    metrics = graph.replay(batch)
    eager, want = model.train_step(eager, batch["features"],
                                   batch["labels"])
    for key in want:
      assert torch.equal(metrics[key], want[key]), key
      assert metrics[key].data_ptr() not in static
  assert graph.replays == 3 and not graph.captured
  carried = graph.carry_copy()
  assert not {t.data_ptr() for t in step_graph.tensors(carried)} & static
  for a, b in zip(step_graph.tensors(carried), step_graph.tensors(eager)):
    assert torch.equal(a, b)
  assert int(carried.opt_state[0].count) == 3  # Adam's count rode along
  # The caller's state was copied in, never written.
  assert int(state.opt_state[0].count) == 0


def test_k_step_graph_equals_k_eager_steps():
  model, batches = _mock_batches(6)
  _, stacked = _mock_batches(6, k=3)
  state = model.create_train_state(seed=0, device="cpu")
  graph = step_graph.StepGraph(train_step_fn(model, 3), state, stacked[0],
                               "cpu")
  for batch in stacked:
    graph.replay(batch)
  eager = state
  for batch in batches:
    eager, _ = model.train_step(eager, batch["features"], batch["labels"])
  for a, b in zip(step_graph.tensors(graph.carry_copy()),
                  step_graph.tensors(eager)):
    assert torch.equal(a, b)


def test_replay_refuses_inputs_of_another_shape():
  model, batches = _mock_batches(1)
  state = model.create_train_state(seed=0, device="cpu")
  graph = step_graph.StepGraph(train_step_fn(model), state, batches[0],
                               "cpu")
  short = {side: {k: v[:4] for k, v in batches[0][side].items()}
           for side in batches[0]}
  with pytest.raises(ValueError, match="buffer"):
    graph.replay(short)
  assert step_graph.input_signature(short) != step_graph.input_signature(
      batches[0])


def test_graph_cache_carries_the_state_across_shapes():
  """Batches of two shapes, alternating: one graph per shape, and the
  carry moves with each dispatch, equal to the eager steps."""
  model, batches = _mock_batches(4)
  for i in (1, 3):
    batches[i] = {side: {k: v[:4] for k, v in batches[i][side].items()}
                  for side in batches[i]}
  state = model.create_train_state(seed=0, device="cpu")
  cache = step_graph.GraphCache(train_step_fn(model), state, "cpu")
  eager = state
  for batch in batches:
    metrics = cache.replay(batch)
    eager, want = model.train_step(eager, batch["features"],
                                   batch["labels"])
    assert all(torch.equal(metrics[k], want[k]) for k in want)
  assert len(cache._graphs) == 2
  assert sorted(g.replays for g in cache._graphs.values()) == [2, 2]
  for a, b in zip(step_graph.tensors(cache.carry_copy()),
                  step_graph.tensors(eager)):
    assert torch.equal(a, b)


def test_graph_cache_reads_the_loaded_carry():
  """A cache of a step that only reads its carry: each graph reads the
  carry last loaded, whichever graph ran before."""
  model, batches = _mock_batches(2)
  short = {side: {k: v[:4] for k, v in batches[1][side].items()}
           for side in batches[1]}
  key = "backbone.dense_0.bias"
  cache = step_graph.GraphCache(
      lambda st, inp, gens: (st, st.params[key] * 2), None, "cpu",
      carries=False)
  for seed in (0, 1, 2):
    state = model.create_train_state(seed=seed, device="cpu")
    cache.load(state)
    for batch in (batches[0], short):
      assert torch.equal(cache.replay(batch), state.params[key] * 2)


def test_set_carry_and_shared_carry():
  model, batches = _mock_batches(1)
  a = model.create_train_state(seed=0, device="cpu")
  b = model.create_train_state(seed=1, device="cpu")
  graph = step_graph.StepGraph(train_step_fn(model), a, batches[0], "cpu")
  graph.set_carry(b)
  for x, y in zip(step_graph.tensors(graph.carry), step_graph.tensors(b)):
    assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
  shared = step_graph.StepGraph(
      lambda st, inp, gens: (st, st.params["backbone.dense_0.bias"] * 2),
      b, batches[0], "cpu", carries=False, own_carry=False)
  assert shared.carry is b
  assert torch.equal(shared.replay(), b.params["backbone.dense_0.bias"] * 2)


class _Stream:
  """Stands in for a CUDA stream: `stream_key` reads `cuda_stream`."""

  def __init__(self, key):
    self.cuda_stream = key


def test_launch_counters_record_a_capture_and_add_per_replay(monkeypatch):
  current = {"stream": _Stream(1)}
  monkeypatch.setattr(counters.torch.cuda, "current_stream",
                      lambda: current["stream"])

  def wrapper():
    counters.count(wrapper)
  wrapper.launches = 0
  wrapper()
  capture = _Stream(2)
  with counters.recording(capture) as rec:
    wrapper()  # on another stream: it runs, and counts
    current["stream"] = capture
    wrapper()
    # Queued on the capturing stream from another thread (as autograd's
    # backward is): recorded too.
    t = threading.Thread(target=wrapper)
    t.start()
    t.join()
  current["stream"] = _Stream(1)
  assert wrapper.launches == 2 and rec == {wrapper: 2}
  wrapper()
  assert wrapper.launches == 3
  for _ in range(3):
    counters.add(rec)
  assert wrapper.launches == 9
  counters.clear_warmups()
  counters.add({wrapper: 1}, warmup=True)
  assert wrapper.launches == 10 and counters.warmups() == {wrapper: 1}
  counters.clear_warmups()


def test_the_collector_is_held_off_until_the_last_capture_ends():
  """A capture holds the cyclic collector off (a dead graph's destructor
  run by a collection inside a capture invalidates it); concurrent
  captures keep it off until the last ends."""
  import gc
  assert gc.isenabled()
  first = step_graph.collector_held()
  second = step_graph.collector_held()
  first.__enter__()
  assert not gc.isenabled()
  second.__enter__()
  first.__exit__(None, None, None)
  assert not gc.isenabled()  # a concurrent capture still runs
  second.__exit__(None, None, None)
  assert gc.isenabled()
  gc.disable()
  try:
    with step_graph.collector_held():
      pass
    assert not gc.isenabled()  # left as the caller had it
  finally:
    gc.enable()


def test_launch_counters_split_by_launching_thread(monkeypatch):
  """Launches and replays count for the thread that makes them; a
  recorded launch counts for the thread that replays it."""
  current = {"stream": _Stream(1)}
  monkeypatch.setattr(counters.torch.cuda, "current_stream",
                      lambda: current["stream"])

  def wrapper():
    counters.count(wrapper)
  wrapper.launches = 0
  counters.clear_by_thread()
  main = threading.current_thread().name
  wrapper()
  capture = _Stream(2)
  with counters.recording(capture) as rec:
    current["stream"] = capture
    wrapper()
    wrapper()
  current["stream"] = _Stream(1)

  def dispatcher():
    wrapper()
    counters.add(rec)  # a replay on this thread
  t = threading.Thread(target=dispatcher, name="dispatcher")
  t.start()
  t.join()
  counters.add(rec, warmup=True)
  assert counters.by_thread() == {main: {wrapper: 3},
                                  "dispatcher": {wrapper: 3}}
  assert wrapper.launches == 6
  counters.clear_by_thread()
  counters.clear_warmups()
  assert counters.by_thread() == {}


# ---- K-step Bellman dispatch ----


class _FixedReplay:
  """Fixed transition batches from `start` (a resumed run sees the
  batches an unbroken one saw at the same steps)."""

  def __init__(self, batches, start=0):
    self._batches, self._start = batches, start

  def wait_until_size(self, *args, **kwargs):
    pass

  def as_stream(self, batch_size):
    return iter([dict(b) for b in self._batches[self._start:]])

  def set_learner_step(self, step):
    pass

  def metrics_scalars(self, prefix="replay_"):
    return {}


def _bellman_batches(learner, n):
  return [make_random_tensors(learner.transition_specification(),
                              batch_size=8, seed=30 + i).to_flat_dict()
          for i in range(n)]


def _assert_same_state(a, b):
  for x, y in zip(step_graph.tensors(a), step_graph.tensors(b)):
    assert torch.equal(x, y)


def test_k4_bellman_dispatch_draws_the_noise_of_k1_and_resumes(tmp_path):
  """8 steps eager, graphed at K=1 and at K=4 (each step's CEM noise
  from `dispatch_seed(seed + 1, step)`): one state, bit for bit; 4 steps
  at K=4 and a resume at K=4 to 8 reach it too; the first call's
  returned state is not written by the second."""
  learner = QTOptLearner(GraspingQModel(device_dtype=torch.float32,
                                        **_VERIFY), device="cpu", **_CEM)
  batches = _bellman_batches(learner, 8)

  def run(name, k, graphs, steps=8, start=0, model_dir=None):
    return train_qtopt(learner, model_dir or str(tmp_path / name),
                       replay_buffer=_FixedReplay(batches, start),
                       max_train_steps=steps, batch_size=8,
                       save_checkpoints_steps=4, log_every_steps=4,
                       steps_per_dispatch=k, graphs=graphs, seed=3)

  eager = run("eager", 1, False)
  _assert_same_state(run("k1", 1, True), eager)
  _assert_same_state(run("k4", 4, True), eager)
  half = run("half", 4, True, steps=4, model_dir=str(tmp_path / "resume"))
  kept = step_graph.copy_tree(half)
  resumed = run("resumed", 4, True, start=4,
                model_dir=str(tmp_path / "resume"))
  assert half.step == 4 and resumed.step == 8
  _assert_same_state(resumed, eager)
  _assert_same_state(half, kept)


# ---- the serving engine ----


def _engine_fn(state, feats):
  return feats["x"] * state.params["w"]


def _engine(**kwargs):
  state = TrainState(step=0, params={"w": torch.tensor([2.0, 3.0])},
                     batch_stats={})
  example = {"x": np.ones((1, 2), np.float32)}
  return BucketedServingEngine(kwargs.pop("fn", _engine_fn), state, example,
                               max_batch=4, device="cpu", **kwargs)


def test_warmup_captures_every_bucket_once():
  engine = _engine()
  assert engine.compiled_buckets == () and engine.compile_count == 0
  engine.warmup()
  assert engine.compiled_buckets == (1, 2, 4) and engine.compile_count == 3
  assert set(engine.bucket_warmup_seconds) == {1, 2, 4}
  for n in (1, 3, 4):
    out = engine.predict({"x": np.ones((n, 2), np.float32)})
    np.testing.assert_array_equal(out, np.tile([2.0, 3.0], (n, 1)))
  assert engine.compile_count == 3  # traffic captures nothing
  engine.warmup()
  assert engine.compile_count == 3


def test_cold_bucket_captures_once_under_racing_dispatches():
  engine = _engine()
  barrier = threading.Barrier(4)

  def dispatch():
    barrier.wait()
    engine.predict({"x": np.ones((2, 2), np.float32)})

  threads = [threading.Thread(target=dispatch) for _ in range(4)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=30)
  assert engine.compiled_buckets == (2,) and engine.compile_count == 1


def test_warmup_async_serves_meanwhile_and_wait_reraises_every_join():
  engine = _engine()
  assert engine.wait_warmup() == 0.0
  thread = engine.warmup_async()
  assert engine.warmup_async() is thread
  out = engine.predict({"x": np.ones((1, 2), np.float32)})
  np.testing.assert_array_equal(out, [[2.0, 3.0]])
  assert engine.wait_warmup() >= 0.0 and engine.compile_count == 3

  def bad(state, feats):
    raise RuntimeError("boom")

  broken = _engine(fn=bad)
  broken.warmup_async()
  for _ in range(2):
    with pytest.raises(RuntimeError, match="boom"):
      broken.wait_warmup()


@pytest.mark.parametrize("graphs", [True, False])
def test_swap_waits_for_dispatches_on_the_slot_it_writes(graphs):
  """A dispatch in flight on slot 0 completes on its params; a swap into
  slot 1 does not wait for it, the next swap (into slot 0) does."""
  entered, release = threading.Event(), threading.Event()

  def slow(state, feats):
    if feats["x"].shape[0] == 2:  # only the held dispatch blocks
      entered.set()
      release.wait(timeout=30)
    return feats["x"] * state.params["w"]

  engine = _engine(fn=slow, graphs=graphs)
  held = {}
  t = threading.Thread(target=lambda: held.update(
      out=engine.predict_versioned({"x": np.ones((2, 2), np.float32)})))
  t.start()
  assert entered.wait(timeout=30)
  new = lambda w: TrainState(  # noqa: E731
      step=0, params={"w": torch.tensor(w)}, batch_stats={})
  engine.swap_state(new([5.0, 7.0]), learner_step=1)  # slot 1
  assert engine.publication.slot == 1
  np.testing.assert_array_equal(
      engine.predict({"x": np.ones((1, 2), np.float32)}), [[5.0, 7.0]])
  second = threading.Thread(target=engine.swap_state,
                            args=(new([9.0, 9.0]),))
  second.start()
  time.sleep(0.2)
  assert second.is_alive() and engine.params_version == 1  # waits
  release.set()
  t.join(timeout=30)
  second.join(timeout=30)
  out, published = held["out"]
  np.testing.assert_array_equal(out, np.tile([2.0, 3.0], (2, 1)))
  assert published.version == 0 and published.slot == 0
  assert engine.params_version == 2 and engine.publication.slot == 0
  np.testing.assert_array_equal(
      engine.predict({"x": np.ones((1, 2), np.float32)}), [[9.0, 9.0]])


def test_graphed_cem_dispatch_equals_eager_with_the_same_generator():
  learner = QTOptLearner(GraspingQModel(device_dtype=torch.float32,
                                        **_VERIFY), device="cpu", **_CEM)
  state = learner.create_state(seed=0).train_state
  spec = learner.observation_specification()
  example = make_random_tensors(spec, batch_size=1, seed=0)
  engines = [BucketedServingEngine(learner.build_policy(), state, example,
                                   max_batch=4, takes_rng=True,
                                   device="cpu", graphs=g)
             for g in (True, False)]
  obs = make_random_tensors(spec, batch_size=3, seed=1).to_flat_dict()
  gens = [torch.Generator().manual_seed(11) for _ in engines]
  outs = [e.predict(obs, g) for e, g in zip(engines, gens)]
  np.testing.assert_array_equal(outs[0], outs[1])
  # The caller's generator advanced as an eager dispatch advances it.
  assert torch.equal(gens[0].get_state(), gens[1].get_state())


# ---- the context policy over the graph's buffers ----


def test_context_policy_graphed_equals_eager_across_the_window():
  from tensor2robot_tpu_torch.research.vrgripper import (
      VRGripperTransformerModel,
      evaluate_gripper_policy,
  )
  model = VRGripperTransformerModel(
      image_size=24, filters=(8, 16), embedding_size=32, width=48, depth=2,
      num_heads=2, max_context_length=8, device_dtype=torch.float32)
  state = model.create_inference_state(seed=0, device="cpu")
  actions = {}
  for graphs in (True, False):
    policy = model.make_context_policy(state, device="cpu", graphs=graphs)
    seen = []

    def record(batch, policy=policy, seen=seen):
      out = policy(batch)
      seen.append(out["action"])
      return out

    record.reset = policy.reset
    evaluate_gripper_policy(record, num_episodes=2, image_size=24, seed=3,
                            max_steps=12)  # past the 8-step window
    actions[graphs] = np.concatenate(seen)
  np.testing.assert_array_equal(actions[True], actions[False])


# ---- flash attention: the padding plan and the chunking ----


def test_kernel_head_dim_plan():
  assert [fa.kernel_head_dim(d) for d in (1, 16, 17, 24, 32, 33, 48, 64, 65,
                                          100, 128)] == [
      16, 16, 32, 32, 32, 64, 64, 64, 128, 128, 128]
  with pytest.raises(ValueError, match="129"):
    fa.kernel_head_dim(129)


def test_batch_chunks_cover_the_batch_within_the_grid():
  assert fa.batch_chunks(3, 4) == [(0, 3)]
  assert fa.batch_chunks(16385, 4) == [(0, 16383), (16383, 16385)]
  assert fa.batch_chunks(10, 3, max_grid=7) == [(0, 2), (2, 4), (4, 6),
                                                (6, 8), (8, 10)]
  for b, h in ((16385, 4), (70000, 1), (5, 65535)):
    chunks = fa.batch_chunks(b, h)
    assert chunks[0][0] == 0 and chunks[-1][1] == b
    assert all(j - i > 0 and (j - i) * h <= 65535 for i, j in chunks)
  with pytest.raises(ValueError):
    fa.batch_chunks(1, 65536)


def _qkv(b, t, h, d, seed):
  g = torch.Generator().manual_seed(seed)
  return [torch.randn((b, t, h, d), generator=g) for _ in range(4)]


@pytest.mark.parametrize("d", [24, 48])
def test_padded_chunked_forward_and_backward_keep_the_true_head_dim(d):
  """The public path's plan over the plain versions as the launches: q,
  k, v padded to the kernel D with the scale of the true D, 5 batch
  chunks of a grid cut to 7, outputs sliced back: the unpadded result."""
  q, k, v, do = _qkv(5, 9, 2, d, seed=d)
  calls = []

  def launch(q_, k_, v_, causal, scale):
    calls.append((q_.shape, scale))
    return fa.flash_attention_reference(q_, k_, v_, causal, scale=scale)

  out, lse = fa._padded_chunked_forward(launch, q, k, v, True, max_grid=4)
  want_out, want_lse = fa.flash_attention_reference(q, k, v, True)
  kd = fa.kernel_head_dim(d)
  assert [c[0] for c in calls] == [(2, 9, 2, kd)] * 2 + [(1, 9, 2, kd)]
  assert all(c[1] == pytest.approx(1 / np.sqrt(d)) for c in calls)
  assert out.shape == q.shape
  torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-6)
  torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-6)

  def launch_bwd(dkdv, q_, k_, v_, do_, lse_, delta_, causal, scale):
    if dkdv:
      return fa.flash_attention_bwd_dkdv_reference(
          q_, k_, v_, do_, lse_, delta_, causal, scale=scale)
    return [fa.flash_attention_bwd_dq_reference(
        q_, k_, v_, do_, lse_, delta_, causal, scale=scale)]

  delta = fa._delta(want_out, do, None)
  got = fa._padded_chunked_backward(launch_bwd, q, k, v, do, want_lse,
                                    delta, True, max_grid=4)
  want = fa.flash_attention_backward_reference(q, k, v, want_out, want_lse,
                                               do, causal=True)
  for g, w in zip(got, want):
    assert g.shape == q.shape
    torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
