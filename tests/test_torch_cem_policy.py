"""Port's CEM, QT-Opt policy and CEMPolicyServer against the JAX package.

`jax.random` cannot be reproduced in torch, so each parity test rebuilds
the JAX noise exactly (`split(rng, iterations)`, then one
`normal(key, (B, P, A))` per key, as `cem_maximize`'s scan draws it)
and injects it into the port. f32 models; actions agree to 1e-5 (same
samples, same f32 scores up to summation order, same tie order).
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu import specs as jax_specs  # noqa: E402
from tensor2robot_tpu.research.qtopt import cem as jax_cem  # noqa: E402
from tensor2robot_tpu.research.qtopt import (  # noqa: E402
    GraspingQModel as JaxModel,
    QTOptLearner as JaxLearner,
)
from tensor2robot_tpu_torch.ops import select_elites  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import (  # noqa: E402
    GraspingQModel,
    QTOptLearner,
    cem,
    convert_variables,
)
from tensor2robot_tpu_torch.serving import (  # noqa: E402
    BucketedServingEngine,
    CEMPolicyServer,
)
from tensor2robot_tpu_torch.serving.microbatcher import (  # noqa: E402
    dispatch_seed,
)
from tensor2robot_tpu_torch.specs import make_random_tensors  # noqa: E402

_TINY = dict(image_size=16, torso_filters=(8, 8), head_filters=(8, 8),
             dense_sizes=(16,), action_dim=3,
             extra_state_features={"height": (1,)})
_CEM = dict(cem_population=16, cem_iterations=2, cem_elites=4)


def _jax_noise(rng, iterations, shape):
  keys = jax.random.split(rng, iterations)
  return torch.from_numpy(np.stack(
      [np.asarray(jax.random.normal(k, shape)) for k in keys]))


class TestCEMMaximize:

  def _score_fns(self, a_dim):
    w = np.random.default_rng(11).standard_normal((a_dim, 1)).astype(
        np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jax_score = lambda x: (x @ jw)[..., 0] - jnp.sum(x ** 2, -1)  # noqa: E731
    torch_score = lambda x: (x @ tw)[..., 0] - (x ** 2).sum(-1)  # noqa: E731
    return jax_score, torch_score

  @pytest.mark.parametrize("path", ["score_fn", "select_fn"])
  def test_injected_noise_matches_jax(self, path):
    b, p, a, iters, elites = 3, 16, 2, 3, 3
    jax_score, torch_score = self._score_fns(a)
    key = jax.random.PRNGKey(0)
    want = jax_cem.cem_maximize(jax_score, key, b, a, iterations=iters,
                                population=p, num_elites=elites)
    noise = _jax_noise(key, iters, (b, p, a))
    kwargs = dict(iterations=iters, population=p, num_elites=elites,
                  noise=noise)
    if path == "score_fn":
      got = cem.cem_maximize(torch_score, b, a, **kwargs)
    else:
      got = cem.cem_maximize(
          None, b, a, select_fn=lambda x, min_std: select_elites(
              torch_score(x), x, elites, min_std), **kwargs)
    for g, w, name in zip(got, want, got._fields):
      np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                 rtol=1e-6, err_msg=name)

  def test_default_device_is_the_card(self):
    """ROADMAP fault C5: with neither noise, generator nor device,
    `cem_maximize` resolves the card (`resolve_device(None)`) and raises
    the resolver's RuntimeError without one; it never picks the CPU
    unasked. `device="cpu"` runs there."""
    assert not torch.cuda.is_available()
    score = lambda x: x.sum(-1)  # noqa: E731
    with pytest.raises(RuntimeError, match="is_available"):
      cem.cem_maximize(score, 2, 2, iterations=1, population=4,
                       num_elites=2)
    got = cem.cem_maximize(score, 2, 2, iterations=1, population=4,
                           num_elites=2, device="cpu")
    assert got.best_action.device.type == "cpu"
    assert got.best_action.shape == (2, 2)

  def test_noise_shape_is_checked(self):
    with pytest.raises(ValueError, match="noise"):
      cem.cem_maximize(lambda x: x.sum(-1), 2, 2, iterations=2,
                       population=4, noise=torch.zeros(2, 2, 5, 2))


class TestBuildPolicyParity:

  @pytest.mark.parametrize("cem_select", ["lax", "fused"])
  def test_policy_matches_jax_learner(self, cem_select):
    """JAX runs the fused path through the Pallas interpreter on CPU;
    the port through its plain version — same actions."""
    jax_learner = JaxLearner(JaxModel(device_dtype=jnp.float32, **_TINY),
                             cem_select=cem_select, **_CEM)
    learner = QTOptLearner(GraspingQModel(device_dtype=torch.float32,
                                          **_TINY),
                           cem_select=cem_select, device="cpu", **_CEM)
    jax_state = jax_learner.create_state(jax.random.PRNGKey(0), 2)
    variables = {"params": jax.device_get(jax_state.train_state.params),
                 "batch_stats": jax.device_get(
                     jax_state.train_state.batch_stats)}
    state = convert_variables(variables)
    obs = jax_specs.make_random_tensors(
        jax_learner.observation_specification(), batch_size=5, seed=1)
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jax_learner.build_policy()(
        jax_state, jax.tree_util.tree_map(jnp.asarray, obs), rng))
    got = learner.build_policy()(
        state, obs.to_flat_dict(),
        noise=_jax_noise(rng, 2, (5, _CEM["cem_population"], 3)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)



def _learner():
  model = GraspingQModel(device_dtype=torch.float32, **_TINY)
  return QTOptLearner(model, device="cpu", **_CEM)


@pytest.fixture(scope="module")
def server():
  learner = _learner()
  state = learner.create_state(seed=0)
  srv = CEMPolicyServer(learner, state.train_state, max_batch=4,
                        max_wait_us=10_000, seed=0, device="cpu")
  yield learner, srv
  srv.close()


class TestCEMPolicyServer:

  def test_action_shapes_and_bounds(self, server):
    learner, srv = server
    obs = make_random_tensors(learner.observation_specification(),
                              batch_size=3, seed=1)
    actions = srv.select_actions(obs.to_flat_dict())
    assert actions.shape == (3, 3)
    assert np.all(actions >= -1.0) and np.all(actions <= 1.0)
    assert set(srv.engine.bucket_warmup_seconds) == {1, 2, 4}

  def test_concurrent_robots_coalesce(self, server):
    learner, srv = server
    spec = learner.observation_specification()
    barrier = threading.Barrier(4)
    results = {}

    def robot(i):
      obs = make_random_tensors(spec, batch_size=1, seed=20 + i)
      barrier.wait()
      results[i] = srv.select_actions(obs.to_flat_dict())

    d0 = srv.batcher.dispatches
    threads = [threading.Thread(target=robot, args=(i,)) for i in range(4)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 4
    assert all(results[i].shape == (1, 3) for i in results)
    assert srv.batcher.dispatches - d0 < 4

  def test_pad_rows_do_not_change_real_rows(self, server):
    """3 rows pad to bucket 4 by replicating the last row; a 4th real
    row in that slot must leave the first 3 actions unchanged."""
    learner, srv = server
    spec = learner.observation_specification()
    three = make_random_tensors(spec, batch_size=3, seed=4).to_flat_dict()
    other = make_random_tensors(spec, batch_size=1, seed=5).to_flat_dict()
    four = {k: np.concatenate([three[k], other[k]]) for k in three}
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a3 = srv.select_actions_direct(three, generator=gen())
    a4 = srv.select_actions_direct(four, generator=gen())
    np.testing.assert_array_equal(a3, a4[:3])

  def test_swap_state_bumps_version(self, server):
    learner, srv = server
    v0 = srv.params_version
    srv.update_state(learner.create_state(seed=1).train_state,
                     learner_step=42)
    assert srv.params_version == v0 + 1
    assert srv.params_learner_step == 42
    srv.update_state(learner.create_state(seed=2).train_state)
    assert srv.params_version == v0 + 2
    assert srv.params_learner_step == 42  # unstamped swaps keep it

  def test_dispatch_seeds_differ(self):
    seeds = {dispatch_seed(0, i) for i in range(100)}
    assert len(seeds) == 100 and all(0 <= s < 2 ** 63 for s in seeds)
    assert dispatch_seed(0, 5) == dispatch_seed(0, 5) != dispatch_seed(1, 5)


def test_int8_server_calibrates_before_its_buckets_capture():
  """An int8 learner that was never calibrated calibrates on the
  spec-random batch (`ensure_calibrated`) before the engine warms up its
  buckets; the server then answers in bounds."""
  model = GraspingQModel(device_dtype=torch.float32, **_TINY)
  learner = QTOptLearner(model, cem_inference="int8", cem_select="fused",
                         device="cpu", **_CEM)
  assert learner.needs_calibration
  state = learner.create_state(seed=0).train_state
  with CEMPolicyServer(learner, state, max_batch=2, seed=0,
                       device="cpu") as srv:
    assert not learner.needs_calibration
    assert sorted(learner.act_scales) == ["head_in_1", "torso_in_0",
                                          "torso_in_1"]
    obs = make_random_tensors(learner.observation_specification(),
                              batch_size=2, seed=3)
    actions = srv.select_actions(obs.to_flat_dict())
  assert actions.shape == (2, 3)
  assert np.all(np.abs(actions) <= 1.0)
  reference = QTOptLearner(model, cem_inference="int8", device="cpu", **_CEM)
  reference.ensure_calibrated(state)
  assert reference.act_scales == learner.act_scales


def test_submit_after_close_raises():
  learner = _learner()
  srv = CEMPolicyServer(learner, learner.create_state(0).train_state,
                        max_batch=2, device="cpu", warmup=False)
  srv.close()
  obs = make_random_tensors(learner.observation_specification(),
                            batch_size=1, seed=0)
  with pytest.raises(RuntimeError, match="closed"):
    srv.select_actions(obs.to_flat_dict())


def test_release_refuses_later_work():
  learner = _learner()
  state = learner.create_state(0).train_state
  obs = make_random_tensors(learner.observation_specification(),
                            batch_size=1, seed=0)
  engine = BucketedServingEngine(learner.build_policy(), state, obs,
                                 max_batch=2, takes_rng=True, device="cpu")
  engine.release()
  engine.release()  # idempotent
  with pytest.raises(RuntimeError, match="released"):
    engine.predict(obs)
  with pytest.raises(RuntimeError, match="released"):
    engine.swap_state(state)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  model = GraspingQModel(**_TINY)
  with pytest.raises(RuntimeError, match="cuda"):
    QTOptLearner(model)
  learner = _learner()
  state = learner.create_state(0).train_state
  with pytest.raises(RuntimeError, match="cuda"):
    CEMPolicyServer(learner, state)
  with pytest.raises(RuntimeError, match="cuda"):
    BucketedServingEngine(learner.build_policy(), state, {}, takes_rng=True)
