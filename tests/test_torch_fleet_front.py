"""The port's front replica (`fleet/front.py`) on the CPU.

  * `_FrontState.handle`, in process: `predict` equals the port's own
    `CEMPolicyServer` for the same params and generator seed, before and
    after a `publish`; `publish` sets the version, swaps every tenant's
    engine, and forwards to the configured tree children (a dead front
    child is skipped, a dead serving host raises); `admission_retune`
    and `slo_report` equal the JAX `AdmissionController`'s for the same
    scripted admissions; the rest of the method table (`hello`,
    `metrics`, `metrics_scalars`, `telemetry`, `flight_record`,
    `shutdown`, unknown methods). Only numpy crosses it.
  * The replicated tier end to end (the counterpart of JAX's
    `test_replicated_tier_end_to_end`, with `env="pose"`): two real
    fronts over TCP behind a `ServingRouter`, both tenants answered, one
    publish to the tree root reaching both, and a hard kill of a
    tenant's home replica shed inside the next call.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensor2robot_tpu.serving import admission as jax_admission  # noqa: E402
from tensor2robot_tpu_torch.fleet import front as front_lib  # noqa: E402
from tensor2robot_tpu_torch.fleet import orchestrator as orch  # noqa: E402
from tensor2robot_tpu_torch.fleet import rpc as rpc_lib  # noqa: E402
from tensor2robot_tpu_torch.fleet.host import _build_learner  # noqa: E402
from tensor2robot_tpu_torch.fleet.learner import publication  # noqa: E402
from tensor2robot_tpu_torch.serving import CEMPolicyServer, ServingRouter  # noqa: E402
from tensor2robot_tpu_torch.serving.microbatcher import dispatch_seed  # noqa: E402
from tensor2robot_tpu_torch.specs import (  # noqa: E402
    TensorSpecStruct,
    make_random_tensors,
)
from tensor2robot_tpu_torch.telemetry import core as tcore  # noqa: E402
from tensor2robot_tpu_torch.telemetry import flightrec  # noqa: E402
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402
from tensor2robot_tpu_torch.telemetry import perf as perf_lib  # noqa: E402


def _config(**overrides):
  base = dict(
      num_actors=1, env="pose", image_size=16, action_dim=2,
      torso_filters=(8,), head_filters=(8,), dense_sizes=(16,),
      cem_population=8, cem_iterations=1, cem_elites=2,
      serve_max_batch=4, transport="tcp", broadcast_degree=2,
      front_hosts=2, front_tenants=("a", "b"), front_slo_ms=50.0,
      launch_timeout_secs=240.0, seed=0, device="cpu")
  base.update(overrides)
  return orch.FleetConfig(**base)


def _observations(learner, n, seed):
  return {k: np.asarray(v) for k, v in make_random_tensors(
      learner.observation_specification(), batch_size=n,
      seed=seed).to_flat_dict().items()}


@pytest.fixture()
def front():
  tmetrics.reset_for_tests()
  state = front_lib._FrontState(_config(), 0)
  yield state
  state.close()
  perf_lib.stop_resource_sampler()
  tmetrics.reset_for_tests()
  tcore.reset_for_tests()


class _Recorder:
  """A loopback RpcServer (TCP) recording the publishes forwarded to it;
  with `fail`, its publish handler raises."""

  def __init__(self, config, fail=False):
    self.published = []
    self.fail = fail
    self.server = rpc_lib.RpcServer(self._handle, authkey=config.authkey,
                                    transport="tcp")
    self.address = list(self.server.address)

  def _handle(self, method, payload, ctx):
    if method == "publish":
      if self.fail:
        raise RuntimeError("swap failed")
      self.published.append(payload)
      return int(payload["step"])
    return None

  def close(self):
    self.server.close(timeout_secs=0.2)


def test_predict_equals_the_cem_policy_server(front):
  config = front._config
  learner = _build_learner(config, device="cpu")
  state = learner.create_state(config.seed).train_state
  server = CEMPolicyServer(learner, state, max_batch=config.serve_max_batch,
                           max_wait_us=0, seed=0, device="cpu")
  try:
    obs = _observations(learner, 1, seed=3)
    reply = front.handle("predict", {"tenant": "a", "features": obs}, {})
    assert set(reply) == {"action", "params_version", "front_index"}
    assert isinstance(reply["action"], np.ndarray)
    np.testing.assert_array_equal(reply["action"],
                                  server.select_actions(obs))
    assert reply["params_version"] == 0 and reply["front_index"] == 0
    # A publication swaps the served params of every tenant.
    published = learner.create_state(seed=5).train_state
    version = front.handle("publish", {
        "state": publication(published), "step": 40, "hop": 0,
        "origin_wall": time.time()}, {})
    assert version == 40
    fresh = CEMPolicyServer(learner, published,
                            max_batch=config.serve_max_batch, max_wait_us=0,
                            seed=0, device="cpu")
    try:
      # Tenant "b" (registration index 1) dispatches for the first time.
      reply = front.handle("predict", {"tenant": "b", "features": obs}, {})
      direct = fresh.engine.predict(
          TensorSpecStruct.from_flat_dict(obs),
          generator=torch.Generator().manual_seed(dispatch_seed(1, 1)))
      np.testing.assert_array_equal(reply["action"], np.asarray(direct))
      assert reply["params_version"] == 40
      digests = front.served_digests()
      assert digests["a"] == digests["b"]
    finally:
      fresh.close()
  finally:
    server.close()


def test_publish_forwards_to_children(front):
  config = front._config
  child = _Recorder(config)
  failing = _Recorder(config, fail=True)
  dead = _Recorder(config)
  dead.close()
  ctx = {}
  try:
    assert front.handle("configure_broadcast", {
        "children": [child.address, dead.address],
        "survivable": [dead.address], "depth": 1}, ctx) is True
    state = _build_learner(config, device="cpu").create_state(2).train_state
    payload = {"state": publication(state), "step": 8, "hop": 0,
               "origin_wall": time.time()}
    assert front.handle("publish", payload, ctx) == 8
    (forwarded,) = child.published
    assert forwarded["hop"] == 1 and forwarded["step"] == 8
    counters = tmetrics.registry().snapshot()["counters"]
    assert counters["fleet.broadcast.forwards"] == 1
    assert counters["fleet.broadcast.forward_failures"] == 1
    # A serving host whose swap fails is not survivable: the error
    # reaches the publisher.
    front.handle("configure_broadcast", {"children": [failing.address],
                                         "depth": 1}, ctx)
    with pytest.raises(rpc_lib.RpcError, match="swap failed"):
      front.handle("publish", dict(payload, step=16), ctx)
    assert front.params_version == 16
    front.handle(rpc_lib.DISCONNECT_METHOD, None, ctx)
  finally:
    child.close()
    failing.close()


def test_admission_and_slo_report_equal_jax(front):
  config = front._config
  learner = _build_learner(config, device="cpu")
  jax_ctrl = jax_admission.AdmissionController(slo_ms=config.front_slo_ms)
  for tenant in config.front_tenants:
    jax_ctrl.register(tenant)
  for i in range(6):
    front.handle("predict", {"tenant": "a" if i % 3 else "b",
                             "features": _observations(learner, 1, i)}, {})
  snapshot = tmetrics.registry().snapshot()
  assert front.handle("slo_report", None, {}) == jax_ctrl.slo_report(snapshot)
  for payload in ({"tenant": "a", "rate_rps": 40.0},
                  {"tenant": "a", "factor": 0.5, "min_rate_rps": 5.0},
                  {"tenant": "b", "rate_rps": 100.0, "burst": 16},
                  {"tenant": "b", "factor": 0.01, "min_rate_rps": 2.0},
                  {"tenant": "a", "rate_rps": None}):
    reply = front.handle("admission_retune", dict(payload), {})
    kwargs = {k: v for k, v in payload.items() if k != "tenant"}
    policy = jax_ctrl.retune(payload["tenant"], **kwargs)
    assert reply == {"tenant": payload["tenant"],
                     "rate_rps": policy.rate_rps, "burst": policy.burst}
  with pytest.raises(KeyError):
    front.handle("admission_retune", {"tenant": "nobody", "rate_rps": 1.0},
                 {})


def test_method_table(front, tmp_path):
  hello = front.handle("hello", None, {})
  assert hello["kind"] == "front" and hello["tenants"] == ["a", "b"]
  assert hello["speculative"] == [] and hello["params_version"] == 0
  metrics = front.handle("metrics", None, {})
  assert metrics["cuda_initialized"] is False
  assert set(metrics["served_params_sha256"]) == {"a", "b"}
  assert metrics["arena"]["resident"] == ["a", "b"]
  assert front.handle("metrics_scalars", None, {}) == {
      "front_serves": 0.0, "front_publishes": 0.0}
  view = front.handle("telemetry", None, {})
  assert view["host"]["gauges"]["proc.cuda_initialized"] == 0.0
  path = front.handle("flight_record", {"out_dir": str(tmp_path),
                                        "reason": "probe"}, {})
  assert flightrec.read_dumps(str(tmp_path))[0]["reason"] == "probe"
  assert path
  assert front.handle("shutdown", None, {}) is True
  assert front.shutdown_requested.is_set()
  with pytest.raises(ValueError, match="unknown front rpc method"):
    front.handle("warp", None, {})


def test_speculative_front_serves_fast_then_refines():
  tmetrics.reset_for_tests()
  state = front_lib._FrontState(_config(front_tenants=("a",),
                                        speculative_cem=True), 1)
  try:
    learner = _build_learner(state._config, device="cpu")
    obs = _observations(learner, 1, seed=0)
    first = state.handle("predict", {"tenant": "a", "features": obs}, {})
    assert np.all(np.isfinite(first["action"]))
    assert state._speculative["a"].flush(timeout_secs=60.0)
    again = state.handle("predict", {"tenant": "a", "features": obs}, {})
    stats = state.handle("metrics", None, {})["speculative"]["a"]
    assert stats["fast_served"] == 1 and stats["refined_served"] == 1
    assert np.all(np.isfinite(again["action"]))
    assert state.handle("hello", None, {})["speculative"] == ["a"]
  finally:
    state.close()
    perf_lib.stop_resource_sampler()
    tmetrics.reset_for_tests()
    tcore.reset_for_tests()


def _call(tier, index, method):
  client = rpc_lib.RpcClient(tier.addresses[index],
                             authkey=tier._config.authkey, transport="tcp")
  try:
    return client.call(method)
  finally:
    client.close()


def test_replicated_tier_end_to_end():
  config = _config()
  learner = _build_learner(config, device="cpu")
  obs = _observations(learner, 1, seed=0)
  tier = front_lib.FrontTier(config, 2).launch(timeout_secs=240.0)
  router = ServingRouter(tier.addresses, authkey=config.authkey,
                         transport="tcp", connect_timeout_secs=5.0,
                         call_timeout_secs=60.0)
  try:
    for tenant in ("a", "b"):
      action = np.asarray(router.predict(tenant, obs))
      assert action.size > 0 and np.all(np.isfinite(action))
    assert router.params_version == 0
    state = learner.create_state(seed=7).train_state
    assert tier.publish(publication(state), step=7) == 7
    for index in (0, 1):
      assert _call(tier, index, "metrics_scalars")["front_publishes"] == 1.0
    digests = [_call(tier, i, "metrics")["served_params_sha256"]
               for i in (0, 1)]
    assert digests[0] == digests[1]
    router.predict("a", obs)
    assert router.params_version == 7
    victim = router.placement("a")[0]
    tier.kill(victim)
    action = np.asarray(router.predict("a", obs))
    assert action.size > 0 and np.all(np.isfinite(action))
    assert victim not in router.alive()
    assert victim not in router.placement("a")
    assert router.stats()["failovers"] >= 1
    assert tier.alive() == [1 - victim]
  finally:
    router.close()
    tier.close()
  assert tier.alive() == []
