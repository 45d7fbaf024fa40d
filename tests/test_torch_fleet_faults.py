"""The port's deterministic fault plan (`fleet/faults.py`) against the JAX
package's, and the recovery seams it drives, on the CPU.

  * `FaultPlan.generate` draws JAX's plans (events and digests) for a
    table of seeds, actor counts and class sets, the seed-7 digest that
    JAX pins included.
  * For a table of plans and seeds, the port's `FaultInjector` fires on
    exactly the calls JAX's fires on: collect batches (`on_batch`),
    learner steps (`on_step`) and a seeded stream of client and server
    RPC calls (`rpc_action`), in every incarnation (non-recurring
    events fire only in the first).
  * The seams on the port's RPC: an injected disconnect runs the real
    disconnect path, a handler error never retries (an injected drop
    recovering through the real deadline and retry is in
    `test_torch_fleet_transport.py`).
  * The rate-based restart budget (no processes).
"""

import pickle
import random

import pytest

pytest.importorskip("torch")

from tensor2robot_tpu.fleet import faults as jax_faults  # noqa: E402
from tensor2robot_tpu_torch.fleet import Fleet, FleetConfig  # noqa: E402
from tensor2robot_tpu_torch.fleet import RpcClient, RpcError, RpcServer  # noqa: E402
from tensor2robot_tpu_torch.fleet import faults  # noqa: E402
from tensor2robot_tpu_torch.fleet import rpc  # noqa: E402
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402

# JAX's pin (tests/test_fleet_faults.py): the seed-7, 2-actor plan.
_SEED7_DIGEST = (
    "1a0cb555a8f2197709fba02331449752b8796fd59df907901bae45a3388a3d8d")


@pytest.fixture(autouse=True)
def _fresh():
  tmetrics.reset_for_tests()
  rpc.set_fault_injector(None)
  yield
  rpc.set_fault_injector(None)
  tmetrics.reset_for_tests()


def _tiny_config(**overrides):
  base = dict(
      num_actors=2, env="toy_grasp", image_size=16, action_dim=2,
      torso_filters=(8,), head_filters=(8,), dense_sizes=(16,),
      cem_population=8, cem_iterations=1, cem_elites=2,
      batch_size=16, max_train_steps=16, min_replay_size=32,
      publish_every_steps=8, log_every_steps=8,
      batch_episodes=8, serve_max_batch=4,
      replay_capacity=512, replay_shards=1,
      heartbeat_timeout_secs=0.0, seed=0, device="cpu")
  base.update(overrides)
  return FleetConfig(**base)


_GENERATE = [
    dict(seed=7, num_actors=2),
    dict(seed=0, num_actors=1),
    dict(seed=3, num_actors=4, actor_batch_range=(1, 3),
         learner_step_range=(2, 9), rpc_call_range=(1, 5)),
    dict(seed=11, num_actors=3, classes=("rpc_drop", "slow_host",
                                         "actor_hang")),
    dict(seed=5, num_actors=2, classes=faults.ALL_FAULT_CLASSES,
         num_fronts=2),
]


@pytest.mark.parametrize("kwargs", _GENERATE)
def test_generated_plans_equal_jax(kwargs):
  port = faults.FaultPlan.generate(**kwargs)
  jax = jax_faults.FaultPlan.generate(**kwargs)
  assert [e.to_json() for e in port.events] == [
      e.to_json() for e in jax.events]
  assert port.digest() == jax.digest()
  assert port.classes() == jax.classes()
  if kwargs == dict(seed=7, num_actors=2):
    assert port.digest() == _SEED7_DIGEST


def test_plan_errors_equal_jax():
  for kwargs in (dict(classes=("actor_crash", "bogus")),
                 dict(classes=("serving_replica_crash",))):
    with pytest.raises(ValueError) as port:
      faults.FaultPlan.generate(seed=0, num_actors=1, **kwargs)
    with pytest.raises(ValueError) as jax:
      jax_faults.FaultPlan.generate(seed=0, num_actors=1, **kwargs)
    assert str(port.value) == str(jax.value)


def _drive(module, plan, role, incarnation, seed):
  """Every seam of one injector over a seeded call sequence: what fired
  where."""
  injector = module.FaultInjector(plan, role, incarnation=incarnation)
  rng = random.Random(seed)
  out = []
  for i in range(1, 25):
    event = injector.on_batch(i)
    out.append(("batch", i, event and event.to_json()))
    event = injector.on_step(i)
    out.append(("step", i, event and event.to_json()))
    side = rng.choice(("client", "server"))
    method = rng.choice(("act", "commit", "sample", "publish"))
    out.append(("rpc", side, method, injector.rpc_action(side, method)))
  return out, injector.injected


def _plans(seed):
  generated = [(module.FaultPlan.generate(seed=seed, num_actors=3,
                                          actor_batch_range=(1, 8),
                                          learner_step_range=(1, 12),
                                          rpc_call_range=(1, 10)))
               for module in (faults, jax_faults)]
  events = [
      dict(fault="actor_crash", target="actor-0", at=3, mode="mid_episode",
           recurring=True),
      dict(fault="actor_hang", target="actor-1", at=2, duration_secs=9.0),
      dict(fault="learner_crash", target="learner", at=5),
      dict(fault="rpc_delay", target="learner", at=2, duration_secs=0.1,
           count=3, method="sample"),
      dict(fault="rpc_drop", target="actor-0", at=4),
      dict(fault="slow_host", target="host", at=3, duration_secs=0.2,
           count=4, method="act"),
      dict(fault="rpc_disconnect", target="host", at=6, method="commit"),
  ]
  hand = [module.FaultPlan(seed=seed, events=tuple(
      module.FaultEvent(**e) for e in events))
          for module in (faults, jax_faults)]
  return [generated, hand]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("role", ["actor-0", "actor-1", "actor-2",
                                  "learner", "host"])
def test_injectors_fire_on_the_same_calls_as_jax(seed, role):
  for port_plan, jax_plan in _plans(seed):
    assert port_plan.digest() == jax_plan.digest()
    for incarnation in (0, 1):
      port = _drive(faults, port_plan, role, incarnation, seed)
      jax = _drive(jax_faults, jax_plan, role, incarnation, seed)
      assert port == jax


def test_plan_ships_inside_the_config_and_installs():
  plan = faults.FaultPlan.generate(seed=3, num_actors=2)
  config = _tiny_config(fault_plan=plan)
  clone = pickle.loads(pickle.dumps(config))
  assert clone.fault_plan.digest() == plan.digest()
  with pytest.raises(ValueError, match="fault_plan"):
    _tiny_config(fault_plan={"not": "a plan"})
  target = plan.events[0].target
  injector = faults.install(config, target)
  assert injector.active and rpc._fault_injector is injector
  rpc.set_fault_injector(None)
  assert not faults.install(config, "nobody").active
  assert rpc._fault_injector is None


def test_injections_are_recorded():
  plan = faults.FaultPlan(seed=0, events=(faults.FaultEvent(
      fault=faults.LEARNER_CRASH, target="learner", at=1),))
  injector = faults.FaultInjector(plan, "learner")
  assert injector.on_step(1) is not None
  assert tmetrics.registry().snapshot()["counters"][
      "fleet.faults.injected.learner_crash"] == 1.0
  assert injector.injected[0]["fault"] == faults.LEARNER_CRASH
  assert faults.RECOVERY_MS_BOUNDS == jax_faults.RECOVERY_MS_BOUNDS


def test_injected_disconnect_runs_the_real_disconnect_path():
  disconnects = []

  def handler(method, payload, ctx):
    if method == rpc.DISCONNECT_METHOD:
      disconnects.append(1)
      return None
    return payload

  plan = faults.FaultPlan(seed=0, events=(faults.FaultEvent(
      fault=faults.RPC_DISCONNECT, target="host", at=2),))
  rpc.set_fault_injector(faults.FaultInjector(plan, "host"))
  server = RpcServer(handler)
  try:
    client = RpcClient(server.address, call_timeout_secs=5.0,
                       max_retries=2)
    assert client.call("ping", 1) == 1
    assert client.call("ping", 2) == 2
    assert client.reconnects == 1
    assert disconnects
    client.close()
  finally:
    server.close()


def test_handler_error_never_retries():
  attempts = []

  def handler(method, payload, ctx):
    if method != rpc.DISCONNECT_METHOD:
      attempts.append(method)
      raise ValueError("application error")

  server = RpcServer(handler)
  try:
    client = RpcClient(server.address, call_timeout_secs=5.0,
                       max_retries=3)
    with pytest.raises(RpcError, match="application error"):
      client.call("op")
    assert attempts == ["op"]
    client.close()
  finally:
    server.close()


def test_rate_budget_slides_and_is_per_target(tmp_path, monkeypatch):
  from tensor2robot_tpu_torch.fleet import orchestrator
  clock = [1000.0]
  monkeypatch.setattr(orchestrator.time, "monotonic", lambda: clock[0])
  fleet = Fleet(_tiny_config(max_actor_restarts=2,
                             restart_window_secs=0.2), str(tmp_path / "m"))
  assert fleet._budget_ok("actor-0")
  fleet._charge_restart("actor-0")
  assert fleet._budget_ok("actor-0")
  fleet._charge_restart("actor-0")
  assert not fleet._budget_ok("actor-0")  # a crash loop trips it
  clock[0] += 0.25
  assert fleet._budget_ok("actor-0")  # the window slid
  assert fleet._budget_ok("actor-1")
  lifetime = Fleet(_tiny_config(max_actor_restarts=1,
                                restart_window_secs=0.0), str(tmp_path))
  lifetime._charge_restart("actor-0")
  clock[0] += 1e6
  assert not lifetime._budget_ok("actor-0")
  learner = Fleet(_tiny_config(max_actor_restarts=5, max_learner_restarts=1),
                  str(tmp_path))
  learner._charge_restart("learner")
  assert not learner._budget_ok("learner")
  assert learner._budget_ok("actor-0")
