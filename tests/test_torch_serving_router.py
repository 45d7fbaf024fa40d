"""The port's replicated-tier router against the JAX package's.

Counterparts of `tests/test_serving_router.py`'s `TestRendezvousPlacement`,
`TestServingRouter` (fake fronts: loopback RPC servers speaking the
front's `predict` surface) and `TestServingReplicaCrashFaults`, on the
port's modules, plus what both packages must decide alike:

  * `ServingRouter.placement` for 200 tenant names over member sets of
    1–5 fronts, as built and after `mark_dead` / `mark_alive`;
  * the replica each routed request lands on, with spread 1 and 2, the
    two routers over the same fake fronts;
  * the serve index at which `FaultInjector.on_serve` fires for the
    `serving_replica_crash` plan each package generates from one seed.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from tensor2robot_tpu.fleet import faults as jax_faults  # noqa: E402
from tensor2robot_tpu.fleet import rpc as jax_rpc  # noqa: E402
from tensor2robot_tpu.serving import router as jax_router  # noqa: E402
from tensor2robot_tpu_torch.fleet import faults  # noqa: E402
from tensor2robot_tpu_torch.fleet import rpc as rpc_lib  # noqa: E402
from tensor2robot_tpu_torch.fleet.actor import home_shard  # noqa: E402
from tensor2robot_tpu_torch.replay.sampler import (  # noqa: E402
    rendezvous_choose,
    rendezvous_rank,
    rendezvous_spread,
    rendezvous_weight,
)
from tensor2robot_tpu_torch.serving import (  # noqa: E402
    NoReplicasError,
    ServingRouter,
)

KEYS = [f"tenant-{i}" for i in range(200)]


class TestRendezvousPlacement:

  def test_byte_parity_with_home_shard(self):
    for n in range(1, 9):
      for key in KEYS:
        assert rendezvous_choose(key, range(n)) == home_shard(key, n)

  def test_weight_deterministic_and_bucket_sensitive(self):
    assert rendezvous_weight("k", 3) == rendezvous_weight("k", 3)
    assert len({rendezvous_weight("k", b) for b in range(16)}) == 16

  def test_rank_is_a_permutation(self):
    buckets = [5, 2, 9, 0]
    rank = rendezvous_rank("some-key", buckets)
    assert sorted(rank) == sorted(buckets)
    assert rank[0] == rendezvous_choose("some-key", buckets)

  def test_membership_change_remaps_only_lost_bucket(self):
    buckets = list(range(5))
    before = {k: rendezvous_choose(k, buckets) for k in KEYS}
    for lost in buckets:
      survivors = [b for b in buckets if b != lost]
      moved = 0
      for key in KEYS:
        after = rendezvous_choose(key, survivors)
        if before[key] == lost:
          moved += 1
          assert after != lost
        else:
          assert after == before[key]
      assert moved > 0

  def test_spread_properties(self):
    buckets = range(6)
    spread = rendezvous_spread("hot", buckets, k=3)
    assert len(set(spread)) == 3
    assert spread == rendezvous_rank("hot", buckets)[:3]
    assert rendezvous_spread("hot", buckets, k=99) == rendezvous_rank(
        "hot", buckets)

  def test_degenerate_inputs_raise(self):
    with pytest.raises(ValueError):
      rendezvous_choose("k", [])
    with pytest.raises(ValueError):
      rendezvous_spread("k", [1, 2], k=0)


@pytest.mark.parametrize("members", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("spread", [1, 2])
def test_placement_equals_jax(members, spread):
  spread = min(spread, members)
  addresses = {i: ("127.0.0.1", 40000 + i) for i in range(members)}
  port = ServingRouter(addresses, spread=spread)
  jax = jax_router.ServingRouter(addresses, spread=spread)
  try:
    def placements():
      return ({t: port.placement(t) for t in KEYS},
              {t: jax.placement(t) for t in KEYS})

    got, want = placements()
    assert got == want
    if members > 1:
      dead = {members - 1} | ({0} if members > 2 else set())
      for router in (port, jax):
        for index in sorted(dead):
          router.mark_dead(index)
      got, want = placements()
      assert got == want
      assert all(not dead & set(p) for p in got.values())
      for router in (port, jax):
        router.mark_alive(members - 1)
      got, want = placements()
      assert got == want
      assert port.alive() == jax.alive()
  finally:
    port.close()
    jax.close()


class _FakeFront:
  """A loopback RpcServer (of `rpc_module`) speaking the front's
  predict surface: the action names the replica."""

  def __init__(self, index, rpc_module=rpc_lib):
    self.index = index
    self.version = 0
    self.calls = 0
    self.reject = False
    self.rpc = rpc_module
    self.server = rpc_module.RpcServer(self._handle)
    self.address = self.server.address

  def _handle(self, method, payload, ctx):
    if method == "predict":
      self.calls += 1
      if self.reject:
        raise ValueError("admission shed")
      return {"action": np.array([float(self.index)]),
              "params_version": self.version,
              "front_index": self.index}
    if method == self.rpc.DISCONNECT_METHOD:
      return None
    raise ValueError(f"unknown method {method}")

  def close(self):
    self.server.close(timeout_secs=0.2)


@pytest.fixture()
def fronts():
  replicas = {i: _FakeFront(i) for i in range(3)}
  yield replicas
  for front in replicas.values():
    front.close()


class TestServingRouter:

  OBS = {"img": np.ones((2, 2), np.float32)}

  def _router(self, replicas, **kwargs):
    return ServingRouter({i: f.address for i, f in replicas.items()},
                         **kwargs)

  def test_placement_is_the_hrw_ranking(self, fronts):
    with self._router(fronts) as router:
      for tenant in ("a", "b", "hot"):
        assert router.placement(tenant) == rendezvous_spread(
            tenant, range(3), k=3)

  def test_predict_routes_to_the_home_replica(self, fronts):
    with self._router(fronts) as router:
      for tenant in KEYS[:20]:
        home = rendezvous_choose(tenant, range(3))
        assert router.predict(tenant, self.OBS)[0] == float(home)

  def test_rpc_error_never_fails_over(self, fronts):
    with self._router(fronts) as router:
      tenant = next(t for t in KEYS if rendezvous_choose(t, range(3)) == 1)
      fronts[1].reject = True
      calls_elsewhere = fronts[0].calls + fronts[2].calls
      with pytest.raises(rpc_lib.RpcError):
        router.predict(tenant, self.OBS)
      assert router.alive() == [0, 1, 2]
      assert fronts[0].calls + fronts[2].calls == calls_elsewhere
      assert router.stats()["shed"] == 1

  def test_replica_death_sheds_only_its_tenants(self, fronts):
    with self._router(fronts) as router:
      before = {t: router.predict(t, self.OBS)[0] for t in KEYS[:40]}
      victim = 2
      fronts[victim].close()
      after = {t: router.predict(t, self.OBS)[0] for t in KEYS[:40]}
      assert victim not in router.alive()
      assert router.stats()["failovers"] >= 1
      for tenant in KEYS[:40]:
        if before[tenant] != float(victim):
          assert after[tenant] == before[tenant]
        else:
          assert after[tenant] == float(rendezvous_choose(tenant, [0, 1]))

  def test_all_dead_raises_no_replicas(self, fronts):
    # A closed server refuses connections: each replica fails over once
    # its connect window closes.
    with self._router(fronts, connect_timeout_secs=0.5) as router:
      for front in fronts.values():
        front.close()
      with pytest.raises(NoReplicasError):
        router.predict("anyone", self.OBS)
      assert router.alive() == []
      assert router.stats()["failovers"] == 3

  def test_mark_alive_rejoins_placement(self, fronts):
    with self._router(fronts) as router:
      router.mark_dead(0)
      assert router.alive() == [1, 2]
      router.mark_alive(0)
      assert router.alive() == [0, 1, 2]
      with pytest.raises(KeyError):
        router.mark_alive(7)

  def test_spread_round_robins_the_hot_tenant(self, fronts):
    with self._router(fronts, spread=2) as router:
      targets = {router.predict("hot", self.OBS)[0] for _ in range(8)}
      assert targets == {float(i) for i in rendezvous_spread(
          "hot", range(3), k=2)}

  def test_dedup_short_circuits_repeats(self, fronts):
    with self._router(fronts, dedup_capacity=16) as router:
      router.predict("t", self.OBS)
      served = sum(f.calls for f in fronts.values())
      for _ in range(5):
        router.predict("t", self.OBS)
      assert sum(f.calls for f in fronts.values()) == served
      assert router.dedup_stats()["hits"] == 5

  def test_dedup_is_tenant_scoped(self, fronts):
    with self._router(fronts, dedup_capacity=16) as router:
      router.predict("tenant-a", self.OBS)
      before = sum(f.calls for f in fronts.values())
      router.predict("tenant-b", self.OBS)
      assert sum(f.calls for f in fronts.values()) == before + 1
      assert router.dedup_stats()["hits"] == 0
      router.predict("tenant-a", self.OBS)
      assert router.dedup_stats()["hits"] == 1

  def test_notify_published_invalidates_dedup(self, fronts):
    with self._router(fronts, dedup_capacity=16) as router:
      router.predict("t", self.OBS)
      for front in fronts.values():
        front.version = 7
      router.notify_published(7)
      served = sum(f.calls for f in fronts.values())
      router.predict("t", self.OBS)
      assert sum(f.calls for f in fronts.values()) == served + 1
      router.predict("t", self.OBS)
      assert sum(f.calls for f in fronts.values()) == served + 1
      assert router.params_version == 7

  def test_bad_arguments_raise(self, fronts):
    with pytest.raises(ValueError):
      ServingRouter({})
    with pytest.raises(ValueError):
      self._router(fronts, spread=0)


@pytest.mark.parametrize("spread", [1, 2])
def test_routed_replicas_equal_jax(spread):
  """Each package's router over its own three fake fronts: the same
  tenants in the same order land on the same replicas, before and after
  a replica dies (failover inside the call)."""
  sequences = []
  for router_module, rpc_module in ((jax_router, jax_rpc),
                                    (None, rpc_lib)):
    replicas = {i: _FakeFront(i, rpc_module) for i in range(3)}
    cls = (router_module.ServingRouter if router_module is not None
           else ServingRouter)
    router = cls({i: f.address for i, f in replicas.items()},
                 spread=spread)
    try:
      tenants = KEYS[:30] + ["hot"] * 6
      seq = [float(router.predict(t, {"x": np.zeros(2)})[0])
             for t in tenants]
      replicas[1].close()
      seq += [float(router.predict(t, {"x": np.zeros(2)})[0])
              for t in tenants]
      stats = router.stats()
      sequences.append((seq, stats["failovers"], stats["alive"]))
    finally:
      router.close()
      for front in replicas.values():
        front.close()
  assert sequences[0] == sequences[1]
  assert sequences[1][1] == 1 and sequences[1][2] == [0, 2]


def test_a_handshake_the_replica_cuts_fails_over():
  """A dying replica's listener can take a connection and reset it
  inside the transport handshake (an `AuthenticationError` from the
  reset): the router fails that replica over inside the call, as it does
  a refused connection. JAX's router catches only `TimeoutError` and
  `ConnectionError` there, so its caller gets the handshake error."""
  import socket
  import struct
  import threading

  listener = socket.socket()
  listener.bind(("127.0.0.1", 0))
  listener.listen(8)

  def reset_every_connection():
    while True:
      try:
        conn, _ = listener.accept()
      except OSError:
        return
      conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                      struct.pack("ii", 1, 0))
      conn.close()

  threading.Thread(target=reset_every_connection, daemon=True).start()
  front = _FakeFront(1)
  front.server.close(timeout_secs=0.2)
  front.server = rpc_lib.RpcServer(front._handle, transport="tcp")
  tenant = next(t for t in KEYS if rendezvous_choose(t, [0, 1]) == 0)
  router = ServingRouter({0: listener.getsockname(),
                          1: front.server.address}, transport="tcp",
                         connect_timeout_secs=2.0)
  try:
    assert float(router.predict(tenant, {"x": np.zeros(2)})[0]) == 1.0
    stats = router.stats()
    assert stats["failovers"] == 1 and stats["alive"] == [1]
  finally:
    router.close()
    front.close()
    listener.close()


class TestServingReplicaCrashFaults:

  def test_default_plan_classes_unchanged(self):
    assert faults.SERVING_REPLICA_CRASH not in faults.FAULT_CLASSES
    assert len(faults.FAULT_CLASSES) == 7
    assert faults.ALL_FAULT_CLASSES == (
        faults.FAULT_CLASSES + (faults.SERVING_REPLICA_CRASH,))

  def test_generate_requires_num_fronts(self):
    with pytest.raises(ValueError, match="num_fronts"):
      faults.FaultPlan.generate(
          seed=3, num_actors=2, classes=(faults.SERVING_REPLICA_CRASH,))

  def test_generate_targets_a_front(self):
    plan = faults.FaultPlan.generate(
        seed=3, num_actors=2, classes=(faults.SERVING_REPLICA_CRASH,),
        num_fronts=2)
    (event,) = plan.events
    assert event.fault == faults.SERVING_REPLICA_CRASH
    assert event.target in ("front-0", "front-1") and event.mode == "hard"
    again = faults.FaultPlan.generate(
        seed=3, num_actors=2, classes=(faults.SERVING_REPLICA_CRASH,),
        num_fronts=2)
    assert plan.digest() == again.digest()

  def test_on_serve_seam_fires_once_at_threshold(self):
    event = faults.FaultEvent(
        fault=faults.SERVING_REPLICA_CRASH, target="front-0", at=3)
    injector = faults.FaultInjector(
        faults.FaultPlan(seed=0, events=(event,)), "front-0")
    assert injector.on_serve(1) is None
    assert injector.on_serve(2) is None
    assert injector.on_serve(3) is event
    assert injector.on_serve(4) is None
    assert injector.injected[0]["fault"] == faults.SERVING_REPLICA_CRASH

  def test_on_serve_ignores_other_roles_and_later_incarnations(self):
    event = faults.FaultEvent(
        fault=faults.SERVING_REPLICA_CRASH, target="front-1", at=1)
    plan = faults.FaultPlan(seed=0, events=(event,))
    assert faults.FaultInjector(plan, "front-0").on_serve(100) is None
    respawned = faults.FaultInjector(plan, "front-1", incarnation=1)
    assert respawned.on_serve(100) is None


def test_a_respawned_front_fires_a_non_recurring_plan_only_in_jax():
  """JAX's `front_main` installs its injector without an incarnation,
  so each respawned JAX front arms a non-recurring
  `serving_replica_crash` again and dies at the same serve (a crash
  loop until the front restart budget shrinks the tier), against
  `faults.py`'s own rule that such events fire in a process's first
  incarnation only. The port's `front_main` takes the incarnation the
  orchestrator counts (ROADMAP Queue C)."""
  import inspect

  from tensor2robot_tpu.fleet import front as jax_front
  from tensor2robot_tpu_torch.fleet import front as port_front
  from tensor2robot_tpu_torch.fleet import orchestrator as port_orch

  assert "incarnation" not in inspect.signature(
      jax_front.front_main).parameters
  assert "incarnation" in inspect.signature(
      port_front.front_main).parameters
  assert "incarnation" in inspect.signature(
      port_orch.Fleet._spawn_front).parameters
  fired = []
  for module, incarnation in ((jax_faults, 0), (faults, 1)):
    event = module.FaultEvent(fault=module.SERVING_REPLICA_CRASH,
                              target="front-0", at=3, recurring=False)
    plan = module.FaultPlan(seed=0, events=(event,))
    # The second incarnation's injector, as each package's front builds it.
    injector = module.FaultInjector(plan, "front-0", incarnation=incarnation)
    fired.append([i for i in range(1, 10)
                  if injector.on_serve(i) is not None])
  assert fired == [[3], []]


@pytest.mark.parametrize("seed", [3, 11, 2024])
def test_on_serve_fires_at_jax_serve_index(seed):
  fired = []
  for module in (jax_faults, faults):
    plan = module.FaultPlan.generate(
        seed=seed, num_actors=2, classes=(module.SERVING_REPLICA_CRASH,),
        num_fronts=3)
    (event,) = plan.events
    injector = module.FaultInjector(plan, event.target)
    hits = [i for i in range(1, 40) if injector.on_serve(i) is not None]
    fired.append((plan.digest(), event.target, hits))
  assert fired[0] == fired[1]
  assert len(fired[1][2]) == 1
