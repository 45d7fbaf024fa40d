"""The fleet's router callers (`fleet/traffic.py`) on the CPU, against
in-process fake fronts (loopback `RpcServer`s speaking the front's
`predict` and `hello`): no fleet, no process.

  * A request's outcome: answered (finite or not), shed by a live
    replica's admission (an `RpcError`), or failed.
  * Robots: each sends the pool's frames in order on its tick, the
    robots phased over the tick; a tick a slow answer overran is
    skipped.
  * The ramp: the calibration's p50 and burst capacity; arrivals step
    through the phases' rates, the last held.
  * `FleetTraffic` on a fake fleet: it waits for the fronts' addresses,
    builds one router per robot and one for the ramp, follows the
    membership events, stops with the run, and reads the final actor
    and front counts from the result's scale events.
  * The CLI parses its configs with the trainer binary's `parse_configs`.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensor2robot_tpu_torch import config as port_gin  # noqa: E402
from tensor2robot_tpu_torch.bin import run_t2r_trainer  # noqa: E402
from tensor2robot_tpu_torch.fleet import orchestrator as orch  # noqa: E402
from tensor2robot_tpu_torch.fleet import rpc as rpc_lib  # noqa: E402
from tensor2robot_tpu_torch.fleet import traffic  # noqa: E402

OBS = [{"img": np.full((2, 2), i, np.float32)} for i in range(8)]


class _FakeRouter:
  """`ServingRouter`'s caller surface, answering from a script."""

  def __init__(self, outcome=None, delay_secs=0.0, serial=False):
    self.outcome = outcome
    self.delay = delay_secs
    self.sent = []
    self.failovers = 0
    self._lock = threading.Lock()
    self._serial = threading.Lock() if serial else None

  def predict(self, tenant, features):
    if self._serial is not None:
      with self._serial:
        time.sleep(self.delay)
    elif self.delay:
      time.sleep(self.delay)
    with self._lock:
      self.sent.append((tenant, float(features["img"][0, 0]),
                        time.perf_counter()))
    if isinstance(self.outcome, BaseException):
      raise self.outcome
    if self.outcome == "failover":
      self.failovers += 1
    if self.outcome == "nan":
      return np.array([np.nan, 0.0])
    return np.zeros(2)

  def stats(self):
    return {"failovers": self.failovers}


@pytest.mark.parametrize("outcome, key", [
    (None, "answered"), ("nan", "nonfinite"),
    (rpc_lib.RpcError("request shed"), "shed"),
    (ConnectionError("gone"), "errors")])
def test_a_request_is_answered_shed_or_failed(outcome, key):
  tally = traffic._Tally()
  ms = tally.call(_FakeRouter(outcome), "policy", OBS[0])
  stats = tally.stats()
  assert stats["offered"] == 1
  assert stats[key] == 1
  assert (ms is None) == (key in ("shed", "errors"))
  others = {"answered", "shed", "errors"} - {key}
  if key == "nonfinite":
    others -= {"answered"}
  assert all(stats[k] == 0 for k in others)


def test_a_failover_latency_is_kept_beside_the_answer():
  tally = traffic._Tally()
  assert tally.call(_FakeRouter("failover"), "policy", OBS[0]) is not None
  assert len(tally.failover_ms) == 1 and tally.stats()["answered"] == 1


def test_robots_send_the_pool_in_order_phased_over_the_tick():
  router = _FakeRouter()
  stop = threading.Event()
  tally = traffic._Tally()
  hz, robots = 20.0, 2
  t0 = time.perf_counter()
  threads = [threading.Thread(target=traffic._robot, args=(
      router, "policy", tally, OBS, t0 + i / (hz * robots), hz, stop))
             for i in range(robots)]
  for thread in threads:
    thread.start()
  time.sleep(0.32)
  stop.set()
  for thread in threads:
    thread.join()
  frames = [f for _, f, _ in router.sent]
  # Frame k goes out at tick k from each robot, the second half a tick
  # after the first: each frame is sent twice in a row.
  assert len(frames) >= 10
  pairs = frames[:len(frames) // 2 * 2]
  assert pairs[0::2] == pairs[1::2] == [float(i % len(OBS)) for i in
                                        range(len(pairs) // 2)]
  assert tally.stats()["answered"] == len(frames)


def test_a_robot_skips_the_ticks_a_slow_answer_overran():
  router = _FakeRouter(delay_secs=0.12)
  stop = threading.Event()
  thread = threading.Thread(target=traffic._robot, args=(
      router, "policy", traffic._Tally(), OBS, time.perf_counter(), 20.0,
      stop))
  thread.start()
  time.sleep(0.45)
  stop.set()
  thread.join()
  frames = [int(f) for _, f, _ in router.sent]
  # 120 ms answers on a 50 ms tick: ticks 0, 3, 6, ... (two skipped).
  assert frames[:3] == [0, 3, 6]


def test_calibrate_reads_the_p50_and_the_burst_capacity():
  # One request at a time, 5 ms each: ~200 completions a second however
  # many callers.
  router = _FakeRouter(delay_secs=0.005, serial=True)
  out = traffic.calibrate(router, "policy", OBS[0], burst_callers=4,
                          samples=5, burst_secs=0.4)
  assert set(out) == {"closed_loop_p50_ms", "sequential_rps",
                      "burst_callers", "capacity_rps"}
  assert 5.0 <= out["closed_loop_p50_ms"] < 50.0
  assert out["sequential_rps"] == pytest.approx(
      1e3 / out["closed_loop_p50_ms"])
  assert out["burst_callers"] == 4
  assert 20.0 < out["capacity_rps"] <= 210.0


def test_the_ramp_steps_through_its_rates_and_holds_the_last():
  ramp = traffic._Ramp(_FakeRouter(), "policy", traffic._Tally(), OBS,
                       [(100.0, 0.5), (200.0, 1.0), (400.0, 1.0)],
                       workers=4)
  assert [ramp._phase(t) for t in (0.0, 0.49, 0.5, 1.49, 1.5, 100.0)] == [
      0, 0, 1, 1, 2, 2]
  stop = threading.Event()
  thread = threading.Thread(target=ramp.run, args=(stop,))
  thread.start()
  time.sleep(0.4)
  stop.set()
  thread.join()
  (first, second, third) = ramp.stats()
  # ~40 Poisson arrivals at 100/s in 0.4 s. Each worker draws its next
  # arrival before it waits for it: at most one a worker is drawn and
  # never sent.
  assert 10 <= first["offered"] <= 80
  assert second["offered"] <= 4 and third["offered"] == 0
  assert first["offered_rps"] == 100.0 and third["offered_rps"] == 400.0
  tally = ramp._tally.stats()
  assert tally["answered"] == tally["offered"]
  assert 0 <= first["offered"] + second["offered"] - tally["offered"] <= 4
  assert (first["latency_ms"]["n"] + second["latency_ms"].get("n", 0)
          == tally["answered"])


class _Front:
  """A loopback front: `hello` and `predict`."""

  def __init__(self, index, config):
    self.index = index
    self.calls = 0
    self.server = rpc_lib.RpcServer(self._handle, authkey=config.authkey,
                                    transport=config.transport)
    self.address = self.server.address

  def _handle(self, method, payload, ctx):
    if method == "predict":
      self.calls += 1
      return {"action": np.array([float(self.index)]),
              "params_version": 0, "front_index": self.index}
    if method == "hello":
      return {"ready_secs": 1.5, "params_version": 0}
    if method == rpc_lib.DISCONNECT_METHOD:
      return None
    raise ValueError(method)

  def close(self):
    self.server.close(timeout_secs=0.2)


class _FakeFleet:
  def __init__(self):
    self.front_addresses = {}
    self.observers = []
    self.closed = False

  def add_front_observer(self, fn):
    self.observers.append(fn)


def test_fleet_traffic_on_a_fake_fleet(monkeypatch):
  monkeypatch.setattr(traffic, "RAMP_PHASE_SECS", 0.2)
  monkeypatch.setattr(traffic, "MAX_IN_FLIGHT", 4)
  monkeypatch.setattr(traffic, "_BURST_SECS", 0.2)
  monkeypatch.setattr(traffic, "_CALIBRATION_SAMPLES", 3)
  fleet = _FakeFleet()
  config = orch.FleetConfig(num_actors=3, front_hosts=2,
                            front_tenants=("policy", "batch"),
                            serve_max_batch=2, dedup_capacity=0,
                            device="cpu")
  fronts = {i: _Front(i, config) for i in range(2)}
  load = traffic.FleetTraffic(fleet, config, robots=("batch",),
                              ramp=("policy",), observations=OBS)
  try:
    with load:
      assert len(fleet.observers) == 1
      time.sleep(0.2)  # no fronts yet: nothing is sent
      assert sum(f.calls for f in fronts.values()) == 0
      fleet.front_addresses = {i: f.address for i, f in fronts.items()}
      time.sleep(1.2)
      (observer,) = fleet.observers
      observer("lost", 1, None)
      time.sleep(0.3)
    calls = {i: f.calls for i, f in fronts.items()}
    time.sleep(0.2)
    assert {i: f.calls for i, f in fronts.items()} == calls  # stopped
    result = SimpleNamespace(
        scale_events=[{"action": "add_front", "index": 2},
                      {"action": "remove"}],
        metrics={"front_hosts": [{"front_index": 0, "ready_secs": 1.0}]})
    seen = load.stats(result)
  finally:
    load.close()
    for front in fronts.values():
      front.close()
  assert seen["errors"] == []
  assert seen["robots_per_tenant"] == 3 and seen["router"]["routers"] == 4
  assert seen["router"]["alive"] == [0]
  assert seen["membership_events"][0]["event"] == "lost"
  assert seen["front_ready_secs_at_launch"] == {"front0": 1.5,
                                                "front1": 1.5}
  assert seen["front_ready_secs"] == {"front0": 1.0}
  assert (seen["num_actors"], seen["num_fronts"]) == (2, 3)
  for tenant in ("policy", "batch"):
    stats = seen["tenants"][tenant]
    assert stats["answered"] == stats["offered"] > 0
    assert stats["errors"] == 0 and stats["shed"] == 0
  assert set(seen["calibration"]["policy"]) >= {"closed_loop_p50_ms",
                                                "capacity_rps"}
  # 3 × the SLO's worth of work at the capacity, capped (here at 4).
  assert seen["calibration"]["policy"]["in_flight"] == 4
  phases = seen["ramp"]["policy"]
  capacity = seen["calibration"]["policy"]["capacity_rps"]
  assert [p["offered_rps"] for p in phases] == pytest.approx(
      [f * capacity for f in traffic.RAMP_FRACTIONS])


def test_a_tenant_is_robots_or_ramped_not_both():
  with pytest.raises(ValueError, match="both robots and ramped"):
    traffic.FleetTraffic(_FakeFleet(), orch.FleetConfig(device="cpu"),
                         robots=("policy",), ramp=("policy",),
                         observations=OBS)


def test_the_cli_parses_with_the_binarys_parse(monkeypatch):
  calls = {}

  def drive(model_dir, config, gin_configs, robots, ramp):
    calls.update(model_dir=model_dir, configs=list(gin_configs),
                 robots=robots, ramp=ramp,
                 publish=config.publish_every_steps)
    return SimpleNamespace(publishes=0, recoveries=[], scale_events=[]), {}

  parsed = []
  real = run_t2r_trainer.parse_configs

  def parse(*args):
    parsed.append(args)
    return real(*args)

  monkeypatch.setattr(traffic, "drive_fleet", drive)
  monkeypatch.setattr(run_t2r_trainer, "parse_configs", parse)
  gin_file = ("tensor2robot_tpu/research/qtopt/configs/"
              "qtopt_serving_replicated.gin")
  port_gin.clear_config()
  try:
    assert traffic.main([
        "--model_dir", "/nonexistent", "--gin_configs", gin_file,
        "--gin_bindings", "FleetConfig.publish_every_steps = 7",
        "--robots", "policy", "--ramp", "batch,other"]) == 0
  finally:
    port_gin.clear_config()
  assert len(parsed) == 1
  assert calls == {"model_dir": "/nonexistent", "configs": [gin_file],
                   "robots": ["policy"], "ramp": ["batch", "other"],
                   "publish": 7}
