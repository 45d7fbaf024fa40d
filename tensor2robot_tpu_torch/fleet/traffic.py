"""Router traffic against a fleet's front replicas: the callers its
serving tier answers.

    python -m tensor2robot_tpu_torch.fleet.traffic --model_dir DIR \
        --gin_configs tensor2robot_tpu/research/qtopt/configs/X.gin \
        [--gin_bindings B]... [--import_modules M]... \
        [--robots policy,batch] [--ramp policy]

Parses the configs with the trainer binary's own `parse_configs` and
runs the fleet through `Fleet.run` (the lifecycle `run_fleet`, and so
`run_t2r_trainer --trainer=fleet`, runs: the launch gate, supervision,
the shutdown barrier; the result goes to `<model_dir>/fleet_result.json`
through the same `write_result`), with a `FleetTraffic` attached. Once
the fleet's fronts answer, it sends single-observation `predict`s
through `serving.router.ServingRouter`s until the run ends. Actors act
against the serving hosts only; the fronts' traffic is these callers'.
Two kinds of caller, per tenant:

  * robots (`robots`): one per actor of the config (`num_actors`), each
    a robot on a `ROBOT_TICK_HZ` control tick with a router of its own,
    the robots phased evenly over the tick. They replay one frame
    sequence, so a frame reaches the front again from the next robot's
    router a fraction of a tick later, within one publication (a
    speculative front then serves its refinement; a robot's own repeats
    would be its router's dedup hits).
  * a ramp (`ramp`), as `bench.py --control` drives its front tier:
    calibrated through a router first (the closed-loop p50 of single
    requests, then the completions per second of a burst by
    `2 × serve_max_batch` closed-loop callers, which fills the front's
    batches), then open-loop Poisson arrivals at `RAMP_FRACTIONS` of
    that capacity, `RAMP_PHASE_SECS` each, the last held until the run
    ends. A pool of workers drains the arrivals, as many as hold
    `SLO_MULTIPLE` × the front's SLO of work at that capacity (Little's
    law): past the capacity a request then waits about that long at the
    front, where its `request_ms` p95 (the control rules' metric) sees
    it. No more than that: a front drowned in handler threads also
    stalls the orchestrator's telemetry polls, which the rules read
    (256 in flight stalled one for 37 s on the card). A caller's latency
    runs from the arrival's due time.

Every router follows the fleet's front membership through
`Fleet.add_front_observer` (`mark_alive` on a respawn or a scale-up,
`mark_dead` on a loss or a scale-down). With the config's
`dedup_capacity` each caches actions per observation and params
version; a `PublicationFollower` tells them of each publication.

What the callers saw goes to `<model_dir>/traffic.json`: per tenant the
requests offered, answered, shed by a replica's admission (an
`RpcError` from a live replica), failed, cut by the fleet's shutdown
(callers stop when `Fleet.closed` turns true), and the latency
quantiles; the latency of the requests during which a router failed
over; the ramp's
calibration and phases; the routers' stats; the membership events; the
final actor and front counts (from the result's scale events) and each
front's time to ready.

The process that runs this builds the observation spec on the CPU and
sends numpy only: it opens no CUDA context, like the orchestrator it
hosts.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import random
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch.fleet import orchestrator as orch
from tensor2robot_tpu_torch.fleet import rpc as rpc_lib
from tensor2robot_tpu_torch.fleet.host import _client_kwargs
from tensor2robot_tpu_torch.serving.router import ServingRouter

log = logging.getLogger(__name__)

TRAFFIC_FILENAME = "traffic.json"
ROBOT_TICK_HZ = 10.0  # a robot's control tick (100 ms)
RAMP_FRACTIONS = (0.3, 0.8, 1.6)  # of the calibrated capacity
RAMP_PHASE_SECS = 2.0
SLO_MULTIPLE = 3.0
MAX_IN_FLIGHT = 256  # `AdmissionController`'s default `max_queue`
_CALIBRATION_SAMPLES = 20
_BURST_SECS = 2.0


def observation_pool(config, size: int = 256,
                     seed: int = 0) -> List[Dict[str, np.ndarray]]:
  """`size` single-observation requests (flat numpy dicts) drawn from
  the fleet model's observation spec, built on the CPU."""
  from tensor2robot_tpu_torch.fleet.host import _build_learner
  from tensor2robot_tpu_torch.specs import make_random_tensors
  spec = _build_learner(config, device="cpu").observation_specification()
  return [{key: np.asarray(value) for key, value in make_random_tensors(
      spec, batch_size=1, seed=seed + i).to_flat_dict().items()}
          for i in range(size)]


def _quantiles(values: Sequence[float]) -> Dict[str, Any]:
  if not values:
    return {"n": 0}
  ordered = sorted(values)
  return {"n": len(ordered),
          "p50": ordered[len(ordered) // 2],
          "p95": ordered[min(len(ordered) - 1, int(len(ordered) * 0.95))],
          "max": ordered[-1]}


class _Tally:
  """What one tenant's callers saw. A request that fails after `ended`
  is set (the fleet began its shutdown under it) is counted as cut, not
  as an error."""

  def __init__(self, ended: Optional[threading.Event] = None):
    self.lock = threading.Lock()
    self.ended = ended
    self.offered = 0
    self.latency_ms: List[float] = []
    self.failover_ms: List[float] = []
    self.shed = 0
    self.cut = 0
    self.errors: List[str] = []
    self.nonfinite = 0

  def call(self, router: ServingRouter, tenant: str,
           features: Dict[str, np.ndarray],
           t_due: Optional[float] = None) -> Optional[float]:
    """One routed request; returns its latency in ms (from `t_due`, a
    `perf_counter` time, when given) or None if it was not answered."""
    with self.lock:
      self.offered += 1
    failovers = router.stats()["failovers"]
    t0 = time.perf_counter() if t_due is None else t_due
    try:
      action = np.asarray(router.predict(tenant, features))
    except rpc_lib.RpcError:
      # A live replica refused it (its admission shed the request).
      with self.lock:
        self.shed += 1
      return None
    except Exception as e:  # noqa: BLE001 — counted, the load goes on
      with self.lock:
        if self.ended is not None and self.ended.is_set():
          self.cut += 1
        else:
          self.errors.append(repr(e))
      return None
    ms = (time.perf_counter() - t0) * 1e3
    failed_over = router.stats()["failovers"] > failovers
    with self.lock:
      self.latency_ms.append(ms)
      if failed_over:
        self.failover_ms.append(ms)
      if action.size == 0 or not np.all(np.isfinite(action)):
        self.nonfinite += 1
    return ms

  def stats(self) -> Dict[str, Any]:
    with self.lock:
      return {"offered": self.offered,
              "answered": len(self.latency_ms),
              "shed": self.shed,
              "cut": self.cut,
              "errors": len(self.errors),
              "first_errors": self.errors[:3],
              "nonfinite": self.nonfinite,
              "latency_ms": _quantiles(self.latency_ms)}


def _robot(router: ServingRouter, tenant: str, tally: _Tally,
           observations: Sequence[Dict[str, np.ndarray]], t0: float,
           hz: float, stop: threading.Event) -> None:
  """One robot: tick k (at `t0 + k / hz`) sends frame k of the pool; a
  tick that a slow answer overran is skipped, as a control loop skips
  it."""
  tick = 0
  while not stop.is_set():
    due = t0 + tick / hz
    if stop.wait(max(0.0, due - time.perf_counter())):
      return
    tally.call(router, tenant, observations[tick % len(observations)])
    tick = max(tick + 1, int((time.perf_counter() - t0) * hz) + 1)


def calibrate(router: ServingRouter, tenant: str,
              features: Dict[str, np.ndarray], burst_callers: int,
              samples: int = _CALIBRATION_SAMPLES,
              burst_secs: float = _BURST_SECS) -> Dict[str, float]:
  """One replica's capacity through `router`, as `bench.py --control`
  takes it: the closed-loop p50 of single requests (after 3 warm ones)
  and the completions per second of `burst_callers` closed-loop callers
  over `burst_secs`. Shed or failed requests do not count as
  completions."""
  for _ in range(3):
    router.predict(tenant, features)
  ms = []
  for _ in range(samples):
    t0 = time.perf_counter()
    router.predict(tenant, features)
    ms.append((time.perf_counter() - t0) * 1e3)
  p50 = float(np.percentile(ms, 50))
  counts = [0] * burst_callers
  stop_at = time.perf_counter() + burst_secs

  def burst(slot: int) -> None:
    while time.perf_counter() < stop_at:
      try:
        router.predict(tenant, features)
      except Exception:  # noqa: BLE001 — not a completion
        continue
      counts[slot] += 1

  threads = [threading.Thread(target=burst, args=(slot,), daemon=True)
             for slot in range(burst_callers)]
  t0 = time.perf_counter()
  for thread in threads:
    thread.start()
  for thread in threads:
    thread.join()
  wall = time.perf_counter() - t0
  return {"closed_loop_p50_ms": p50,
          "sequential_rps": 1e3 / p50,
          "burst_callers": burst_callers,
          "capacity_rps": max(1.0, sum(counts) / wall)}


class _Ramp:
  """Open-loop Poisson arrivals whose rate steps through `rates`
  (`(rps, seconds)` pairs, the last held), drained by `workers` threads
  through one router."""

  def __init__(self, router: ServingRouter, tenant: str, tally: _Tally,
               observations: Sequence[Dict[str, np.ndarray]],
               rates: Sequence[Tuple[float, float]], workers: int,
               seed: int = 0):
    self._router = router
    self._tenant = tenant
    self._tally = tally
    self._observations = observations
    self._rates = list(rates)
    self._rng = random.Random(seed)
    self._lock = threading.Lock()
    self._t = 0.0  # the last arrival, s after `_t0`
    self._n = 0
    self._t0 = time.perf_counter()
    self._workers = workers
    self._phase_ms: List[List[float]] = [[] for _ in self._rates]
    self._phase_offered = [0] * len(self._rates)

  def _phase(self, t: float) -> int:
    end = 0.0
    for i, (_, secs) in enumerate(self._rates[:-1]):
      end += secs
      if t < end:
        return i
    return len(self._rates) - 1

  def _next(self) -> Tuple[float, int, int]:
    with self._lock:
      self._t += self._rng.expovariate(self._rates[self._phase(self._t)][0])
      self._n += 1
      phase = self._phase(self._t)
      self._phase_offered[phase] += 1
      return self._t0 + self._t, self._n, phase

  def run(self, stop: threading.Event) -> None:
    def worker() -> None:
      while not stop.is_set():
        due, n, phase = self._next()
        if stop.wait(max(0.0, due - time.perf_counter())):
          return
        ms = self._tally.call(
            self._router, self._tenant,
            self._observations[n % len(self._observations)], t_due=due)
        if ms is not None:
          with self._lock:
            self._phase_ms[phase].append(ms)

    threads = [threading.Thread(target=worker, daemon=True,
                                name=f"ramp-{self._tenant}-{i}")
               for i in range(self._workers)]
    for thread in threads:
      thread.start()
    for thread in threads:
      thread.join()

  def stats(self) -> List[Dict[str, Any]]:
    with self._lock:
      return [{"offered_rps": rps, "secs": secs,
               "offered": self._phase_offered[i],
               "latency_ms": _quantiles(self._phase_ms[i])}
              for i, (rps, secs) in enumerate(self._rates)]


def _front_ready_secs(config, addresses: Dict[int, Tuple[str, int]]
                      ) -> Dict[str, Optional[float]]:
  """Each live front's build-to-ready seconds, from its `hello`."""
  out = {}
  for index, address in sorted(addresses.items()):
    client = rpc_lib.RpcClient(address, **_client_kwargs(config))
    try:
      out[f"front{index}"] = client.call("hello").get("ready_secs")
    finally:
      client.close()
  return out


class PublicationFollower:
  """Keeps routers' dedup caches publish-aware: polls one live front's
  `hello` every `interval_secs` and hands its params version to each
  router's `notify_published` (a router learns versions only from
  replies, and a cache that answers every request hears none)."""

  def __init__(self, routers: Sequence[ServingRouter], config,
               addresses_fn, interval_secs: float = 0.5):
    self._routers = list(routers)
    self._config = config
    self._addresses_fn = addresses_fn
    self._interval = float(interval_secs)
    self._stop = threading.Event()
    self._thread = threading.Thread(target=self._run,
                                    name="publication-follower",
                                    daemon=True)

  def start(self) -> "PublicationFollower":
    self._thread.start()
    return self

  def _run(self) -> None:
    client, index = None, None
    while not self._stop.wait(self._interval):
      alive = self._routers[0].alive()
      addresses = self._addresses_fn()
      try:
        if client is None or index not in alive:
          if client is not None:
            client.close()
          client = None
          index = next(i for i in alive if i in addresses)
          client = rpc_lib.RpcClient(
              addresses[index], connect_timeout_secs=5.0,
              call_timeout_secs=10.0, max_retries=0,
              **_client_kwargs(self._config))
        version = int(client.call("hello")["params_version"])
        for router in self._routers:
          router.notify_published(version)
      except Exception:  # noqa: BLE001 — a dying front; retry next tick
        if client is not None:
          client.close()
        client = None
    if client is not None:
      client.close()

  def stop(self) -> None:
    self._stop.set()
    self._thread.join(timeout=30.0)


class FleetTraffic:
  """Callers attached to one `Fleet` for the length of its run:

      with FleetTraffic(fleet, config, robots=("policy",)) as traffic:
        result = fleet.run()
      seen = traffic.stats(result)

  Registers a front observer at entry, then waits on a thread of its
  own for the fleet's fronts to answer and starts the callers; exit
  stops them. Each robot and the ramp hold their own router."""

  def __init__(self, fleet: orch.Fleet, config,
               robots: Sequence[str] = (), ramp: Sequence[str] = (),
               observations: Optional[Sequence[Dict[str, Any]]] = None):
    overlap = set(robots) & set(ramp)
    if overlap:
      raise ValueError(f"tenants {sorted(overlap)} are both robots and "
                       f"ramped")
    self._fleet = fleet
    self._config = config
    self._robots = tuple(robots)
    self._ramp_tenants = tuple(ramp)
    if observations is None:
      observations = observation_pool(config) if robots or ramp else ()
    self._observations = list(observations)
    self._lock = threading.Lock()
    self._stop = threading.Event()
    self._t0 = time.monotonic()
    self._routers: List[ServingRouter] = []
    self._tallies = {t: _Tally(self._stop)
                     for t in self._robots + self._ramp_tenants}
    self._threads: List[threading.Thread] = []
    self._ramps: Dict[str, _Ramp] = {}
    self._calibration: Dict[str, Dict[str, float]] = {}
    self._events: List[Dict[str, Any]] = []
    self._ready_at_launch: Dict[str, Optional[float]] = {}
    self._follower: Optional[PublicationFollower] = None
    self._errors: List[str] = []
    self._starter = threading.Thread(target=self._start,
                                     name="fleet-traffic", daemon=True)

  def __enter__(self) -> "FleetTraffic":
    self._fleet.add_front_observer(self._observe)
    if self._tallies:
      self._starter.start()
    return self

  def __exit__(self, *exc_info) -> None:
    self.stop()

  def _router(self) -> ServingRouter:
    config = self._config
    return ServingRouter(
        self._fleet.front_addresses, authkey=config.authkey,
        transport=config.transport, spread=config.front_spread,
        dedup_capacity=config.dedup_capacity,
        connect_timeout_secs=5.0,
        call_timeout_secs=config.rpc_call_timeout_secs,
        sndbuf=config.tcp_sndbuf, rcvbuf=config.tcp_rcvbuf)

  def _observe(self, event: str, index: int, address: Any) -> None:
    with self._lock:
      self._events.append({"event": event, "index": index,
                           "t": round(time.monotonic() - self._t0, 3)})
      routers = list(self._routers)
    for router in routers:
      if event in ("respawned", "added"):
        router.mark_alive(index, address)
      else:
        router.mark_dead(index)

  def _start(self) -> None:
    deadline = time.monotonic() + self._config.launch_timeout_secs
    while not self._fleet.front_addresses:
      if self._stop.wait(0.1):
        return
      if time.monotonic() > deadline:
        self._errors.append("no front address within the launch timeout")
        return
    config = self._config
    try:
      self._ready_at_launch = _front_ready_secs(
          config, self._fleet.front_addresses)
    except Exception as e:  # noqa: BLE001 — reported, the run goes on
      self._errors.append(f"hello: {e!r}")
      return
    robots_per_tenant = max(1, int(config.num_actors))
    with self._lock:
      if self._stop.is_set():
        return
      # Built under the observer's lock: no membership event falls
      # between a router's address map and its first `_observe`.
      robots = {t: [self._router() for _ in range(robots_per_tenant)]
                for t in self._robots}
      ramp_routers = {t: self._router() for t in self._ramp_tenants}
      self._routers = ([r for rs in robots.values() for r in rs]
                       + list(ramp_routers.values()))
      if config.dedup_capacity:
        self._follower = PublicationFollower(
            self._routers, config, lambda: self._fleet.front_addresses
        ).start()
    t0 = time.perf_counter()
    for tenant, routers in robots.items():
      for i, router in enumerate(routers):
        self._spawn(_robot, router, tenant, self._tallies[tenant],
                    self._observations,
                    t0 + i / (ROBOT_TICK_HZ * len(routers)),
                    ROBOT_TICK_HZ, self._stop)
    for i, (tenant, router) in enumerate(ramp_routers.items()):
      self._spawn(self._run_ramp, tenant, router, i)
    # The callers stop as the fleet begins its shutdown (its fronts are
    # stopped after its actors drain).
    while not self._stop.wait(0.05):
      if self._fleet.closed:
        self._stop.set()

  def _spawn(self, target: Callable[..., None], *args: Any) -> None:
    thread = threading.Thread(target=target, args=args, daemon=True)
    with self._lock:
      if self._stop.is_set():
        return
      self._threads.append(thread)
    thread.start()

  def _run_ramp(self, tenant: str, router: ServingRouter,
                seed: int) -> None:
    features = self._observations[0]
    try:
      calibration = calibrate(
          router, tenant, features,
          burst_callers=2 * self._config.serve_max_batch,
          samples=_CALIBRATION_SAMPLES, burst_secs=_BURST_SECS)
    except Exception as e:  # noqa: BLE001 — reported, the run goes on
      self._errors.append(f"calibrate {tenant}: {e!r}")
      return
    capacity = calibration["capacity_rps"]
    calibration["in_flight"] = workers = int(min(MAX_IN_FLIGHT, max(
        calibration["burst_callers"], math.ceil(
            SLO_MULTIPLE * self._config.front_slo_ms / 1e3 * capacity))))
    ramp = _Ramp(router, tenant, self._tallies[tenant], self._observations,
                 [(f * capacity, RAMP_PHASE_SECS) for f in RAMP_FRACTIONS],
                 workers=workers, seed=seed)
    with self._lock:
      self._calibration[tenant] = calibration
      self._ramps[tenant] = ramp
    ramp.run(self._stop)

  def stop(self, timeout_secs: float = 60.0) -> None:
    self._stop.set()
    if self._starter.is_alive():
      self._starter.join(timeout=timeout_secs)
    with self._lock:
      threads = list(self._threads)
    for thread in threads:
      thread.join(timeout=timeout_secs)
    with self._lock:
      follower, self._follower = self._follower, None
    if follower is not None:
      follower.stop()

  def stats(self, result: Optional[orch.FleetResult] = None
            ) -> Dict[str, Any]:
    """What the callers saw; with the fleet's `result`, the final actor
    and front counts (its scale events applied to the config's) and
    each final front's time to ready."""
    with self._lock:
      routers = list(self._routers)
      out: Dict[str, Any] = {
          "tenants": {t: tally.stats()
                      for t, tally in self._tallies.items()},
          "robots_per_tenant": (max(1, int(self._config.num_actors))
                                if self._robots else 0),
          "robot_tick_hz": ROBOT_TICK_HZ,
          "calibration": dict(self._calibration),
          "ramp": {t: ramp.stats() for t, ramp in self._ramps.items()},
          "membership_events": list(self._events),
          "front_ready_secs_at_launch": dict(self._ready_at_launch),
          "errors": list(self._errors),
      }
    failover: List[float] = []
    for tally in self._tallies.values():
      with tally.lock:
        failover.extend(tally.failover_ms)
    out["failover_latency_ms"] = _quantiles(failover)
    stats = [r.stats() for r in routers]
    dedup = [s["dedup"] for s in stats if s["dedup"]]
    out["router"] = {
        "routers": len(stats),
        "requests": sum(s["requests"] for s in stats),
        "failovers": sum(s["failovers"] for s in stats),
        "shed": sum(s["shed"] for s in stats),
        "alive": stats[0]["alive"] if stats else [],
        "params_version": max((s["params_version"] for s in stats),
                              default=0),
        "dedup": ({k: sum(d.get(k, 0) for d in dedup) for k in dedup[0]}
                  if dedup else None)}
    if result is not None:
      events = [e["action"] for e in result.scale_events]
      out["num_actors"] = (self._config.num_actors + events.count("add")
                           - events.count("remove"))
      out["num_fronts"] = (self._config.front_hosts
                           + events.count("add_front")
                           - events.count("remove_front"))
      out["front_ready_secs"] = {
          f"front{front['front_index']}": front.get("ready_secs")
          for front in result.metrics.get("front_hosts") or ()}
    return out

  def close(self) -> None:
    self.stop()
    with self._lock:
      routers, self._routers = self._routers, []
    for router in routers:
      router.close()


def drive_fleet(model_dir: str,
                config: Optional[orch.FleetConfig] = None,
                gin_configs: Sequence[str] = (),
                robots: Sequence[str] = (),
                ramp: Sequence[str] = ()
                ) -> Tuple[orch.FleetResult, Dict[str, Any]]:
  """`run_fleet` with a `FleetTraffic` attached: runs one fleet through
  `Fleet.run`, with `robots` and `ramp` tenants' callers while it runs;
  writes `fleet_result.json` and `traffic.json` under `model_dir` and
  returns both."""
  config = config or orch.FleetConfig()
  fleet = orch.Fleet(config, model_dir, gin_configs=gin_configs)
  os.makedirs(model_dir, exist_ok=True)
  traffic = FleetTraffic(fleet, config, robots=robots, ramp=ramp)
  try:
    with traffic:
      result = fleet.run()
    orch.write_result(result, model_dir)
    seen = traffic.stats(result)
  finally:
    traffic.close()
  with open(os.path.join(model_dir, TRAFFIC_FILENAME), "w") as f:
    json.dump(seen, f, default=orch._jsonable)
  return result, seen


def _tenants(value: str) -> List[str]:
  return [t for t in value.split(",") if t]


def parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(
      prog="python -m tensor2robot_tpu_torch.fleet.traffic",
      description="Runs a gin-configured fleet with router traffic on its "
                  "front replicas.")
  p.add_argument("--model_dir", required=True)
  p.add_argument("--gin_configs", action="append", default=[],
                 help="Gin config file; repeatable, comma lists allowed.")
  p.add_argument("--gin_bindings", action="append", default=[],
                 help="One gin binding string; repeatable.")
  p.add_argument("--import_modules", action="append", default=[],
                 help="Extra module to import before parsing; repeatable.")
  p.add_argument("--robots", type=_tenants, default=[],
                 help="Comma list of tenants whose callers are robots "
                      "(one per actor of the config, at a 10 Hz tick).")
  p.add_argument("--ramp", type=_tenants, default=[],
                 help="Comma list of tenants driven by a calibrated "
                      "open-loop ramp past one replica's capacity.")
  return p


def main(argv: Optional[Sequence[str]] = None) -> int:
  from tensor2robot_tpu_torch.bin import run_t2r_trainer

  args = parser().parse_args(argv)
  configs = run_t2r_trainer.parse_configs(
      args.gin_configs, args.gin_bindings, args.import_modules)
  result, seen = drive_fleet(
      args.model_dir, orch.FleetConfig(), gin_configs=configs,
      robots=args.robots, ramp=args.ramp)
  print(json.dumps({"publishes": result.publishes,
                    "recoveries": result.recoveries,
                    "scale_events": result.scale_events,
                    "traffic": seen}, default=orch._jsonable),
        flush=True)
  return 0


if __name__ == "__main__":
  logging.basicConfig(level=logging.INFO,
                      format="%(asctime)s %(name)s: %(message)s")
  sys.exit(main())
