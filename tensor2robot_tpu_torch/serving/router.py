"""The replicated-tier router (port of `serving/router.py`): tenant
placement over N serving-front replicas, with caller-side failover and
dedup.

The router is a client-side library: a request goes straight from the
caller to the owning front replica, so routing adds a hash and a dict
lookup to the data path, never a network hop.

Placement is rendezvous hashing over the live replica set, the rule
(`replay.sampler.rendezvous_spread`) that homes actors on replay shards:

  * each tenant homes on its HRW winner, so arena budgets shard across
    hosts with no placement table;
  * a hot tenant spreads over its top-`spread` replicas (requests
    round-robin across them);
  * on a replica death only the dead replica's tenants remap; every
    other tenant keeps its warm arena residency.

Failover is part of the data path: a call that dies with `TimeoutError`
or `ConnectionError` (the RPC envelope's terminal errors), or a replica
that cannot be connected to within `connect_timeout_secs`, marks the
replica dead, remaps over the survivors and retries, so tenants shed to
survivors within one client deadline of a crash. `RpcError` (a
server-side application error, most often an admission rejection) is
never failover: the replica is healthy; the error goes to the caller.

The observation-dedup cache (`serving.dedup`) sits here because the
router sees every tenant's traffic before placement: identical
(quantized) frames under an unchanged params version return the cached
action without touching a replica. The version is learned from predict
replies (each carries its `params_version`); a version advance
invalidates stale entries, and `notify_published()` does it eagerly.
Only numpy and plain Python cross the wire both ways.
"""

from __future__ import annotations

import threading
from multiprocessing import AuthenticationError
from typing import Any, Dict, List, Optional, Tuple

from tensor2robot_tpu_torch.fleet import rpc as rpc_lib
from tensor2robot_tpu_torch.replay.sampler import rendezvous_spread
from tensor2robot_tpu_torch.serving.dedup import ObservationDedupCache
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics


class NoReplicasError(ConnectionError):
  """Every replica in the tenant's failover order is dead."""


def _unreachable(error: BaseException) -> bool:
  """A replica the caller could not reach: refused, reset or timed out,
  or a transport handshake the peer cut (an `AuthenticationError` from
  an OSError, as a dying replica's backlog gives). JAX's router fails
  over the first kind only."""
  if isinstance(error, (TimeoutError, ConnectionError)):
    return True
  return (isinstance(error, AuthenticationError)
          and isinstance(error.__cause__, OSError))


class ServingRouter:
  """Caller-side placement + failover over a front-replica set."""

  def __init__(self,
               replicas: Dict[int, Tuple[str, int]],
               authkey: bytes = rpc_lib.DEFAULT_AUTHKEY,
               transport: str = "loopback",
               spread: int = 1,
               dedup_capacity: int = 0,
               quantize_scale: float = 256.0,
               connect_timeout_secs: float = 20.0,
               call_timeout_secs: float = rpc_lib.DEFAULT_CALL_TIMEOUT_SECS,
               max_retries: int = 0,
               sndbuf: int = 0,
               rcvbuf: int = 0):
    """Args:
      replicas: front_index → RPC address of every front host.
      spread: a tenant's requests round-robin over its top-`spread`
        HRW replicas (1 = classic single-home placement).
      dedup_capacity: > 0 enables the observation-dedup cache.
      max_retries: per-call retries INSIDE one replica (0 default —
        the router's cross-replica failover IS the retry story; inner
        retries multiply the shed time by (retries+1)).
    """
    if not replicas:
      raise ValueError("ServingRouter needs at least one replica")
    if spread < 1:
      raise ValueError(f"spread must be >= 1, got {spread}")
    self._addresses = {int(i): tuple(a) for i, a in replicas.items()}
    self._spread = int(spread)
    self._client_kwargs = dict(
        authkey=authkey, transport=transport,
        connect_timeout_secs=connect_timeout_secs,
        call_timeout_secs=call_timeout_secs,
        max_retries=max_retries, sndbuf=sndbuf, rcvbuf=rcvbuf)
    self._lock = threading.Lock()
    self._alive = set(self._addresses)
    # Per-replica client POOLS: RpcClient serializes concurrent
    # callers on its connection, so each caller thread checks a
    # client out and returns it — N threads get N connections, and a
    # front's per-connection handler threads give them real
    # concurrency server-side.
    self._pool: Dict[int, List[rpc_lib.RpcClient]] = {}
    self._rr: Dict[str, int] = {}
    self._version = 0
    self._dedup: Optional[ObservationDedupCache] = None
    if dedup_capacity > 0:
      self._dedup = ObservationDedupCache(
          capacity=dedup_capacity, quantize_scale=quantize_scale)
    self._tm_requests = tmetrics.counter("serving.router.requests")
    self._tm_failovers = tmetrics.counter("serving.router.failovers")
    self._tm_shed = tmetrics.counter("serving.router.shed")
    self._tm_alive = tmetrics.gauge("serving.router.replicas_alive")
    self._tm_alive.set(len(self._alive))
    # Telemetry counters are process-global (shared across routers);
    # stats() must describe THIS router, so keep local tallies too.
    self._n = {"requests": 0, "failovers": 0, "shed": 0}
    self._closed = False

  # ---- membership ----

  def alive(self) -> List[int]:
    with self._lock:
      return sorted(self._alive)

  def placement(self, tenant: str) -> List[int]:
    """The tenant's failover-ordered replica list (HRW top-spread
    first, then the remaining survivors in rank order)."""
    with self._lock:
      members = sorted(self._alive)
    if not members:
      raise NoReplicasError("no live front replicas")
    ranked = rendezvous_spread(tenant, members, k=len(members))
    return ranked

  def mark_dead(self, index: int) -> None:
    with self._lock:
      if index not in self._alive:
        return
      self._alive.discard(index)
      stale = self._pool.pop(index, [])
      self._tm_alive.set(len(self._alive))
    for client in stale:
      try:
        client.close()
      except Exception:  # noqa: BLE001 — teardown of a dead peer
        pass

  def mark_alive(self, index: int,
                 address: Optional[Tuple[str, int]] = None) -> None:
    """Re-adds a replica (a respawned front) to the placement set.

    Any pooled clients for the index are stale by definition — they
    hold sockets to the PREVIOUS incarnation (a respawn binds a fresh
    port), and checking one out would fail the first call and demote
    the replica straight back to dead (fatal when it is the only
    one). Flush them here so the next predict dials the new address.
    """
    with self._lock:
      if address is not None:
        self._addresses[int(index)] = tuple(address)
      if index not in self._addresses:
        raise KeyError(f"unknown replica {index}")
      self._alive.add(int(index))
      stale = self._pool.pop(int(index), [])
      self._tm_alive.set(len(self._alive))
    for client in stale:
      try:
        client.close()
      except Exception:  # noqa: BLE001 — teardown of a dead peer
        pass

  def _fail_over(self, index: int) -> None:
    """Marks a replica dead on the data path, counting the failover once
    (a replica another call already marked dead counts none)."""
    with self._lock:
      was_alive = index in self._alive
    self.mark_dead(index)
    if was_alive:
      self._tm_failovers.inc()
      with self._lock:
        self._n["failovers"] += 1

  # ---- version / dedup plumbing ----

  @property
  def params_version(self) -> int:
    with self._lock:
      return self._version

  def notify_published(self, version: int) -> None:
    """Publish-aware callers call this after a param fan-out: the
    dedup cache drops every entry from older versions eagerly."""
    self._observe_version(int(version))

  def _observe_version(self, version: int) -> None:
    with self._lock:
      if version <= self._version:
        return
      self._version = version
    if self._dedup is not None:
      self._dedup.invalidate(version)

  # ---- client pool ----

  def _checkout(self, index: int) -> rpc_lib.RpcClient:
    with self._lock:
      if index not in self._alive:
        raise ConnectionError(f"replica {index} is marked dead")
      pool = self._pool.setdefault(index, [])
      if pool:
        return pool.pop()
      address = self._addresses[index]
    return rpc_lib.RpcClient(address, **self._client_kwargs)

  def _checkin(self, index: int, client: rpc_lib.RpcClient) -> None:
    with self._lock:
      if index in self._alive and not self._closed:
        self._pool.setdefault(index, []).append(client)
        return
    client.close()

  # ---- the data path ----

  def predict(self, tenant: str, features: Any) -> Any:
    """One routed action request: dedup short-circuit → the tenant's
    replica (round-robin over its spread set) → failover across
    survivors on replica death."""
    self._tm_requests.inc()
    with self._lock:
      self._n["requests"] += 1
    key = None
    if self._dedup is not None:
      # Tenant-scoped: two tenants streaming the SAME frame must not
      # share cached actions — they can be entirely different models.
      key = f"{tenant}|{self._dedup.key(features)}"
      cached = self._dedup.get(key, self.params_version)
      if cached is not None:
        return cached
    ranked = self.placement(tenant)
    spread = ranked[:self._spread]
    with self._lock:
      offset = self._rr[tenant] = self._rr.get(tenant, -1) + 1
    # The candidate order: start inside the spread set at the
    # round-robin position, then the remaining survivors as failover.
    candidates = (spread[offset % len(spread):]
                  + spread[:offset % len(spread)]
                  + ranked[len(spread):])
    last_error: Optional[BaseException] = None
    for index in candidates:
      try:
        client = self._checkout(index)
      except Exception as e:  # noqa: BLE001 — re-raised unless unreachable
        if not _unreachable(e):
          raise
        # Marked dead by a concurrent call, or no server at the address
        # (a dead replica refuses connections until the connect window
        # closes): the replica leaves the placement set and the next
        # candidate gets the request.
        last_error = e
        self._fail_over(index)
        continue
      try:
        reply = client.call(
            "predict", {"tenant": tenant, "features": features})
      except rpc_lib.RpcError:
        # Server-side application error (admission shed, unknown
        # tenant): the replica is healthy — never failover.
        self._checkin(index, client)
        self._tm_shed.inc()
        with self._lock:
          self._n["shed"] += 1
        raise
      except Exception as e:  # noqa: BLE001 — re-raised unless unreachable
        if not _unreachable(e):
          raise
        # A dead/wedged replica: poisoned client stays closed, the
        # replica leaves the placement set, the next candidate gets
        # the request. This IS the shed path — no orchestrator in
        # the loop.
        last_error = e
        client.close()
        self._fail_over(index)
        continue
      self._checkin(index, client)
      version = int(reply.get("params_version", 0))
      self._observe_version(version)
      action = reply["action"]
      if self._dedup is not None and key is not None:
        self._dedup.put(key, version, action)
      return action
    raise NoReplicasError(
        f"no live replica could serve tenant {tenant!r}: "
        f"{last_error!r}")

  # ---- observability / lifecycle ----

  def dedup_stats(self) -> Optional[Dict[str, int]]:
    return None if self._dedup is None else self._dedup.stats()

  def stats(self) -> Dict[str, Any]:
    with self._lock:
      alive = sorted(self._alive)
      counts = dict(self._n)
    counts.update({
        "alive": alive,
        "params_version": self.params_version,
        "dedup": self.dedup_stats(),
    })
    return counts

  def close(self) -> None:
    with self._lock:
      self._closed = True
      pools = list(self._pool.values())
      self._pool.clear()
    for pool in pools:
      for client in pool:
        try:
          client.close()
        except Exception:  # noqa: BLE001
          pass

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
    return False
