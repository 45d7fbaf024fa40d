"""Fleet RPC (port of `fleet/rpc.py`): actors and learner ⇄ the
replay/serving host, over `multiprocessing.connection` (loopback, the
default) or `fleet.transport` (TCP).

  * `RpcServer`: accept loop and one handler thread per connection. The
    handler sees `(method, payload, ctx)` where `ctx` is a
    per-connection dict that survives until disconnect: the host keeps
    each connection's replay-session ids there, and the synthetic
    `__disconnect__` call on EOF is how a crashed actor's staged
    half-episode is aborted server-side.
  * `RpcClient`: blocking request/response with a per-call deadline and
    exponential-backoff-and-jitter retries: every call bounds its wait
    for the reply (`call_timeout_secs`, default 120 s), and a timed-out
    or dropped connection is retried through a fresh connection (the
    host re-creates an actor's session on first use of the new
    connection, aborting whatever the old one staged). Retries are
    at-least-once: the session-abort contract guarantees a retried
    commit never lands a partial episode. Not thread-safe by design: one
    owner thread per client; a process that needs RPC from two threads
    (the learner's train loop and its prefetch thread) opens two
    clients.

The wire format is the JAX package's (a `(method, payload, req)` tuple
out, `("ok"|"err", value)` back, pickled by each transport's framing),
so the two packages' clients and servers interoperate on numpy payloads.

Fault-injection seams (`fleet/faults.py`): one process-global injector
is consulted on every client call (delay, drop the send) and every
server handler turn (stall, disconnect). The seams sit in the real code
paths, so an injected drop times out through the same deadline and
recovers through the same retry a production fault would.
"""

from __future__ import annotations

import logging
import os
import random
import socket
import threading
import time
import traceback
from multiprocessing.connection import Client, Listener
from typing import Any, Callable, List, Optional, Tuple

from tensor2robot_tpu_torch import telemetry
from tensor2robot_tpu_torch.fleet import transport as transport_lib
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics

log = logging.getLogger(__name__)

# Transport seam. "loopback" is the stdlib multiprocessing.connection
# pair, the single-host default. "tcp" is `fleet.transport`: real
# sockets, out-of-band frames, the same authkey riding an HMAC
# challenge. The deadline/retry/poisoning contract, the fault seams and
# the span stamps below are written against the shared connection shape
# (send/recv/poll/close), so both transports share those lines.
TRANSPORTS = ("loopback", "tcp")

# The shared secret for connection auth. Loopback-only transport; the
# orchestrator generates a per-fleet key so two fleets on one machine
# cannot cross-connect even if they guess each other's port.
DEFAULT_AUTHKEY = b"t2r-fleet"

DISCONNECT_METHOD = "__disconnect__"

# Deadline/retry defaults (overridable per client and per call). The
# default deadline is deliberately generous — it exists to unstrand
# callers from a dead host, not to police a slow one; latency-critical
# callers pass tighter per-call values.
DEFAULT_CALL_TIMEOUT_SECS = 120.0
DEFAULT_MAX_RETRIES = 2
_BACKOFF_BASE_SECS = 0.05
_BACKOFF_MAX_SECS = 2.0

# Process-global fault injector (faults.FaultInjector or None). One
# per process is the right granularity: a fleet child is either a
# client-side process (actor/learner) or the host.
_fault_injector: Optional[Any] = None


def set_fault_injector(injector: Optional[Any]) -> None:
  """Installs (or clears, with None) this process's RPC fault seam."""
  global _fault_injector
  _fault_injector = injector


def _fault_action(side: str, method: str) -> Optional[Tuple[str, float]]:
  injector = _fault_injector
  if injector is None:
    return None
  return injector.rpc_action(side, method)


class RpcError(RuntimeError):
  """A handler raised on the server side; carries the remote traceback."""


class RpcServer:
  """Threaded request/response server over a loopback Listener."""

  def __init__(self,
               handler: Callable[[str, Any, dict], Any],
               host: str = "127.0.0.1",
               authkey: bytes = DEFAULT_AUTHKEY,
               transport: str = "loopback",
               sndbuf: int = 0,
               rcvbuf: int = 0):
    """`handler(method, payload, ctx) -> result` runs on a
    per-connection thread; exceptions it raises are serialized back to
    the caller as `RpcError` (the connection stays up). On EOF the
    synthetic `(DISCONNECT_METHOD, None, ctx)` call runs once.
    `transport`/`sndbuf`/`rcvbuf`: see `TRANSPORTS` above (buffer
    sizes apply to "tcp" only; 0 = OS default)."""
    if transport not in TRANSPORTS:
      raise ValueError(
          f"transport must be one of {TRANSPORTS}, got {transport!r}")
    self._handler = handler
    if transport == "tcp":
      self._listener = transport_lib.TcpListener(
          host, 0, authkey=authkey, sndbuf=sndbuf, rcvbuf=rcvbuf)
    else:
      self._listener = Listener((host, 0), authkey=authkey)
    self.transport = transport
    self.address: Tuple[str, int] = self._listener.address
    self._stop = threading.Event()
    self._lock = threading.Lock()
    self._conns: List[Any] = []
    self._threads: List[threading.Thread] = []
    self._accept_thread = threading.Thread(
        target=self._accept_loop, name="fleet-rpc-accept", daemon=True)
    self._accept_thread.start()

  def _accept_loop(self) -> None:
    while not self._stop.is_set():
      try:
        conn = self._listener.accept()
      except (OSError, EOFError):
        # A closed listener, or close()'s wake-up connection failing
        # its handshake: the shutdown signal.
        return
      except Exception:  # auth failure from a stray connector
        if self._stop.is_set():
          return  # close()'s wake-up connection
        log.warning("fleet rpc: rejected connection", exc_info=True)
        continue
      if self._stop.is_set():
        conn.close()
        return
      thread = threading.Thread(
          target=self._serve, args=(conn,),
          name="fleet-rpc-conn", daemon=True)
      with self._lock:
        self._conns.append(conn)
        self._threads.append(thread)
      thread.start()

  def _serve(self, conn) -> None:
    ctx: dict = {}
    try:
      while not self._stop.is_set():
        try:
          message = conn.recv()
        except (EOFError, OSError):
          break
        # Wire format: (method, payload[, req]). `req` is the
        # client-stamped correlation id, echoed into the server-side
        # span so a trace merge links the rpc_call.<m>/rpc.<m> pair as
        # one flow. Two-tuples stay accepted (id-less callers).
        method, payload = message[0], message[1]
        req = message[2] if len(message) > 2 else None
        # Server-side fault seam (chaos): a stall models a slow host,
        # a disconnect models a half-dead one — the break runs the
        # REAL disconnect path below (session abort and all), and the
        # client recovers through its real reconnect-and-retry.
        action = _fault_action("server", method)
        if action is not None:
          kind, secs = action
          if kind == "delay":
            time.sleep(secs)
          elif kind == "disconnect":
            break
        try:
          # Every RPC method gets a server-side span for free: the
          # merged timeline shows act/commit/sample handler time per
          # connection thread (no-op until telemetry is configured).
          # The echoed `req` makes it one flow with the client span.
          span_args = {"req": req} if req is not None else {}
          with telemetry.span(f"rpc.{method}", **span_args):
            result = self._handler(method, payload, ctx)
          reply = ("ok", result)
        except BaseException:  # serialized back, connection stays up
          reply = ("err", traceback.format_exc())
        try:
          conn.send(reply)
        except (EOFError, OSError):
          break
    finally:
      try:
        self._handler(DISCONNECT_METHOD, None, ctx)
      except Exception:
        log.exception("fleet rpc: disconnect handler failed")
      try:
        conn.close()
      except OSError:
        pass
      with self._lock:
        if conn in self._conns:
          self._conns.remove(conn)

  def close(self, timeout_secs: float = 5.0) -> None:
    """Stops intake: wakes the accept loop (closing a listening socket
    does not return a blocked `accept` on Linux, so one connection that
    fails the handshake does), closes the listener and every live
    connection (unblocks recv), then joins the handler threads."""
    self._stop.set()
    try:
      socket.create_connection(self.address, timeout=1.0).close()
    except OSError:
      pass
    try:
      self._listener.close()
    except OSError:
      pass
    with self._lock:
      conns = list(self._conns)
      threads = list(self._threads)
    for conn in conns:
      try:
        conn.close()
      except OSError:
        pass
    deadline = time.monotonic() + timeout_secs
    for thread in threads + [self._accept_thread]:
      thread.join(timeout=max(0.0, deadline - time.monotonic()))

  def __enter__(self) -> "RpcServer":
    return self

  def __exit__(self, *exc) -> bool:
    self.close()
    return False


class RpcClient:
  """Deadline-bounded request/response client with retry. One owner
  thread per instance (see module docstring) — open a second client
  for a second thread."""

  def __init__(self,
               address: Tuple[str, int],
               authkey: bytes = DEFAULT_AUTHKEY,
               connect_timeout_secs: float = 20.0,
               call_timeout_secs: Optional[float] =
               DEFAULT_CALL_TIMEOUT_SECS,
               max_retries: int = DEFAULT_MAX_RETRIES,
               transport: str = "loopback",
               sndbuf: int = 0,
               rcvbuf: int = 0):
    """`call_timeout_secs` is the default per-call reply deadline
    (None disables it: a caller then waits forever, opt-in only);
    `max_retries` bounds reconnect-and-retry attempts per call. A
    retried caller needs no session re-establishment: the
    host rebuilds sessions server-side on first use of the fresh
    connection (see the module docstring). `transport` must match the
    server's (see `TRANSPORTS`)."""
    if transport not in TRANSPORTS:
      raise ValueError(
          f"transport must be one of {TRANSPORTS}, got {transport!r}")
    self._address = tuple(address)
    self._authkey = authkey
    self._transport = transport
    self._sndbuf = sndbuf
    self._rcvbuf = rcvbuf
    self._connect_timeout = connect_timeout_secs
    self._call_timeout = call_timeout_secs
    self._max_retries = int(max_retries)
    self.reconnects = 0
    self._conn = None
    # Correlation-id sequence: every call stamps a process-unique
    # `req` into its client span and the wire triple; the server echoes
    # it into its handler span. Single-owner like the
    # client itself — a bare increment is safe.
    self._req_seq = 0
    self._connect(connect_timeout_secs)

  def _connect(self, timeout_secs: float) -> None:
    deadline = time.monotonic() + timeout_secs
    last_error: Optional[BaseException] = None
    while True:
      try:
        if self._transport == "tcp":
          self._conn = transport_lib.connect_tcp(
              self._address, self._authkey,
              sndbuf=self._sndbuf, rcvbuf=self._rcvbuf)
        else:
          self._conn = Client(self._address, authkey=self._authkey)
        return
      except (ConnectionRefusedError, FileNotFoundError, OSError) as e:
        # The host process may still be warming up its engine (or
        # rebinding after a fault); retry until the window closes.
        last_error = e
        if time.monotonic() > deadline:
          raise TimeoutError(
              f"fleet rpc: no server at {self._address} after "
              f"{timeout_secs:.0f}s") from last_error
        time.sleep(0.05)

  def call_once(self, method: str, payload: Any = None,
                timeout_secs: Optional[float] = None) -> Any:
    """ONE request/response round trip — no retry, no reconnect.

    `timeout_secs` bounds the wait for the REPLY (None falls back to
    the client default; an explicit None default disables). On expiry
    raises `TimeoutError` and the connection must be considered
    POISONED (an in-flight reply may still arrive and would be read as
    the answer to the next call); on a dropped connection raises
    `ConnectionError`. `RpcError` when the server-side handler raised.
    """
    timeout = (self._call_timeout if timeout_secs is None
               else timeout_secs)
    self._req_seq += 1
    req = f"{os.getpid()}-{id(self) & 0xffffff:x}-{self._req_seq}"
    try:
      # Client-side span: the caller's view of the same RPC (queueing
      # + transport + handler), so actor-vs-host wait decomposes in
      # the merged timeline; `req` links it to the server span.
      with telemetry.span(f"rpc_call.{method}", req=req):
        action = _fault_action("client", method)
        if action is not None:
          kind, secs = action
          if kind == "delay":
            time.sleep(secs)
            action = None
        if action is None:
          # (a "drop" skips the send: the request is lost in flight
          # and the REAL deadline below fires.)
          self._conn.send((method, payload, req))
        if timeout is not None and not self._conn.poll(timeout):
          tmetrics.counter("fleet.rpc.timeouts").inc()
          raise TimeoutError(
              f"fleet rpc: no reply to {method!r} in "
              f"{timeout:.0f}s")
        status, value = self._conn.recv()
    except TimeoutError:
      # Before the broad OSError clause: TimeoutError IS an OSError
      # subclass, and the deadline must never be rebranded as a
      # connection drop (callers distinguish the two).
      raise
    except (EOFError, OSError) as e:
      raise ConnectionError(
          f"fleet rpc: server dropped during {method!r}") from e
    if status == "err":
      raise RpcError(f"remote {method!r} failed:\n{value}")
    return value

  def call(self, method: str, payload: Any = None,
           timeout_secs: Optional[float] = None,
           max_retries: Optional[int] = None) -> Any:
    """Request/response with deadline + reconnect-and-retry.

    A `TimeoutError` or `ConnectionError` closes the (poisoned)
    connection, backs off exponentially with jitter, reconnects, and
    resends — up to `max_retries` times, after which the last error
    is raised. `RpcError` (a server-side handler
    exception) never retries: the request ARRIVED; re-sending it is
    the application's decision, not the transport's. Retried commits
    are at-least-once (see module docstring — partial rows can never
    land, duplicates are whole episodes).
    """
    retries = self._max_retries if max_retries is None else max_retries
    t_first_failure: Optional[float] = None
    attempt = 0
    while True:
      try:
        result = self.call_once(method, payload,
                                timeout_secs=timeout_secs)
        if t_first_failure is not None:
          # The call RECOVERED: stamp the end-to-end outage the caller
          # experienced (first failure → first success) into the
          # shared recovery histogram next to the process-level MTTRs.
          from tensor2robot_tpu_torch.fleet import faults
          recovery_ms = (time.monotonic() - t_first_failure) * 1e3
          faults.recovery_histogram().observe(recovery_ms)
          tmetrics.counter("fleet.rpc.recovered").inc()
          telemetry.event("fleet.rpc_recovered", method=method,
                          attempts=attempt,
                          recovery_ms=round(recovery_ms, 1))
        return result
      except (TimeoutError, ConnectionError) as e:
        if t_first_failure is None:
          t_first_failure = time.monotonic()
        if attempt >= retries:
          raise
        attempt += 1
        tmetrics.counter("fleet.rpc.retries").inc()
        log.warning(
            "fleet rpc: %r failed (%s); retry %d/%d with fresh "
            "connection", method, e, attempt, retries)
        # Poisoned-on-timeout contract: never reuse the old socket.
        try:
          self._conn.close()
        except OSError:
          pass
        backoff = min(_BACKOFF_MAX_SECS,
                      _BACKOFF_BASE_SECS * (2 ** (attempt - 1)))
        # Full jitter: concurrent retriers (every actor saw the same
        # host stall) must not reconnect in lockstep.
        time.sleep(backoff * random.random())
        self._connect(self._connect_timeout)
        self.reconnects += 1
        tmetrics.counter("fleet.rpc.reconnects").inc()

  def close(self) -> None:
    if self._conn is not None:
      try:
        self._conn.close()
      except OSError:
        pass
      self._conn = None

  def __enter__(self) -> "RpcClient":
    return self

  def __exit__(self, *exc) -> bool:
    self.close()
    return False
