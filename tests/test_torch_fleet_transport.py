"""The port's fleet transport and RPC (`fleet/transport.py`,
`fleet/rpc.py`) against the JAX package's, on the CPU.

  * Frames: the port's `encode_frame` gives JAX's bytes for the same
    payloads (numpy arrays of several dtypes in and out of band, nested
    containers, plain values); the handshake's HMAC answers equal JAX's
    for the same key and challenge (the challenges themselves are random
    nonces).
  * The wire's edges on the port: partial reads, EOF mid-frame, bad
    magic and oversized declared lengths, send-side oversizes, a wrong
    key.
  * RPC on both transports: round trip, handler errors (the connection
    survives), the disconnect callback with the connection's context,
    the per-call deadline and reconnect-and-retry.
  * Interop both ways, loopback and TCP: a port `RpcClient` calls a JAX
    `RpcServer` and a JAX client calls a port server, numpy payloads
    bit for bit, errors and disconnects included.
  * The rendezvous home shard and the address book equal JAX's.
"""

import socket
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from tensor2robot_tpu.fleet import actor as jax_actor  # noqa: E402
from tensor2robot_tpu.fleet import rpc as jax_rpc  # noqa: E402
from tensor2robot_tpu.fleet import transport as jax_transport  # noqa: E402
from tensor2robot_tpu_torch.fleet import actor  # noqa: E402
from tensor2robot_tpu_torch.fleet import rpc  # noqa: E402
from tensor2robot_tpu_torch.fleet import transport  # noqa: E402
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402

KEY = b"fleet-test-key"
TRANSPORTS = ("loopback", "tcp")


@pytest.fixture(autouse=True)
def _fresh():
  tmetrics.reset_for_tests()
  rpc.set_fault_injector(None)
  yield
  rpc.set_fault_injector(None)
  tmetrics.reset_for_tests()


def _payloads():
  rng = np.random.default_rng(0)
  return [
      "ok", None, 17, 3.5, b"\x00raw", ("act", {"k": [1, 2]}),
      {"image": rng.integers(0, 255, (4, 16, 16, 3), dtype=np.uint8),
       "action": rng.standard_normal((4, 2)).astype(np.float32)},
      {"actor_id": "actor-3", "transitions": {
          "reward": rng.random((8, 1)).astype(np.float32),
          "done": np.ones((8, 1), np.float32)},
       "policy_version": 2, "policy_learner_step": 50, "policy_hop": 1},
      ("publish", {"step": 50, "state": {
          "params": {"w": rng.standard_normal((32, 32))},
          "batch_stats": {"mean": np.zeros(8, np.float64)}}}, "1-a-7"),
      np.arange(12, dtype=np.int64).reshape(3, 4)[:, ::2],  # strided
      np.zeros((0, 3), np.float32),
  ]


def _bytes(module, obj):
  return b"".join(bytes(v) for v in module.encode_frame(obj))


@pytest.mark.parametrize("index", range(len(_payloads())))
def test_frames_are_jax_bytes(index):
  obj = _payloads()[index]
  assert _bytes(transport, obj) == _bytes(jax_transport, obj)


def test_handshake_answers_and_constants_equal_jax():
  challenge = bytes(range(32))
  for domain in ("_SERVER_DOMAIN", "_CLIENT_DOMAIN"):
    assert getattr(transport, domain) == getattr(jax_transport, domain)
    assert transport._digest(KEY, getattr(transport, domain), challenge) == (
        jax_transport._digest(KEY, getattr(jax_transport, domain), challenge))
  assert transport.MAGIC == jax_transport.MAGIC
  assert transport._HEADER.format == jax_transport._HEADER.format
  assert transport.DEFAULT_MAX_FRAME_BYTES == (
      jax_transport.DEFAULT_MAX_FRAME_BYTES)
  assert rpc.TRANSPORTS == jax_rpc.TRANSPORTS
  assert rpc.DISCONNECT_METHOD == jax_rpc.DISCONNECT_METHOD


def _pair(**kwargs):
  a, b = socket.socketpair()
  return transport.TcpConnection(a, **kwargs), transport.TcpConnection(b)


def test_partial_reads_reassemble_the_frame():
  raw, sock = socket.socketpair()
  conn = transport.TcpConnection(sock)
  payload = {"arr": np.arange(999, dtype=np.int32), "tag": "drip"}
  wire = _bytes(transport, payload)

  def dribble():
    for i in range(0, len(wire), 7):
      raw.sendall(wire[i:i + 7])

  thread = threading.Thread(target=dribble, daemon=True)
  thread.start()
  try:
    got = conn.recv()
    assert got["tag"] == "drip"
    np.testing.assert_array_equal(got["arr"], payload["arr"])
    thread.join(timeout=5.0)
  finally:
    raw.close()
    conn.close()


def test_bad_frames_and_oversizes():
  raw, sock = socket.socketpair()
  conn = transport.TcpConnection(sock)
  wire = _bytes(transport, {"x": np.zeros(4096, np.float64)})
  raw.sendall(wire[:len(wire) // 2])
  raw.close()
  with pytest.raises(EOFError):
    conn.recv()
  conn.close()
  raw, sock = socket.socketpair()
  conn = transport.TcpConnection(sock)
  raw.sendall(b"nope" + bytes(12))
  with pytest.raises(transport.FrameError, match="magic"):
    conn.recv()
  conn.close()
  raw.close()
  raw, sock = socket.socketpair()
  conn = transport.TcpConnection(sock, max_frame_bytes=1024)
  raw.sendall(transport._HEADER.pack(transport.MAGIC, 1 << 40, 0))
  with pytest.raises(transport.FrameError, match="max_frame_bytes"):
    conn.recv()
  conn.close()
  raw.close()
  left, right = _pair(max_frame_bytes=1024)
  with pytest.raises(ValueError, match="exceeds"):
    left.send(np.zeros(4096, np.uint8))
  left.send("still healthy")
  assert right.recv() == "still healthy"
  left.close()
  right.close()


def test_zero_copy_receive_is_a_view_of_the_buffer():
  a, b = socket.socketpair()
  left = transport.TcpConnection(a)
  right = transport.TcpConnection(b, track_buffers=True)
  big = np.random.default_rng(1).standard_normal(1 << 17)
  thread = threading.Thread(target=left.send, args=({"w": big},))
  thread.start()
  got = right.recv()["w"]
  thread.join()
  assert np.array_equal(got, big)
  assert any(np.shares_memory(got, np.frombuffer(buf, np.uint8))
             for buf in right.last_recv_buffers)
  left.close()
  right.close()


def _handler(seen):
  def handle(method, payload, ctx):
    if method == "echo":
      ctx["n"] = ctx.get("n", 0) + 1
      return {"payload": payload, "call": ctx["n"]}
    if method == "double":
      return {k: np.asarray(v) * 2 for k, v in payload.items()}
    if method == "boom":
      raise ValueError("intentional")
    if method == "sleep":
      time.sleep(float(payload))
      return "late"
    if method == rpc.DISCONNECT_METHOD:
      seen.append(ctx.get("n", 0))
      return None
    raise KeyError(method)
  return handle


def _wait(predicate, secs=5.0):
  deadline = time.monotonic() + secs
  while not predicate() and time.monotonic() < deadline:
    time.sleep(0.01)
  return predicate()


_SIDES = {"port": rpc, "jax": jax_rpc}


@pytest.mark.parametrize("transport_name", TRANSPORTS)
@pytest.mark.parametrize("server_side,client_side",
                         [("port", "port"), ("jax", "port"),
                          ("port", "jax")])
def test_round_trip_errors_disconnect_and_interop(transport_name,
                                                  server_side, client_side):
  server_lib, client_lib = _SIDES[server_side], _SIDES[client_side]
  seen = []
  rng = np.random.default_rng(2)
  arrays = {"image": rng.integers(0, 255, (8, 16, 16, 3), dtype=np.uint8),
            "action": rng.standard_normal((8, 2)).astype(np.float32)}
  with server_lib.RpcServer(_handler(seen), authkey=KEY,
                            transport=transport_name) as server:
    client = client_lib.RpcClient(server.address, authkey=KEY,
                                  transport=transport_name)
    assert client.call("echo", 1) == {"payload": 1, "call": 1}
    assert client.call("echo", "x")["call"] == 2
    doubled = client.call("double", arrays)
    for key, value in arrays.items():
      assert doubled[key].dtype == (value * 2).dtype
      assert np.array_equal(doubled[key], value * 2)
    with pytest.raises(client_lib.RpcError, match="intentional"):
      client.call("boom")
    assert client.call("echo", None)["call"] == 3  # survived the error
    client.close()
    assert _wait(lambda: seen == [3])


@pytest.mark.parametrize("transport_name", TRANSPORTS)
def test_wrong_key_is_rejected_and_not_retried(transport_name):
  with jax_rpc.RpcServer(_handler([]), authkey=KEY,
                         transport=transport_name) as server:
    with pytest.raises(Exception) as info:
      rpc.RpcClient(server.address, authkey=b"other-key",
                    transport=transport_name,
                    connect_timeout_secs=2.0).call("echo", 1)
    assert "uth" in type(info.value).__name__ + str(info.value)


@pytest.mark.parametrize("transport_name", TRANSPORTS)
def test_deadline_then_retry_through_a_fresh_connection(transport_name):
  with rpc.RpcServer(_handler([]), authkey=KEY,
                     transport=transport_name) as server:
    client = rpc.RpcClient(server.address, authkey=KEY,
                           transport=transport_name, call_timeout_secs=0.2,
                           max_retries=0)
    with pytest.raises(TimeoutError):
      client.call("sleep", 1.0)
    assert tmetrics.registry().snapshot()["counters"][
        "fleet.rpc.timeouts"] == 1.0
    client.close()
    # A dropped request (the client-side fault seam) times out through
    # the real deadline and recovers through the real retry.
    from tensor2robot_tpu_torch.fleet import faults
    plan = faults.FaultPlan(seed=0, events=(faults.FaultEvent(
        fault=faults.RPC_DROP, target="actor-0", at=2, method="echo"),))
    rpc.set_fault_injector(faults.FaultInjector(plan, "actor-0"))
    client = rpc.RpcClient(server.address, authkey=KEY,
                           transport=transport_name, call_timeout_secs=0.3,
                           max_retries=2)
    assert client.call("echo", 1)["call"] == 1
    assert client.call("echo", 2) == {"payload": 2, "call": 1}  # retried
    assert client.reconnects == 1
    counters = tmetrics.registry().snapshot()["counters"]
    assert counters["fleet.rpc.retries"] == 1.0
    assert counters["fleet.rpc.recovered"] == 1.0
    client.close()


def test_dead_server_is_a_connection_error():
  server = rpc.RpcServer(_handler([]), authkey=KEY)
  client = rpc.RpcClient(server.address, authkey=KEY, max_retries=0,
                         call_timeout_secs=5.0)
  assert client.call("echo", 0)["call"] == 1
  server.close(timeout_secs=0.5)  # the client's handler stays blocked
  with pytest.raises((ConnectionError, TimeoutError)):
    client.call("echo", 1)
  client.close()


def test_home_shard_and_address_book_equal_jax():
  ids = [f"actor-{i}" for i in range(32)] + [f"pod-{i}" for i in range(8)]
  for num_shards in (1, 2, 3, 5):
    assert [actor.home_shard(a, num_shards) for a in ids] == [
        jax_actor.home_shard(a, num_shards) for a in ids]
  for address in (("127.0.0.1", 5), {"serving": [("h", 1), ["g", 2]],
                                      "shards": [("s", 3)]}):
    assert actor.address_book(address) == jax_actor.address_book(address)
  with pytest.raises(ValueError):
    actor.home_shard("actor-0", 0)
