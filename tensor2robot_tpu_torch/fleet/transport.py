"""TCP fleet transport (port of `fleet/transport.py`): length-prefixed
frames over plain sockets, selected per server/client with
`transport="tcp"` while `"loopback"` (`multiprocessing.connection`)
stays the default.

Wire format (one frame per `send`), the JAX package's byte for byte:

    magic  "t2rw"                     4 bytes
    body_len                          u64 LE   (pickle stream length)
    nbuf                              u32 LE   (out-of-band buffer count)
    buf_len[nbuf]                     u64 LE each
    body                              body_len bytes (pickle protocol 5)
    buffers...                        buf_len[i] bytes each, raw

Large array payloads (param publications, episode batches, sampled
Bellman batches) ride pickle protocol 5 out-of-band buffers: the
sender's `pickle.dumps(obj, buffer_callback=...)` leaves every
contiguous array out of the pickle stream, and `sendmsg` gathers the
header, body and raw buffer memoryviews straight from the arrays' own
memory. The receiver `recv_into`s each buffer once into a preallocated
bytearray and `pickle.loads(body, buffers=...)` rebuilds arrays as views
of those bytearrays. Only numpy and plain Python cross a fleet RPC: a
pickled CUDA tensor would rebuild itself on the card in the receiver.

Connection hygiene:

  * `TCP_NODELAY` always; `SO_SNDBUF`/`SO_RCVBUF` configurable (0 = OS
    default).
  * Auth: the per-fleet authkey rides a mutual HMAC-SHA256
    challenge/response on connect (domain-separated both directions,
    `hmac.compare_digest`), so two fleets on one network never
    cross-connect and a stray connector is rejected before any frame is
    parsed.
  * Oversized-frame guard: a declared length beyond `max_frame_bytes`
    raises `FrameError` and kills the connection before any allocation.
    Send-side oversizes raise `ValueError` (a caller bug; the connection
    stays healthy).
  * Partial reads and writes are the normal case; EOF mid-frame surfaces
    as `EOFError`, the stdlib connection's signal, so `rpc.py`'s
    deadline, retry and poisoning rules work unchanged on both
    transports.
"""

from __future__ import annotations

import hmac
import os
import pickle
import select
import socket
import struct
from multiprocessing import AuthenticationError
from typing import Any, List, Optional, Tuple

from tensor2robot_tpu_torch.telemetry import metrics as tmetrics

MAGIC = b"t2rw"
_HEADER = struct.Struct("<4sQI")  # magic, body_len, nbuf
_BUFLEN = struct.Struct("<Q")

# One frame may not declare more than this many payload bytes (body +
# out-of-band buffers). Generous — a full param publication or a
# sampled batch is megabytes — while still refusing a corrupt header
# before it allocates.
DEFAULT_MAX_FRAME_BYTES = 1 << 30  # 1 GiB

_HANDSHAKE_TIMEOUT_SECS = 10.0
_CHALLENGE_BYTES = 32
# Domain separation: the two handshake directions can never be
# reflected into each other.
_SERVER_DOMAIN = b"t2r-fleet-transport:server:"
_CLIENT_DOMAIN = b"t2r-fleet-transport:client:"


class FrameError(OSError):
  """A malformed or over-limit frame arrived; the connection is dead."""


def _digest(authkey: bytes, domain: bytes, challenge: bytes) -> bytes:
  return hmac.new(authkey, domain + challenge, "sha256").digest()


def _configure_socket(sock: socket.socket, sndbuf: int,
                      rcvbuf: int) -> None:
  sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
  if sndbuf:
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, int(sndbuf))
  if rcvbuf:
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, int(rcvbuf))


def encode_frame(obj: Any, max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES
                 ) -> List[memoryview]:
  """[header, body, raw buffers...] — ready for gather-send.

  Contiguous buffer-protocol payloads (numpy arrays) stay OUT of the
  pickle stream (protocol-5 out-of-band); anything that cannot expose
  raw contiguous memory falls back to the in-band stream.
  """
  buffers: List[pickle.PickleBuffer] = []
  try:
    body = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    raws = [b.raw() for b in buffers]
  except BufferError:
    # A non-contiguous out-of-band buffer slipped through (not a numpy
    # array — those only emit contiguous PickleBuffers): re-serialize
    # everything in-band rather than copy behind the caller's back.
    body = pickle.dumps(obj, protocol=5)
    raws = []
  total = len(body) + sum(r.nbytes for r in raws)
  if total > max_frame_bytes:
    raise ValueError(
        f"frame of {total} bytes exceeds max_frame_bytes="
        f"{max_frame_bytes}")
  parts = [memoryview(_HEADER.pack(MAGIC, len(body), len(raws)))]
  if raws:
    lens = b"".join(_BUFLEN.pack(r.nbytes) for r in raws)
    parts.append(memoryview(lens))
  parts.append(memoryview(body))
  parts.extend(raws)
  return parts


class TcpConnection:
  """One framed, authenticated socket: the stdlib-Connection shape
  (`send`/`recv`/`poll`/`close`) `rpc.py` is written against.

  Not thread-safe: single owner, like `rpc.RpcClient`; the server gives
  each connection its own handler thread.
  """

  def __init__(self, sock: socket.socket,
               max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
               track_buffers: bool = False):
    sock.settimeout(None)  # blocking data phase; poll() bounds waits
    self._sock: Optional[socket.socket] = sock
    self._max_frame = int(max_frame_bytes)
    self._track = track_buffers
    # Copy-count instrumentation: payload copies beyond the single
    # kernel crossing per side. Out-of-band buffers are sent straight
    # from the object's memory and received straight into their final
    # backing store, so both stay 0.
    self.last_send_oob_copies = 0
    self.last_recv_oob_copies = 0
    self.last_recv_buffers: List[bytearray] = []
    self._tm_bytes_sent = tmetrics.counter("fleet.wire.bytes_sent")
    self._tm_bytes_recv = tmetrics.counter("fleet.wire.bytes_received")
    self._tm_frames_sent = tmetrics.counter("fleet.wire.frames_sent")
    self._tm_frames_recv = tmetrics.counter("fleet.wire.frames_received")
    self._tm_oob = tmetrics.counter("fleet.wire.oob_buffers_sent")

  # ---- send ----

  def send(self, obj: Any) -> None:
    if self._sock is None:
      raise OSError("connection is closed")
    parts = encode_frame(obj, self._max_frame)
    noob = len(parts) - 2 - (1 if len(parts) > 2 else 0)
    total = sum(p.nbytes for p in parts)
    self._sendmsg_all(parts)
    self.last_send_oob_copies = 0  # gather-send: no user-space copy
    self._tm_bytes_sent.inc(total)
    self._tm_frames_sent.inc()
    if noob > 0:
      self._tm_oob.inc(noob)

  def _sendmsg_all(self, views: List[memoryview]) -> None:
    """Gather-send with partial-write handling (the normal TCP case)."""
    pending = [v.cast("B") if v.ndim != 1 or v.format != "B" else v
               for v in views]
    while pending:
      sent = self._sock.sendmsg(pending)
      while sent:
        head = pending[0]
        if sent >= head.nbytes:
          sent -= head.nbytes
          pending.pop(0)
        else:
          pending[0] = head[sent:]
          sent = 0

  # ---- recv ----

  def _recv_exact(self, view: memoryview) -> None:
    """Fills `view` across however many partial reads it takes."""
    got = 0
    while got < len(view):
      n = self._sock.recv_into(view[got:])
      if n == 0:
        raise EOFError("connection closed mid-frame")
      got += n

  def recv(self) -> Any:
    if self._sock is None:
      raise OSError("connection is closed")
    header = bytearray(_HEADER.size)
    self._recv_exact(memoryview(header))
    magic, body_len, nbuf = _HEADER.unpack(header)
    if magic != MAGIC:
      raise FrameError(f"bad frame magic {bytes(magic)!r}")
    # The guard runs on DECLARED lengths, before any allocation.
    if body_len > self._max_frame or nbuf > self._max_frame // 8:
      raise FrameError(
          f"frame declares body of {body_len} bytes / {nbuf} buffers "
          f"(max_frame_bytes={self._max_frame})")
    lens: List[int] = []
    if nbuf:
      raw_lens = bytearray(_BUFLEN.size * nbuf)
      self._recv_exact(memoryview(raw_lens))
      lens = [_BUFLEN.unpack_from(raw_lens, i * _BUFLEN.size)[0]
              for i in range(nbuf)]
    total = body_len + sum(lens)
    if total > self._max_frame:
      raise FrameError(
          f"frame declares {total} payload bytes "
          f"(max_frame_bytes={self._max_frame})")
    body = bytearray(body_len)
    self._recv_exact(memoryview(body))
    oob: List[bytearray] = []
    for length in lens:
      buf = bytearray(length)
      # recv_into the FINAL backing store: pickle.loads below hands
      # out views of these bytearrays, so the kernel→user read is the
      # only copy the payload ever takes on this side.
      self._recv_exact(memoryview(buf))
      oob.append(buf)
    self._tm_bytes_recv.inc(_HEADER.size + len(lens) * _BUFLEN.size
                            + total)
    self._tm_frames_recv.inc()
    self.last_recv_oob_copies = 0
    self.last_recv_buffers = oob if self._track else []
    return pickle.loads(body, buffers=[memoryview(b) for b in oob])

  # ---- the stdlib-Connection surface rpc.py uses ----

  def poll(self, timeout: Optional[float] = 0.0) -> bool:
    if self._sock is None:
      raise OSError("connection is closed")
    readable, _, _ = select.select([self._sock], [], [], timeout)
    return bool(readable)

  def fileno(self) -> int:
    if self._sock is None:
      raise OSError("connection is closed")
    return self._sock.fileno()

  def close(self) -> None:
    sock, self._sock = self._sock, None
    if sock is not None:
      try:
        sock.shutdown(socket.SHUT_RDWR)
      except OSError:
        pass
      sock.close()


# ---- handshake ----


def _send_block(sock: socket.socket, payload: bytes) -> None:
  sock.sendall(struct.pack("<I", len(payload)) + payload)


def _recv_block(sock: socket.socket, limit: int = 256) -> bytes:
  raw = bytearray(4)
  view = memoryview(raw)
  got = 0
  while got < 4:
    n = sock.recv_into(view[got:])
    if n == 0:
      raise EOFError("connection closed during handshake")
    got += n
  (length,) = struct.unpack("<I", raw)
  if length > limit:
    raise FrameError(f"handshake block of {length} bytes (limit {limit})")
  payload = bytearray(length)
  view = memoryview(payload)
  got = 0
  while got < length:
    n = sock.recv_into(view[got:])
    if n == 0:
      raise EOFError("connection closed during handshake")
    got += n
  return bytes(payload)


def _server_handshake(sock: socket.socket, authkey: bytes) -> None:
  challenge = os.urandom(_CHALLENGE_BYTES)
  _send_block(sock, challenge)
  answer = _recv_block(sock)
  if not hmac.compare_digest(
      answer, _digest(authkey, _SERVER_DOMAIN, challenge)):
    raise AuthenticationError("client failed the authkey challenge")
  client_challenge = _recv_block(sock)
  _send_block(sock, _digest(authkey, _CLIENT_DOMAIN, client_challenge))


def _client_handshake(sock: socket.socket, authkey: bytes) -> None:
  challenge = _recv_block(sock)
  _send_block(sock, _digest(authkey, _SERVER_DOMAIN, challenge))
  my_challenge = os.urandom(_CHALLENGE_BYTES)
  _send_block(sock, my_challenge)
  answer = _recv_block(sock)
  if not hmac.compare_digest(
      answer, _digest(authkey, _CLIENT_DOMAIN, my_challenge)):
    raise AuthenticationError("server failed the authkey challenge")


class TcpListener:
  """Bound TCP listener whose `accept` yields authenticated
  `TcpConnection`s — the stdlib-Listener shape `rpc.RpcServer` drives.
  """

  def __init__(self, host: str = "127.0.0.1", port: int = 0,
               authkey: bytes = b"", sndbuf: int = 0, rcvbuf: int = 0,
               max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
               backlog: int = 64):
    if not authkey:
      raise ValueError("TcpListener requires a non-empty authkey")
    self._authkey = authkey
    self._sndbuf = int(sndbuf)
    self._rcvbuf = int(rcvbuf)
    self._max_frame = int(max_frame_bytes)
    self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    self._sock.bind((host, int(port)))
    self._sock.listen(backlog)
    self.address: Tuple[str, int] = self._sock.getsockname()[:2]

  def accept(self) -> TcpConnection:
    """Blocks for one connection; auth/handshake failures raise
    `AuthenticationError` (the accept loop logs and keeps serving);
    only a closed listener raises `OSError` out of here."""
    sock, _ = self._sock.accept()  # OSError here = listener closed
    try:
      _configure_socket(sock, self._sndbuf, self._rcvbuf)
      sock.settimeout(_HANDSHAKE_TIMEOUT_SECS)
      _server_handshake(sock, self._authkey)
    except AuthenticationError:
      sock.close()
      raise
    except Exception as e:  # timeout / EOF / bad block mid-handshake
      sock.close()
      raise AuthenticationError(
          f"transport handshake failed: {e!r}") from e
    return TcpConnection(sock, max_frame_bytes=self._max_frame)

  def close(self) -> None:
    self._sock.close()


def connect_tcp(address: Tuple[str, int], authkey: bytes,
                sndbuf: int = 0, rcvbuf: int = 0,
                max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                track_buffers: bool = False) -> TcpConnection:
  """Dial + authenticate; raises `ConnectionRefusedError`/`OSError`
  while the server is still warming (the rpc.py connect-retry window)
  and `AuthenticationError` on a key mismatch (never retried)."""
  if not authkey:
    raise ValueError("connect_tcp requires a non-empty authkey")
  sock = socket.create_connection(tuple(address),
                                  timeout=_HANDSHAKE_TIMEOUT_SECS)
  try:
    _configure_socket(sock, sndbuf, rcvbuf)
    _client_handshake(sock, authkey)
  except AuthenticationError:
    sock.close()
    raise
  except Exception as e:
    sock.close()
    raise AuthenticationError(
        f"transport handshake failed: {e!r}") from e
  return TcpConnection(sock, max_frame_bytes=max_frame_bytes,
                       track_buffers=track_buffers)
