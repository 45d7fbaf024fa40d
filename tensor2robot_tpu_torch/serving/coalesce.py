"""Request coalescing for the micro-batcher (port of `serving/coalesce.py`).

Requests are objects with ``features`` (a tree with a leading batch
dim of numpy leaves), ``n`` (rows) and ``future`` (a
`concurrent.futures.Future`). The four steps keep the JAX package's
contracts:

  * `take_batch` — first request (a carried-over request leads) plus
    whatever coalesces within the deadline, ≤ max_batch rows;
  * `claim_batch` — marks every taken request RUNNING; a future
    cancelled while queued is dropped here, so delivery cannot race;
  * `concat_features` / `deliver` — one concatenated dispatch in,
    per-caller ``.copy()``-ed slices out;
  * `fail_batch` — an error reaches every still-pending caller.
"""

from __future__ import annotations

import queue
import time
from concurrent import futures
from typing import Any, List, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch.utils import tree


def take_batch(source: "queue.Queue",
               carry,
               max_batch: int,
               max_wait_secs: float,
               first_timeout_secs: Optional[float] = None
               ) -> Tuple[List[Any], Any]:
  """Coalesces one dispatch's requests; returns ``(batch, carry')``."""
  if carry is not None:
    first, carry = carry, None
  else:
    try:
      first = (source.get(timeout=first_timeout_secs)
               if first_timeout_secs else source.get_nowait())
    except queue.Empty:
      return [], None
  batch = [first]
  rows = first.n
  deadline = time.perf_counter() + max_wait_secs
  while rows < max_batch:
    remaining = deadline - time.perf_counter()
    try:
      nxt = (source.get(timeout=remaining) if remaining > 0
             else source.get_nowait())
    except queue.Empty:
      break
    if rows + nxt.n > max_batch:
      carry = nxt
      break
    batch.append(nxt)
    rows += nxt.n
  return batch, carry


def claim_batch(batch: List[Any]) -> List[Any]:
  """RUNNING-marks the batch; returns the requests still live."""
  claimed = []
  for request in batch:
    try:
      if request.future.set_running_or_notify_cancel():
        claimed.append(request)
    except (futures.InvalidStateError, RuntimeError):
      # A racing close() already finished this future; not ours.
      pass
  return claimed


def concat_features(batch: List[Any]) -> Any:
  """One dispatch-ready features tree from the batch's requests."""
  return tree.map_structure(
      lambda *leaves: np.concatenate([np.asarray(a) for a in leaves],
                                     axis=0),
      *[request.features for request in batch])


def deliver(batch: List[Any], outputs: Any) -> None:
  """Scatters per-caller slices of ``outputs`` back to the futures."""
  offset = 0
  for request in batch:
    lo, hi = offset, offset + request.n
    request.future.set_result(
        tree.map_structure(lambda a: a[lo:hi].copy(), outputs))
    offset = hi


def fail_batch(batch: List[Any], exc: BaseException) -> None:
  """Delivers ``exc`` to every caller still waiting."""
  for request in batch:
    if not request.future.done():
      request.future.set_exception(exc)
