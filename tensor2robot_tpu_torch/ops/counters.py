"""Launch counts of the kernel wrappers.

Each wrapper counts its kernel's launches in a plain integer,
`<wrapper>.launches`, through `count`. Work queued on a stream that is
capturing a CUDA graph launches nothing: inside `recording(stream)` the
counts of launches queued on that stream go to the recording instead
(from any thread: autograd runs a backward on threads of its own, on the
stream of the forward), and the graph's owner adds them once per replay
(`add`). Launches of a graph's warm-up calls before its capture ran and
count; `warmups()` tallies them apart as well, so that a reader can
tell N replays' launches from the warm-up's. `by_thread()` splits the
counts by the name of the thread that launched (a replay's, the
replaying thread's), so that a reader can tell apart paths that run
on threads of their own, such as a server's dispatcher.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Iterator

import torch

_LOCK = threading.Lock()
_RECORDINGS: Dict[Any, Dict[Callable, int]] = {}  # stream key → recording
_WARMUPS: Dict[Callable, int] = {}
_BY_THREAD: Dict[str, Dict[Callable, int]] = {}  # thread name → counts


def stream_key(stream: Any = None) -> Any:
  """The key of `stream` (default: the current CUDA stream)."""
  if stream is None:
    stream = torch.cuda.current_stream()
  return stream.cuda_stream


def _launched(wrapper: Callable, n: int) -> None:
  """Adds `n` to `wrapper`'s count and to this thread's (under _LOCK)."""
  wrapper.launches += n
  mine = _BY_THREAD.setdefault(threading.current_thread().name, {})
  mine[wrapper] = mine.get(wrapper, 0) + n


def count(wrapper: Callable) -> None:
  """One launch of `wrapper`'s kernel, on the current CUDA stream."""
  with _LOCK:
    recording = _RECORDINGS.get(stream_key()) if _RECORDINGS else None
    if recording is not None:
      recording[wrapper] = recording.get(wrapper, 0) + 1
    else:
      _launched(wrapper, 1)


def add(deltas: Dict[Callable, int], warmup: bool = False) -> None:
  """Adds `deltas` (wrapper → launches) to the wrappers' counts; with
  `warmup`, to the warm-up tally too."""
  with _LOCK:
    for wrapper, n in deltas.items():
      _launched(wrapper, n)
      if warmup:
        _WARMUPS[wrapper] = _WARMUPS.get(wrapper, 0) + n


def warmups() -> Dict[Callable, int]:
  """Launches made by graph warm-ups since `clear_warmups()`."""
  with _LOCK:
    return dict(_WARMUPS)


def clear_warmups() -> None:
  with _LOCK:
    _WARMUPS.clear()


def by_thread() -> Dict[str, Dict[Callable, int]]:
  """Launches since `clear_by_thread()`, by launching thread's name."""
  with _LOCK:
    return {name: dict(n) for name, n in _BY_THREAD.items()}


def clear_by_thread() -> None:
  with _LOCK:
    _BY_THREAD.clear()


@contextlib.contextmanager
def recording(stream: Any) -> Iterator[Dict[Callable, int]]:
  """Launches queued on `stream` meanwhile, by wrapper, instead of the
  counts."""
  key = stream_key(stream)
  rec: Dict[Callable, int] = {}
  with _LOCK:
    _RECORDINGS[key] = rec
  try:
    yield rec
  finally:
    with _LOCK:
      del _RECORDINGS[key]
