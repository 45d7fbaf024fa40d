"""Launch counts of the kernel wrappers.

Each wrapper counts its kernel's launches in a plain integer,
`<wrapper>.launches`, through `count`. Work queued on a stream that is
capturing a CUDA graph launches nothing: inside `recording(stream)` the
counts of launches queued on that stream go to the recording instead
(from any thread: autograd runs a backward on threads of its own, on the
stream of the forward), and the graph's owner adds them once per replay
(`add`). Launches of a graph's warm-up calls before its capture ran and
count; `warmups()` tallies them apart as well, so that a reader can
tell N replays' launches from the warm-up's.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Iterator

import torch

_LOCK = threading.Lock()
_RECORDINGS: Dict[Any, Dict[Callable, int]] = {}  # stream key → recording
_WARMUPS: Dict[Callable, int] = {}


def stream_key(stream: Any = None) -> Any:
  """The key of `stream` (default: the current CUDA stream)."""
  if stream is None:
    stream = torch.cuda.current_stream()
  return stream.cuda_stream


def count(wrapper: Callable) -> None:
  """One launch of `wrapper`'s kernel, on the current CUDA stream."""
  with _LOCK:
    recording = _RECORDINGS.get(stream_key()) if _RECORDINGS else None
    if recording is not None:
      recording[wrapper] = recording.get(wrapper, 0) + 1
    else:
      wrapper.launches += 1


def add(deltas: Dict[Callable, int], warmup: bool = False) -> None:
  """Adds `deltas` (wrapper → launches) to the wrappers' counts; with
  `warmup`, to the warm-up tally too."""
  with _LOCK:
    for wrapper, n in deltas.items():
      wrapper.launches += n
      if warmup:
        _WARMUPS[wrapper] = _WARMUPS.get(wrapper, 0) + n


def warmups() -> Dict[Callable, int]:
  """Launches made by graph warm-ups since `clear_warmups()`."""
  with _LOCK:
    return dict(_WARMUPS)


def clear_warmups() -> None:
  with _LOCK:
    _WARMUPS.clear()


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
