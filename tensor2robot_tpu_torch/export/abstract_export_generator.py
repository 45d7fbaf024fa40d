"""Export generator protocol: trained state → serving artifact (port of
`export/abstract_export_generator.py`).

An exporter takes the model and a `TrainState` and writes a
self-describing artifact under a timestamped directory, whose spec
assets let a predictor rebuild the serving contract without the model
class. `sanitize_signature_key` / `check_signature_keys` are the wire
contract between exporters and predictors; `claim_timestamped_export_dir`
and `latest_export_dir` are the publish/poll protocol.
"""

from __future__ import annotations

import abc
import os
import time
from typing import Any, Optional


def sanitize_signature_key(key: str) -> str:
  """Flat spec key → signature input name (no '/' allowed).

  This is a WIRE CONTRACT between exporters and predictors; both sides
  must use this one helper. The mapping is not injective ('a/b' and
  'a_b' collide): exporters must call `check_signature_keys` over the
  full key set so a colliding spec fails loudly at export time instead
  of producing an ambiguous feed.
  """
  return key.replace("/", "_")


def check_signature_keys(keys) -> None:
  """Raises if two flat spec keys sanitize to the same input name."""
  seen = {}
  for key in keys:
    name = sanitize_signature_key(key)
    if name in seen and seen[name] != key:
      raise ValueError(
          f"Flat spec keys {seen[name]!r} and {key!r} both sanitize to "
          f"signature name {name!r}; rename one — the serving feed "
          "would be ambiguous.")
    seen[name] = key


def claim_timestamped_export_dir(export_dir_base: str) -> tuple:
  """Atomically claims `<base>/<unix_ts>`; returns (final_dir, tmp_dir).

  Monotonic timestamp dirs, so pollers pick `max()`. The claim is the
  mkdir of `<ts>.tmp` (atomic on POSIX): concurrent exporters (the async
  export hook's thread racing the end-of-training exporter within the
  same second) get distinct timestamps instead of colliding inside one
  half-written artifact. The caller writes into tmp_dir and publishes
  with os.rename(tmp_dir, final_dir).
  """
  os.makedirs(export_dir_base, exist_ok=True)
  ts = int(time.time())
  while True:
    path = os.path.join(export_dir_base, str(ts))
    tmp = path + ".tmp"
    if not os.path.exists(path):
      try:
        os.mkdir(tmp)
        return path, tmp
      except FileExistsError:
        pass
    ts += 1


def latest_export_dir(export_dir_base: str) -> Optional[str]:
  """Largest finalized timestamped subdir, or None."""
  if not os.path.isdir(export_dir_base):
    return None
  candidates = [d for d in os.listdir(export_dir_base)
                if d.isdigit()
                and not d.endswith(".tmp")
                and os.path.isdir(os.path.join(export_dir_base, d))]
  if not candidates:
    return None
  return os.path.join(export_dir_base, max(candidates, key=int))


class AbstractExportGenerator(abc.ABC):
  """Builds serving artifacts from a model + TrainState."""

  def __init__(self, export_dir_base: Optional[str] = None):
    self._export_dir_base = export_dir_base

  def export_dir_base(self, model_dir: str) -> str:
    return self._export_dir_base or os.path.join(model_dir, "export")

  def set_export_dir_base(self, export_dir_base: str) -> None:
    """Public override point (used by e.g. AsyncExportHook)."""
    self._export_dir_base = export_dir_base

  @abc.abstractmethod
  def export(self, model: Any, state: Any, model_dir: str) -> str:
    """Writes one serving artifact; returns its path."""
