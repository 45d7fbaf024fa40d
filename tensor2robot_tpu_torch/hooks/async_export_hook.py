"""Async export hook: checkpoint → serving export during training (port
of `hooks/async_export_hook.py`).

During training, every Nth checkpoint is exported (`export/`) and
published to a directory that robots poll. Async means off the training
thread: the export (a `torch.export` trace per platform and its save,
seconds of host work) runs in one background worker while the steps go
on. If a new checkpoint lands while an export is still running, the
older request is dropped: robots want the newest model, never a backlog.

The snapshot is taken on the training thread: the params and batch
statistics copied to the host (`.detach().to("cpu")` copies, never
views), without the optimizer state. A graphed trainer's state lives in
CUDA-graph static buffers that the next replay overwrites in place.

The worker may trace the card's program while the training thread
captures a CUDA graph (an evaluation graph at its first pass). Captures
run in `capture_error_mode="thread_local"` with the collector held
(`utils.step_graph`), so the worker's own CUDA work (its copies to the
card, the trace's allocations) does not touch the capture; chip_smoke
phase 56 pins that on the card.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Optional

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.hooks.hook import Hook

log = logging.getLogger(__name__)


@gin.configurable
class AsyncExportHook(Hook):
  """Exports a serving artifact after every Nth checkpoint."""

  def __init__(self, export_generator,
               export_every_n_checkpoints: int = 1,
               export_dir_base: Optional[str] = None,
               block: bool = False):
    """Args:
      export_generator: an AbstractExportGenerator.
      export_every_n_checkpoints: cadence (1 = every checkpoint).
      export_dir_base: overrides the generator's target directory.
      block: run exports inline (tests / deterministic pipelines).
    """
    self._generator = export_generator
    if export_dir_base is not None:
      self._generator.set_export_dir_base(export_dir_base)
    self._every_n = max(1, int(export_every_n_checkpoints))
    self._block = block
    self._model = None
    self._count = 0
    self._lock = threading.Lock()
    self._pending: Optional[tuple] = None
    self._worker: Optional[threading.Thread] = None
    self.export_paths = []

  def begin(self, model, model_dir: str) -> None:
    self._model = model

  def after_checkpoint(self, step: int, state: Any,
                       model_dir: str) -> None:
    self._count += 1
    if self._count % self._every_n != 0:
      return
    # Imported here: the export stack imports the models, whose layers
    # import this package's users.
    from tensor2robot_tpu_torch.export.savedmodel_export_generator import (
        host_state as snapshot,
    )
    host_state = snapshot(state)
    if self._block:
      self._export(host_state, model_dir)
      return
    with self._lock:
      self._pending = (host_state, model_dir)
      if self._worker is None:
        self._worker = threading.Thread(
            target=self._drain, name="async-export", daemon=True)
        self._worker.start()

  def _drain(self) -> None:
    while True:
      with self._lock:
        if self._pending is None:
          # Hand back the worker slot under the same lock that guards
          # _pending: a checkpoint thread setting _pending either sees
          # it taken (this loop will pick the work up) or free (it
          # starts a fresh worker). No request can fall in between.
          self._worker = None
          return
        host_state, model_dir = self._pending
        self._pending = None
      self._export(host_state, model_dir)

  def _export(self, host_state, model_dir: str) -> None:
    try:
      path = self._generator.export(self._model, host_state, model_dir)
      self.export_paths.append(path)
      log.info("Exported serving model to %s", path)
    except Exception:  # noqa: BLE001 — export failure must not kill training
      log.exception("Async export failed; training continues.")

  def end(self, step: int, state: Any, model_dir: str) -> None:
    while True:
      with self._lock:
        worker = self._worker
      if worker is None:
        break
      worker.join(timeout=300.0)
      if worker.is_alive():
        log.warning("Async export still running at shutdown; detaching.")
        return
    # Drain anything that slipped in as the last worker exited, so the
    # final model always gets published.
    with self._lock:
      pending, self._pending = self._pending, None
    if pending is not None:
      self._export(*pending)
