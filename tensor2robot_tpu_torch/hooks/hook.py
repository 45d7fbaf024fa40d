"""Hook protocol for the training loop (port of `hooks/hook.py`): the
trainer calls each hook at fixed points of its loop."""

from __future__ import annotations

from typing import Any, Iterable, Optional


class Hook:
  """Base hook: override any subset of the callbacks."""

  # Trainers read this to detect the online regime (actors feeding
  # replay while training), which changes the prefetch depth default.
  drives_online_collection: bool = False

  def begin(self, model, model_dir: str) -> None:
    """Called once before the first step."""

  def after_step(self, step: int, metrics: dict) -> None:
    """Called after every train step (metrics are device tensors)."""

  def after_checkpoint(self, step: int, state: Any,
                       model_dir: str) -> None:
    """Called after a checkpoint is saved at `step`."""

  def end(self, step: int, state: Any, model_dir: str) -> None:
    """Called once after training finishes."""


class HookList(Hook):
  """Fans callbacks out to a list of hooks."""

  def __init__(self, hooks: Optional[Iterable[Hook]] = None):
    self._hooks = list(hooks or [])

  @property
  def drives_online_collection(self) -> bool:  # type: ignore[override]
    return any(getattr(h, "drives_online_collection", False)
               for h in self._hooks)

  def begin(self, model, model_dir):
    for h in self._hooks:
      h.begin(model, model_dir)

  def after_step(self, step, metrics):
    for h in self._hooks:
      h.after_step(step, metrics)

  def after_checkpoint(self, step, state, model_dir):
    for h in self._hooks:
      h.after_checkpoint(step, state, model_dir)

  def end(self, step, state, model_dir):
    for h in self._hooks:
      h.end(step, state, model_dir)
