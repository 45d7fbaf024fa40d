"""Checkpoints (port of `utils/checkpoints.py`): save, list, restore.

The port's own format, not orbax's: `torch.save` of the state's leaves
at `<model_dir>/ckpt/<step>/state.pt`, written to a temporary name and
renamed, so a reader never sees a partial file. A state is stored as
`{"leaves": {path: leaf}}`, each tensor on the CPU, where a path names
the leaf's place in the state (dataclass fields, named-tuple fields,
dict keys and tuple positions joined by "/"); `restore_state` rebuilds
the structure of a `like` state with the stored leaves, on each `like`
leaf's device and dtype, and loads with `weights_only=True`. Saves are
synchronous. The JAX package writes a separate inference-variables
payload; the port's predictors and warm starts read params and batch
statistics out of the one state file (`restore_variables`,
`restore_params`: a model_dir, a step directory or the file itself), so
it is not written.

A pipeline rank holds one stage of the stage-stacked leaves: its
checkpoints are written in the one-device layout (`gather_state` on the
stage ring, rank 0 writes) and resumed by slicing it again
(`restore_state(..., mesh=)`), so a pipeline checkpoint serves on one
device unchanged.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional

import torch

CKPT_SUBDIR = "ckpt"


def _ckpt_root(model_dir: str) -> str:
  return os.path.join(model_dir, CKPT_SUBDIR)


def _fields(node) -> Optional[Dict[str, Any]]:
  """A container's children by name, or None for a leaf."""
  if dataclasses.is_dataclass(node) and not isinstance(node, type):
    return {f.name: getattr(node, f.name) for f in dataclasses.fields(node)}
  if isinstance(node, tuple) and hasattr(node, "_fields"):
    return dict(zip(node._fields, node))
  if isinstance(node, dict):
    return {str(k): v for k, v in node.items()}
  if isinstance(node, (tuple, list)):
    return {str(i): v for i, v in enumerate(node)}
  return None


def flatten_state(state: Any, prefix: str = "") -> Dict[str, Any]:
  """{path: leaf} of a state; tensors detached and on the CPU."""
  children = _fields(state)
  if children is None:
    if isinstance(state, torch.Tensor):
      return {prefix: state.detach().cpu()}
    return {prefix: state}
  out = {}
  for name, child in children.items():
    out.update(flatten_state(child, f"{prefix}/{name}" if prefix else name))
  return out


def tensor_digests(tensors: Dict[str, torch.Tensor]) -> Dict[str, str]:
  """SHA-256 of each tensor's bytes (on the CPU), keyed by name."""
  return {name: hashlib.sha256(
      value.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
          for name, value in sorted(tensors.items())}


def unflatten_state(like: Any, leaves: Dict[str, Any]) -> Any:
  """`flatten_state`'s inverse: `leaves` in `like`'s structure, each
  tensor on its `like` leaf's device and dtype."""
  return _rebuild(like, leaves)


def _rebuild(like: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
  children = _fields(like)
  if children is None:
    value = leaves[prefix]
    if isinstance(like, torch.Tensor):
      return value.to(device=like.device, dtype=like.dtype)
    return value
  built = {name: _rebuild(child, leaves,
                          f"{prefix}/{name}" if prefix else name)
           for name, child in children.items()}
  if dataclasses.is_dataclass(like):
    return dataclasses.replace(like, **built)
  if isinstance(like, tuple) and hasattr(like, "_fields"):
    return type(like)(**built)
  if isinstance(like, dict):
    return {k: built[str(k)] for k in like}
  return type(like)(built[str(i)] for i in range(len(like)))


def list_steps(model_dir: str) -> List[int]:
  """Steps whose state has been written."""
  root = _ckpt_root(model_dir)
  if not os.path.isdir(root):
    return []
  return sorted(int(e) for e in os.listdir(root)
                if re.fullmatch(r"\d+", e)
                and os.path.isfile(os.path.join(root, e, "state.pt")))


def latest_step(model_dir: str) -> Optional[int]:
  steps = list_steps(model_dir)
  return steps[-1] if steps else None


def wait_for_new_checkpoint(model_dir: str,
                            last_step: Optional[int] = None,
                            timeout_secs: Optional[float] = None,
                            poll_interval_secs: float = 1.0) -> Optional[int]:
  """Blocks until a checkpoint newer than `last_step` is written; returns
  its step, or None after `timeout_secs`."""
  deadline = None if timeout_secs is None else time.time() + timeout_secs
  while True:
    step = latest_step(model_dir)
    if step is not None and (last_step is None or step > last_step):
      return step
    if deadline is not None and time.time() > deadline:
      return None
    time.sleep(poll_interval_secs)


def _atomic_save(obj: Any, path: str) -> None:
  tmp = f"{path}.tmp"
  torch.save(obj, tmp)
  os.replace(tmp, path)


class CheckpointWriter:
  """Synchronous writer that keeps the newest `max_to_keep` steps."""

  def __init__(self, model_dir: str, max_to_keep: Optional[int] = 5):
    self._root = _ckpt_root(model_dir)
    os.makedirs(self._root, exist_ok=True)
    self._max_to_keep = max_to_keep

  def save(self, step: int, state: Any) -> None:
    step_dir = os.path.join(self._root, str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    _atomic_save({"leaves": flatten_state(state)},
                 os.path.join(step_dir, "state.pt"))
    self._gc()

  def _gc(self) -> None:
    if self._max_to_keep is None:
      return
    steps = sorted(int(e) for e in os.listdir(self._root)
                   if re.fullmatch(r"\d+", e))
    for step in steps[:max(len(steps) - self._max_to_keep, 0)]:
      shutil.rmtree(os.path.join(self._root, str(step)), ignore_errors=True)


def _step_file(model_dir: str, step: int) -> str:
  return os.path.join(_ckpt_root(model_dir), str(int(step)), "state.pt")


def _load_leaves(model_dir: str, step: Optional[int]) -> Dict[str, Any]:
  if step is None:
    step = latest_step(model_dir)
    if step is None:
      raise FileNotFoundError(
          f"No checkpoints found under {_ckpt_root(model_dir)}")
  return _read(_step_file(model_dir, step))


def _read(path: str) -> Dict[str, Any]:
  return torch.load(path, map_location="cpu", weights_only=True)["leaves"]


def restore_state(model_dir: str, like: Any,
                  step: Optional[int] = None, mesh=None) -> Any:
  """The state saved at `step` (default: the latest), in `like`'s
  structure, each tensor on its `like` leaf's device and dtype. With a
  pipeline `mesh` (a `stage` axis above 1) the one-device layout is
  sliced to this rank's stage (`parallel.sharding.shard_state`)."""
  leaves = _load_leaves(model_dir, step)
  if _pipelined(mesh):
    from tensor2robot_tpu_torch.parallel import sharding
    leaves = sharding.shard_state(leaves, mesh)
  return _rebuild(like, leaves)


def _pipelined(mesh) -> bool:
  from tensor2robot_tpu_torch.parallel import pipeline
  return pipeline.is_pipelined(mesh)


def gather_state(state: Any, mesh) -> Optional[Dict[str, Any]]:
  """A pipeline rank's state in the one-device layout, flat: on the
  mesh's rank 0 `flatten_state` of the whole state, each stage-stacked
  leaf (`parallel.sharding.is_stage_stacked`) concatenated over the
  stage ring; None on every other rank. Collective over the stage ring
  of data index 0: those ranks must all call it (the others return
  None at once). Without a pipeline mesh, `flatten_state(state)`."""
  flat = flatten_state(state)
  if not _pipelined(mesh):
    return flat
  from tensor2robot_tpu_torch.parallel import collectives, sharding
  if mesh.axis_index("data"):
    return None
  stacked = {k: v for k, v in flat.items() if sharding.is_stage_stacked(k)}
  parts = collectives.all_gather_object(stacked, mesh.group("stage"))
  if mesh.rank != 0:
    return None
  flat.update({k: torch.cat([part[k] for part in parts])
               for k in stacked})
  return flat


def _find_params_path(path_or_model_dir: str,
                      step: Optional[int] = None) -> str:
  """The state file of a model_dir (at `step`, else its latest step), of
  a step directory, or a direct path to a state file."""
  candidates = []
  if step is not None:
    candidates.append(_step_file(path_or_model_dir, step))
  else:
    found = latest_step(path_or_model_dir)
    if found is not None:
      candidates.append(_step_file(path_or_model_dir, found))
    candidates.append(os.path.join(path_or_model_dir, "state.pt"))
    candidates.append(path_or_model_dir)
  for path in candidates:
    if os.path.isfile(path):
      return path
  raise FileNotFoundError(
      f"No params checkpoint found at any of: {candidates}")


def _subtree(leaves: Dict[str, Any], name: str) -> Dict[str, Any]:
  prefix = name + "/"
  return {k[len(prefix):]: v for k, v in leaves.items()
          if k.startswith(prefix)}


def _adopt_like(like: Dict[str, Any], restored: Dict[str, Any],
                path: str) -> Dict[str, Any]:
  """`restored`'s leaves, keyed and typed like `like` (each on its
  `like` leaf's device and dtype)."""
  missing = sorted(set(like) - set(restored))
  if missing:
    raise KeyError(f"Checkpoint {path} lacks {missing}")
  return {k: restored[k].to(device=v.device, dtype=v.dtype)
          for k, v in like.items()}


def restore_variables(path_or_model_dir: str, like: Dict[str, Any],
                      step: Optional[int] = None) -> Dict[str, Any]:
  """The inference variables ``{"params": ..., "batch_stats": ...}`` of
  a model_dir (at `step`, else the latest), a step directory or a state
  file, in `like`'s structure, each tensor on its `like` leaf's device
  and dtype. The optimizer state in the same file is not read. A payload
  without batch statistics keeps `like`'s, with a warning (the JAX
  package's rule for payloads that predate them)."""
  path = _find_params_path(path_or_model_dir, step)
  leaves = _read(path)
  restored = _subtree(leaves, "params")
  if not restored:
    restored = dict(leaves)  # a bare params payload
  out = {"params": _adopt_like(like["params"], restored, path)}
  like_stats = like.get("batch_stats", {})
  stats = _subtree(leaves, "batch_stats")
  if like_stats and not stats:
    import logging
    logging.getLogger(__name__).warning(
        "Params payload at %s carries no batch_stats; BN stats keep their "
        "current (init) values.", path)
  out["batch_stats"] = (_adopt_like(like_stats, stats, path)
                        if like_stats and stats else like_stats)
  return out


def restore_params(path_or_model_dir: str, like: Dict[str, Any],
                   step: Optional[int] = None) -> Dict[str, Any]:
  """Just the params, for warm starts: `like` is the params dict alone.

  Accepts a model_dir (the latest step, or `step`), a step directory, or
  a direct state file. A payload that also carries batch statistics (or
  a whole state) yields its params subtree; the leaves take `like`'s
  dtype and device."""
  path = _find_params_path(path_or_model_dir, step)
  leaves = _read(path)
  restored = _subtree(leaves, "params") or dict(leaves)
  return _adopt_like(like, restored, path)
