"""Batch-bucket math (port of `serving/bucketing.py`): powers-of-two
buckets + batch-dim padding.

Requests pad up to the next power-of-two bucket, so the engine serves
a finite set of shapes (the set later per-bucket CUDA graphs will
capture). Padding rows replicate the request's LAST real row rather
than zeros: replicated rows are in-distribution for any per-row
network, and eval-mode inference is row-independent, so pad rows
cannot change real rows' outputs (pinned by tests/test_torch_cem_policy.py).
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch.utils import tree


def bucket_table(max_batch: int) -> Tuple[int, ...]:
  """Powers of two 1, 2, 4, ... covering `max_batch` (last ≥ max_batch)."""
  if max_batch < 1:
    raise ValueError(f"max_batch must be >= 1, got {max_batch}")
  table = []
  b = 1
  while b < max_batch:
    table.append(b)
    b *= 2
  table.append(b)
  return tuple(table)


def bucket_for(n: int, table: Sequence[int]) -> int:
  """Smallest bucket holding n rows; raises when n exceeds the table."""
  if n < 1:
    raise ValueError(f"batch size must be >= 1, got {n}")
  for b in table:
    if n <= b:
      return b
  raise ValueError(
      f"batch size {n} exceeds the largest bucket {table[-1]}; raise "
      f"max_batch or split the request.")


def _pad_rows(array: np.ndarray, bucket: int) -> np.ndarray:
  n = array.shape[0]
  if n == bucket:
    return array
  pad = np.repeat(array[-1:], bucket - n, axis=0)
  return np.concatenate([array, pad], axis=0)


def pad_batch(features: Any, bucket: int) -> Any:
  """Pads every leaf's leading dim up to `bucket` (last-row replication)."""
  return tree.map_structure(lambda a: _pad_rows(np.asarray(a), bucket),
                            features)


def unpad_batch(outputs: Any, n: int) -> Any:
  """Slices every leaf back to the request's true n rows."""
  return tree.map_structure(lambda a: a[:n], outputs)
