"""Shared-memory batch ring: the zero-copy seam of the host data plane
(port of `data/shm_ring.py`).

A ring of fixed-size slots in one `multiprocessing.shared_memory`
segment. Each slot holds one finished batch laid out by a `WireLayout`,
every key at a fixed 64-byte-aligned offset, so a producer process
fills a slot with plain copies (`write`) and the consumer maps the same
bytes as arrays without copying (`views`).

bfloat16 fields travel as their uint16 bits (numpy has no bfloat16
without `ml_dtypes`): `write` takes a torch bfloat16 tensor, and
`views` gives a torch bfloat16 tensor over the slot's bytes.

Slot accounting (which slots are free, which hold finished batches)
lives in `data.plane`; nothing here synchronizes. A view is valid only
until its slot goes back to a producer; anyone keeping a batch past
that point must copy it.
"""

from __future__ import annotations

from multiprocessing import shared_memory
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.specs.tensorspec import numpy_dtype

_ALIGN = 64  # cache-line alignment for every array start
_BF16 = "bfloat16"


def _dtype_name(dtype) -> str:
  return _BF16 if dtype is torch.bfloat16 or str(dtype) == _BF16 else (
      np.dtype(dtype).name)


def _wire_array(value: Any) -> np.ndarray:
  """A batch leaf as numpy (a bfloat16 tensor as its uint16 bits)."""
  if isinstance(value, torch.Tensor):
    if value.dtype is torch.bfloat16:
      return value.contiguous().view(torch.int16).numpy().view(np.uint16)
    return value.numpy()
  return np.asarray(value)


def _leaf(array: np.ndarray, dtype: str):
  """A slot array in its field's dtype (a bfloat16 tensor view)."""
  if dtype == _BF16:
    return torch.from_numpy(array.view(np.int16)).view(torch.bfloat16)
  return array


class WireLayout:
  """Fixed (key, shape, dtype) fields → slot byte layout.

  Shapes are full batch shapes ([B, ...]). Both sides compute the layout
  independently from the same specs, so field order is deterministic
  (sorted keys, then the extra fields).
  """

  def __init__(self, fields: Sequence[Tuple[str, Tuple[int, ...], str]]):
    if not fields:
      raise ValueError("WireLayout needs at least one field")
    self.fields: List[Tuple[str, Tuple[int, ...], str]] = [
        (str(k), tuple(int(d) for d in shape), _dtype_name(dtype))
        for k, shape, dtype in fields]
    self.offsets: Dict[str, int] = {}
    cursor = 0
    for key, shape, dtype in self.fields:
      if key in self.offsets:
        raise ValueError(f"Duplicate layout key {key!r}")
      cursor = -(-cursor // _ALIGN) * _ALIGN  # round up
      self.offsets[key] = cursor
      cursor += int(np.prod(shape, dtype=np.int64)) * numpy_dtype(
          dtype).itemsize
    self.slot_bytes = max(-(-cursor // _ALIGN) * _ALIGN, _ALIGN)

  @classmethod
  def from_flat_specs(cls, flat_specs: Dict[str, object], batch_size: int,
                      leading_dims: Optional[Dict[str, Tuple[int, ...]]] = None,
                      extra_fields: Iterable[
                          Tuple[str, Tuple[int, ...], str]] = ()):
    """Layout for the [B, ...]-batched parse output of flat specs;
    `leading_dims` inserts per-key dims after the batch dim (the episode
    generator's [B, T, ...]), `extra_fields` appends spec-less keys."""
    leading_dims = leading_dims or {}
    fields = []
    for key in sorted(flat_specs):
      spec = flat_specs[key]
      shape = ((batch_size,) + tuple(leading_dims.get(key, ()))
               + tuple(int(d) for d in spec.shape))
      fields.append((key, shape, _dtype_name(spec.dtype)))
    fields.extend(extra_fields)
    return cls(fields)

  def check_batch(self, flat: Dict[str, Any]) -> None:
    """Raises if a producer batch doesn't conform (shape/dtype/keys)."""
    keys = {k for k, _, _ in self.fields}
    if set(flat) != keys:
      raise ValueError(
          f"Batch keys {sorted(flat)} != layout keys {sorted(keys)}")
    for key, shape, dtype in self.fields:
      value = flat[key]
      got = _dtype_name(value.dtype) if isinstance(
          value, torch.Tensor) else np.asarray(value).dtype.name
      if tuple(value.shape) != shape or got != dtype:
        raise ValueError(
            f"Field {key!r}: got {got} {tuple(value.shape)}, layout says "
            f"{dtype} {shape}")


class ShmRing:
  """`num_slots` fixed-layout batch slots in one shared segment."""

  def __init__(self, layout: WireLayout, num_slots: int,
               name: Optional[str] = None, create: bool = True):
    if num_slots < 1:
      raise ValueError(f"num_slots must be >= 1, got {num_slots}")
    self.layout = layout
    self.num_slots = int(num_slots)
    if create:
      self._shm = shared_memory.SharedMemory(
          create=True, size=layout.slot_bytes * self.num_slots)
    else:
      self._shm = shared_memory.SharedMemory(name=name)
    self._owner = create
    self._closed = False

  @property
  def name(self) -> str:
    return self._shm.name

  @classmethod
  def attach(cls, name: str, layout: WireLayout,
             num_slots: int) -> "ShmRing":
    """Maps an existing ring (worker side), kept out of the resource
    tracker: ownership is the creator's alone, and a worker's
    registration would race the creator's unlink (and, before Python
    3.13, have the tracker unlink a segment its siblings still use)."""
    from multiprocessing import resource_tracker
    orig_register = resource_tracker.register

    def _no_shm_register(rname, rtype):
      if rtype != "shared_memory":
        orig_register(rname, rtype)

    resource_tracker.register = _no_shm_register
    try:
      return cls(layout, num_slots, name=name, create=False)
    finally:
      resource_tracker.register = orig_register

  def _view(self, slot: int, key: str, shape, dtype) -> np.ndarray:
    base = slot * self.layout.slot_bytes + self.layout.offsets[key]
    return np.ndarray(shape, dtype=numpy_dtype(dtype), buffer=self._shm.buf,
                      offset=base)

  def write(self, slot: int, flat: Dict[str, Any]) -> None:
    """Producer: copy one conforming batch into `slot`."""
    self.layout.check_batch(flat)
    for key, shape, dtype in self.layout.fields:
      np.copyto(self._view(slot, key, shape, dtype), _wire_array(flat[key]))

  def views(self, slot: int) -> Dict[str, Any]:
    """Consumer: zero-copy views of one slot (valid until the slot is
    handed back to a producer)."""
    if not 0 <= slot < self.num_slots:
      raise IndexError(f"slot {slot} out of range 0..{self.num_slots - 1}")
    return {key: _leaf(self._view(slot, key, shape, dtype), dtype)
            for key, shape, dtype in self.layout.fields}

  def close(self) -> None:
    """Unmaps; the creating side also unlinks the segment."""
    if self._closed:
      return
    self._closed = True
    try:
      self._shm.close()
    except BufferError:
      # Live views pin the map (an exception unwinding mid-step): leave
      # it to process exit; the unlink below still removes the name.
      pass
    if self._owner:
      try:
        self._shm.unlink()
      except FileNotFoundError:  # pragma: no cover - double close race
        pass
