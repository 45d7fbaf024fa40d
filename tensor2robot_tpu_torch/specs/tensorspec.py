"""Declarative tensor specifications (port of `specs/tensorspec.py`).

`ExtendedTensorSpec` and `TensorSpecStruct` keep the JAX package's
semantics: immutable logical (unbatched) shapes, '/'-joined flat paths,
insertion-ordered leaves. What stays behind: the jax pytree
registration (`utils.tree.map_structure` walks structs instead),
`to_shape_dtype_struct`, and the `PartitionSpec` sharding field.

dtypes are numpy dtypes; bfloat16 is kept as `torch.bfloat16`, since
numpy has no bfloat16 of its own without `ml_dtypes`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

PATH_SEP = "/"

_VALID_NAME_RE = re.compile(r"^[A-Za-z0-9_.\-]+$")

_TORCH_TO_NUMPY = {
    torch.float32: np.float32, torch.float64: np.float64,
    torch.float16: np.float16, torch.uint8: np.uint8,
    torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32,
    torch.int64: np.int64, torch.bool: np.bool_,
}


def _normalize_dtype(dtype: Any):
  """numpy dtype, or `torch.bfloat16` for bfloat16 in any spelling."""
  if dtype is None:
    raise ValueError("TensorSpec dtype must not be None.")
  if dtype is torch.bfloat16 or getattr(dtype, "name", dtype) == "bfloat16":
    return torch.bfloat16
  if isinstance(dtype, torch.dtype):
    return np.dtype(_TORCH_TO_NUMPY[dtype])
  return np.dtype(dtype)


def numpy_dtype(dtype: Any) -> np.dtype:
  """A spec dtype as numpy holds it: bfloat16 travels as its uint16 bits."""
  dtype = _normalize_dtype(dtype)
  return np.dtype(np.uint16) if dtype is torch.bfloat16 else dtype


@dataclasses.dataclass(frozen=True)
class ExtendedTensorSpec:
  """An immutable tensor declaration with data-pipeline metadata.

  See the JAX package's class for the meaning of each field.
  """

  shape: Tuple[int, ...]
  dtype: Any
  name: Optional[str] = None
  is_optional: bool = False
  is_sequence: bool = False
  data_format: Optional[str] = None
  dataset_key: str = ""
  varlen: bool = False

  def __post_init__(self):
    shape = tuple(int(d) for d in self.shape)
    if any(d <= 0 for d in shape):
      raise ValueError(
          f"ExtendedTensorSpec shapes must be fully-defined and positive, "
          f"got {shape} for name={self.name!r}.")
    object.__setattr__(self, "shape", shape)
    object.__setattr__(self, "dtype", _normalize_dtype(self.dtype))
    if self.name is not None and not _VALID_NAME_RE.match(self.name):
      raise ValueError(f"Invalid spec name: {self.name!r}")
    if self.data_format is not None and self.data_format not in (
        "jpeg", "png", "raw"):
      raise ValueError(f"Unsupported data_format: {self.data_format!r}")

  @classmethod
  def from_spec(cls, spec: "ExtendedTensorSpec",
                **overrides) -> "ExtendedTensorSpec":
    kwargs = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(spec)}
    kwargs.update(overrides)
    return cls(**kwargs)

  @classmethod
  def from_array(cls, array: Any,
                 name: Optional[str] = None) -> "ExtendedTensorSpec":
    arr = array if hasattr(array, "dtype") else np.asarray(array)
    return cls(shape=tuple(arr.shape), dtype=arr.dtype, name=name)

  @property
  def is_image(self) -> bool:
    return self.data_format in ("jpeg", "png")

  def replace(self, **overrides) -> "ExtendedTensorSpec":
    return self.from_spec(self, **overrides)


TensorSpec = ExtendedTensorSpec


class TensorSpecStruct(Mapping[str, Any]):
  """Ordered, nested attribute/dict hybrid over flat '/' paths."""

  __slots__ = ("_flat",)

  def __init__(self, *args, **kwargs):
    object.__setattr__(self, "_flat", {})
    init = {}
    if args:
      if len(args) > 1:
        raise TypeError("TensorSpecStruct takes at most one positional arg")
      src = args[0]
      init.update(src._flat if isinstance(src, TensorSpecStruct)
                  else dict(src))
    init.update(kwargs)
    for key, value in init.items():
      self[key] = value

  def _subkeys(self, prefix: str):
    prefix_sep = prefix + PATH_SEP
    return [k for k in self._flat if k.startswith(prefix_sep)]

  def __getitem__(self, key: str):
    if not isinstance(key, str):
      raise TypeError(f"Keys must be str, got {type(key)}")
    if key in self._flat:
      return self._flat[key]
    sub = self._subkeys(key)
    if sub:
      cut = len(key) + len(PATH_SEP)
      return TensorSpecStruct({k[cut:]: self._flat[k] for k in sub})
    raise KeyError(key)

  def __setitem__(self, key: str, value: Any):
    if not isinstance(key, str) or not key or key.startswith(PATH_SEP):
      raise KeyError(f"Invalid key: {key!r}")
    self._delete_prefix(key, missing_ok=True)
    if isinstance(value, (TensorSpecStruct, dict)):
      items = (value if isinstance(value, TensorSpecStruct)
               else TensorSpecStruct(value))._flat.items()
      for sub_key, leaf in items:
        self._flat[f"{key}{PATH_SEP}{sub_key}"] = leaf
    else:
      self._flat[key] = value

  def _delete_prefix(self, key: str, missing_ok: bool = False):
    found = self._flat.pop(key, _MISSING) is not _MISSING
    for k in self._subkeys(key):
      del self._flat[k]
      found = True
    if not found and not missing_ok:
      raise KeyError(key)

  def __delitem__(self, key: str):
    self._delete_prefix(key)

  def __contains__(self, key) -> bool:
    return key in self._flat or bool(self._subkeys(key))

  def __iter__(self) -> Iterator[str]:
    seen = []
    for k in self._flat:
      top = k.split(PATH_SEP, 1)[0]
      if top not in seen:
        seen.append(top)
    return iter(seen)

  def __len__(self) -> int:
    return sum(1 for _ in self)

  def __getattr__(self, name: str):
    if name.startswith("_"):
      raise AttributeError(name)
    try:
      return self[name]
    except KeyError as e:
      raise AttributeError(name) from e

  def __setattr__(self, name: str, value: Any):
    if name.startswith("_"):
      object.__setattr__(self, name, value)
    else:
      self[name] = value

  def __delattr__(self, name: str):
    try:
      del self[name]
    except KeyError as e:
      raise AttributeError(name) from e

  def to_flat_dict(self) -> dict:
    """Flat '/'-path → leaf dict (insertion-ordered copy)."""
    return dict(self._flat)

  @classmethod
  def from_flat_dict(cls, flat: Mapping[str, Any]) -> "TensorSpecStruct":
    out = cls()
    out._flat.update(flat)
    return out

  def to_nested_dict(self) -> dict:
    """The leaves as nested dicts, one level per path component."""
    out: dict = {}
    for path, leaf in self._flat.items():
      *parents, last = path.split(PATH_SEP)
      node = out
      for p in parents:
        node = node.setdefault(p, {})
      node[last] = leaf
    return out

  def keys(self):
    return list(iter(self))

  def values(self):
    return [self[k] for k in self]

  def items(self):
    return [(k, self[k]) for k in self]

  def __eq__(self, other):
    if isinstance(other, TensorSpecStruct):
      return self._flat == other._flat
    if isinstance(other, Mapping):
      return self._flat == TensorSpecStruct(other)._flat
    return NotImplemented

  def __repr__(self):
    inner = ", ".join(f"{k}: {v!r}" for k, v in self._flat.items())
    return f"TensorSpecStruct({{{inner}}})"


_MISSING = object()
