"""Spec (de)serialization for serving assets (port of
`specs/serialization.py`).

The serving contract as JSON: every `ExtendedTensorSpec` field round
trips, and the asset file is `t2r_assets.json`. The format is the JAX
package's byte for byte, so an assets string written by either package
reads back in the other.
"""

from __future__ import annotations

import json
from typing import Any, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.specs import packing
from tensor2robot_tpu_torch.specs.tensorspec import (
    ExtendedTensorSpec,
    TensorSpecStruct,
)

ASSET_FILENAME = "t2r_assets.json"
_FORMAT_VERSION = 1


def spec_to_dict(spec: ExtendedTensorSpec) -> dict:
  dtype_name = ("bfloat16" if spec.dtype is torch.bfloat16
                else np.dtype(spec.dtype).name)
  out = {"shape": list(spec.shape), "dtype": dtype_name}
  if spec.name is not None:
    out["name"] = spec.name
  for field in ("is_optional", "is_sequence", "varlen"):
    if getattr(spec, field):
      out[field] = True
  if spec.data_format is not None:
    out["data_format"] = spec.data_format
  if spec.dataset_key:
    out["dataset_key"] = spec.dataset_key
  return out


def spec_from_dict(data: dict) -> ExtendedTensorSpec:
  return ExtendedTensorSpec(
      shape=tuple(data["shape"]),
      dtype=data["dtype"],
      name=data.get("name"),
      is_optional=data.get("is_optional", False),
      is_sequence=data.get("is_sequence", False),
      data_format=data.get("data_format"),
      dataset_key=data.get("dataset_key", ""),
      varlen=data.get("varlen", False),
  )


def struct_to_dict(spec_structure: Any) -> dict:
  flat = packing.flatten_spec_structure(spec_structure).to_flat_dict()
  return {k: spec_to_dict(v) for k, v in flat.items()}


def struct_from_dict(data: dict) -> TensorSpecStruct:
  return TensorSpecStruct.from_flat_dict(
      {k: spec_from_dict(v) for k, v in data.items()})


def serialize_assets(feature_spec: Any, label_spec: Optional[Any] = None,
                     global_step: Optional[int] = None,
                     extra: Optional[dict] = None) -> str:
  """Serializes the serving contract to a JSON string."""
  payload = {"format_version": _FORMAT_VERSION,
             "feature_spec": struct_to_dict(feature_spec)}
  if label_spec is not None:
    payload["label_spec"] = struct_to_dict(label_spec)
  if global_step is not None:
    payload["global_step"] = int(global_step)
  if extra:
    payload["extra"] = extra
  return json.dumps(payload, indent=2, sort_keys=False)


def deserialize_assets(serialized: str) -> dict:
  """Inverse of serialize_assets; spec dicts become TensorSpecStructs."""
  payload = json.loads(serialized)
  version = payload.get("format_version")
  if version != _FORMAT_VERSION:
    raise ValueError(f"Unsupported t2r asset format version: {version}")
  out = {"feature_spec": struct_from_dict(payload["feature_spec"])}
  if "label_spec" in payload:
    out["label_spec"] = struct_from_dict(payload["label_spec"])
  for key in ("global_step", "extra"):
    if key in payload:
      out[key] = payload[key]
  return out


def write_assets(path: str, feature_spec: Any, **kwargs) -> None:
  with open(path, "w") as f:
    f.write(serialize_assets(feature_spec, **kwargs))


def read_assets(path: str) -> dict:
  with open(path) as f:
    return deserialize_assets(f.read())
