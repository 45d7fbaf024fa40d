"""Export-backed predictor: serves the newest export without the model
class (port of `predictors/saved_model_predictor.py`).

The robot-side consumer of the trainer's exports
(`export/savedmodel_export_generator.py`): `restore()` polls
`export_dir_base` for an export newer than the one loaded, reads its
spec assets and `signatures.json`, and loads `program.<device
type>.pt2` (`torch.export.load`), all before it swaps anything, so a
broken export leaves the predictor whole on its previous version.
`predict` validates the features against the asset feature spec and the
dims the program accepts, then serves the signature asked for:
`serving_default` runs the program on the flat features;
`parse_tf_example` / `parse_tf_sequence_example` parse serialized
protos with the port's host parsers first (`data/tfexample.py`). The
program runs on `device` (None = the CUDA card; raises without one),
one captured graph per input shape (`utils.step_graph.GraphCache`, as
`CheckpointPredictor` serves); on the CPU the same step runs eagerly.
Outputs come back as host numpy (bf16 as f32).

An exported program takes every input of its signature: a feature spec's
optional keys too. A meta model's exported serving therefore always
conditions (`MetaPolicy.set_task` first), as the JAX SavedModel does.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

# The port's operators (`torch.ops.t2r.*`) must be registered before a
# program that holds them is loaded.
import tensor2robot_tpu_torch.ops  # noqa: F401
from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.data import tfexample
from tensor2robot_tpu_torch.device import DeviceLike, resolve_device
from tensor2robot_tpu_torch.export.abstract_export_generator import (
    latest_export_dir,
)
from tensor2robot_tpu_torch.export.savedmodel_export_generator import (
    load_signatures,
    program_filename,
)
from tensor2robot_tpu_torch.predictors.abstract_predictor import (
    AbstractPredictor,
)
from tensor2robot_tpu_torch.predictors.checkpoint_predictor import _host
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.utils.step_graph import GraphCache

_PROTO_SIGNATURES = ("parse_tf_example", "parse_tf_sequence_example")


@gin.configurable
class SavedModelPredictor(AbstractPredictor):
  """Serves the newest export under `export_dir_base`."""

  def __init__(self, export_dir_base: str,
               signature: str = "serving_default",
               device: DeviceLike = None):
    """The JAX constructor's arguments, plus `device` (None = the CUDA
    card)."""
    self._export_dir_base = export_dir_base
    self._signature = signature
    self._device = resolve_device(device)
    self._graphs: Optional[GraphCache] = None
    self._inputs: Optional[list] = None
    self._dims: Dict[str, Dict] = {}
    self._sequence_length: Optional[int] = None
    self._feature_spec: Optional[TensorSpecStruct] = None
    self._label_spec: Optional[TensorSpecStruct] = None
    self._serving_metadata: Optional[dict] = None
    self._version = -1
    self._global_step = -1
    self.load_seconds = 0.0

  @property
  def device(self) -> torch.device:
    return self._device

  @property
  def feature_specification(self) -> TensorSpecStruct:
    self.assert_is_loaded()
    return self._feature_spec

  @property
  def label_specification(self):
    return self._label_spec

  @property
  def model_version(self) -> int:
    return self._version

  @property
  def global_step(self) -> int:
    return self._global_step

  @property
  def serving_metadata(self) -> Optional[dict]:
    """The exporter's recommended serving config (bucket table,
    micro-batch deadline) from the asset payload, when shipped."""
    return self._serving_metadata

  def restore(self, timeout_secs: Optional[float] = None,
              poll_interval_secs: float = 1.0) -> bool:
    """Loads an export NEWER than the currently loaded one.

    `timeout_secs=None` blocks until one appears. On timeout, returns
    whether the predictor is serviceable (some version already loaded).
    """
    deadline = (time.time() + timeout_secs) if timeout_secs is not None \
        else None
    while True:
      path = latest_export_dir(self._export_dir_base)
      if path is not None:
        version = int(os.path.basename(path))
        if version > self._version:
          self._load(path, version)
          return True
      if deadline is not None and time.time() >= deadline:
        return self._version >= 0
      time.sleep(poll_interval_secs)

  def _load(self, path: str, version: int) -> None:
    t0 = time.perf_counter()
    # Read everything FIRST: a broken export must leave the predictor
    # fully on its previous version, never mixing a new program with old
    # specs.
    assets = specs_lib.read_assets(
        os.path.join(path, "assets.extra", specs_lib.ASSET_FILENAME))
    manifest = load_signatures(path)
    signature = manifest["signatures"].get(self._signature)
    if signature is None:
      raise ValueError(
          f"Export {path} has no signature {self._signature!r}; it has "
          f"{sorted(manifest['signatures'])}.")
    program_path = os.path.join(path, program_filename(self._device.type))
    if not os.path.isfile(program_path):
      raise FileNotFoundError(
          f"Export {path} has no program for {self._device.type} "
          f"({os.path.basename(program_path)}); it was exported for "
          f"{manifest['platforms']}.")
    program = torch.export.load(program_path).module()
    step = lambda carry, inputs, generators: (  # noqa: E731
        carry, program(inputs))
    graphs = GraphCache(step, {}, self._device, carries=False)

    self._graphs = graphs
    self._inputs = manifest["signatures"]["serving_default"]["inputs"]
    self._dims = manifest["dims"].get(self._device.type, {})
    self._sequence_length = signature.get("sequence_example_length")
    self._feature_spec = assets["feature_spec"]
    self._label_spec = assets.get("label_spec")
    self._global_step = assets.get("global_step", -1)
    self._serving_metadata = assets.get("extra", {}).get("serving")
    self._version = version
    self.load_seconds = time.perf_counter() - t0

  def _parse(self, features) -> Dict[str, Any]:
    """A proto signature's feed: serialized protos → flat features."""
    value = features.get("examples", features) \
        if isinstance(features, dict) else features
    serialized = [bytes(v) for v in np.asarray(value, dtype=object)]
    if self._signature == "parse_tf_example":
      return tfexample.graph_parse_example(serialized, self._feature_spec)
    flat = tfexample.graph_parse_sequence_example(
        serialized, self._feature_spec, self._sequence_length)
    # The parser's true-lengths output is not a model feature.
    flat.pop(tfexample.SEQUENCE_LENGTH_KEY, None)
    return flat

  def _check_dims(self, flat: Dict[str, Any]) -> None:
    for key, axes in self._dims.items():
      shape = np.shape(flat[key])
      for axis, (low, high) in axes.items():
        size = shape[int(axis)]
        if size < low or (high is not None and size > high):
          raise ValueError(
              f"Feature {key!r} axis {axis} has size {size}; the exported "
              f"program accepts [{low}, {high if high is not None else '∞'}]"
              f" (signatures.json).")

  def predict(self, features: Dict[str, np.ndarray]) -> Dict[str, Any]:
    self.assert_is_loaded()
    if self._signature in _PROTO_SIGNATURES:
      flat = self._parse(features)
    else:
      flat = self._validate(features).to_flat_dict()
    missing = [k for k in self._inputs if k not in flat]
    if missing:
      raise ValueError(
          f"The exported program takes every input of its signature; "
          f"missing {missing} (a meta model's exported serving always "
          f"conditions: MetaPolicy.set_task first).")
    self._check_dims(flat)
    outputs = self._graphs.replay(
        {k: torch.as_tensor(np.asarray(flat[k]), device=self._device)
         for k in self._inputs})
    if isinstance(outputs, TensorSpecStruct):
      outputs = outputs.to_flat_dict()
    return {k: _host(v) for k, v in outputs.items()}
