"""The serving exporter: `torch.export` programs of `predict_step` + t2r
spec assets (port of `export/savedmodel_export_generator.py`).

The JAX exporter stages the model's pure `predict_step`, closed over the
trained params, to a TF SavedModel with jax2tf, lowered for the CPU and
the TPU. The card's machine has no TensorFlow; the port writes one
`torch.export` program per platform instead, into the same timestamped
directory layout, with the same spec assets:

  <export_dir_base>/<unix_ts>/
    program.cuda.pt2        traced on the card (`torch.export.save`)
    program.cpu.pt2         traced on the CPU
    signatures.json         the signatures, the static sequence length,
                            and the dims each program accepts
    assets.extra/t2r_assets.json   feature spec, label spec, global step
                            (+ `extra["serving"]`), the JAX file's bytes

Each program is traced on its own device, never moved: the layers pick
their backend by the device they see at trace time (`attention_impl =
"auto"` is the flash kernel on the card, the plain attention on the CPU),
and a traced factory call keeps its device. A card's program holds the
flash forward as one `torch.ops.t2r.flash_attention_fwd` node that
launches the kernel when the program runs (`ops/flash_attention.py`).

Exports in one process take turns (a lock around each trace):
`torch.export` keeps its tracing modes in process-wide state, and two
traces at once on two threads corrupt each other.

The traced function is `predict_step` over the frozen state (params and
batch statistics copied to the host first; no optimizer state), taking
one flat dict keyed by the feature spec's flat keys, as JAX's
`predict_flat`. The batch axis is a `torch.export.Dim.DYNAMIC` when
`batch_polymorphic`, the time axis of `is_sequence` specs always: an
export whose code specializes such an axis raises, naming the axes, and
the ranges `torch.export` accepted for each are written to
`signatures.json` (the predictor checks inputs against them). A model
whose `predict_step` takes `torch.func` transforms
(`predict_step_has_function_transforms`, MAML's inner gradient) is first
recorded with `make_fx` at the example's shapes, which writes the
transforms out as plain operators; it needs `batch_polymorphic=False`.

Signatures, with JAX's rules: `serving_default` is the program;
`parse_tf_example` (flat specs) and `parse_tf_sequence_example`
(sequence specs, when `sequence_example_length` is set) are the port's
host parsers (`data/tfexample.py` `graph_parse_example` /
`graph_parse_sequence_example`, over the asset feature spec) feeding the
program, run by the predictor; a sequence spec without a length skips
the proto signature with JAX's `RuntimeWarning`.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.device import resolve_device
from tensor2robot_tpu_torch.export.abstract_export_generator import (
    AbstractExportGenerator,
    check_signature_keys,
    claim_timestamped_export_dir,
)
from tensor2robot_tpu_torch.models.abstract_model import TrainState

PLATFORMS = ("cuda", "cpu")
# torch.export keeps its tracing modes in process-wide state: two traces
# at once on two threads (the async export hook's worker and the
# end-of-training exporter) corrupt each other. Exports take turns.
_TRACE_LOCK = threading.Lock()
SIGNATURES_FILE = "signatures.json"
_FORMAT_VERSION = 1
# Example sizes of the traced axes: distinct and above 1, so that no
# axis is specialized by a coincidence of sizes.
_TRACE_BATCH, _TRACE_TIME = 2, 3


def program_filename(platform: str) -> str:
  return f"program.{platform}.pt2"


def load_signatures(export_dir: str) -> dict:
  """The `signatures.json` manifest of an export directory."""
  with open(os.path.join(export_dir, SIGNATURES_FILE)) as f:
    manifest = json.load(f)
  if manifest.get("format_version") != _FORMAT_VERSION:
    raise ValueError(f"Unsupported signatures format in {export_dir}: "
                     f"{manifest.get('format_version')}")
  return manifest


def host_state(state: Any) -> TrainState:
  """`state`'s step, params and batch statistics as host copies (never
  views of the trainer's buffers, which a later replay overwrites); no
  optimizer state (what an export reads)."""
  copy = lambda d: {k: v.detach().to("cpu", copy=True)  # noqa: E731
                    for k, v in d.items()}
  return TrainState(step=int(state.step), params=copy(state.params),
                    batch_stats=copy(state.batch_stats or {}))


class _PredictFlat(torch.nn.Module):
  """`predict_step` over a frozen state, flat dict in, flat dict out."""

  def __init__(self, model: Any, state: TrainState):
    super().__init__()
    self._model = model
    self._state = state

  def forward(self, flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    features = specs_lib.TensorSpecStruct.from_flat_dict(dict(flat))
    outputs = self._model.predict_step(self._state, features)
    if isinstance(outputs, specs_lib.TensorSpecStruct):
      outputs = outputs.to_flat_dict()
    if not isinstance(outputs, dict):
      outputs = {"output": outputs}
    return dict(outputs)


def _example(flat_specs, seq_keys, batch: int, device) -> Dict[str, Any]:
  example = specs_lib.make_random_tensors(
      flat_specs, batch_size=batch,
      sequence_length=_TRACE_TIME if seq_keys else None,
      seed=0).to_flat_dict()
  return {k: (v if isinstance(v, torch.Tensor)
              else torch.as_tensor(np.asarray(v))).to(device)
          for k, v in ((k, example[k]) for k in flat_specs)}


def _accepted_dims(program, example: Dict[str, Any],
                   seq_keys) -> Dict[str, Dict]:
  """{flat key: {axis: [low, high or None]}} of each input's batch axis
  (and time axis, for a sequence spec): the range `torch.export` kept for
  a symbolic axis, [n, n] for one traced static. Export traces at sizes
  ≥ 2 and records a low of 2; sizes 1 pass the program's own input check
  and are served, so a low of 2 is written as 1."""
  from torch.export.graph_signature import InputKind
  user = [s.arg.name for s in program.graph_signature.input_specs
          if s.kind == InputKind.USER_INPUT]
  values = {n.name: n.meta["val"] for n in program.graph.nodes
            if n.op == "placeholder"}
  dims: Dict[str, Dict] = {}
  for key, name in zip(example, user):
    shape = values[name].shape
    for axis in range(2 if key in seq_keys else 1):
      size = shape[axis]
      if isinstance(size, torch.SymInt):
        vr = program.range_constraints[size.node.expr]
        low = int(vr.lower)
        high = int(vr.upper) if vr.upper.is_Integer else None
        accepted = [1 if low <= 2 else low, high]
      else:
        accepted = [int(size), int(size)]
      dims.setdefault(key, {})[str(axis)] = accepted
  return dims


def _trace(model, host: TrainState, flat_specs, seq_keys,
           batch_polymorphic: bool, device: torch.device):
  """(the exported program, the dims it accepts) on `device`."""
  state = host.to(device)
  # The network bound to the state ahead of the trace (cached per state):
  # binding loads the state dict, parameter by parameter under no_grad,
  # and each grad-mode switch inside a trace costs torch.export a graph
  # split.
  getattr(model, "bind", lambda s: None)(state)
  fn = _PredictFlat(model, state)
  transforms = getattr(model, "predict_step_has_function_transforms", False)
  if transforms and (batch_polymorphic or seq_keys):
    raise ValueError(
        f"{type(model).__name__}.predict_step takes torch.func "
        "transforms, which torch.export cannot trace: the exporter "
        "records it with make_fx at fixed shapes, so the batch (and any "
        "time) axis cannot be polymorphic. Export it with "
        "SavedModelExportGenerator(batch_polymorphic=False) (task batch "
        "1, what MetaPolicy feeds).")
  example = _example(flat_specs, seq_keys,
                     _TRACE_BATCH if batch_polymorphic else 1, device)
  shapes = None
  if transforms:
    from torch.fx.experimental.proxy_tensor import make_fx
    fn = make_fx(fn, tracing_mode="real")(example)
  else:
    dynamic = torch.export.Dim.DYNAMIC
    shapes = ({key: ({0: dynamic} if batch_polymorphic else {})
               | ({1: dynamic} if key in seq_keys else {}) or None
               for key in example},)
  try:
    # Traced with grad mode off, so that predict_step's inference mode
    # changes no grad mode inside the program: the program then holds
    # no grad-mode region, which `torch.export.load` would refuse.
    with torch.no_grad():
      program = torch.export.export(fn, (example,), dynamic_shapes=shapes)
  except torch._dynamo.exc.UserError as e:
    raise ValueError(
        f"Export of {type(model).__name__}.predict_step on {device}: its "
        "code specializes an axis that the export keeps polymorphic "
        "(batch when batch_polymorphic, time of is_sequence specs); "
        f"torch.export says: {e}") from e
  return program, _accepted_dims(program, example, seq_keys)


@gin.configurable
class SavedModelExportGenerator(AbstractExportGenerator):
  """Exports `predict_step` as `torch.export` programs with spec assets
  (the JAX class's name, arguments and gin name)."""

  def __init__(self,
               export_dir_base: Optional[str] = None,
               include_tf_example_signature: bool = True,
               batch_polymorphic: bool = True,
               sequence_example_length: Optional[int] = None,
               serving_max_batch: Optional[int] = None,
               serving_max_wait_us: int = 200,
               platforms: Sequence[str] = PLATFORMS):
    """The JAX arguments (see the JAX class), plus `platforms`: the
    devices to trace a program on, the card's and the CPU's by default
    (JAX lowers for the CPU and the TPU). "cuda" raises without a
    card."""
    super().__init__(export_dir_base)
    unknown = set(platforms) - set(PLATFORMS)
    if unknown or not platforms:
      raise ValueError(f"platforms {tuple(platforms)}: each must be one "
                       f"of {PLATFORMS}")
    self._include_tf_example_signature = include_tf_example_signature
    self._batch_polymorphic = batch_polymorphic
    self._sequence_example_length = sequence_example_length
    self._serving_max_batch = serving_max_batch
    self._serving_max_wait_us = serving_max_wait_us
    self._platforms = tuple(platforms)
    self.export_seconds: Dict[str, float] = {}

  def export(self, model: Any, state: Any, model_dir: str) -> str:
    import time

    feature_spec = specs_lib.flatten_spec_structure(
        model.preprocessor.get_in_feature_specification(Mode.PREDICT))
    flat_specs = feature_spec.to_flat_dict()
    check_signature_keys(flat_specs)
    host = host_state(state)
    seq_keys = {k for k, s in flat_specs.items()
                if getattr(s, "is_sequence", False)}

    signatures: Dict[str, Dict] = {
        "serving_default": {"inputs": list(flat_specs)}}
    if self._include_tf_example_signature and not seq_keys:
      signatures["parse_tf_example"] = {"inputs": ["examples"]}
    elif (self._include_tf_example_signature
          and self._sequence_example_length is not None):
      signatures["parse_tf_sequence_example"] = {
          "inputs": ["examples"],
          "sequence_example_length": int(self._sequence_example_length)}
    elif self._include_tf_example_signature:
      warnings.warn(
          f"Skipping the serialized-proto serving signature: feature "
          f"specs {sorted(seq_keys)} are sequences, which travel as "
          f"tf.SequenceExample, and no sequence_example_length was "
          f"configured. Pass "
          f"SavedModelExportGenerator.sequence_example_length to emit "
          f"parse_tf_sequence_example, or serve via serving_default.",
          RuntimeWarning, stacklevel=2)

    export_base = self.export_dir_base(model_dir)
    export_dir, tmp_dir = claim_timestamped_export_dir(export_base)
    try:
      dims = {}
      for platform in self._platforms:
        device = resolve_device(platform)
        t0 = time.perf_counter()
        with _TRACE_LOCK:
          program, dims[platform] = _trace(
              model, host, flat_specs, seq_keys, self._batch_polymorphic,
              device)
        torch.export.save(program,
                          os.path.join(tmp_dir, program_filename(platform)))
        self.export_seconds[platform] = time.perf_counter() - t0
      with open(os.path.join(tmp_dir, SIGNATURES_FILE), "w") as f:
        json.dump({"format_version": _FORMAT_VERSION,
                   "platforms": list(self._platforms),
                   "signatures": signatures,
                   "dims": dims}, f, indent=2)

      assets_dir = os.path.join(tmp_dir, "assets.extra")
      os.makedirs(assets_dir, exist_ok=True)
      extra = None
      if self._serving_max_batch is not None:
        from tensor2robot_tpu_torch.serving.bucketing import bucket_table
        extra = {"serving": {
            "max_batch": int(self._serving_max_batch),
            "bucket_sizes": list(bucket_table(self._serving_max_batch)),
            "max_wait_us": int(self._serving_max_wait_us),
        }}
      specs_lib.write_assets(
          os.path.join(assets_dir, specs_lib.ASSET_FILENAME),
          feature_spec,
          label_spec=model.preprocessor.get_in_label_specification(
              Mode.PREDICT),
          global_step=host.step,
          extra=extra)
    except BaseException:
      shutil.rmtree(tmp_dir, ignore_errors=True)
      raise
    # Atomic publish: pollers never observe a half-written export.
    os.rename(tmp_dir, export_dir)
    return export_dir


@gin.configurable
def create_default_exporters(model,
                             export_dir_base: Optional[str] = None,
                             **kwargs):
  """Reference-parity factory for train_eval's create_exporters_fn."""
  del model
  return [SavedModelExportGenerator(export_dir_base=export_dir_base,
                                    **kwargs)]
