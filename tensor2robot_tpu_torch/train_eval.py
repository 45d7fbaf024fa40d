"""train_eval_model: the training / evaluation loop (port of
`train_eval.py`).

The JAX package jits the model's pure train and eval steps once and
dispatches the compiled programs; here each is a CUDA graph
(`utils.step_graph.StepGraph`): the train step, K steps per dispatch
when `steps_per_dispatch` is K (the JAX `lax.scan` over K stacked
batches), carries the `TrainState` in its static buffers, and the eval
step reads a copy of it. A batch of another shape captures a graph of
its own, as a new shape compiles anew under jit, and a shape seen
before replays its graph (`utils.step_graph.GraphCache`). On the CPU the same
steps run eagerly over the same buffers; `graphs=False` runs them
eagerly, one call each, on either device.

The host loop: pull a batch (a `DevicePrefetcher` copies it to the
device ahead of the step; K batches stacked when K > 1), dispatch,
call the hooks, log every `log_every_steps` steps (one host read per
log) to `<model_dir>/metrics_train.jsonl` in the telemetry envelope,
checkpoint every `save_checkpoints_steps` steps and at the end (keeping
the newest `max_checkpoints_to_keep`), evaluate every
`eval_every_steps` steps and at the end (`metrics_eval.jsonl`). A run
resumes from the latest checkpoint in `model_dir`. Hooks and the
checkpoint writer get copies of the state: nothing they keep is a
buffer that a later replay writes, and the returned state is a copy.

Startup (`overlap_startup`, True by default, as in JAX): the restore of
the latest checkpoint, the input pipeline's spin-up (its prefetcher
starts copying batches to the card) and the "compile" phase run
together on threads (`startup.orchestrator.run_overlapped`), and each
phase's seconds go to `<model_dir>/startup_timings.json`. The JAX
package's compile phase is XLA's ahead-of-time compilation; the port's
is the kernel libraries the network launches on the card, built if
needed and loaded (`kernel_libraries`). All three are host work and
copies: each step's CUDA graph is captured at its first dispatch, after
the join, on the loop's thread. A failed phase is raised after every
phase has joined, and the input phase's prefetcher (and a data plane's
workers) are closed first. Overlapped and serial starts give the same
states bit for bit.

The records: the step's metrics, `steps_per_sec` over the interval
without its stalls (checkpoint saves, interleaved evaluations and the
record writes), `stall_fraction` (their share of the interval),
`input_wait_fraction` (the share spent waiting for the prefetcher), the
kernel build cache's `compile_cache.*` counters, the resource sampler's
`rsrc.*` gauges and the perf meter's `perf.*` (`telemetry.perf`):
`perf.device_time_fraction` always, and `perf.flops_per_sec` and
`perf.mfu` where the step's FLOPs could be counted
(`utils.profiling.train_step_flops`: one eager step on the first batch,
results dropped) and the card's peak is known.

After training, each exporter of `create_exporters_fn(model)` exports
the final state (`export/`), as the JAX trainer does.

Not ported yet: meshes and sharding strategies (ROADMAP A11); they raise
where they are asked for.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import torch

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data import prefetch as prefetch_lib
from tensor2robot_tpu_torch.data.abstract_input_generator import (
    AbstractInputGenerator,
    Mode,
)
from tensor2robot_tpu_torch.device import DeviceLike, resolve_device
from tensor2robot_tpu_torch.hooks import Hook, HookList
from tensor2robot_tpu_torch.models.abstract_model import TrainState
from tensor2robot_tpu_torch.models.model_interface import ModelInterface
from tensor2robot_tpu_torch.startup import compile_cache, orchestrator
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics
from tensor2robot_tpu_torch.telemetry import perf as perf_lib
from tensor2robot_tpu_torch.telemetry import records
from tensor2robot_tpu_torch.telemetry import sentinel as sentinel_lib
from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib
from tensor2robot_tpu_torch.utils import profiling
from tensor2robot_tpu_torch.utils.step_graph import GraphCache

log = logging.getLogger(__name__)

_FEATURES, _LABELS = "features/", "labels/"
_DEFAULT_MIN_SIZE_TO_SHARD = 2 ** 10


class MetricLogger:
  """Scalar metric sink: log line + one JSONL file per tag (train, ...),
  each record the telemetry envelope (`telemetry.records`). ``role``
  defaults to the process's telemetry role."""

  def __init__(self, model_dir: str, role: Optional[str] = None):
    self._model_dir = model_dir
    self._role = role
    os.makedirs(model_dir, exist_ok=True)
    self._files: Dict[str, Any] = {}

  def write(self, tag: str, step: int, metrics: Dict[str, Any]) -> None:
    scalars = {k: float(v) for k, v in metrics.items()}
    if tag not in self._files:
      self._files[tag] = open(
          os.path.join(self._model_dir, f"metrics_{tag}.jsonl"), "a")
    record = records.make_record(step, scalars, role=self._role)
    self._files[tag].write(json.dumps(record) + "\n")
    self._files[tag].flush()
    rendered = ", ".join(f"{k}={v:.5g}" for k, v in scalars.items())
    log.info("[%s] step %d: %s", tag, step, rendered)

  def close(self) -> None:
    for f in self._files.values():
      f.close()
    self._files.clear()


def _flat(struct) -> Dict[str, Any]:
  if struct is None:
    return {}
  return dict(struct.to_flat_dict() if hasattr(struct, "to_flat_dict")
              else struct)


def _packed(stream: Iterable) -> Iterator[Dict[str, Any]]:
  """(features, labels) batches as one flat dict, keys prefixed by
  their side, as the prefetcher and K-stacking take them. Closing it
  closes `stream` (a data plane's workers end with it)."""
  try:
    for features, labels in stream:
      yield {**{_FEATURES + k: v for k, v in _flat(features).items()},
             **{_LABELS + k: v for k, v in _flat(labels).items()}}
  finally:
    closer = getattr(stream, "close", None)
    if callable(closer):
      closer()


def _unpacked(batch: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
  return {side: {k[len(prefix):]: v for k, v in batch.items()
                 if k.startswith(prefix)}
          for side, prefix in (("features", _FEATURES), ("labels", _LABELS))}


def _device_batches(stream: Iterable, device: torch.device, k: int = 1,
                    buffer_size: int = 2) -> prefetch_lib.DevicePrefetcher:
  packed = _packed(stream)
  if k > 1:
    # Stacking keeps K batches at once: ring views must be copies.
    getattr(stream, "require_copies", lambda: None)()
    packed = prefetch_lib.stack_batches(packed, k)
  return prefetch_lib.DevicePrefetcher(packed, device,
                                       buffer_size=buffer_size, source=stream)


def train_step_fn(model: ModelInterface, k: int = 1) -> Callable:
  """K train steps as `StepGraph`'s step: over a state and a batch
  `{"features", "labels"}` (each leaf `[K, B, ...]` when K > 1), the new
  state and the last step's metrics."""

  def fn(state, batch, generators):
    metrics = None
    for i in range(k):
      features, labels = batch["features"], batch["labels"]
      if k > 1:
        features = {key: v[i] for key, v in features.items()}
        labels = {key: v[i] for key, v in labels.items()}
      state, metrics = model.train_step(state, features, labels)
    return state, metrics

  return fn


def eval_step_fn(model: ModelInterface) -> Callable:
  """The eval step as `StepGraph`'s step (the state is only read)."""
  return lambda state, batch, generators: (  # noqa: E731
      state, model.eval_step(state, batch["features"], batch["labels"]))


def _at_step(state: TrainState, step: int) -> TrainState:
  return dataclasses.replace(state, step=step)


class _Evaluator:
  """Eval passes: the eval step graphed per batch shape (each graph
  given the evaluated state once per pass), or eager."""

  def __init__(self, model: ModelInterface, device: torch.device,
               graphs: bool):
    self._fn = eval_step_fn(model)
    self._graphs = (GraphCache(self._fn, None, device, carries=False)
                    if graphs else None)
    self._device = device

  def run(self, state: TrainState, generator: AbstractInputGenerator,
          eval_steps: int, batch_size: Optional[int]) -> Dict[str, float]:
    """Averages the eval metrics over `eval_steps` batches."""
    prefetcher = _device_batches(
        generator.create_dataset(Mode.EVAL, batch_size=batch_size),
        self._device)
    totals: Dict[str, float] = {}
    count = 0
    if self._graphs is not None:
      self._graphs.load(state)
    try:
      for packed in prefetcher:
        batch = _unpacked(packed)
        if self._graphs is None:
          metrics = self._fn(state, batch, ())[1]
        else:
          metrics = self._graphs.replay(batch)
        for key, value in metrics.items():
          totals[key] = totals.get(key, 0.0) + float(value)
        count += 1
        if count >= eval_steps:
          break
    finally:
      prefetcher.close()
    return {k: v / count for k, v in totals.items()} if count else {}


def kernel_libraries(model: ModelInterface, device: torch.device) -> list:
  """Builds (where not built yet) and loads the kernel libraries that
  `model`'s network launches on `device`: what each module's
  ``kernel_libraries(device)`` names. Returns their names; none off the
  card."""
  create = getattr(model, "create_network", None)
  if device.type != "cuda" or create is None:
    return []
  with torch.device("meta"):
    network = create()
  names = {}
  for module in network.modules():
    for name, load in getattr(module, "kernel_libraries",
                              lambda d: {})(device).items():
      names.setdefault(name, load)
  for load in names.values():
    load()
  return sorted(names)


def _check_unported(mesh, sharding_strategy: str, min_size_to_shard: int):
  if (mesh is not None or sharding_strategy != "replicated"
      or min_size_to_shard != _DEFAULT_MIN_SIZE_TO_SHARD):
    raise NotImplementedError(
        "train_eval_model(mesh=..., sharding_strategy=..., "
        "min_size_to_shard=...): meshes and sharding strategies are not "
        "ported yet (ROADMAP A11).")


@gin.configurable
def train_eval_model(
    model: ModelInterface = gin.REQUIRED,
    model_dir: str = gin.REQUIRED,
    input_generator_train: Optional[AbstractInputGenerator] = None,
    input_generator_eval: Optional[AbstractInputGenerator] = None,
    max_train_steps: int = 1000,
    eval_steps: int = 10,
    eval_every_steps: Optional[int] = None,
    save_checkpoints_steps: int = 500,
    max_checkpoints_to_keep: int = 5,
    batch_size: Optional[int] = None,
    eval_batch_size: Optional[int] = None,
    mesh=None,
    sharding_strategy: str = "replicated",
    min_size_to_shard: int = _DEFAULT_MIN_SIZE_TO_SHARD,
    create_exporters_fn: Optional[Callable] = None,
    hooks: Iterable[Hook] = (),
    log_every_steps: int = 100,
    seed: int = 0,
    init_batch_size: int = 2,
    steps_per_dispatch: int = 1,
    overlap_startup: bool = True,
    device: DeviceLike = None,
    graphs: bool = True,
) -> TrainState:
  """Trains (with interleaved evaluation) on `device` (None = the CUDA
  card; raises without one); resumes from `model_dir`'s latest
  checkpoint, else starts from a state made from `seed`.

  `steps_per_dispatch` K runs K steps per dispatch (one graph replay):
  the log, checkpoint and eval cadences and `max_train_steps` must be
  multiples of K, and per-step hooks see each dispatch's last metrics.
  `overlap_startup` runs the startup phases together (the module
  docstring); False runs them one after the other, the input phase at
  the loop's start. `init_batch_size` is accepted for the JAX signature:
  the port builds its networks from their specs. Returns the final
  state.
  """
  _check_unported(mesh, sharding_strategy, min_size_to_shard)
  del init_batch_size
  compile_cache.configure_compilation_cache()
  device = resolve_device(device)
  k = prefetch_lib.validate_steps_per_dispatch(
      steps_per_dispatch,
      log_every_steps=log_every_steps,
      save_checkpoints_steps=save_checkpoints_steps,
      max_train_steps=max_train_steps,
      eval_every_steps=eval_every_steps)
  os.makedirs(model_dir, exist_ok=True)
  hook_list = HookList(list(hooks))
  if input_generator_train is not None:
    input_generator_train.set_specification_from_model(model, Mode.TRAIN)
  if input_generator_eval is not None:
    input_generator_eval.set_specification_from_model(model, Mode.EVAL)

  state = model.create_train_state(seed=seed, device=device)
  resume_step = ckpt_lib.latest_step(model_dir)
  will_train = input_generator_train is not None and max_train_steps > 0

  def restore_phase() -> TrainState:
    return ckpt_lib.restore_state(model_dir, like=state, step=resume_step)

  def input_phase() -> prefetch_lib.DevicePrefetcher:
    return _device_batches(
        input_generator_train.create_dataset(Mode.TRAIN,
                                             batch_size=batch_size),
        device, k)

  phases: Dict[str, Callable[[], Any]] = {}
  if overlap_startup:
    if will_train or input_generator_eval is not None:
      phases["compile"] = lambda: kernel_libraries(model, device)
    if resume_step is not None:
      phases["restore"] = restore_phase
    if will_train:
      phases["input"] = input_phase
  if resume_step is not None:
    log.info("Resuming from checkpoint at step %d in %s", resume_step,
             model_dir)
  train_prefetcher = None
  if phases:
    report = orchestrator.run_overlapped(phases)
    if report.errors:
      # A failed phase must not leak the input phase's prefetcher.
      orchestrator.close_quietly(report.results.get("input"))
      report.raise_first(order=("restore", "input", "compile"))
    state = report.results.get("restore", state)
    train_prefetcher = report.results.get("input")
    try:
      report.write(model_dir)
    except OSError:
      log.warning("Could not write %s", orchestrator.STARTUP_TIMINGS_FILE,
                  exc_info=True)
  elif resume_step is not None:
    state = restore_phase()
  step = int(state.step)
  if k > 1 and step % k and step < max_train_steps:
    orchestrator.close_quietly(train_prefetcher)
    raise ValueError(
        f"Resumed at step {step}, not a multiple of "
        f"steps_per_dispatch={k}: boundaries would never align.")

  metric_logger = MetricLogger(model_dir)
  writer = ckpt_lib.CheckpointWriter(model_dir,
                                     max_to_keep=max_checkpoints_to_keep)
  evaluator = _Evaluator(model, device, graphs)
  eval_batch = eval_batch_size or batch_size
  prefetcher = train_prefetcher
  graphs_by_shape: Optional[GraphCache] = None
  registry = tmetrics.registry()
  perf_lib.start_resource_sampler(
      sources=[profiling.device_memory_source()])
  watch_sentinel = sentinel_lib.build_for_run(model_dir)
  # The step's FLOPs are counted on the first batch's shapes.
  perf_meter = perf_lib.PerfMeter(
      peak_flops=profiling.device_peak_flops(device), devices=1)

  def current() -> TrainState:
    """The state as of `step`, a copy no later replay writes."""
    return (state if graphs_by_shape is None
            else _at_step(graphs_by_shape.carry_copy(), step))

  try:
    hook_list.begin(model, model_dir)
    if input_generator_train is not None and step < max_train_steps:
      if prefetcher is None:
        prefetcher = input_phase()
      train_fn = train_step_fn(model, k)
      if graphs:
        graphs_by_shape = GraphCache(train_fn, state, device)
      t_last = time.time()
      steps_since_log = 0
      # Wall spent in checkpoint saves, interleaved evaluations and
      # record writes in the interval: `steps_per_sec` leaves it out,
      # `stall_fraction` is its share.
      stall_secs = 0.0
      last_saved = resume_step
      prefetch_iter = prefetch_lib.TimedIterator(prefetcher)
      counted = False
      for packed in prefetch_iter:
        if step >= max_train_steps:
          break
        batch = _unpacked(packed)
        if not counted:
          one = batch if k == 1 else {side: {key: v[0] for key, v in
                                             leaves.items()}
                                      for side, leaves in batch.items()}
          perf_meter.flops_per_step = profiling.train_step_flops(
              train_step_fn(model), state, one, ())
          counted = True
        with perf_meter.dispatch("train.dispatch", step=step):
          if graphs_by_shape is not None:
            metrics = graphs_by_shape.replay(batch)
          else:
            state, metrics = train_fn(state, batch, ())
        step += k
        steps_since_log += k
        hook_list.after_step(step, metrics)
        if step % log_every_steps == 0 or step == max_train_steps:
          scalars = {key: v.item() for key, v in metrics.items()}
          dt = time.time() - t_last
          scalars["steps_per_sec"] = steps_since_log / max(
              dt - stall_secs, 1e-9)
          scalars["stall_fraction"] = min(
              max(stall_secs / max(dt, 1e-9), 0.0), 1.0)
          scalars["input_wait_fraction"] = prefetch_iter.wait_fraction(dt)
          scalars.update(registry.scalars("compile_cache."))
          scalars.update(registry.scalars("rsrc."))
          registry.gauge("train.steps_per_sec").set(scalars["steps_per_sec"])
          registry.gauge("train.stall_fraction").set(
              scalars["stall_fraction"])
          scalars.update(perf_meter.publish(scalars["steps_per_sec"], dt))
          t_last = time.time()
          steps_since_log = 0
          t_write = time.perf_counter()
          metric_logger.write("train", step, scalars)
          if watch_sentinel is not None:
            watch_sentinel.evaluate({**registry.scalars(), **scalars},
                                    step=step)
          # The write is a stall of the interval that just began.
          stall_secs = time.perf_counter() - t_write
        if step % save_checkpoints_steps == 0 or step == max_train_steps:
          t_save = time.perf_counter()
          saved = current()
          writer.save(step, saved)
          last_saved = step
          hook_list.after_checkpoint(step, saved, model_dir)
          stall_secs += time.perf_counter() - t_save
        if (input_generator_eval is not None and eval_every_steps
            and step % eval_every_steps == 0 and step != max_train_steps):
          t_eval = time.perf_counter()
          metric_logger.write("eval", step, evaluator.run(
              current(), input_generator_eval, eval_steps, eval_batch))
          stall_secs += time.perf_counter() - t_eval
      state = current()
      if last_saved != step:
        writer.save(step, state)
        hook_list.after_checkpoint(step, state, model_dir)

    state = current()
    if input_generator_eval is not None:
      eval_metrics = evaluator.run(state, input_generator_eval, eval_steps,
                                   eval_batch)
      if eval_metrics:
        metric_logger.write("eval", step, eval_metrics)
    if create_exporters_fn is not None:
      for exporter in create_exporters_fn(model):
        exporter.export(model, state, model_dir)
    hook_list.end(step, state, model_dir)
  finally:
    if prefetcher is not None:
      prefetcher.close()
    if watch_sentinel is not None:
      watch_sentinel.close()
    metric_logger.close()
  return current()


@gin.configurable
def continuous_eval(
    model: ModelInterface = gin.REQUIRED,
    model_dir: str = gin.REQUIRED,
    input_generator_eval: AbstractInputGenerator = gin.REQUIRED,
    eval_steps: int = 10,
    eval_batch_size: Optional[int] = None,
    mesh=None,
    timeout_secs: Optional[float] = None,
    poll_interval_secs: float = 2.0,
    max_evals: Optional[int] = None,
    seed: int = 0,
    init_batch_size: int = 2,
    device: DeviceLike = None,
    graphs: bool = True,
) -> Dict[int, Dict[str, float]]:
  """Polls `model_dir` for new checkpoints and evaluates each one on
  `device` (None = the CUDA card); returns {step: metrics}.

  Each record carries `restore_secs`, `eval_secs` and
  `restore_and_eval_secs`: how far this evaluator lags the trainer per
  checkpoint. The loop ends after `max_evals` evaluations or when no new
  checkpoint comes within `timeout_secs`.
  """
  _check_unported(mesh, "replicated", _DEFAULT_MIN_SIZE_TO_SHARD)
  del init_batch_size
  compile_cache.configure_compilation_cache()
  device = resolve_device(device)
  input_generator_eval.set_specification_from_model(model, Mode.EVAL)
  state = model.create_train_state(seed=seed, device=device)
  evaluator = _Evaluator(model, device, graphs)
  metric_logger = MetricLogger(model_dir)
  results: Dict[int, Dict[str, float]] = {}
  last_step = None
  try:
    while max_evals is None or len(results) < max_evals:
      new_step = ckpt_lib.wait_for_new_checkpoint(
          model_dir, last_step, timeout_secs=timeout_secs,
          poll_interval_secs=poll_interval_secs)
      if new_step is None:
        break
      t_restore = time.perf_counter()
      state = ckpt_lib.restore_state(model_dir, like=state, step=new_step)
      restore_secs = time.perf_counter() - t_restore
      t_eval = time.perf_counter()
      metrics = evaluator.run(state, input_generator_eval, eval_steps,
                              eval_batch_size)
      eval_secs = time.perf_counter() - t_eval
      metrics.update(restore_secs=restore_secs, eval_secs=eval_secs,
                     restore_and_eval_secs=restore_secs + eval_secs)
      metric_logger.write("eval", new_step, metrics)
      results[new_step] = metrics
      last_step = new_step
  finally:
    metric_logger.close()
  return results
