"""QT-Opt training loop (port of `research/qtopt/train_qtopt.py`), on
one card: replay → device prefetch → Bellman step.

The host thread samples replay batches; `DevicePrefetcher` copies them
to the card ahead of the step; each dispatch of K steps is one replay
of a CUDA graph (`utils.step_graph.StepGraph`, the counterpart of the
JAX loop's compiled `lax.scan` over K steps): the prefetched batches
are copied into the graph's static inputs, the K noise generators are
seeded, and the graph runs K `QTOptLearner.train_step`s over the state
it carries in its static buffers. On the CPU the same step runs eagerly
over the same buffers. `graphs=False` runs the steps eagerly instead,
one `train_step` call each (the reference the graphed run is held to).
Kept from the JAX loop: `prefill_random`, `wait_until_size`, resume
from the latest checkpoint, the metric log (`grad_steps_per_sec`,
`input_wait_fraction` and the replay metrics every `log_every_steps`),
checkpoints every `save_checkpoints_steps` and at the end, the hooks
(`begin`, `after_step`, `after_checkpoint`, and `end` in a `finally`),
CEM noise from a per-step generator seeded from (seed + 1, absolute
step), and `steps_per_dispatch` K with the JAX cadence rules: every
cadence a multiple of K, hooks and logs see each dispatch's last
metrics. Step i of a dispatch starting at step s draws its CEM noise
from a generator seeded `dispatch_seed(seed + 1, s + i)`, whatever K
and wherever a run resumed. Hooks, the logger and the checkpoint writer
get copies: nothing they keep is a buffer a later replay writes, and the
returned state is a copy too.

An int8 learner (`cem_inference="int8"`) that was never calibrated
calibrates on one replay batch before the first dispatch, as the JAX
loop does before it traces its step.

`shard_weight_update=True` on one process is the plain update: on the
JAX package's one-device mesh every sharding constraint is a no-op and
the step is bit for bit the plain optimizer's.

The perf plane (`telemetry.perf`) rides the loop as in JAX: the process's
resource sampler (host RSS, the card's allocator bytes), and a
`PerfMeter` around each dispatch whose ``perf.device_time_fraction``,
``perf.flops_per_sec`` and ``perf.mfu`` (from `utils.profiling.
qtopt_step_flops`, the analytic count, over the card's peak) join every
record with the ``rsrc.*`` and ``compile_cache.*`` gauges; the alert
sentinel (`telemetry.sentinel.build_for_run`) evaluates the registry
and each record at log cadence, as in JAX.

A learner group (a `torch.distributed` group of more than one process,
`parallel.distributed.maybe_initialize_distributed`) trains over the
data axis of `parallel.mesh.create_mesh`: `batch_size` is per process,
every rank samples its own rows and runs each step inside
`parallel.collectives.data_parallel` (batch norm over the global batch,
gradients and metrics averaged over the group), rank 0's initial state
is every rank's, and each step's CEM noise is the global batch's draw
from the step's generator, this rank's rows of it, so the group's step
is the one-process step on the global batch. Only rank 0 (the chief)
owns the host-side surfaces: the checkpoints, the metric log, the
sentinel and the replay's learner-step tags; every rank runs its hooks.
At the end the ranks' params and batch statistics are gathered by digest
and must be equal; the chief writes them to `learner_group.json`.
The group's steps run eagerly (a collective cannot sit inside a CUDA
graph capture); the analytic FLOPs count the global batch, and
`perf.mfu` divides them by the peak of the distinct devices the group
spans (one for a group on one card). At world size 1 the path is the
one-process path, graphed, bit for bit. Not ported: a mesh other than
the data axis and `shard_weight_update` across a group's ranks (ROADMAP
A11 rest) raise.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Iterable, Optional

import torch

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data import prefetch as prefetch_lib
from tensor2robot_tpu_torch.hooks import Hook, HookList
from tensor2robot_tpu_torch.parallel import collectives, distributed
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.research.qtopt import cem
from tensor2robot_tpu_torch.research.qtopt.qtopt_learner import (
    QTOptLearner,
    QTOptState,
)
from tensor2robot_tpu_torch.research.qtopt.replay_buffer import ReplayBuffer
from tensor2robot_tpu_torch.serving.microbatcher import dispatch_seed
from tensor2robot_tpu_torch.specs import make_random_tensors
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics
from tensor2robot_tpu_torch.telemetry import perf as perf_lib
from tensor2robot_tpu_torch.telemetry import sentinel as sentinel_lib
from tensor2robot_tpu_torch.train_eval import MetricLogger
from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib
from tensor2robot_tpu_torch.utils import profiling
from tensor2robot_tpu_torch.utils.step_graph import StepGraph

log = logging.getLogger(__name__)


def step_generator(seed: int, step: int,
                   device: torch.device) -> torch.Generator:
  """The CEM noise generator of absolute step `step` of a run seeded
  with `seed`: the same per step whatever K and wherever a run resumed."""
  return torch.Generator(device=device).manual_seed(
      dispatch_seed(seed + 1, step))


def k_step_fn(learner: QTOptLearner, k: int) -> Callable:
  """The dispatch of K Bellman steps, `StepGraph`'s step: over a state,
  K stacked transition batches `[K, B, ...]` (one unstacked batch when K
  = 1) and K generators, the new state and the last step's metrics."""

  def fn(state, transitions, generators):
    metrics = None
    for i in range(k):
      batch = (transitions if k == 1 else
               {key: v[i] for key, v in transitions.items()})
      state, metrics = learner.train_step(state, batch,
                                          generator=generators[i])
    return state, metrics

  return fn


def group_noise(learner: QTOptLearner, generator: torch.Generator,
                local_batch: int, rank: int, world: int) -> torch.Tensor:
  """A learner-group rank's CEM noise `[iterations, local_batch, P, A]`:
  its rows of the draws a one-process step on the global batch
  (`world · local_batch` rows) takes from `generator`."""
  noise = cem.draw_noise(generator, learner.cem_iterations,
                         world * local_batch, learner.cem_population,
                         learner.model.action_dim)
  return noise[:, rank * local_batch:(rank + 1) * local_batch]


GROUP_FILENAME = "learner_group.json"


def _check_ranks_agree(state: QTOptState, step: int, world: int,
                       chief: bool, model_dir: str) -> None:
  """A learner group's end: every rank's params and batch statistics,
  by digest, gathered and held equal (ranks that drifted apart raise);
  the chief writes them to `<model_dir>/learner_group.json`."""
  ts = state.train_state
  ranks = collectives.all_gather_object(
      ckpt_lib.tensor_digests({**ts.params, **ts.batch_stats}))
  if any(r != ranks[0] for r in ranks):
    differ = sorted(k for k in ranks[0]
                    if len({r.get(k) for r in ranks}) > 1)
    raise RuntimeError(f"learner group ranks ended apart at step {step}: "
                       f"{differ}")
  if chief:
    with open(os.path.join(model_dir, GROUP_FILENAME), "w") as f:
      json.dump({"world_size": world, "step": step,
                 "rank_digests": ranks}, f)


def _at_step(state: QTOptState, step: int) -> QTOptState:
  return dataclasses.replace(
      state, train_state=dataclasses.replace(state.train_state, step=step))


@gin.configurable
def train_qtopt(
    learner: QTOptLearner = gin.REQUIRED,
    model_dir: str = gin.REQUIRED,
    replay_buffer: Optional[ReplayBuffer] = None,
    max_train_steps: int = 1000,
    batch_size: int = 256,
    min_replay_size: Optional[int] = None,
    save_checkpoints_steps: int = 500,
    max_checkpoints_to_keep: int = 5,
    log_every_steps: int = 100,
    mesh=None,
    hooks: Iterable[Hook] = (),
    seed: int = 0,
    prefill_random: bool = False,
    steps_per_dispatch: int = 1,
    prefetch_buffer_size: Optional[int] = None,
    shard_weight_update: bool = False,
    graphs: bool = True,
) -> QTOptState:
  """Runs the QT-Opt learner loop on `learner.device`; resumes from
  `model_dir`'s latest checkpoint. Returns the final state.

  `graphs` (default) runs each dispatch of `steps_per_dispatch` steps as
  one `StepGraph` replay; False runs the steps eagerly, one call each.

  `replay_buffer` is fed by the caller (actors, logged episodes);
  `prefill_random=True` adds `min(capacity, 4·batch_size)` spec-random
  transitions drawn from `seed` first (benchmarks, smoke runs).
  """
  if mesh is not None and (not isinstance(mesh, mesh_lib.Mesh) or set(
      mesh.axis_names) - {mesh_lib.DATA_AXIS}):
    raise NotImplementedError(
        f"train_qtopt(mesh={getattr(mesh, 'shape', type(mesh).__name__)})"
        ": only a data-axis mesh of parallel.mesh.create_mesh is ported "
        "for QT-Opt (ROADMAP A11 rest).")
  world = collectives.group_size()
  if world > 1 and shard_weight_update:
    raise NotImplementedError(
        "shard_weight_update across a learner group's ranks is a sharded "
        "optimizer (ROADMAP A11 rest).")
  # Validate the dispatch quantization before any side effects.
  k = prefetch_lib.validate_steps_per_dispatch(
      steps_per_dispatch,
      log_every_steps=log_every_steps,
      save_checkpoints_steps=save_checkpoints_steps,
      max_train_steps=max_train_steps)
  device = learner.device
  if mesh is not None and mesh.size != world:
    raise ValueError(f"mesh {mesh.shape} spans {mesh.size} devices; the "
                     f"process group has {world}")
  rank = distributed.process_index()
  # Only the chief owns the host-side surfaces (files and replay tags).
  chief = rank == 0
  if chief:
    os.makedirs(model_dir, exist_ok=True)
  group = world > 1
  # A collective cannot sit inside a capture: the group steps eagerly.
  graphs = graphs and not group
  hook_list = HookList(list(hooks))

  spec = learner.transition_specification()
  if replay_buffer is None:
    replay_buffer = ReplayBuffer(spec)
  if prefill_random:
    replay_buffer.add(make_random_tensors(
        spec, batch_size=min(replay_buffer.capacity, 4 * batch_size),
        seed=seed))
  state = learner.create_state(seed)
  resume_step = ckpt_lib.latest_step(model_dir) if chief else None
  if resume_step is not None:
    log.info("Resuming QT-Opt from step %d", resume_step)
    state = ckpt_lib.restore_state(model_dir, like=state, step=resume_step)
  if group:
    # Every rank starts from the chief's state (and its resume step).
    resume_step, leaves = collectives.broadcast_object(
        (resume_step, ckpt_lib.flatten_state(state) if chief else None))
    state = ckpt_lib.unflatten_state(state, leaves)
  step = int(state.step)
  if k > 1 and step % k and step < max_train_steps:
    raise ValueError(
        f"Resumed at step {step}, not a multiple of "
        f"steps_per_dispatch={k}: the checkpoint/log boundaries would "
        "never align. Resume with K=1 (or a K dividing the resume step) "
        "first.")

  metric_logger = MetricLogger(model_dir) if chief else None
  writer = (ckpt_lib.CheckpointWriter(model_dir,
                                      max_to_keep=max_checkpoints_to_keep)
            if chief else None)
  registry = tmetrics.registry()
  perf_lib.start_resource_sampler(
      sources=[profiling.device_memory_source()])
  watch_sentinel = sentinel_lib.build_for_run(model_dir) if chief else None
  # `batch_size` is per process: the step's work is the global batch's,
  # over the peak of the devices the group spans (ranks sharing a card
  # share its peak).
  perf_meter = perf_lib.PerfMeter(
      flops_per_step=profiling.qtopt_step_flops(
          learner, batch_size * world, params=state.train_state.params),
      peak_flops=profiling.device_peak_flops(device),
      devices=collectives.distinct_devices(device))
  prefetcher = None
  graph = None

  def current():
    """The state as of `step`, a copy no later replay writes."""
    return state if graph is None else _at_step(graph.carry_copy(), step)

  try:
    # Hooks begin before the replay wait: actors bootstrapping an empty
    # buffer must start collecting first.
    hook_list.begin(learner.model, model_dir)
    replay_buffer.wait_until_size(min_replay_size or batch_size)
    # The int8 tower's activation scales calibrate on a real replay batch
    # before the first dispatch (a captured step reads them).
    if learner.needs_calibration:
      calibration = replay_buffer.sample(batch_size)
      if group:
        # One calibration for the group: the scales are the step's.
        calibration = collectives.broadcast_object(
            calibration if chief else None)
      learner.calibrate(state, calibration)
    stream = replay_buffer.as_stream(batch_size)
    if k > 1:
      stream = prefetch_lib.stack_batches(stream, k)
    depth = prefetch_lib.prefetch_buffer_size(
        prefetch_buffer_size, online=hook_list.drives_online_collection)
    prefetcher = prefetch_lib.DevicePrefetcher(stream, device,
                                               buffer_size=depth)
    if chief:
      replay_buffer.set_learner_step(step)
    prefetch_iter = prefetch_lib.TimedIterator(prefetcher)
    t_last = time.time()
    steps_since_log = 0
    last_saved = resume_step
    for transitions in prefetch_iter:
      if step >= max_train_steps:
        break
      with perf_meter.dispatch("qtopt.dispatch", step=step, k=k):
        if graphs:
          if graph is None:
            graph = StepGraph(k_step_fn(learner, k), state, transitions,
                              device, num_generators=k)
          for i, generator in enumerate(graph.generators):
            generator.manual_seed(dispatch_seed(seed + 1, step + i))
          metrics = graph.replay(transitions)
        else:
          batches = ([transitions] if k == 1 else
                     [{key: v[i] for key, v in transitions.items()}
                      for i in range(k)])
          for i, batch in enumerate(batches):
            generator = step_generator(seed, step + i, device)
            if not group:
              state, metrics = learner.train_step(state, batch,
                                                  generator=generator)
              continue
            with collectives.data_parallel():
              state, metrics = learner.train_step(
                  state, batch, noise=group_noise(
                      learner, generator, batch_size, rank, world))
      step += k
      steps_since_log += k
      if chief:
        replay_buffer.set_learner_step(step)
      hook_list.after_step(step, metrics)
      if chief and (step % log_every_steps == 0 or step == max_train_steps):
        scalars = {key: v.item() for key, v in metrics.items()}
        dt = time.time() - t_last
        scalars["grad_steps_per_sec"] = steps_since_log / max(dt, 1e-9)
        scalars["input_wait_fraction"] = prefetch_iter.wait_fraction(dt)
        scalars.update(replay_buffer.metrics_scalars())
        scalars.update(registry.scalars("compile_cache."))
        scalars.update(registry.scalars("rsrc."))
        registry.gauge("train.grad_steps_per_sec").set(
            scalars["grad_steps_per_sec"])
        scalars.update(perf_meter.publish(scalars["grad_steps_per_sec"], dt))
        metric_logger.write("train", step, scalars)
        if watch_sentinel is not None:
          watch_sentinel.evaluate({**registry.scalars(), **scalars},
                                  step=step)
        t_last = time.time()
        steps_since_log = 0
      if step % save_checkpoints_steps == 0 or step == max_train_steps:
        saved = current()
        if chief:
          writer.save(step, saved)
        last_saved = step
        hook_list.after_checkpoint(step, saved.train_state, model_dir)
    state = current()
    if last_saved != step:
      if chief:
        writer.save(step, state)
      hook_list.after_checkpoint(step, state.train_state, model_dir)
    if group:
      _check_ranks_agree(state, step, world, chief, model_dir)
  finally:
    try:
      hook_list.end(step, current().train_state, model_dir)
    except Exception:  # noqa: BLE001 — don't mask the original error
      log.exception("hook end() failed during teardown")
    if prefetcher is not None:
      prefetcher.close()
    if watch_sentinel is not None:
      watch_sentinel.close()
    if metric_logger is not None:
      metric_logger.close()
  return state
