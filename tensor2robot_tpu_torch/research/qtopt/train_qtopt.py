"""QT-Opt training loop (port of `research/qtopt/train_qtopt.py`), on
one card: replay → device prefetch → Bellman step.

The host thread samples replay batches; `DevicePrefetcher` copies them
to the card ahead of the step; `QTOptLearner.train_step` runs eagerly.
Kept from the JAX loop: `prefill_random`, `wait_until_size`, resume
from the latest checkpoint, the metric log (`grad_steps_per_sec`,
`input_wait_fraction` and the replay metrics every `log_every_steps`),
checkpoints every `save_checkpoints_steps` and at the end, the hooks
(`begin`, `after_step`, `after_checkpoint`, and `end` in a `finally`),
CEM noise from a per-step generator seeded from (seed + 1, absolute
step), and `steps_per_dispatch` K with the JAX cadence rules: every
cadence a multiple of K, K stacked batches per dispatch run as an
eager loop, hooks and logs see each dispatch's last metrics.

Not ported: a mesh (ROADMAP A11), `shard_weight_update` (A11) and
multi-process learner groups (A13) raise; the perf meter, the sentinel,
the compile-cache tap and the resource sampler (A7, A12) are left out;
the K-step dispatch as one CUDA graph is later perf work.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Iterable, Optional

import torch

from tensor2robot_tpu_torch.data import prefetch as prefetch_lib
from tensor2robot_tpu_torch.hooks import Hook, HookList
from tensor2robot_tpu_torch.research.qtopt.qtopt_learner import (
    QTOptLearner,
    QTOptState,
)
from tensor2robot_tpu_torch.research.qtopt.replay_buffer import ReplayBuffer
from tensor2robot_tpu_torch.serving.microbatcher import dispatch_seed
from tensor2robot_tpu_torch.specs import make_random_tensors
from tensor2robot_tpu_torch.train_eval import MetricLogger
from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib

log = logging.getLogger(__name__)


def step_generator(seed: int, step: int,
                   device: torch.device) -> torch.Generator:
  """The CEM noise generator of absolute step `step` of a run seeded
  with `seed`: the same per step whatever K and wherever a run resumed."""
  return torch.Generator(device=device).manual_seed(
      dispatch_seed(seed + 1, step))


def train_qtopt(
    learner: QTOptLearner,
    model_dir: str,
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
) -> QTOptState:
  """Runs the QT-Opt learner loop on `learner.device`; resumes from
  `model_dir`'s latest checkpoint. Returns the final state.

  `replay_buffer` is fed by the caller (actors, logged episodes);
  `prefill_random=True` adds `min(capacity, 4·batch_size)` spec-random
  transitions drawn from `seed` first (benchmarks, smoke runs).
  """
  if mesh is not None or shard_weight_update:
    raise NotImplementedError(
        "train_qtopt(mesh=..., shard_weight_update=True): meshes and "
        "sharded weight updates are not ported yet (ROADMAP A11).")
  if (torch.distributed.is_available() and torch.distributed.is_initialized()
      and torch.distributed.get_world_size() > 1):
    raise NotImplementedError(
        "multi-process learner groups are not ported yet (ROADMAP A13).")
  # Validate the dispatch quantization before any side effects.
  k = prefetch_lib.validate_steps_per_dispatch(
      steps_per_dispatch,
      log_every_steps=log_every_steps,
      save_checkpoints_steps=save_checkpoints_steps,
      max_train_steps=max_train_steps)
  os.makedirs(model_dir, exist_ok=True)
  device = learner.device
  hook_list = HookList(list(hooks))

  spec = learner.transition_specification()
  if replay_buffer is None:
    replay_buffer = ReplayBuffer(spec)
  if prefill_random:
    replay_buffer.add(make_random_tensors(
        spec, batch_size=min(replay_buffer.capacity, 4 * batch_size),
        seed=seed))
  state = learner.create_state(seed)
  resume_step = ckpt_lib.latest_step(model_dir)
  if resume_step is not None:
    log.info("Resuming QT-Opt from step %d", resume_step)
    state = ckpt_lib.restore_state(model_dir, like=state, step=resume_step)
  step = int(state.step)
  if k > 1 and step % k and step < max_train_steps:
    raise ValueError(
        f"Resumed at step {step}, not a multiple of "
        f"steps_per_dispatch={k}: the checkpoint/log boundaries would "
        "never align. Resume with K=1 (or a K dividing the resume step) "
        "first.")

  metric_logger = MetricLogger(model_dir)
  writer = ckpt_lib.CheckpointWriter(model_dir,
                                     max_to_keep=max_checkpoints_to_keep)
  prefetcher = None
  try:
    # Hooks begin before the replay wait: actors bootstrapping an empty
    # buffer must start collecting first.
    hook_list.begin(learner.model, model_dir)
    replay_buffer.wait_until_size(min_replay_size or batch_size)
    stream = replay_buffer.as_stream(batch_size)
    if k > 1:
      stream = prefetch_lib.stack_batches(stream, k)
    depth = prefetch_lib.prefetch_buffer_size(
        prefetch_buffer_size, online=hook_list.drives_online_collection)
    prefetcher = prefetch_lib.DevicePrefetcher(stream, device,
                                               buffer_size=depth)
    replay_buffer.set_learner_step(step)
    prefetch_iter = prefetch_lib.TimedIterator(prefetcher)
    t_last = time.time()
    steps_since_log = 0
    last_saved = resume_step
    for transitions in prefetch_iter:
      if step >= max_train_steps:
        break
      batches = ([transitions] if k == 1 else
                 [{key: v[i] for key, v in transitions.items()}
                  for i in range(k)])
      for batch in batches:
        state, metrics = learner.train_step(
            state, batch, generator=step_generator(seed, step, device))
        step += 1
      steps_since_log += k
      replay_buffer.set_learner_step(step)
      hook_list.after_step(step, metrics)
      if step % log_every_steps == 0 or step == max_train_steps:
        scalars = {key: v.item() for key, v in metrics.items()}
        dt = time.time() - t_last
        scalars["grad_steps_per_sec"] = steps_since_log / max(dt, 1e-9)
        scalars["input_wait_fraction"] = prefetch_iter.wait_fraction(dt)
        scalars.update(replay_buffer.metrics_scalars())
        metric_logger.write("train", step, scalars)
        t_last = time.time()
        steps_since_log = 0
      if step % save_checkpoints_steps == 0 or step == max_train_steps:
        writer.save(step, state)
        last_saved = step
        hook_list.after_checkpoint(step, state.train_state, model_dir)
    if last_saved != step:
      writer.save(step, state)
      hook_list.after_checkpoint(step, state.train_state, model_dir)
  finally:
    try:
      hook_list.end(step, state.train_state, model_dir)
    except Exception:  # noqa: BLE001 — don't mask the original error
      log.exception("hook end() failed during teardown")
    if prefetcher is not None:
      prefetcher.close()
    metric_logger.close()
  return state
