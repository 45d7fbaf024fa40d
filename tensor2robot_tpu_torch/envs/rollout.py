"""Anakin-style collection on the card closing the loop into QT-Opt (port
of `envs/rollout.py`).

When the env is a batched function of tensors (envs/core.py), acting and
env stepping run on the card beside training: a rollout of `num_envs`
envs for `rollout_length` steps, its transitions written into a replay
ring that lives on the card, and K Bellman steps sampled from that ring,
all one CUDA graph replayed once per iteration. No transition crosses
the host, and the rollout policy reads the current learner params, so
``param_refresh_lag`` is zero by construction.

Three layers, composable separately:

  * ``rollout`` / ``make_collect_fn``: the rollout engine (a Python loop
    over steps where JAX runs `lax.scan`) producing replay-wire batches
    (`[T·N]` rows of `QTOptLearner.transition_specification`).
  * ``train_anakin``: the `--trainer=anakin` online mode.
  * ``JaxEnvBandit`` / ``score_scenarios`` / ``evaluate_scenarios``: the
    host seams: the batched-bandit adapter `GraspActor` drives (a
    functional env as a scenario source), and the seeded procedural
    sweep that `run_success_protocol envs` and `ScenarioSuccessEvalHook`
    report per-bucket success over.

The JAX keys become generators on the card. Where JAX splits a key, the
port draws from one generator in a fixed order; the draws of an
iteration never depend on the data, so a CUDA graph captures them, and a
generator seeded alike before a replay draws what an eager call draws.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data import prefetch as prefetch_lib
from tensor2robot_tpu_torch.device import resolve_device
from tensor2robot_tpu_torch.envs.core import (
    AutoResetEnv,
    BatchedEnv,
    FunctionalEnv,
)
from tensor2robot_tpu_torch.envs.pose import PoseBanditEnv
from tensor2robot_tpu_torch.envs.procgen import ProcGenGraspEnv
from tensor2robot_tpu_torch.parallel import rules as rules_lib
from tensor2robot_tpu_torch.serving.microbatcher import dispatch_seed
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics
from tensor2robot_tpu_torch.telemetry import perf as perf_lib
from tensor2robot_tpu_torch.telemetry import sentinel as sentinel_lib
from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib
from tensor2robot_tpu_torch.utils import profiling
from tensor2robot_tpu_torch.utils.step_graph import StepGraph, copy_tree

log = logging.getLogger(__name__)

# The replay wire keys of a single-camera transition batch.
WIRE_KEYS = ("image", "action", "reward", "done", "next_image")


def make_batched(env: FunctionalEnv, num_envs: int) -> BatchedEnv:
  """The canonical composition: auto-reset inside, the batch outside."""
  return BatchedEnv(AutoResetEnv(env), num_envs)


def rollout(batched: BatchedEnv,
            policy_fn: Callable[[Dict[str, torch.Tensor], torch.Generator],
                                torch.Tensor],
            env_states, generator: torch.Generator, length: int):
  """`length` steps of every env. ``policy_fn(obs, generator) -> actions
  [N, A]``. Returns ``(env_states', traj)``, every traj leaf `[length,
  num_envs, ...]` in wire order: ``image`` is the acting observation,
  ``next_image`` the post-transition one (the terminal frame at an
  episode's end, not the reset frame)."""
  steps = []
  states = env_states
  for _ in range(length):
    obs = batched.observe(states)
    actions = policy_fn(obs, generator)
    states, next_obs, reward, done = batched.step(states, actions,
                                                  generator)
    steps.append({
        "image": obs["image"],
        "action": actions,
        "reward": reward[:, None].float(),
        "done": done[:, None].float(),
        "next_image": next_obs["image"],
    })
  return states, {k: torch.stack([s[k] for s in steps]) for k in WIRE_KEYS}


def flatten_time(traj):
  """[T, N, ...] → [T·N, ...]: a traj as one replay-wire batch."""
  return {k: v.reshape((v.shape[0] * v.shape[1],) + tuple(v.shape[2:]))
          for k, v in traj.items()}


def _check_wire_spec(learner) -> None:
  """train_anakin covers models whose transition spec is exactly the
  single-camera wire (image/action/reward/done/next_image): an env only
  renders images, so extra state features would sample as garbage."""
  spec = learner.transition_specification().to_flat_dict()
  extra = sorted(set(spec) - set(WIRE_KEYS))
  if extra:
    raise ValueError(
        "train_anakin needs a {image, action} model; the transition "
        f"spec carries extra keys the env cannot produce: {extra}")


def make_collect_fn(learner, env: FunctionalEnv, num_envs: int,
                    rollout_length: int, epsilon: float = 0.1,
                    cem_population: Optional[int] = None,
                    cem_iterations: Optional[int] = None):
  """(init_fn, collect_fn) for ε-greedy CEM collection.

  ``init_fn(generator) -> env_states`` resets the batch on the
  generator's device; ``collect_fn(learner_state, env_states, generator)
  -> (env_states', batch)`` rolls ``rollout_length`` steps of
  ``num_envs`` envs with the CEM policy over the passed learner params
  (ε-greedy per env-step) and returns a flat `[T·N]`-row wire batch.
  The policy runs under `no_grad`, not inference mode, so its actions
  can be written into tensors a later autograd step reads. Each step
  draws the CEM noise, then the random actions, then the ε coins, then
  the env's step and reset draws.
  """
  _check_wire_spec(learner)
  batched = make_batched(env, num_envs)
  policy = learner.build_policy(cem_population=cem_population,
                                cem_iterations=cem_iterations,
                                no_grad=True)
  epsilon = float(epsilon)

  def init_fn(generator):
    return batched.reset(generator)

  def collect_fn(learner_state, env_states, generator):
    def policy_fn(obs, gen):
      greedy = policy(learner_state, obs, generator=gen)
      random_actions = torch.rand(greedy.shape, generator=gen,
                                  device=gen.device) * 2.0 - 1.0
      explore = torch.rand((num_envs,), generator=gen,
                           device=gen.device) < epsilon
      return torch.where(explore[:, None], random_actions, greedy).float()

    with torch.no_grad():
      env_states, traj = rollout(batched, policy_fn, env_states, generator,
                                 rollout_length)
    return env_states, flatten_time(traj)

  return init_fn, collect_fn


def make_anakin_collect_fn(learner, env: FunctionalEnv, num_envs: int,
                           rollout_length: int, epsilon: float = 0.1,
                           devices=None,
                           cem_population: Optional[int] = None,
                           cem_iterations: Optional[int] = None):
  """`make_collect_fn` with a leading device axis on env states and
  batches (`[D, T·N/D, ...]`; `flatten_devices` folds it away), for one
  device: D > 1 raises (ROADMAP A11)."""
  if devices is not None and len(devices) > 1:
    raise NotImplementedError(
        f"make_anakin_collect_fn over {len(devices)} devices: the pod "
        "program is not ported yet (ROADMAP A11).")
  inner_init, inner_collect = make_collect_fn(
      learner, env, num_envs, rollout_length, epsilon=epsilon,
      cem_population=cem_population, cem_iterations=cem_iterations)
  lead = lambda state: dataclasses.replace(state, **{  # noqa: E731
      f.name: getattr(state, f.name)[None]
      for f in dataclasses.fields(state)})

  def init_fn(generator):
    return lead(inner_init(generator))

  def collect_fn(learner_state, env_states, generator):
    states, batch = inner_collect(learner_state, dataclasses.replace(
        env_states, **{f.name: getattr(env_states, f.name)[0]
                       for f in dataclasses.fields(env_states)}),
        generator)
    return lead(states), {k: v[None] for k, v in batch.items()}

  return init_fn, collect_fn


def flatten_devices(batch):
  """[D, R, ...] → [D·R, ...]: a device-axis collection as one batch."""
  return {k: v.reshape((v.shape[0] * v.shape[1],) + tuple(v.shape[2:]))
          for k, v in batch.items()}


def _build_env(env_family: str, model) -> FunctionalEnv:
  if env_family == "pose":
    return PoseBanditEnv(image_size=model.image_size,
                         action_dim=model.action_dim)
  if env_family == "procgen":
    return ProcGenGraspEnv(image_size=model.image_size,
                           action_dim=model.action_dim)
  raise ValueError(f"env_family={env_family!r} not in "
                   "('pose', 'procgen') and no env was passed")


def _resolve_devices(num_devices: Optional[int],
                     device: torch.device) -> int:
  """The device count `num_devices` asks for: None and 0 on one card
  are one. More than one raises (ROADMAP A11)."""
  if num_devices is None:
    return 1
  visible = torch.cuda.device_count() if device.type == "cuda" else 1
  d = visible if num_devices == 0 else int(num_devices)
  if d > 1:
    raise NotImplementedError(
        f"train_anakin(num_devices={num_devices}) asks for {d} devices: the "
        "pod program over several devices is not ported yet (ROADMAP A11).")
  if d < 1:
    raise ValueError(f"num_devices={num_devices} asks for {d} devices; "
                     f"{visible} local devices are visible")
  return d


def ring_capacity(replay_capacity: int, batch_size: int, rows: int) -> int:
  """The ring's row count: at least the batch and one segment, rounded
  up to a whole number of `rows`-row segments (one insert = one slot)."""
  capacity = max(int(replay_capacity), batch_size, rows)
  return ((capacity + rows - 1) // rows) * rows


def empty_ring(spec, capacity: int, device) -> Dict[str, torch.Tensor]:
  """The ring's zeroed buffers, one `[capacity, ...]` tensor per key."""
  return {key: torch.zeros((capacity,) + tuple(sp.shape),
                           dtype=torch.from_numpy(np.empty(0, sp.dtype)).dtype,
                           device=device)
          for key, sp in spec.items()}


def ring_insert(ring: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                fill: torch.Tensor, ptr: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Writes a `[rows, ...]` batch at row `ptr` (a device int64, a
  multiple of rows) in place; returns the new (fill, ptr) tensors. No
  host read: the slot index stays on the device."""
  rows = next(iter(batch.values())).shape[0]
  capacity = next(iter(ring.values())).shape[0]
  slot = (ptr // rows).reshape(1)
  for name, buf in ring.items():
    seg = buf.view((capacity // rows, rows) + tuple(buf.shape[1:]))
    seg.index_copy_(0, slot, batch[name].reshape((1,) + tuple(seg.shape[1:])))
  return (torch.clamp(fill + rows, max=capacity),
          torch.remainder(ptr + rows, capacity))


def ring_sample(ring: Dict[str, torch.Tensor], fill: torch.Tensor,
                batch_size: int, generator: torch.Generator
                ) -> Dict[str, torch.Tensor]:
  """`batch_size` rows drawn uniformly from the filled prefix
  ``[0, fill)``: indices ``floor(u · fill)``, clamped below `fill`, from
  `generator` (`torch.randint` would need the bound on the host)."""
  u = torch.rand((batch_size,), generator=generator, device=fill.device)
  idx = torch.minimum((u * fill.float()).long(), fill - 1)
  return {name: buf.index_select(0, idx) for name, buf in ring.items()}


def anakin_train_steps(learner, qstate, ring, fill, batch_size: int,
                       generators):
  """The iteration's Bellman half: per generator one uniform sample of
  `batch_size` rows from the ring, then `learner.train_step` on it with
  that generator's CEM noise. Returns (state, the last step's
  metrics)."""
  metrics = None
  for generator in generators:
    batch = ring_sample(ring, fill, batch_size, generator)
    qstate, metrics = learner.train_step(qstate, batch, generator=generator)
  return qstate, metrics


def make_iteration(learner, collect_fn, batch_size: int, capacity: int):
  """The Anakin iteration as a `StepGraph` step over the carry
  ``(learner state, env states, ring, fill, ptr)`` and ``K + 1``
  generators: collect with the first, write the ring in place, then K
  Bellman steps, one generator each. Its outputs are the last step's
  metrics with ``collect_reward_mean`` and ``replay_fill``."""

  def iteration(carry, _, generators):
    qstate, states, ring, fill, ptr = carry
    states, batch = collect_fn(qstate, states, generators[0])
    fill, ptr = ring_insert(ring, batch, fill, ptr)
    qstate, metrics = anakin_train_steps(learner, qstate, ring, fill,
                                         batch_size, generators[1:])
    metrics = dict(metrics)
    metrics["collect_reward_mean"] = batch["reward"].mean()
    metrics["replay_fill"] = fill.float() / capacity
    return (qstate, states, ring, fill, ptr), metrics

  return iteration


def _at_step(state, step: int):
  return dataclasses.replace(
      state, train_state=dataclasses.replace(state.train_state, step=step))


def _check_pod_rules(learner, params, sharding_rules: str,
                    num_devices: int) -> None:
  """The rules seam of the shard_map pod program: every param's
  placement under the `sharding_rules` family table on the pod mesh
  must be replicated (the collect stage broadcasts the params). Raises
  ValueError on an unknown family, on a param no rule matches, and on a
  table that shards a param."""
  with torch.device("meta"):
    network = learner.model.create_network()
  specs = rules_lib.match_state_rules(
      rules_lib.family_rules(sharding_rules), params, network,
      rules_lib.MeshShape({rules_lib.POD_AXIS: num_devices}))
  bad = [name for name, spec in specs.items() if spec != rules_lib.P()]
  if bad:
    raise ValueError(
        "the shard_map pod program broadcasts params into the collect "
        f"stage; rules table {sharding_rules!r} shards {bad[:3]} on the "
        "pod mesh")


@gin.configurable
def train_anakin(
    learner=gin.REQUIRED,
    model_dir: str = gin.REQUIRED,
    env: Optional[FunctionalEnv] = None,
    env_family: str = "pose",
    num_envs: int = 256,
    rollout_length: int = 4,
    train_batches_per_iter: int = 4,
    batch_size: int = 256,
    replay_capacity: int = 16384,
    max_train_steps: int = 1000,
    log_every_steps: int = 100,
    save_checkpoints_steps: int = 500,
    max_checkpoints_to_keep: int = 5,
    epsilon: float = 0.1,
    cem_population: Optional[int] = None,
    cem_iterations: Optional[int] = None,
    num_devices: Optional[int] = None,
    pod_program: str = "pmap",
    sharding_rules: Optional[str] = None,
    shard_weight_update: bool = False,
    update_shard_min_size: int = 2 ** 10,
    hooks: Iterable = (),
    seed: int = 0,
    graphs: bool = True,
):
  """QT-Opt online training with collection on the card, on
  `learner.device`; resumes from `model_dir`'s latest checkpoint and
  returns the final `QTOptState`.

  One iteration (one CUDA-graph replay on the card, `graphs=True`):
    1. roll ``rollout_length`` steps of ``num_envs`` auto-resetting envs
       with the ε-greedy CEM policy over the CURRENT params,
    2. write the `[T·N]` wire batch into the replay ring on the card
       (capacity rounded up to a multiple of the segment, so an insert
       is one slot; the write cursor and fill count are device tensors,
       so no iteration reads the host),
    3. run ``train_batches_per_iter`` Bellman steps, each on a uniform
       sample of ``batch_size`` rows of the filled prefix.
  ``graphs=False`` runs the same iteration eagerly (the CPU always
  does).

  Every cadence must be a multiple of ``train_batches_per_iter`` (the
  JAX dispatch quantum). Iteration seeds: the collection draws from a
  generator seeded ``dispatch_seed(seed + 4, s)`` at the iteration's
  first step s, the Bellman step of absolute step i samples and draws
  its CEM noise from one seeded ``dispatch_seed(seed + 1, i)``; envs
  reset from ``seed + 2``. A checkpoint holds the learner state only: a
  resume restores the learner exactly and restarts collection (empty
  ring, fresh envs), as JAX does.

  ``num_devices``: None runs the single program; 0 or 1 on one card is
  the JAX pod program at D = 1, which is the single program bit for bit,
  and only adds the pod records' ``devices``, ``global_batch_size`` and
  ``bellman_batches_per_sec``. More devices raise (ROADMAP A11).
  ``pod_program``: "pmap" or "shard_map", the JAX pod program's two
  substrates; at D = 1 both are the single program (JAX pins its
  shard_map program there bit for bit to the pmap one), so the port runs
  that one for either. ``sharding_rules`` names a `parallel.rules`
  family table; with the shard_map pod program the learner's params are
  matched through it on the pod mesh (`{"pod": D}`), where every
  placement must resolve to replicated (the collect stage broadcasts
  the params): a table that places a param on the pod raises, as does an
  unknown family. Other programs ignore it, as in JAX.
  ``shard_weight_update=True`` on one device is the plain update, bit
  for bit (the JAX one-device mesh's sharding constraints are no-ops),
  whatever ``update_shard_min_size``.

  Records carry the last step's metrics, ``collect_reward_mean``,
  ``replay_fill``, ``grad_steps_per_sec``, ``env_steps_per_sec``,
  ``param_refresh_lag_steps`` (0.0 by construction), the resource
  sampler's ``rsrc.*`` gauges and the perf meter's ``perf.*``
  (`telemetry.perf`; ``perf.mfu`` from `utils.profiling.
  qtopt_step_flops` × D over the peak × D). The alert sentinel
  (`telemetry.sentinel.build_for_run`) evaluates each record, as in JAX.
  """
  del shard_weight_update, update_shard_min_size  # the plain update
  if pod_program not in ("pmap", "shard_map"):
    raise ValueError(f"pod_program={pod_program!r} not in "
                     "('pmap', 'shard_map')")
  k = prefetch_lib.validate_steps_per_dispatch(
      train_batches_per_iter,
      log_every_steps=log_every_steps,
      save_checkpoints_steps=save_checkpoints_steps,
      max_train_steps=max_train_steps)
  device = learner.device
  pod = num_devices is not None
  d = _resolve_devices(num_devices, device)
  if env is None:
    env = _build_env(env_family, learner.model)
  rows = num_envs * rollout_length
  capacity = ring_capacity(replay_capacity // d, batch_size, rows)
  _check_wire_spec(learner)
  spec = learner.transition_specification().to_flat_dict()

  from tensor2robot_tpu_torch.hooks import HookList
  from tensor2robot_tpu_torch.train_eval import MetricLogger

  os.makedirs(model_dir, exist_ok=True)
  state = learner.create_state(seed)
  if pod and pod_program == "shard_map" and sharding_rules is not None:
    _check_pod_rules(learner, state.train_state.params, sharding_rules, d)
  resume_step = ckpt_lib.latest_step(model_dir)
  if resume_step is not None:
    log.info("Resuming anakin QT-Opt from step %d", resume_step)
    state = ckpt_lib.restore_state(model_dir, like=state, step=resume_step)
  step = int(state.step)
  if k > 1 and step % k and step < max_train_steps:
    raise ValueError(
        f"Resumed at step {step}, not a multiple of "
        f"train_batches_per_iter={k}: the checkpoint/log boundaries "
        "would never align.")

  init_fn, collect_fn = make_collect_fn(
      learner, env, num_envs, rollout_length, epsilon=epsilon,
      cem_population=cem_population, cem_iterations=cem_iterations)
  env_states = init_fn(torch.Generator(device=device).manual_seed(seed + 2))
  if learner.needs_calibration:
    # The int8 tower's activation scales calibrate on real rendered
    # frames, the first envs' observations, before any capture.
    sample = min(num_envs, 64)
    first = dataclasses.replace(env_states, **{
        f.name: getattr(env_states, f.name)[:sample]
        for f in dataclasses.fields(env_states)})
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    learner.calibrate(state, {
        "image": env.observe(first)["image"],
        "action": torch.rand((sample, learner.model.action_dim),
                             generator=gen, device=device) * 2.0 - 1.0,
    })

  iteration = make_iteration(learner, collect_fn, batch_size, capacity)

  def seed_generators(gens):
    gens[0].manual_seed(dispatch_seed(seed + 4, step))
    for i, gen in enumerate(gens[1:]):
      gen.manual_seed(dispatch_seed(seed + 1, step + i))

  carry = (state, env_states, empty_ring(spec, capacity, device),
           torch.zeros((), dtype=torch.int64, device=device),
           torch.zeros((), dtype=torch.int64, device=device))
  del env_states
  metric_logger = MetricLogger(model_dir, role="anakin")
  hook_list = HookList(list(hooks))
  writer = ckpt_lib.CheckpointWriter(model_dir,
                                     max_to_keep=max_checkpoints_to_keep)
  registry = tmetrics.registry()
  perf_lib.start_resource_sampler(
      sources=[profiling.device_memory_source()])
  watch_sentinel = sentinel_lib.build_for_run(model_dir)
  # One optimizer step takes `batch_size` rows per device (global batch
  # D·B): the per-device count × D over the peak × D keeps perf.mfu the
  # per-card share of peak of the Bellman model (the collection's FLOPs
  # are not model FLOPs).
  per_device_flops = profiling.qtopt_step_flops(
      learner, batch_size, params=state.train_state.params)
  perf_meter = perf_lib.PerfMeter(
      flops_per_step=per_device_flops * d if per_device_flops else None,
      peak_flops=profiling.device_peak_flops(device), devices=d)
  graph = None
  eager_gens = [torch.Generator(device=device) for _ in range(k + 1)]

  def current():
    """The learner state as of `step`, a copy no later replay writes."""
    qstate = carry[0] if graph is None else copy_tree(graph.carry[0])
    return _at_step(qstate, step)

  try:
    hook_list.begin(learner.model, model_dir)
    t_last = time.time()
    steps_since_log = 0
    last_saved = resume_step
    while step < max_train_steps:
      with perf_meter.dispatch("anakin.dispatch", step=step, k=k,
                               devices=d):
        if graphs:
          if graph is None:
            graph = StepGraph(iteration, carry, {}, device,
                              num_generators=k + 1)
            carry = None  # the graph's static buffers hold it from here
          seed_generators(graph.generators)
          metrics = graph.replay()
        else:
          seed_generators(eager_gens)
          carry, metrics = iteration(carry, {}, eager_gens)
      step += k
      steps_since_log += k
      hook_list.after_step(step, metrics)
      if step % log_every_steps == 0 or step == max_train_steps:
        scalars = {key: v.item() for key, v in metrics.items()}
        dt = max(time.time() - t_last, 1e-9)
        scalars["grad_steps_per_sec"] = steps_since_log / dt
        scalars["env_steps_per_sec"] = (steps_since_log // k) * rows / dt
        if pod:
          scalars["devices"] = d
          scalars["global_batch_size"] = d * batch_size
          scalars["bellman_batches_per_sec"] = (
              scalars["grad_steps_per_sec"] * d)
        # Zero by construction: acting params are the training params.
        scalars["param_refresh_lag_steps"] = 0.0
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
        writer.save(step, saved)
        last_saved = step
        hook_list.after_checkpoint(step, saved.train_state, model_dir)
    state = current()
    if last_saved != step:
      writer.save(step, state)
      hook_list.after_checkpoint(step, state.train_state, model_dir)
  finally:
    try:
      hook_list.end(step, current().train_state, model_dir)
    except Exception:  # noqa: BLE001 — don't mask the original error
      log.exception("hook end() failed during teardown")
    if watch_sentinel is not None:
      watch_sentinel.close()
    metric_logger.close()
  return state


def _state_device(state) -> torch.device:
  ts = state.train_state if hasattr(state, "train_state") else state
  return next(iter(ts.params.values())).device


@gin.configurable
class JaxEnvBandit:
  """A functional env as the host batched-bandit interface.

  `GraspActor` and the success-protocol evaluations speak ``reset_batch
  / grade / action_dim / sample_transitions`` (`ToyGraspEnv`'s single
  step contract). This adapter lets a functional env serve as that
  scenario source: reset and render run on `device` (the card unless
  the caller asks for the CPU), ``grade`` is the env's own reward
  function, so host and device rewards cannot drift. The name is the
  JAX package's, kept for configs.
  """

  def __init__(self, env: Optional[FunctionalEnv] = None,
               seed: int = 0, device=None, **env_kwargs):
    self._env = env if env is not None else ProcGenGraspEnv(**env_kwargs)
    self._device = resolve_device(device)
    self._generator = torch.Generator(device=self._device).manual_seed(seed)
    self._rng = np.random.default_rng(seed)
    # The bucket ids of the most recent reset_batch (None for envs
    # without scenario buckets).
    self.last_buckets: Optional[np.ndarray] = None

  @property
  def env(self) -> FunctionalEnv:
    return self._env

  @property
  def action_dim(self) -> int:
    return self._env.action_dim

  def reset_batch(self, n: int
                  ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """N fresh scenarios: ({image: [N, S, S, 3]}, target poses)."""
    with torch.no_grad():
      states = self._env.reset(self._generator, n)
      obs = self._env.observe(states)
    self.last_buckets = (
        self._env.scenario_bucket(states).cpu().numpy()
        if hasattr(self._env, "scenario_bucket") else None)
    return ({k: v.cpu().numpy() for k, v in obs.items()},
            states.pose.cpu().numpy())

  def grade(self, actions: np.ndarray,
            positions: np.ndarray) -> np.ndarray:
    f32 = dict(dtype=torch.float32, device=self._device)
    return self._env.grasp_reward(torch.as_tensor(actions, **f32),
                                  torch.as_tensor(positions, **f32)
                                  ).cpu().numpy()

  def sample_transitions(self, n: int) -> Dict[str, np.ndarray]:
    """N random-policy transitions in the learner's replay layout."""
    observations, positions = self.reset_batch(n)
    actions = self._rng.uniform(
        -1, 1, (n, self._env.action_dim)).astype(np.float32)
    reward = self.grade(actions, positions)
    return {
        "image": observations["image"],
        "action": actions,
        "reward": reward[:, None].astype(np.float32),
        "done": np.ones((n, 1), np.float32),
        "next_image": observations["image"],
    }


def score_scenarios(learner, state, env: FunctionalEnv, env_states,
                    seed: int = 0,
                    cem_population: Optional[int] = None,
                    cem_iterations: Optional[int] = None,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None
                    ) -> Dict[str, object]:
  """`evaluate_scenarios` on GIVEN scenarios: CEM actions for every
  scenario (noise from `generator` or given whole as `noise`
  `[iterations, N, P, A]`), graded, grouped by `scenario_bucket`, beside
  the random baseline on the same scenarios (numpy's
  `default_rng(seed + 1)`, as JAX draws it) and the SHA-256 digests of
  the actions and of the poses."""
  policy = learner.build_policy(cem_population=cem_population,
                                cem_iterations=cem_iterations)
  n = env_states.pose.shape[0]
  with torch.no_grad():
    obs = env.observe(env_states)
    actions = policy(state, obs, generator=generator, noise=noise)
    rewards = env.grasp_reward(actions, env_states.pose)
    bucket = (env.scenario_bucket(env_states)
              if hasattr(env, "scenario_bucket")
              else torch.zeros((n,), dtype=torch.int32))
  actions = actions.float().cpu().numpy()
  rewards = rewards.cpu().numpy()
  bucket = bucket.cpu().numpy()
  poses = env_states.pose.cpu().numpy()
  per_bucket = {}
  for b in range(int(getattr(env, "num_buckets", 1))):
    mask = bucket == b
    per_bucket[str(b)] = {
        "count": int(mask.sum()),
        "success_rate": (float(rewards[mask].mean())
                         if mask.any() else None),
    }
  random_actions = np.random.default_rng(seed + 1).uniform(
      -1, 1, actions.shape).astype(np.float32)
  with torch.no_grad():
    random_rewards = env.grasp_reward(
        torch.as_tensor(random_actions, device=env_states.pose.device),
        env_states.pose).cpu().numpy()
  return {
      "success_rate": float(rewards.mean()),
      "random_baseline_success_rate": float(random_rewards.mean()),
      "per_bucket": per_bucket,
      "num_scenarios": int(n),
      "action_digest": hashlib.sha256(
          np.ascontiguousarray(actions).tobytes()).hexdigest(),
      "scenario_digest": hashlib.sha256(
          np.ascontiguousarray(poses).tobytes()).hexdigest(),
  }


@gin.configurable
def evaluate_scenarios(
    learner,
    state,
    env: Optional[FunctionalEnv] = None,
    num_scenarios: int = 512,
    seed: int = 0,
    cem_population: Optional[int] = None,
    cem_iterations: Optional[int] = None,
) -> Dict[str, object]:
  """Seeded procedural robustness sweep: success per scenario bucket.

  Resets ``num_scenarios`` scenarios from a generator seeded `seed` on
  the state's device, selects every action with the CEM policy (its
  noise from the same generator), and grades them (`score_scenarios`).
  The same seed gives the same scenarios and the same action stream:
  ``action_digest`` and ``scenario_digest`` are the reproducibility
  handles `run_success_protocol seedcheck` holds.
  """
  if env is None:
    env = ProcGenGraspEnv(image_size=learner.model.image_size,
                          action_dim=learner.model.action_dim)
  generator = torch.Generator(device=_state_device(state)).manual_seed(seed)
  with torch.no_grad():
    env_states = env.reset(generator, num_scenarios)
  return score_scenarios(learner, state, env, env_states, seed=seed,
                         cem_population=cem_population,
                         cem_iterations=cem_iterations, generator=generator)
