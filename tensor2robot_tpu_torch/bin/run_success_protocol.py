"""Success protocols on the port: per-checkpoint closed-loop success of
QT-Opt's CEM policy (held-out `ToyGraspEnv` episodes, procedural
scenarios) and of the gripper BC clones.

    python -m tensor2robot_tpu_torch.bin.run_success_protocol
        {qtopt,online,envs,gripper,seedcheck} [--out_dir DIR]
        [--device cpu] [--cem_select {lax,fused}] [--small]

Modes (the port of `scripts/run_success_protocol.py`'s):
  * ``qtopt`` — `GraspingQModel()` (64×64 images, action 4, Adam 1e-3)
    under `QTOptLearner(cem_population=64, cem_iterations=2,
    cem_elites=6)` trains 2000 steps of batch 256 on 16384 random-policy
    grasps; `QTOptSuccessEvalHook` scores every 500-step checkpoint on
    512 episodes with CEM 64 × 3. Writes
    `qtopt_flagship_success_eval.jsonl`.
  * ``online`` — the offline→online protocol: the same model and learner
    pretrain 2000 steps on 16384 logged random grasps in a 32768-row
    replay (`steps_per_dispatch=50`), then resume to 4000 steps at lr
    3e-4 while a `GraspActor` (32 episodes a batch, ε 0.3) collects with
    actions from a `CEMPolicyServer(max_batch=32, max_wait_us=2000)`
    and commits through a `ReplayWriteService(queue_batches=16,
    overflow="drop")` into the same replay; `ActorStateRefreshHook`
    hands each checkpoint to the server. Writes
    `qtopt_online_vs_offline.jsonl`: both phases' success per checkpoint
    and a summary row (the replay plane's counters, the staleness of
    the learner's samples, the serving dispatches, each phase's
    `grad_steps_per_sec` and `input_wait_fraction`).
  * ``envs`` — Anakin-trained QT-Opt scored on a seeded procedural
    sweep: a 32×32 `GraspingQModel` (torso (16, 32), head (32, 32),
    dense (32, 32), action 2, Adam 1e-3, CEM 64 × 2, 6 elites) trains
    2000 steps through `train_anakin` (256 `ProcGenGraspEnv` envs,
    rollout 4, 4 Bellman steps of batch 256 an iteration, a 16384-row
    ring on the card, ε 0.1); `evaluate_scenarios` then scores 512
    scenarios (CEM 64 × 3) per distractor bucket, beside the random
    baseline on the same scenarios. Writes `qtopt_envs_scenarios.jsonl`.
  * ``gripper`` — gripper BC twice over, from 96 scripted demos at 24×24
    written as TFRecords: the per-step clone (`VRGripperRegressionModel`,
    500 steps of batch 32 transitions) scored by `SuccessEvalHook` on
    500 episodes at its checkpoint, and the transformer clone (width 48,
    depth 1, 400 steps) scored through its full-history
    `EpisodeContextPolicy` on 500 episodes. Writes
    `vrgripper_bc_success_eval.jsonl` and
    `vrgripper_transformer_success_eval.jsonl`.
  * ``seedcheck`` — two synchronous collect → flush → sample passes of
    the online plane at test size (seeded replay, service, actor with
    the learner's own CEM policy, a recording sampler) must draw the
    same sample schedule and action stream (SHA-256 digests); two
    procedural sweeps the same scenario and action digests; and two
    `train_anakin` runs the same final params at each device count
    (1; 2 is recorded as skipped with fewer than two cards, and as not
    ported with more: ROADMAP A11). On the card the Anakin pass runs
    with cuDNN's deterministic algorithms (its default convolution
    backward is not deterministic).

Every stochastic input derives from `PROTOCOL_SEED`. The learner runs on
the CUDA card unless `--device cpu` is given; `--cem_select` picks the
learner's CEM select (`fused`: the `cem_select` kernel; `lax`: sort and
gather, the JAX protocol's own configuration); `--small` runs the test
size (16×16 images, action 2, narrow towers, a few steps; the gripper
mode 16×16, a few demos, steps and episodes). Each mode prints one JSON
line per artifact.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.device import resolve_device
from tensor2robot_tpu_torch.hooks import QTOptSuccessEvalHook
from tensor2robot_tpu_torch.models import optimizers as opt_lib
from tensor2robot_tpu_torch.replay import (
    ReplayBatchSampler,
    ReplayWriteService,
)
from tensor2robot_tpu_torch.research.qtopt import (
    ActorStateRefreshHook,
    GraspActor,
    GraspingQModel,
    QTOptLearner,
    ReplayBuffer,
    ToyGraspEnv,
    train_qtopt,
)
from tensor2robot_tpu_torch.research.qtopt.actor import acting_copy
from tensor2robot_tpu_torch.serving import CEMPolicyServer
from tensor2robot_tpu_torch.telemetry.records import read_records
from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib

# The one seed every stochastic input of the protocol derives from.
PROTOCOL_SEED = 0


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
  """The protocol's sizes and cadences (`FULL`: the JAX protocol's)."""

  model: Dict[str, Any] = dataclasses.field(default_factory=dict)
  cem: Dict[str, int] = dataclasses.field(default_factory=lambda: dict(
      cem_population=64, cem_iterations=2, cem_elites=6))
  lr: float = 1e-3
  finetune_lr: float = 3e-4
  replay_capacity: int = 32768
  offline_transitions: int = 16384
  batch_size: int = 256
  offline_steps: int = 2000
  save_checkpoints_steps: int = 500
  log_every_steps: int = 250
  steps_per_dispatch: int = 50
  eval_episodes: int = 512
  eval_cem: Dict[str, int] = dataclasses.field(default_factory=lambda: dict(
      cem_population=64, cem_iterations=3))
  server_max_batch: int = 32
  server_max_wait_us: int = 2000
  queue_batches: int = 16
  actor_batch_episodes: int = 32
  actor_epsilon: float = 0.3


FULL = ProtocolConfig()
SMALL = ProtocolConfig(
    model=dict(image_size=16, torso_filters=(8,), head_filters=(8,),
               dense_sizes=(16,), action_dim=2),
    cem=dict(cem_population=8, cem_iterations=1, cem_elites=2),
    replay_capacity=512, offline_transitions=256, batch_size=16,
    offline_steps=8, save_checkpoints_steps=4, log_every_steps=4,
    steps_per_dispatch=2, eval_episodes=64,
    eval_cem=dict(cem_population=8, cem_iterations=1),
    server_max_batch=8, actor_batch_episodes=8)


def build_learner(config: ProtocolConfig, lr: float, device=None,
                  cem_select: str = "fused") -> QTOptLearner:
  """`GraspingQModel(**config.model)` with Adam at `lr`, under the
  protocol's CEM."""
  model = GraspingQModel(
      create_optimizer_fn=lambda: opt_lib.create_optimizer(
          learning_rate=lr), **config.model)
  return QTOptLearner(model, cem_select=cem_select, device=device,
                      **config.cem)


def _env(learner: QTOptLearner, seed: int) -> ToyGraspEnv:
  return ToyGraspEnv(image_size=learner.model.image_size,
                     action_dim=learner.model.action_dim, seed=seed)


def offline_replay(learner: QTOptLearner, config: ProtocolConfig,
                   capacity: Optional[int] = None) -> ReplayBuffer:
  """The logged dataset: `offline_transitions` random-policy grasps in a
  seeded replay buffer."""
  replay = ReplayBuffer(learner.transition_specification(),
                        capacity=capacity or config.replay_capacity,
                        seed=PROTOCOL_SEED)
  replay.add(_env(learner, PROTOCOL_SEED).sample_transitions(
      config.offline_transitions))
  return replay


def make_eval_hook(learner: QTOptLearner,
                   config: ProtocolConfig) -> QTOptSuccessEvalHook:
  """The protocol's scoring: `eval_episodes` held-out episodes under
  the config's evaluation CEM."""
  return QTOptSuccessEvalHook(learner, eval_kwargs=dict(
      num_episodes=config.eval_episodes,
      image_size=learner.model.image_size, seed=5, **config.eval_cem))


def _rates(model_dir: str, lo: int, hi: int) -> Dict[str, Any]:
  """The train log's rates over the intervals ending in (lo, hi].
  `grad_steps_per_sec` and `input_wait_fraction` are the steps past the
  first interval (which holds the warm-up and the capture) over those
  intervals' wall time, and their wait over it, so that checkpoints,
  evaluations and stalls count; beside them each interval's, and the
  median past the first."""
  records = [r for r in read_records(
      os.path.join(model_dir, "metrics_train.jsonl"))
             if lo < r["step"] <= hi]
  later = records[1:] or records
  starts = [lo] + [r["step"] for r in records[:-1]]
  steps = {r["step"]: r["step"] - s for r, s in zip(records, starts)}
  secs = {r["step"]: steps[r["step"]] / r["grad_steps_per_sec"]
          for r in records}
  total_s = sum(secs[r["step"]] for r in later)
  return {
      "grad_steps_per_sec": sum(steps[r["step"]] for r in later) / total_s,
      "input_wait_fraction": sum(
          r["input_wait_fraction"] * secs[r["step"]] for r in later) / total_s,
      "median_grad_steps_per_sec": statistics.median(
          r["grad_steps_per_sec"] for r in later),
      "median_input_wait_fraction": statistics.median(
          r["input_wait_fraction"] for r in later),
      "per_interval_grad_steps_per_sec": [
          r["grad_steps_per_sec"] for r in records],
      "per_interval_input_wait_fraction": [
          r["input_wait_fraction"] for r in records],
  }


def offline_phase(learner: QTOptLearner, replay: ReplayBuffer,
                  model_dir: str, config: ProtocolConfig,
                  steps_per_dispatch: Optional[int] = None) -> Dict[str, Any]:
  """Offline pretraining on the logged replay to `offline_steps`, scored
  per checkpoint. Returns the phase's wall seconds and rates."""
  t0 = time.perf_counter()
  train_qtopt(
      learner=learner, model_dir=model_dir, replay_buffer=replay,
      max_train_steps=config.offline_steps, batch_size=config.batch_size,
      save_checkpoints_steps=config.save_checkpoints_steps,
      log_every_steps=config.log_every_steps,
      steps_per_dispatch=steps_per_dispatch or config.steps_per_dispatch,
      seed=PROTOCOL_SEED, hooks=[make_eval_hook(learner, config)])
  wall_s = time.perf_counter() - t0
  return {"wall_s": wall_s,
          "grad_steps_per_wall_sec": config.offline_steps / wall_s,
          **_rates(model_dir, 0, config.offline_steps)}


def online_phase(learner: QTOptLearner, replay: ReplayBuffer,
                 model_dir: str, config: ProtocolConfig,
                 max_train_steps: Optional[int] = None,
                 save_checkpoints_steps: Optional[int] = None,
                 log_every_steps: Optional[int] = None,
                 eval_hook: Optional[QTOptSuccessEvalHook] = None
                 ) -> Dict[str, Any]:
  """Online fine-tuning: resumes `model_dir`'s latest checkpoint to
  `max_train_steps` (default twice `offline_steps`) while a server-wired
  `GraspActor` commits ε-greedy CEM grasps into `replay` through a
  `ReplayWriteService`, the acting params refreshed at every checkpoint
  and scored by `eval_hook` (default: `make_eval_hook(learner,
  config)`).
  Returns the phase's wall seconds, rates and the plane's counters; a
  latched writer error raises."""
  start = ckpt_lib.latest_step(model_dir)
  state = ckpt_lib.restore_state(
      model_dir, like=learner.create_state(PROTOCOL_SEED), step=start)
  acting0 = acting_copy(state.train_state)
  server = CEMPolicyServer(learner, acting0,
                           max_batch=config.server_max_batch,
                           max_wait_us=config.server_max_wait_us,
                           seed=PROTOCOL_SEED + 7, device=learner.device)
  service = ReplayWriteService(replay.store,
                               queue_batches=config.queue_batches,
                               overflow="drop")
  actor = GraspActor(
      learner, service, env=_env(learner, PROTOCOL_SEED + 123),
      batch_episodes=config.actor_batch_episodes,
      epsilon=config.actor_epsilon, seed=PROTOCOL_SEED + 11,
      policy_server=server)
  actor.update_state(acting0)
  end = max_train_steps or 2 * config.offline_steps
  t0 = time.perf_counter()
  try:
    train_qtopt(
        learner=learner, model_dir=model_dir, replay_buffer=replay,
        max_train_steps=end, batch_size=config.batch_size,
        save_checkpoints_steps=(save_checkpoints_steps
                                or config.save_checkpoints_steps),
        log_every_steps=log_every_steps or config.log_every_steps,
        steps_per_dispatch=config.steps_per_dispatch, seed=PROTOCOL_SEED,
        hooks=[eval_hook or make_eval_hook(learner, config),
               ActorStateRefreshHook([actor])])
    wall_s = time.perf_counter() - t0
  finally:
    actor.stop()
    try:
      service.close()
    finally:
      server.close()
  return {
      "wall_s": wall_s,
      "grad_steps_per_wall_sec": (end - start) / wall_s,
      **_rates(model_dir, start, end),
      "episodes_collected": actor.episodes_collected,
      "episodes_dropped": actor.episodes_dropped,
      "actor_crashed": actor.crashed,
      "actor_crash_error": (None if actor.crash_error is None
                            else repr(actor.crash_error)),
      "policy_versions": len(actor.episodes_by_policy_version),
      "ingestion": service.metrics_scalars(),
      "staleness": replay.staleness_snapshot(),
      "serving_dispatches": server.engine.dispatch_count,
      "serving_batch_sizes": sorted(set(server.batcher.batch_sizes)),
  }


def _emit(name: str, payload: dict) -> None:
  print(json.dumps({"artifact": name, **payload}), flush=True)


def _write_jsonl(path: str, rows: List[dict]) -> None:
  os.makedirs(os.path.dirname(path), exist_ok=True)
  with open(path, "w") as f:
    for row in rows:
      f.write(json.dumps(row) + "\n")


def run_qtopt(out_dir: str, device=None, cem_select: str = "fused",
              config: ProtocolConfig = FULL) -> Dict[str, Any]:
  """The flagship run: offline training on a 16384-row replay (the JAX
  protocol's `qtopt` mode: one step per dispatch), scored per
  checkpoint."""
  learner = build_learner(config, config.lr, device, cem_select)
  replay = offline_replay(learner, config,
                          capacity=config.offline_transitions)
  model_dir = os.path.join(out_dir, "qtopt")
  offline_phase(learner, replay, model_dir, config, steps_per_dispatch=1)
  records = read_records(os.path.join(model_dir,
                                      "metrics_success_eval.jsonl"))
  _write_jsonl(os.path.join(out_dir, "qtopt_flagship_success_eval.jsonl"),
               records)
  info = {"records": len(records), "last": records[-1]}
  _emit("qtopt_flagship_success_eval.jsonl", info)
  return info


def run_online(out_dir: str, device=None, cem_select: str = "fused",
               config: ProtocolConfig = FULL) -> Dict[str, Any]:
  """The offline→online protocol (module docstring); returns the
  summary row, with every success record under `records`."""
  learner = build_learner(config, config.lr, device, cem_select)
  replay = offline_replay(learner, config)
  model_dir = os.path.join(out_dir, "qtopt_online")
  offline = offline_phase(learner, replay, model_dir, config)
  ft_learner = build_learner(config, config.finetune_lr, device, cem_select)
  online = online_phase(ft_learner, replay, model_dir, config)
  records = read_records(os.path.join(model_dir,
                                      "metrics_success_eval.jsonl"))
  for r in records:
    r["phase"] = ("offline" if r["step"] <= config.offline_steps
                  else "online")
  phase = {p: [r for r in records if r["phase"] == p]
           for p in ("offline", "online")}
  offline_final = max(phase["offline"], key=lambda r: r["step"])
  online_final = max(phase["online"], key=lambda r: r["step"])
  summary = {
      "step": online_final["step"],
      "phase": "summary",
      "offline_only_success_rate": offline_final["success_rate"],
      "online_finetuned_success_rate": online_final["success_rate"],
      "online_best_success_rate": max(
          r["success_rate"] for r in phase["online"]),
      "random_baseline_success_rate":
          online_final["random_baseline_success_rate"],
      "online_episodes_collected": online["episodes_collected"],
      "finetune_regime": (f"eps={config.actor_epsilon}, batch_episodes="
                          f"{config.actor_batch_episodes}, "
                          f"lr={config.finetune_lr}"),
      "cem_select": cem_select,
      "device": str(learner.device),
      "offline": offline,
      "online": online,
  }
  _write_jsonl(os.path.join(out_dir, "qtopt_online_vs_offline.jsonl"),
               records + [summary])
  _emit("qtopt_online_vs_offline.jsonl",
        {"records": len(records) + 1, "last": summary})
  return {**summary, "records": records}


def seedcheck_pass(device=None, cem_select: str = "fused") -> Dict[str, Any]:
  """One synchronous pass of the online plane at test size: six cycles
  of collect → flush → sample, the learner step tagged per cycle."""
  learner = build_learner(SMALL, SMALL.lr, device, cem_select)
  replay = ReplayBuffer(learner.transition_specification(), capacity=1024,
                        seed=PROTOCOL_SEED)
  service = ReplayWriteService(replay.store, queue_batches=8,
                               overflow="drop")
  actor = GraspActor(learner, service, env=_env(learner, PROTOCOL_SEED + 123),
                     batch_episodes=16, epsilon=0.3, seed=PROTOCOL_SEED + 11)
  sampler = ReplayBatchSampler(replay.store, batch_size=32,
                               record_schedule=True)
  actions = hashlib.sha256()
  actor.update_state(learner.create_state(PROTOCOL_SEED))
  try:
    for cycle in range(6):
      actor.collect_once()
      service.flush()
      replay.store.set_learner_step(cycle)
      batch = sampler.sample()
      actions.update(
          np.ascontiguousarray(batch.to_flat_dict()["action"]).tobytes())
  finally:
    service.close()
  return {
      "sample_schedule_sha256": sampler.schedule_digest(),
      "action_stream_sha256": actions.hexdigest(),
      "staleness_mean": sampler.staleness_snapshot()["mean_age_steps"],
      "episodes": actor.episodes_collected,
  }


@dataclasses.dataclass(frozen=True)
class EnvsConfig:
  """The envs protocol's sizes (`ENVS_FULL`: the JAX protocol's)."""

  model: Dict[str, Any] = dataclasses.field(default_factory=lambda: dict(
      image_size=32, action_dim=2, torso_filters=(16, 32),
      head_filters=(32, 32), dense_sizes=(32, 32)))
  cem: Dict[str, int] = dataclasses.field(default_factory=lambda: dict(
      cem_population=64, cem_iterations=2, cem_elites=6))
  lr: float = 1e-3
  num_envs: int = 256
  rollout_length: int = 4
  train_batches_per_iter: int = 4
  batch_size: int = 256
  replay_capacity: int = 16384
  max_train_steps: int = 2000
  log_every_steps: int = 200
  save_checkpoints_steps: int = 500
  epsilon: float = 0.1
  num_scenarios: int = 512
  sweep_cem: Dict[str, int] = dataclasses.field(default_factory=lambda: dict(
      cem_population=64, cem_iterations=3))


ENVS_FULL = EnvsConfig()
ENVS_SMALL = EnvsConfig(
    model=SMALL.model, cem=SMALL.cem, num_envs=16, rollout_length=2,
    train_batches_per_iter=2, batch_size=16, replay_capacity=128,
    max_train_steps=8, log_every_steps=4, save_checkpoints_steps=4,
    num_scenarios=64, sweep_cem=dict(cem_population=8, cem_iterations=1))


def run_envs(out_dir: str, device=None, cem_select: str = "fused",
             config: EnvsConfig = ENVS_FULL) -> Dict[str, Any]:
  """The envs protocol (module docstring): returns the summary row, with
  the per-bucket rows under `records`."""
  from tensor2robot_tpu_torch.envs import (
      ProcGenGraspEnv,
      evaluate_scenarios,
      train_anakin,
  )

  model = GraspingQModel(
      create_optimizer_fn=lambda: opt_lib.create_optimizer(
          learning_rate=config.lr), **config.model)
  learner = QTOptLearner(model, cem_select=cem_select, device=device,
                         **config.cem)
  env = ProcGenGraspEnv(image_size=model.image_size,
                        action_dim=model.action_dim)
  model_dir = os.path.join(out_dir, "qtopt_envs")
  t0 = time.perf_counter()
  state = train_anakin(
      learner=learner, model_dir=model_dir, env=env,
      num_envs=config.num_envs, rollout_length=config.rollout_length,
      train_batches_per_iter=config.train_batches_per_iter,
      batch_size=config.batch_size, replay_capacity=config.replay_capacity,
      max_train_steps=config.max_train_steps,
      log_every_steps=config.log_every_steps,
      save_checkpoints_steps=config.save_checkpoints_steps,
      epsilon=config.epsilon, seed=PROTOCOL_SEED)
  train_s = time.perf_counter() - t0
  t0 = time.perf_counter()
  sweep = evaluate_scenarios(learner, state, env=env,
                             num_scenarios=config.num_scenarios,
                             seed=PROTOCOL_SEED + 5, **config.sweep_cem)
  sweep_s = time.perf_counter() - t0
  train_records = read_records(os.path.join(model_dir,
                                            "metrics_train.jsonl"))
  records = [{"scenario_bucket": bucket, "distractors": int(bucket),
              **stats} for bucket, stats in sorted(sweep["per_bucket"].items())]
  last = train_records[-1]
  summary = {
      "phase": "summary",
      "scenario_family": "procgen",
      "success_rate": sweep["success_rate"],
      "random_baseline_success_rate": sweep["random_baseline_success_rate"],
      "num_scenarios": sweep["num_scenarios"],
      "action_digest": sweep["action_digest"],
      "scenario_digest": sweep["scenario_digest"],
      "train_steps": last["step"],
      "final_collect_reward_mean": last["collect_reward_mean"],
      "env_steps_per_sec_last": last["env_steps_per_sec"],
      "grad_steps_per_sec_last": last["grad_steps_per_sec"],
      "param_refresh_lag_steps": 0.0,
      "train_wall_s": train_s,
      "sweep_wall_s": sweep_s,
      "cem_select": cem_select,
      "device": str(learner.device),
  }
  _write_jsonl(os.path.join(out_dir, "qtopt_envs_scenarios.jsonl"),
               records + [summary])
  _emit("qtopt_envs_scenarios.jsonl",
        {"records": len(records) + 1, "last": summary})
  return {**summary, "records": records}


@dataclasses.dataclass(frozen=True)
class GripperConfig:
  """The gripper protocol's sizes (`GRIPPER_FULL`: the JAX protocol's)."""

  image_size: int = 24
  demos: int = 96
  bc_steps: int = 500
  bc_batch: int = 32
  bc_sequence_length: int = 12
  transformer_steps: int = 400
  transformer_batch: int = 8
  transformer_sequence_length: int = 16
  episodes: int = 500


GRIPPER_FULL = GripperConfig()
GRIPPER_SMALL = GripperConfig(image_size=16, demos=8, bc_steps=4,
                              bc_batch=8, transformer_steps=4,
                              transformer_batch=4, episodes=4)


def run_gripper(out_dir: str, device=None,
                config: GripperConfig = GRIPPER_FULL) -> Dict[str, Any]:
  """The gripper protocol (module docstring): the two clones' success
  records; returns {artifact name: its last record}."""
  from tensor2robot_tpu_torch import train_eval
  from tensor2robot_tpu_torch.data.tfrecord_input_generator import (
      TFRecordEpisodeInputGenerator,
  )
  from tensor2robot_tpu_torch.hooks import SuccessEvalHook
  from tensor2robot_tpu_torch.research.vrgripper import (
      TransitionInputGenerator,
      VRGripperRegressionModel,
      VRGripperTransformerModel,
      collect_demo_episodes,
      evaluate_gripper_policy,
  )
  from tensor2robot_tpu_torch.train_eval import MetricLogger

  img = config.image_size
  device = resolve_device(device)
  demos = os.path.join(out_dir, "demos.tfrecord")
  collect_demo_episodes(demos, num_episodes=config.demos, image_size=img,
                        seed=0, action_noise=0.1)
  optimizer = lambda: opt_lib.create_optimizer(  # noqa: E731
      learning_rate=3e-3)
  out = {}

  # The per-step BC clone, scored through the checkpoint hook.
  bc = VRGripperRegressionModel(
      image_size=img, filters=(8, 16), embedding_size=32,
      hidden_sizes=(32,), create_optimizer_fn=optimizer)
  bc_dir = os.path.join(out_dir, "bc")
  train_eval.train_eval_model(
      model=bc, model_dir=bc_dir,
      input_generator_train=TransitionInputGenerator(
          TFRecordEpisodeInputGenerator(
              file_patterns=demos,
              sequence_length=config.bc_sequence_length, seed=1),
          batch_size=config.bc_batch, seed=1),
      max_train_steps=config.bc_steps, batch_size=config.bc_batch,
      save_checkpoints_steps=config.bc_steps, log_every_steps=200,
      hooks=[SuccessEvalHook(
          eval_fn=evaluate_gripper_policy,
          eval_kwargs={"num_episodes": config.episodes, "image_size": img,
                       "seed": 5})],
      device=device)
  records = read_records(os.path.join(bc_dir, "metrics_success_eval.jsonl"))
  _write_jsonl(os.path.join(out_dir, "vrgripper_bc_success_eval.jsonl"),
               records)
  _emit("vrgripper_bc_success_eval.jsonl",
        {"records": len(records), "last": records[-1]})
  out["vrgripper_bc_success_eval.jsonl"] = records[-1]

  # The long-context transformer clone, full-history policy.
  tr = VRGripperTransformerModel(
      image_size=img, filters=(8, 16), embedding_size=32, width=48,
      depth=1, num_heads=2, max_context_length=64,
      attention_impl="reference", create_optimizer_fn=optimizer)
  tr_dir = os.path.join(out_dir, "transformer")
  train_eval.train_eval_model(
      model=tr, model_dir=tr_dir,
      input_generator_train=TFRecordEpisodeInputGenerator(
          file_patterns=demos,
          sequence_length=config.transformer_sequence_length,
          batch_size=16, shuffle_buffer_size=config.demos, seed=1),
      max_train_steps=config.transformer_steps,
      batch_size=config.transformer_batch,
      save_checkpoints_steps=config.transformer_steps, log_every_steps=100,
      device=device)
  state = tr.create_inference_state(0, device=device)
  variables = ckpt_lib.restore_variables(
      tr_dir, like={"params": state.params,
                    "batch_stats": state.batch_stats or {}})
  state = dataclasses.replace(state, params=variables["params"])
  policy = tr.make_context_policy(
      state, context_length=config.transformer_sequence_length,
      device=device)
  metrics = evaluate_gripper_policy(policy, num_episodes=config.episodes,
                                    image_size=img, seed=5)
  logger = MetricLogger(tr_dir)
  try:
    logger.write("success_eval", config.transformer_steps, metrics)
  finally:
    logger.close()
  records = read_records(os.path.join(tr_dir, "metrics_success_eval.jsonl"))
  _write_jsonl(os.path.join(out_dir,
                            "vrgripper_transformer_success_eval.jsonl"),
               records)
  _emit("vrgripper_transformer_success_eval.jsonl",
        {"records": len(records), "last": records[-1]})
  out["vrgripper_transformer_success_eval.jsonl"] = records[-1]
  return out


def _small_learner(device, cem_select: str) -> QTOptLearner:
  return build_learner(SMALL, SMALL.lr, device, cem_select)


def envs_pass(device=None, cem_select: str = "fused") -> Dict[str, Any]:
  """The envs half: a seeded procedural sweep of 64 scenarios by a
  test-size learner; its scenario and action digests."""
  from tensor2robot_tpu_torch.envs import ProcGenGraspEnv, evaluate_scenarios

  learner = _small_learner(device, cem_select)
  sweep = evaluate_scenarios(
      learner, learner.create_state(PROTOCOL_SEED),
      env=ProcGenGraspEnv(image_size=16, action_dim=2), num_scenarios=64,
      seed=PROTOCOL_SEED)
  return {"scenario_sweep_action_sha256": sweep["action_digest"],
          "scenario_sweep_scenario_sha256": sweep["scenario_digest"]}


@contextlib.contextmanager
def deterministic_cudnn():
  """cuDNN's deterministic algorithms for the block (its default
  convolution backward is not deterministic on the card)."""
  flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
  torch.backends.cudnn.deterministic = True
  torch.backends.cudnn.benchmark = False
  try:
    yield
  finally:
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def pod_pass(device=None, cem_select: str = "fused") -> Dict[str, Any]:
  """The Anakin half: `train_anakin` at test size (4 steps); the SHA-256
  of its final params per device count. Count 1 is the single program;
  2 is recorded as skipped without two cards (as JAX records it), and
  as not ported with them (ROADMAP A11)."""
  from tensor2robot_tpu_torch.envs import train_anakin

  device = resolve_device(device)
  visible = torch.cuda.device_count() if device.type == "cuda" else 1
  digests: Dict[str, Any] = {"pod_visible_devices": visible}
  for count in (1, 2):
    key = f"pod_params_sha256_devices_{count}"
    if count > visible:
      digests[key] = "skipped: not enough local devices"
      continue
    if count > 1:
      digests[key] = "skipped: not ported (ROADMAP A11)"
      continue
    learner = _small_learner(device, cem_select)
    with tempfile.TemporaryDirectory() as tmp, deterministic_cudnn():
      state = train_anakin(
          learner=learner, model_dir=tmp, env_family="procgen", num_envs=8,
          rollout_length=2, train_batches_per_iter=2, batch_size=8,
          replay_capacity=64, max_train_steps=4, log_every_steps=2,
          save_checkpoints_steps=4, seed=PROTOCOL_SEED)
    digest = hashlib.sha256()
    for leaf in state.train_state.params.values():
      digest.update(leaf.detach().float().cpu().numpy().tobytes())
    digests[key] = digest.hexdigest()
  return digests


def run_seedcheck(device=None, cem_select: str = "fused") -> Dict[str, Any]:
  """Two seeded runs of each half; `reproducible` iff their digests
  agree."""
  a, b = seedcheck_pass(device, cem_select), seedcheck_pass(device,
                                                            cem_select)
  ea, eb = envs_pass(device, cem_select), envs_pass(device, cem_select)
  pa, pb = pod_pass(device, cem_select), pod_pass(device, cem_select)
  ok = (a["sample_schedule_sha256"] == b["sample_schedule_sha256"]
        and a["action_stream_sha256"] == b["action_stream_sha256"]
        and ea == eb and pa == pb)
  a.update(ea)
  a.update(pa)
  b.update(eb)
  b.update(pb)
  out = {"reproducible": ok, "run_a": a, "run_b": b}
  print(json.dumps({"artifact": "seedcheck", **out}), flush=True)
  return out


def main(argv: Optional[List[str]] = None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("mode", choices=("qtopt", "online", "envs", "gripper",
                                       "seedcheck"))
  parser.add_argument("--out_dir", default=None,
                      help="where the artifacts go (qtopt, online, envs, "
                           "gripper); default: a temporary directory")
  parser.add_argument("--device", default=None,
                      help="torch device of the learner (default: cuda)")
  parser.add_argument("--cem_select", choices=("lax", "fused"),
                      default="fused")
  parser.add_argument("--small", action="store_true",
                      help="the test size (16x16 images, a few steps)")
  args = parser.parse_args(argv)
  if args.mode == "seedcheck":
    out = run_seedcheck(args.device, args.cem_select)
    return 0 if out["reproducible"] else 1
  runs = {
      "qtopt": lambda d: run_qtopt(d, args.device, args.cem_select,
                                   SMALL if args.small else FULL),
      "online": lambda d: run_online(d, args.device, args.cem_select,
                                     SMALL if args.small else FULL),
      "envs": lambda d: run_envs(d, args.device, args.cem_select,
                                 ENVS_SMALL if args.small else ENVS_FULL),
      "gripper": lambda d: run_gripper(
          d, args.device, GRIPPER_SMALL if args.small else GRIPPER_FULL),
  }
  if args.out_dir is not None:
    runs[args.mode](args.out_dir)
  else:
    with tempfile.TemporaryDirectory() as tmp:
      runs[args.mode](tmp)
  return 0


if __name__ == "__main__":
  sys.exit(main())
