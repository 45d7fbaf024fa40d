"""Where a policy call spends its time on the card.

    python -m tensor2robot_tpu_torch.bin.profile_policy [--batches 8 256]
    python -m tensor2robot_tpu_torch.bin.profile_policy --model vrgripper_transformer
    python -m tensor2robot_tpu_torch.bin.profile_policy --model vrgripper_train
    python -m tensor2robot_tpu_torch.bin.profile_policy --model qtopt_train \
        [--cem_inference bf16|int8] [--cem_select fused|lax]
    python -m tensor2robot_tpu_torch.bin.profile_policy --model anakin \
        [--cem_select fused|lax]
    python -m tensor2robot_tpu_torch.bin.profile_policy --graphs [--model ...]

`--model qtopt` (the default) runs `QTOptLearner.build_policy()` at
`GraspingQModel()`'s full width (bf16, random weights from seed 0, CEM
2 × 64 samples, 6 elites, cem_select="fused") once per batch size.
`--model vrgripper_transformer` runs the `EpisodeContextPolicy` of
`VRGripperTransformerModel` at the width of
`train_vrgripper_transformer.gin` (`research/vrgripper/gin_config.py`:
48×48 images, filters (16, 32), embedding 64, width 128, depth 4, 4
heads, context 512, bf16, random weights from seed 0) one env step at a
time. `--model vrgripper_train` runs `train_step` of the same model
(Adam at lr 3e-4, the gin's) on the first batch of `chip_smoke.py`'s
training run: 16 of 64 seeded expert episodes (seed 11) cut to 32
steps, the gin's training shape. `--model qtopt_train` runs
`QTOptLearner.train_step` of the Bellman-training configuration in
`research/qtopt/synthetic_bandit.py` (`GraspingQModel()`, batch 256, CEM
2 × 64 with the fused select, Adam 1e-4) on one batch of its synthetic
bandit transitions, each step from the same state; `--cem_inference
int8` runs the int8 CEM tower (calibrated on that batch) and
`--cem_select lax` the sort + gather select. `--model anakin` profiles
the Anakin iteration at `qtopt_anakin.gin`'s configuration
(`GraspingQModel(image_size=64, action_dim=2)`, CEM 2 × 64, 6 elites,
1024 procgen envs × rollout 4, ε 0.1, 4 Bellman steps of batch 256
from a full 16384-row ring) in three parts, each one graph replay as
`train_anakin` runs it: the collection alone, the 4 Bellman steps
alone, and the whole iteration (`envs.rollout.make_iteration`); and
the envs' render + auto-reset step alone.

`--graphs` runs each call as the product path graphs it: one replay of
a CUDA graph (`utils.step_graph.StepGraph`) of the CEM dispatch, of the
context policy's forward, of `train_eval`'s train step and of
`train_qtopt`'s Bellman step (K=1, its noise generator seeded per
step); without it every call runs eagerly.

Each prints, under `torch.profiler`: the wall time per call (host clock
around synchronized calls), the device-busy time per call (sum of
kernel times), the device's idle share, the number of kernels run per
call, the host's launch calls per call (kernel launches and graph
launches, from the CUDA runtime and driver events) and graph launches
among them, and the kernels that take the most device time. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import torch

from tensor2robot_tpu_torch.research.qtopt import GraspingQModel, QTOptLearner
from tensor2robot_tpu_torch.specs import make_random_tensors
from tensor2robot_tpu_torch.utils.step_graph import StepGraph

_KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx")
_GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


def _device_time_us(event) -> float:
  for attr in ("device_time_total", "cuda_time_total"):
    value = getattr(event, attr, None)
    if value is not None:
      return float(value)
  return 0.0


def profile_calls(call: Callable[[], None], calls: int = 20,
                  top: int = 8) -> dict:
  """Wall and device time per `call()`, over `calls` calls in a row
  with one synchronize at the end."""
  for _ in range(5):
    call()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(calls):
    call()
  torch.cuda.synchronize()
  wall_ms = (time.perf_counter() - t0) / calls * 1e3

  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    for _ in range(calls):
      call()
    torch.cuda.synchronize()
  events = prof.key_averages()
  kernels = [e for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA]
  graph_launches = sum(e.count for e in events if e.key in _GRAPH_LAUNCHES)
  host_launches = graph_launches + sum(
      e.count for e in events if e.key in _KERNEL_LAUNCHES)
  busy_us = sum(_device_time_us(e) for e in kernels)
  launches = sum(e.count for e in kernels)
  ranked = sorted(kernels, key=_device_time_us, reverse=True)[:top]
  busy_ms = busy_us / calls / 1e3
  return {
      "wall_ms_per_call": wall_ms,
      "device_busy_ms_per_call": busy_ms,
      "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
      "kernel_launches_per_call": launches / calls,
      "host_launches_per_call": host_launches / calls,
      "graph_launches_per_call": graph_launches / calls,
      "top_kernels": [{"name": e.key[:160],
                       "ms_per_call": _device_time_us(e) / calls / 1e3,
                       "calls_per_call": e.count / calls}
                      for e in ranked],
  }


def _replayer(fn, carry, inputs, num_generators: int = 0, **kwargs):
  """One replay of `fn` captured as a `StepGraph` on the card, its
  generators seeded 0, as a call."""
  graph = StepGraph(fn, carry, inputs, "cuda", num_generators=num_generators,
                    **kwargs)

  def replay():
    for generator in graph.generators:
      generator.manual_seed(0)
    return graph.replay()

  return replay


def profile_cem(batch: int, graphs: bool = False) -> dict:
  learner = QTOptLearner(GraspingQModel(), cem_iterations=2,
                         cem_population=64, cem_elites=6,
                         cem_select="fused")
  state = learner.create_state(seed=0)
  obs = {k: torch.from_numpy(v).cuda() for k, v in make_random_tensors(
      learner.observation_specification(), batch_size=batch,
      seed=1).to_flat_dict().items()}
  policy = learner.build_policy()
  gen = torch.Generator(device="cuda").manual_seed(0)

  if graphs:
    dispatch = _replayer(
        lambda st, o, gens: (st, policy(st, o, generator=gens[0])),
        state.train_state, obs, num_generators=1, carries=False,
        own_carry=False)
  else:
    dispatch = lambda: policy(state, obs, generator=gen)  # noqa: E731

  return {"model": "qtopt", "batch": batch, "graphs": graphs,
          **profile_calls(dispatch)}


def profile_context_policy(graphs: bool = False) -> dict:
  from tensor2robot_tpu_torch.research.vrgripper import VRGripperEnv
  from tensor2robot_tpu_torch.research.vrgripper.gin_config import gin_model
  model = gin_model()
  policy = model.make_context_policy(model.create_inference_state(seed=0),
                                     graphs=graphs)
  env = VRGripperEnv(image_size=48, seed=1)
  obs = env.reset()

  def step():  # the action's copy to the host synchronizes
    nonlocal obs
    action = policy({k: v[None] for k, v in obs.items()})["action"]
    obs, _, done = env.step(action[0])
    if done:
      obs = env.reset()
      policy.reset()

  return {"model": "vrgripper_transformer", "context": 512,
          "graphs": graphs, **profile_calls(step)}


def profile_train_step(graphs: bool = False) -> dict:
  from tensor2robot_tpu_torch.data import EpisodeInputGenerator, Mode
  from tensor2robot_tpu_torch.research.vrgripper import gin_config
  model = gin_config.gin_model()
  gen = EpisodeInputGenerator(
      gin_config.expert_episodes(64, seed=11),
      sequence_length=gin_config.GIN_SEQUENCE_LENGTH,
      batch_size=gin_config.GIN_BATCH_SIZE, seed=0)
  gen.set_specification_from_model(model, Mode.TRAIN)
  features, labels = next(iter(gen.create_dataset(Mode.TRAIN)))
  to_card = lambda s: {k: torch.as_tensor(v).cuda()  # noqa: E731
                       for k, v in s.to_flat_dict().items()}
  features, labels = to_card(features), to_card(labels)
  state = model.create_train_state(seed=0)

  def eager():
    nonlocal state
    state, metrics = model.train_step(state, features, labels)
    return metrics

  if graphs:
    from tensor2robot_tpu_torch.train_eval import train_step_fn
    run = _replayer(train_step_fn(model), state,
                    {"features": features, "labels": labels})
  else:
    run = eager

  def step():  # the loss's copy to the host synchronizes, as a log does
    run()["loss"].item()

  return {"model": "vrgripper_train", "batch": gin_config.GIN_BATCH_SIZE,
          "sequence_length": gin_config.GIN_SEQUENCE_LENGTH,
          "graphs": graphs, **profile_calls(step)}


def profile_qtopt_train_step(graphs: bool = False,
                             cem_inference: str = "bf16",
                             cem_select: str = "fused") -> dict:
  from tensor2robot_tpu_torch.research.qtopt import synthetic_bandit as bandit
  learner = bandit.bellman_learner(cem_inference=cem_inference,
                                   cem_select=cem_select)
  state = learner.create_state(seed=0)
  batch = {k: torch.from_numpy(v).cuda() for k, v in
           bandit.bandit_transitions(learner, bandit.BATCH_SIZE,
                                     seed=1).items()}
  if learner.needs_calibration:
    learner.calibrate(state, batch)
  gen = torch.Generator(device="cuda").manual_seed(0)

  if graphs:
    from tensor2robot_tpu_torch.research.qtopt.train_qtopt import k_step_fn
    run = _replayer(k_step_fn(learner, 1), state, batch, num_generators=1)
  else:
    run = lambda: learner.train_step(state, batch, generator=gen)[1]  # noqa: E731

  def step():  # the loss's copy to the host synchronizes, as a log does
    run()["loss"].item()

  return {"model": "qtopt_train", "batch": bandit.BATCH_SIZE,
          "cem_inference": cem_inference, "cem_select": cem_select,
          "graphs": graphs, **profile_calls(step)}


def profile_anakin(cem_select: str = "fused") -> dict:
  from tensor2robot_tpu_torch import envs
  from tensor2robot_tpu_torch.envs import rollout
  learner = QTOptLearner(GraspingQModel(image_size=64, action_dim=2),
                         cem_iterations=2, cem_population=64, cem_elites=6,
                         cem_select=cem_select)
  num_envs, length, k, batch = 1024, 4, 4, 256
  env = envs.ProcGenGraspEnv(image_size=64, action_dim=2)
  init_fn, collect_fn = envs.make_collect_fn(learner, env, num_envs, length,
                                             epsilon=0.1)
  state = learner.create_state(seed=0)
  gen = torch.Generator(device="cuda").manual_seed(0)
  states = init_fn(gen)
  spec = learner.transition_specification().to_flat_dict()
  capacity = rollout.ring_capacity(16384, batch, num_envs * length)
  ring = rollout.empty_ring(spec, capacity, "cuda")
  fill = ptr = torch.zeros((), dtype=torch.int64, device="cuda")
  for _ in range(capacity // (num_envs * length)):  # a full ring
    states, collected = collect_fn(state, states, gen)
    fill, ptr = rollout.ring_insert(ring, collected, fill, ptr)

  def collect(carry, _, gens):
    new_states, collected = collect_fn(carry[0], carry[1], gens[0])
    return (carry[0], new_states), {"reward": collected["reward"].mean()}

  def bellman(qstate, _, gens):
    return rollout.anakin_train_steps(learner, qstate, ring, fill, batch,
                                      gens)

  iteration = rollout.make_iteration(learner, collect_fn, batch, capacity)
  wrapped = envs.AutoResetEnv(env)
  actions = torch.zeros((num_envs, 2), device="cuda")

  def env_step(carry, _, gens):
    env.observe(carry)
    return wrapped.step(carry, actions, gens[0])[0], {}

  parts = {
      "collect": _replayer(collect, (state, states), {}, num_generators=1),
      "bellman": _replayer(bellman, state, {}, num_generators=k),
      "iteration": _replayer(iteration, (state, states, ring, fill, ptr),
                             {}, num_generators=k + 1),
      "env_step": _replayer(env_step, states, {}, num_generators=1),
  }
  out = {"model": "anakin", "num_envs": num_envs, "rollout_length": length,
         "train_batches_per_iter": k, "batch": batch,
         "cem_select": cem_select, "graphs": True}
  for name, replay in parts.items():
    out[name] = profile_calls(replay, calls=10)
  return out


def main():
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--model", choices=("qtopt", "vrgripper_transformer",
                                          "vrgripper_train", "qtopt_train",
                                          "anakin"),
                      default="qtopt")
  parser.add_argument("--batches", type=int, nargs="+", default=[8, 256],
                      help="CEM batch sizes (--model qtopt)")
  parser.add_argument("--graphs", action="store_true",
                      help="each call one CUDA-graph replay")
  parser.add_argument("--cem_inference", choices=("bf16", "int8"),
                      default="bf16", help="CEM tower (--model qtopt_train)")
  parser.add_argument("--cem_select", choices=("fused", "lax"),
                      default="fused",
                      help="CEM select (--model qtopt_train, anakin)")
  args = parser.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit("profile_policy needs a CUDA card")
  print(f"device: {torch.cuda.get_device_name(0)}")
  if args.model == "qtopt":
    for batch in args.batches:
      print(json.dumps(profile_cem(batch, args.graphs)), flush=True)
  elif args.model == "vrgripper_transformer":
    print(json.dumps(profile_context_policy(args.graphs)), flush=True)
  elif args.model == "anakin":
    print(json.dumps(profile_anakin(args.cem_select)), flush=True)
  elif args.model == "qtopt_train":
    print(json.dumps(profile_qtopt_train_step(
        args.graphs, args.cem_inference, args.cem_select)), flush=True)
  else:
    print(json.dumps(profile_train_step(args.graphs)), flush=True)


if __name__ == "__main__":
  main()
