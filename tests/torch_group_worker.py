"""Learner-group ranks for tests/test_torch_distributed.py.

Spawned processes import torch and the port only (no JAX): each joins a
gloo group through `parallel.distributed.maybe_initialize_distributed`,
runs its part and puts numpy results on a queue. One intra-op thread in
each, so a rank's CPU arithmetic is the same in every process.
"""

import os
import types

import numpy as np
import torch

VERIFY = dict(image_size=16, torso_filters=(8,), head_filters=(8,),
              dense_sizes=(16,), action_dim=2)
CEM = dict(cem_population=8, cem_iterations=1, cem_elites=2)


def _numpy(tensors):
  return {k: v.detach().float().numpy().copy() for k, v in tensors.items()}


def _learner(dtype):
  from tensor2robot_tpu_torch.research.qtopt import (
      GraspingQModel,
      QTOptLearner,
  )
  return QTOptLearner(GraspingQModel(device_dtype=dtype, **VERIFY),
                      device="cpu", **CEM)


def state_numpy(state):
  """Every leaf of a learner state as numpy, keyed by its path."""
  from tensor2robot_tpu_torch.utils import checkpoints

  return {k: (v.numpy().copy() if isinstance(v, torch.Tensor)
              else np.asarray(v))
          for k, v in checkpoints.flatten_state(state).items()}


def group_step(address, world, rank, jobs, out):
  """One Bellman step per job, as rank `rank` of a `world`-process
  group: `jobs` is a list of (dtype name, state, this rank's rows, this
  rank's noise). Puts (rank, initialized twice, [(grads, new state,
  metrics)], the distinct devices the group spans)."""
  torch.set_num_threads(1)
  from tensor2robot_tpu_torch.parallel import collectives, distributed

  first = distributed.maybe_initialize_distributed(address, world, rank)
  again = distributed.maybe_initialize_distributed(address, world, rank)
  results = []
  for dtype, state, batch, noise in jobs:
    learner = _learner(getattr(torch, dtype))
    with collectives.data_parallel():
      grads, stats, metrics = learner.train_grads(state, batch, noise=noise)
    new = learner.apply_gradients(state, grads, stats)
    results.append((_numpy(grads), state_numpy(new), _numpy(metrics)))
  out.put((rank, (first, again), results,
           collectives.distinct_devices(torch.device("cpu"))))
  torch.distributed.destroy_process_group()


def train_loop(address, world, rank, model_dir, out, steps=4):
  """`train_qtopt` over a seeded prefilled buffer, as rank `rank` of a
  `world`-process group (`world` 0: no group at all). Puts (rank, final
  state, files under model_dir)."""
  torch.set_num_threads(1)
  import torch.distributed as dist

  from tensor2robot_tpu_torch.fleet import proc
  from tensor2robot_tpu_torch.fleet.learner import learner_group_plan
  from tensor2robot_tpu_torch.parallel import distributed
  from tensor2robot_tpu_torch.research.qtopt import train_qtopt
  from tensor2robot_tpu_torch.research.qtopt.replay_buffer import (
      ReplayBuffer,
  )
  from tensor2robot_tpu_torch.specs import make_random_tensors

  batch_size = 8
  if world:
    proc.adopt_coordinator(address, num_processes=world, process_id=rank)
    if not distributed.maybe_initialize_distributed():
      # One process: the launch contract initializes nothing; join a
      # real one-process group all the same.
      dist.init_process_group("gloo", init_method=f"tcp://{address}",
                              world_size=1, rank=0)
    batch_size = learner_group_plan(
        types.SimpleNamespace(batch_size=8 * world), world, rank)[
            "local_batch_size"]
  learner = _learner(torch.float32)
  spec = learner.transition_specification()
  replay = ReplayBuffer(spec, capacity=64, seed=7)
  replay.add(make_random_tensors(spec, batch_size=64, seed=3).to_flat_dict())
  state = train_qtopt(
      learner=learner, model_dir=model_dir, replay_buffer=replay,
      max_train_steps=steps, batch_size=batch_size,
      save_checkpoints_steps=2, log_every_steps=2, seed=0)
  files = sorted(os.listdir(model_dir)) if os.path.exists(model_dir) else None
  out.put((rank, state_numpy(state), files))
  if dist.is_initialized():
    dist.destroy_process_group()
