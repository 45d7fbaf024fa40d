"""Shared helpers for fleet child processes (port of `fleet/proc.py`):
the distributed-env scrub and the heartbeat.

Every fleet child runs `scrub_inherited_distributed_env` first: a fleet
is often launched from a process that itself sits inside a multi-process
training context, and `multiprocessing`'s spawn children inherit the
parent's environ wholesale. A child that kept those variables could
join a process group it is not part of and block waiting for peers.
The scrub drops torch's `env://` launch contract (`MASTER_ADDR`,
`RANK`, ...) and the JAX package's coordinator triple alike. Children
that do join a process group (the ranks of a learner group,
`FleetConfig.learner_hosts > 1`) are handed a fresh coordinator address
by the orchestrator and adopt it explicitly (`adopt_coordinator`).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import time
from typing import Any

from tensor2robot_tpu_torch.telemetry import metrics as tmetrics

# torch.distributed's env:// rendezvous variables and the JAX package's
# launch contract.
_DISTRIBUTED_ENV_VARS = (
    "MASTER_ADDR",
    "MASTER_PORT",
    "RANK",
    "WORLD_SIZE",
    "LOCAL_RANK",
    "LOCAL_WORLD_SIZE",
    "JAX_COORDINATOR_ADDRESS",
    "JAX_NUM_PROCESSES",
    "JAX_PROCESS_ID",
)


# What the fleet's children import: torch and each role's stack.
CHILD_PRELOAD = (
    "torch",
    "tensor2robot_tpu_torch.fleet.actor",
    "tensor2robot_tpu_torch.fleet.front",
    "tensor2robot_tpu_torch.fleet.host",
    "tensor2robot_tpu_torch.fleet.learner",
    "tensor2robot_tpu_torch.fleet.pod",
    "tensor2robot_tpu_torch.envs.rollout",
    "tensor2robot_tpu_torch.replay.service",
    "tensor2robot_tpu_torch.research.pose_env.grasp_bandit",
    "tensor2robot_tpu_torch.research.qtopt.actor",
    "tensor2robot_tpu_torch.research.qtopt.train_qtopt",
    "tensor2robot_tpu_torch.serving.cem_policy",
)


def children_context():
  """The multiprocessing context a fleet starts its children in.

  A forkserver imports `CHILD_PRELOAD` once and forks every child with
  those modules loaded: spawned children each paid torch's import (5–9 s
  of a core each on a loaded 8-core host, ROADMAP trap 54). The server
  never initializes CUDA (importing torch does not), so its forks are
  as clean as spawned children; they see the environment as it was when
  the server started (the first child of the process)."""
  ctx = mp.get_context("forkserver")
  ctx.set_forkserver_preload(list(CHILD_PRELOAD))
  return ctx


def scrub_inherited_distributed_env() -> None:
  """Drops inherited multi-process launch variables from this process."""
  for var in _DISTRIBUTED_ENV_VARS:
    os.environ.pop(var, None)


def adopt_coordinator(address: str, num_processes: int = 1,
                      process_id: int = 0) -> None:
  """Installs an orchestrator-issued coordinator triple into this
  process's environment as torch's `env://` contract (`MASTER_ADDR`,
  `MASTER_PORT`, `WORLD_SIZE`, `RANK`), which
  `parallel.distributed.maybe_initialize_distributed` reads. The
  orchestrator picked `address` with `ephemeral_coordinator_address()`,
  so two fleets on one machine never race on a fixed port."""
  host, port = address.rsplit(":", 1)
  os.environ["MASTER_ADDR"] = host
  os.environ["MASTER_PORT"] = port
  os.environ["WORLD_SIZE"] = str(int(num_processes))
  os.environ["RANK"] = str(int(process_id))


def pin_single_host_device(device) -> None:
  """A learner-group rank presents one local device to the group. JAX
  pins one XLA host-platform device (an inherited forced multi-device
  CPU topology tears gloo's first collective); the port's rank trains on
  the one `device` its learner builds on: on a card this makes it the
  process's current CUDA device, so every allocation lands there; on the
  CPU there is nothing to pin."""
  import torch

  device = torch.device(device)
  if device.type == "cuda":
    # `set_device` takes an index: "cuda" alone is the current card.
    torch.cuda.set_device(device.index if device.index is not None
                          else torch.cuda.current_device())


def await_address(address: Any) -> Any:
  """The address a fleet child dials. At launch the orchestrator spawns
  its children before the hosts are up and sends their address down a
  pipe once they are (`Fleet.launch`): `address` is then that pipe's
  receiving end, and this blocks for it. Returns None when the pipe
  closes unsent (the launch was aborted)."""
  if not hasattr(address, "recv"):
    return address
  try:
    return address.recv()
  except (EOFError, OSError):
    return None
  finally:
    address.close()


def record_cuda_state() -> bool:
  """Sets this process's ``proc.cuda_initialized`` gauge to whether it
  has initialized CUDA (`torch.cuda.is_initialized()`; False when torch
  was never imported) and returns it. Only the host(s) and the learner
  of a fleet may touch the card; the gauge rides each role's telemetry
  so a run can show which did."""
  torch = sys.modules.get("torch")
  initialized = bool(torch is not None and torch.cuda.is_initialized())
  tmetrics.gauge("proc.cuda_initialized").set(float(initialized))
  return initialized


def beat(heartbeat) -> None:
  """Stamps a shared heartbeat slot with the current monotonic time.

  `heartbeat` is a `multiprocessing.Value('d')`; CLOCK_MONOTONIC is
  system-wide on Linux, so the orchestrator compares stamps from any
  process against its own clock.
  """
  if heartbeat is not None:
    heartbeat.value = time.monotonic()


def hang(duration_secs: float) -> None:
  """Deterministic hang injection: sleep without beating.

  The `actor_hang` fault class (`fleet/faults.py`): the process stays
  alive but its heartbeat goes stale, which is what a wedged env binding
  or a deadlocked native call looks like from the orchestrator: detected
  by the heartbeat timer, recovered by kill-and-respawn under the
  restart policy. A real hang would not check a stop event either, so
  this one doesn't.
  """
  time.sleep(duration_secs)
