"""Shared helpers for fleet child processes (port of `fleet/proc.py`):
the distributed-env scrub and the heartbeat.

Every fleet child runs `scrub_inherited_distributed_env` first: a fleet
is often launched from a process that itself sits inside a multi-process
training context, and `multiprocessing`'s spawn children inherit the
parent's environ wholesale. A child that kept those variables could
join a process group it is not part of and block waiting for peers.
The scrub drops torch's `env://` launch contract (`MASTER_ADDR`,
`RANK`, ...) and the JAX package's coordinator triple alike. The port's
learner runs on one process (a learner group is ROADMAP A11), so no
child adopts a coordinator.
"""

from __future__ import annotations

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


def scrub_inherited_distributed_env() -> None:
  """Drops inherited multi-process launch variables from this process."""
  for var in _DISTRIBUTED_ENV_VARS:
    os.environ.pop(var, None)


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
