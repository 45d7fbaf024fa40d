"""Multi-process runtime initialization (port of
`parallel/distributed.py`) over `torch.distributed`.

Call `maybe_initialize_distributed()` once at process start, before the
first collective. A multi-process launch passes the coordination triple
(coordinator address, process count, process id) explicitly or through
the environment; the group then rendezvouses through a TCP store at the
coordinator address (`tcp://host:port`). One process is a no-op, so the
same binary runs alone or as one rank of a group.

The backend is gloo. A learner group on one card puts every rank on
`cuda:0`, and NCCL refuses two ranks on one device; the collectives of
the port (`parallel.collectives`) stage one flat buffer through host
memory, so the ranks compute on the card and only the reduction runs on
the host. The JAX module's `_maybe_enable_cpu_collectives` (XLA:CPU's
gloo switch) has no counterpart: gloo is torch's CPU backend already.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
from typing import Optional

log = logging.getLogger(__name__)

BACKEND = "gloo"



def ephemeral_coordinator_address(host: str = "127.0.0.1") -> str:
  """A collision-safe coordinator address for same-host launches.

  The coordinator (the one process that spawns the others) calls this
  once before spawning and hands the result to every child. The OS
  assigns a port from the ephemeral range (`bind(0)`), so two concurrent
  fleets (or a fleet and the tests) on one machine never race on a
  fixed port. The port is released before the store binds it; the
  ephemeral range cycles rather than re-issuing the port it just handed
  out, so a collision in that window is vanishingly unlikely."""
  with socket.socket() as s:
    s.bind((host, 0))
    return f"{host}:{s.getsockname()[1]}"


def maybe_initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_secs: float = 1800.0,
) -> bool:
  """Joins this process to a gloo process group when a multi-process
  launch is given; returns True when a group of more than one process is
  (now) initialized.

  The triple comes from the arguments, else from torch's env://
  contract (`MASTER_ADDR`:`MASTER_PORT`, `WORLD_SIZE`, `RANK`), which
  `fleet.proc.adopt_coordinator` writes.
  Idempotent. One process (no address, or a count of 1) initializes
  nothing and returns False. JAX's `force` (argless TPU-pod discovery)
  has no counterpart: torch needs the whole triple."""
  import torch.distributed as dist

  if dist.is_initialized():
    return dist.get_world_size() > 1
  env = os.environ
  if coordinator_address is None and env.get("MASTER_ADDR") and env.get(
      "MASTER_PORT"):
    coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
  if num_processes is None and env.get("WORLD_SIZE"):
    num_processes = int(env["WORLD_SIZE"])
  if process_id is None and env.get("RANK"):
    process_id = int(env["RANK"])
  if not coordinator_address or (num_processes or 1) <= 1:
    return False
  if process_id is None:
    raise ValueError(
        f"a group of {num_processes} processes at {coordinator_address} "
        "needs a process id (or RANK)")
  dist.init_process_group(
      BACKEND, init_method=f"tcp://{coordinator_address}",
      world_size=int(num_processes), rank=int(process_id),
      timeout=datetime.timedelta(seconds=timeout_secs))
  log.info("torch.distributed initialized (%s): process %d/%d via %s",
           BACKEND, dist.get_rank(), dist.get_world_size(),
           coordinator_address)
  return True


def process_index() -> int:
  """This process's rank (0 without a group): rank 0 is the chief."""
  import torch.distributed as dist

  return dist.get_rank() if dist.is_initialized() else 0
