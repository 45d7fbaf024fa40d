"""Main training binary (port of `bin/run_t2r_trainer.py`): flags → gin
configs → the configured entry point.

    python -m tensor2robot_tpu_torch.bin.run_t2r_trainer \
      --gin_configs tensor2robot_tpu/research/pose_env/configs/train_pose_env.gin \
      --gin_bindings "train_eval_model.model_dir='/tmp/pose_env'"

The shipped `.gin` files are read in place (relative paths resolve from
the working directory, then from the repository root) and parsed into
the port's own registry. The configured entry point runs on the CUDA
card; on the CPU add ``--gin_bindings "train_eval_model.device='cpu'"``
(``--trainer=train_eval``), ``"QTOptLearner.device='cpu'"``
(``--trainer=qtopt`` and ``--trainer=anakin``) or
``"FleetConfig.device='cpu'"`` (``--trainer=fleet``, which also needs
``"run_fleet.model_dir='...'"``; the shipped fleet configs bind
``FleetConfig.env = "mujoco_pose"``, whose actors need `mujoco`: where
it is missing, as on the card's machine, bind ``FleetConfig.env =
"pose"`` on top).

The flags keep the JAX binary's names. `--validate_only` resolves every
statement of each config against the port's registry (the JAX rules
GIN101–GIN107: unknown configurables, parameters and references,
undefined macros, unresolvable includes) and exits 1 on any finding; it
is narrower than the JAX flag, which also runs the JAX package's source
lints (t2rcheck, which covers JAX code only). `--trainer=fleet` runs
`run_fleet(gin_configs=...)`, whose launch gate reruns the configs
through `--validate_only`. `--prometheus_port` serves the registry for
the run's length. Not ported: the multi-host `jax_*` flags (A11).

The rank launch. A mesh over several devices needs as many processes
(one card shows one device to a process): when the bound
`train_eval_model.mesh` is a `create_mesh()` whose `axis_shapes` need
more than one process and no `WORLD_SIZE` is set (no launcher started
this process as a rank), the binary starts the ranks itself. It forks
them from the fleet's forkserver (`fleet.proc.children_context`, its
preload grown by the trainer's families); each
clears inherited launch variables, adopts a fresh coordinator address
(`fleet.proc.adopt_coordinator`, torch's env:// variables), joins the
gloo group, pins `cuda:0` by index where it trains on the card, and
runs this binary's arguments as rank r. The binary waits for every rank:
a rank that ends badly stops the others and fails the run with that
rank's exit code (128 + the signal of a killed rank). The ranks take the
same steps and end together, so once one has exited 0 the others get
`RANK_EXIT_GRACE_SECS`; a rank still running then is hung, and the
binary kills them all and exits 124. It prints one
line ``ranks: {"world": N, "pids": [...]}`` once they are started and
one ``ranks exited: [...]`` with their exit codes at the end.
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
import sys
import time
from typing import List, Optional, Sequence

import numpy as np

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.config import validate

# Configurable registration happens at import; every family of the port
# is imported so configs can reference them without import lines.
DEFAULT_MODULES = (
    "tensor2robot_tpu_torch.models",
    "tensor2robot_tpu_torch.data",
    "tensor2robot_tpu_torch.envs",
    "tensor2robot_tpu_torch.export",
    "tensor2robot_tpu_torch.fleet",
    "tensor2robot_tpu_torch.hooks",
    "tensor2robot_tpu_torch.meta_learning",
    "tensor2robot_tpu_torch.predictors",
    "tensor2robot_tpu_torch.replay",
    "tensor2robot_tpu_torch.serving",
    "tensor2robot_tpu_torch.startup.compile_cache",
    "tensor2robot_tpu_torch.utils.profiling",
    "tensor2robot_tpu_torch.research.grasp2vec",
    "tensor2robot_tpu_torch.research.pose_env",
    "tensor2robot_tpu_torch.research.qtopt",
    "tensor2robot_tpu_torch.research.vrgripper",
)


# How long the binary waits for the other ranks once one has exited 0.
RANK_EXIT_GRACE_SECS = 300.0


def import_configurable_families(extra: Sequence[str] = ()) -> None:
  """Imports the default families and `extra`. Every module is imported
  strictly: a family that fails to import is a fault, not a note."""
  for module in list(DEFAULT_MODULES) + list(extra):
    importlib.import_module(module)


def parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(
      prog="python -m tensor2robot_tpu_torch.bin.run_t2r_trainer",
      description="Parses gin configs into the port's registry and runs "
                  "the configured trainer.")
  p.add_argument("--gin_configs", action="append", default=[],
                 help="Path to a gin config file; repeatable, and each "
                      "value may be a comma-separated list.")
  p.add_argument("--gin_bindings", action="append", default=[],
                 help="One gin binding string; repeatable.")
  p.add_argument("--import_modules", action="append", default=[],
                 help="Extra module to import before parsing (to register "
                      "configurables); repeatable.")
  p.add_argument("--validate_only", action="store_true",
                 help="Check every statement of --gin_configs against the "
                      "port's registry (unknown configurables, parameters "
                      "and @references, undefined macros, bad includes), "
                      "print the findings and exit 1 if there are any. "
                      "Narrower than the JAX flag: no source lints "
                      "(t2rcheck).")
  p.add_argument("--trainer", default="train_eval",
                 choices=("train_eval", "qtopt", "fleet", "anakin"),
                 help="Entry point after parsing: train_eval_model() "
                      "(default), train_qtopt(), run_fleet() or "
                      "train_anakin().")
  p.add_argument("--prometheus_port", type=int, default=None,
                 help="Serve the process's metrics registry as a "
                      "Prometheus scrape endpoint (GET /metrics) on this "
                      "port for the run (0 = a free port, printed). Unset: "
                      "the gin default `default_port.port`, else off.")
  return p


def config_files(gin_configs: Sequence[str]) -> List[str]:
  """The `--gin_configs` values as a list of files (each value may be a
  comma-separated list)."""
  return [c for entry in gin_configs for c in entry.split(",") if c]


def parse_configs(gin_configs: Sequence[str], gin_bindings: Sequence[str],
                  import_modules: Sequence[str] = ()) -> List[str]:
  """The binary's parse: imports the configurable families and
  `import_modules`, parses the configs and bindings into the port's
  registry and returns the config files."""
  configs = config_files(gin_configs)
  import_configurable_families(import_modules)
  gin.parse_config_files_and_bindings(configs, gin_bindings)
  return configs


def mesh_processes() -> int:
  """How many processes the bound `train_eval_model.mesh` needs when the
  binary must start them itself: the product of `create_mesh.axis_shapes`
  when that mesh is bound, no axis is -1 and this process is no rank of
  a launch (no `WORLD_SIZE`); else 0."""
  if os.environ.get("WORLD_SIZE"):
    return 0
  try:
    mesh = gin.query_parameter("train_eval_model.mesh")
    shapes = gin.query_parameter("create_mesh.axis_shapes")
  except gin.GinError:
    return 0
  if (getattr(mesh, "name", None) != "create_mesh"
      or not isinstance(shapes, dict)):
    return 0
  sizes = [int(v) for v in shapes.values()]
  if -1 in sizes:
    return 0
  world = int(np.prod(sizes))
  return world if world > 1 else 0


def _rank_main(argv: Sequence[str], address: str, world: int,
               rank: int) -> None:
  """A launched rank: the scrubbed environment, the coordinator, the
  group, `cuda:0` where it trains on the card, then the binary."""
  from tensor2robot_tpu_torch.fleet import proc
  from tensor2robot_tpu_torch.parallel import distributed

  proc.scrub_inherited_distributed_env()
  proc.adopt_coordinator(address, num_processes=world, process_id=rank)
  logging.basicConfig(
      level=logging.INFO,
      format=f"%(asctime)s rank {rank}/{world} %(name)s: %(message)s")
  if not distributed.maybe_initialize_distributed():
    raise RuntimeError(f"rank {rank} of {world} joined no process group")
  import torch
  # The ranks share the host's cores, as torchrun's one thread a rank.
  torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
  code = _main(argv, launched_rank=True)
  import torch.distributed as dist
  dist.destroy_process_group()
  sys.exit(code)


def _pin_rank_device() -> None:
  """Makes the rank's training device its current one: the card by index
  (`cuda:0`, ROADMAP trap 57); a rank without CUDA raises unless
  `train_eval_model.device` is bound to the CPU."""
  from tensor2robot_tpu_torch.device import resolve_device
  from tensor2robot_tpu_torch.fleet import proc
  try:
    device = gin.query_parameter("train_eval_model.device")
  except gin.GinError:
    device = None
  device = resolve_device(device)
  if device.type == "cuda" and device.index is None:
    import torch
    device = torch.device("cuda", 0)
  proc.pin_single_host_device(device)


def launch_ranks(argv: Sequence[str], world: int) -> int:
  """Starts `world` ranks of this binary's arguments and waits for them
  (the module docstring); returns the run's exit code."""
  from tensor2robot_tpu_torch.fleet import proc
  from tensor2robot_tpu_torch.parallel.distributed import (
      ephemeral_coordinator_address,
  )

  ctx = proc.children_context()
  # The ranks fork with the trainer's families imported once.
  ctx.set_forkserver_preload(list(proc.CHILD_PRELOAD) + list(DEFAULT_MODULES)
                             + ["tensor2robot_tpu_torch.bin.run_t2r_trainer"])
  address = ephemeral_coordinator_address()
  procs = [ctx.Process(target=_rank_main,
                       args=(list(argv), address, world, rank),
                       name=f"rank-{rank}")
           for rank in range(world)]
  for p in procs:
    p.start()
  print("ranks: " + json.dumps({"world": world,
                                "pids": [p.pid for p in procs]}),
        flush=True)
  deadline = None  # set when the first rank exits 0
  code = None
  try:
    while code is None:
      codes = [p.exitcode for p in procs]
      failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
      if failed:
        rank, c = failed[0]
        code = c if c > 0 else 128 - c
        logging.error("rank %d of %d ended with exit code %d: stopping "
                      "the run", rank, world, c)
      elif all(c == 0 for c in codes):
        code = 0
      elif deadline is None and 0 in codes:
        deadline = time.monotonic() + RANK_EXIT_GRACE_SECS
      elif deadline is not None and time.monotonic() > deadline:
        code = 124
        logging.error("ranks %s of %d still ran %s s after rank %d "
                      "exited 0: stopping the run",
                      [r for r, c in enumerate(codes) if c is None], world,
                      RANK_EXIT_GRACE_SECS, codes.index(0))
      else:
        time.sleep(0.2)
  finally:
    for p in procs:
      if p.exitcode is None:
        p.kill()
    for p in procs:
      p.join(timeout=30)
  print("ranks exited: " + json.dumps([p.exitcode for p in procs]),
        flush=True)
  return code


def main(argv: Optional[Sequence[str]] = None) -> int:
  return _main(sys.argv[1:] if argv is None else argv)


def _main(argv: Sequence[str], launched_rank: bool = False) -> int:
  """`main`; a `launched_rank` pins the device it trains on after the
  parse."""
  args = parser().parse_args(argv)
  if args.validate_only:
    configs = config_files(args.gin_configs)
    import_configurable_families(args.import_modules)
    findings = [f for config in configs
                for f in validate.validate_config_file(config)]
    for finding in findings:
      print(finding.render())
    print(f"validate_only: {len(findings)} finding(s) in {len(configs)} "
          "config(s)")
    return 1 if findings else 0
  configs = parse_configs(args.gin_configs, args.gin_bindings,
                          args.import_modules)
  world = mesh_processes() if args.trainer == "train_eval" else 0
  if world:
    gin.clear_config()  # each rank parses the configs itself
    return launch_ranks(argv, world)
  if launched_rank:
    _pin_rank_device()
  # The scrape endpoint: the flag wins, else the gin-backed default.
  # Started before the entry point so every trainer and the fleet's
  # supervising process serve /metrics off their live registry.
  from tensor2robot_tpu_torch.telemetry import prometheus as prometheus_lib
  prometheus_port = args.prometheus_port
  if prometheus_port is None:
    prometheus_port = prometheus_lib.default_port()
  endpoint = None
  if prometheus_port is not None and prometheus_port >= 0:
    endpoint = prometheus_lib.serve(port=prometheus_port)
    print(f"prometheus: serving /metrics on port {endpoint.port}",
          flush=True)
  try:
    _run_trainer(args.trainer, configs)
  finally:
    if endpoint is not None:
      endpoint.close()
  return 0


def _run_trainer(trainer: str, configs: Sequence[str]) -> None:
  """Runs the entry point `--trainer` names over the parsed bindings."""
  if trainer == "qtopt":
    from tensor2robot_tpu_torch.research.qtopt.train_qtopt import (
        train_qtopt,
    )
    train_qtopt()
  elif trainer == "fleet":
    # The orchestrator reruns these configs through --validate_only as
    # its pre-spawn launch gate.
    from tensor2robot_tpu_torch.fleet import run_fleet
    run_fleet(gin_configs=configs)
  elif trainer == "anakin":
    from tensor2robot_tpu_torch.envs import train_anakin
    train_anakin()
  else:
    train_eval.train_eval_model()


if __name__ == "__main__":
  logging.basicConfig(level=logging.INFO,
                      format="%(asctime)s %(name)s: %(message)s")
  sys.exit(main())
