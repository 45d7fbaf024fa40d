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
``FleetConfig.env = "mujoco_pose"``, which is ROADMAP A10a, so bind
``FleetConfig.env = "pose"`` on top).

The flags keep the JAX binary's names. `--validate_only` resolves every
statement of each config against the port's registry (the JAX rules
GIN101–GIN107: unknown configurables, parameters and references,
undefined macros, unresolvable includes) and exits 1 on any finding; it
is narrower than the JAX flag, which also runs the JAX package's source
lints (t2rcheck, which covers JAX code only). `--trainer=fleet` runs
`run_fleet(gin_configs=...)`, whose launch gate reruns the configs
through `--validate_only`. Not ported: the Prometheus endpoint (ROADMAP
A13 rest) and the multi-host `jax_*` flags (A11).
"""

from __future__ import annotations

import argparse
import importlib
import logging
import sys
from typing import Optional, Sequence

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
                 help="Not ported yet (ROADMAP A13 rest): raises when "
                      "set.")
  return p


def main(argv: Optional[Sequence[str]] = None) -> int:
  args = parser().parse_args(argv)
  configs = [c for entry in args.gin_configs for c in entry.split(",") if c]
  import_configurable_families(args.import_modules)
  if args.validate_only:
    findings = [f for config in configs
                for f in validate.validate_config_file(config)]
    for finding in findings:
      print(finding.render())
    print(f"validate_only: {len(findings)} finding(s) in {len(configs)} "
          "config(s)")
    return 1 if findings else 0
  if args.prometheus_port is not None:
    raise NotImplementedError(
        "--prometheus_port: the scrape endpoint is not ported yet "
        "(ROADMAP A13 rest).")
  gin.parse_config_files_and_bindings(configs, args.gin_bindings)
  if args.trainer == "qtopt":
    from tensor2robot_tpu_torch.research.qtopt.train_qtopt import (
        train_qtopt,
    )
    train_qtopt()
  elif args.trainer == "fleet":
    # The orchestrator reruns these configs through --validate_only as
    # its pre-spawn launch gate.
    from tensor2robot_tpu_torch.fleet import run_fleet
    run_fleet(gin_configs=configs)
  elif args.trainer == "anakin":
    from tensor2robot_tpu_torch.envs import train_anakin
    train_anakin()
  else:
    train_eval.train_eval_model()
  return 0


if __name__ == "__main__":
  logging.basicConfig(level=logging.INFO,
                      format="%(asctime)s %(name)s: %(message)s")
  sys.exit(main())
