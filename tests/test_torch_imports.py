"""The PyTorch port imports neither JAX, nor absl, TensorFlow,
protobuf, PIL or ml_dtypes (the card's machine has none of them), nor
anything of the JAX package.

A subprocess imports every module of `tensor2robot_tpu_torch`, then
lists what landed in `sys.modules`; `chip_smoke.py`'s own imports are
read from its source. Note the prefix trap: the port's name starts with
"tensor2robot_tpu", so the pin matches that package exactly and its
submodules by the "tensor2robot_tpu." prefix.
"""

import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FORBIDDEN = r"""
_PACKAGES = ("jax", "flax", "absl", "tensor2robot_tpu", "tensorflow",
             "google.protobuf", "PIL", "ml_dtypes")
def forbidden(m):
    return m in _PACKAGES or m.startswith(tuple(p + "." for p in _PACKAGES))
"""
exec(_FORBIDDEN)

_PROBE = _FORBIDDEN + r"""
import importlib, pkgutil, sys
import tensor2robot_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if forbidden(m))
print("COUNT=%d" % len(names))
print("NAMES=" + ",".join(names))
print("BAD=" + ",".join(bad))
"""

# Modules the walk must find (a rename must not drop one from the pin).
_EXPECTED = (
    "ops.cem_select", "ops.flash_attention", "layers.vision_layers",
    "layers.transformer", "models.convert", "models.regression_model",
    "parallel.ring_attention", "research.vrgripper.vrgripper_env",
    "research.vrgripper.vrgripper_models",
    "research.vrgripper.vrgripper_transformer_models",
    "research.vrgripper.gin_config",
    "data.episode_input_generator", "data.random_input_generator",
    "models.optimizers", "telemetry.records", "train_eval",
    "ops.cem_head", "replay.store", "replay.sampler", "hooks.hook",
    "data.prefetch", "utils.checkpoints", "research.qtopt.replay_buffer",
    "research.qtopt.train_qtopt", "utils.native", "replay.service",
    "research.qtopt.actor", "research.qtopt.grasping_env",
    "hooks.success_eval_hook", "bin.run_success_protocol",
    "telemetry.core", "telemetry.metrics", "serving.admission",
    "serving.arena", "serving.front", "serving.dedup", "serving.speculative",
    "startup.compile_cache", "config.ginlite", "config.validate",
    "bin.run_t2r_trainer", "research.pose_env.pose_env",
    "research.pose_env.pose_env_models", "specs.packing",
    "specs.serialization", "data.tfrecord_io", "data.example_proto",
    "data.png", "data.tfexample", "data.tfrecord_input_generator",
    "data.shm_ring", "data.plane", "preprocessors.abstract_preprocessor",
    "preprocessors.noop_preprocessor", "data.jpeg", "layers.resnet",
    "research.grasp2vec.grasp2vec_model", "research.grasp2vec.losses",
    "research.grasp2vec.visualization", "research.grasp2vec.grasp_env",
    "research.grasp2vec.goal_reward", "predictors.abstract_predictor",
    "predictors.checkpoint_predictor", "layers.mdn", "layers.snail",
    "meta_learning.maml_model", "meta_learning.meta_data",
    "meta_learning.meta_policies",
    "research.vrgripper.episode_to_transitions",
    "research.vrgripper.vrgripper_meta_models",
    "research.vrgripper.vrgripper_wtl_models",
    "research.pose_env.pose_env_maml_models",
    "envs.core", "envs.pose", "envs.procgen", "envs.rollout",
    "research.pose_env.grasp_bandit", "parallel.moe", "parallel.rules",
    "startup.orchestrator", "telemetry.perf", "utils.profiling",
    "telemetry.sentinel", "telemetry.flightrec", "fleet.proc",
    "fleet.transport", "fleet.rpc", "fleet.faults", "fleet.actor",
    "fleet.host", "fleet.learner", "fleet.orchestrator",
    "fleet.front", "fleet.traffic", "serving.router", "control",
    "control.rules", "control.policies", "control.actuators",
    "control.controller", "telemetry.merge", "telemetry.report",
    "telemetry.prometheus", "fleet.pod", "parallel.distributed",
    "parallel.mesh", "parallel.collectives",
)


def test_port_modules_import_no_jax():
  env = dict(os.environ, PYTHONPATH=_REPO)
  out = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr
  lines = dict(line.split("=", 1) for line in out.stdout.split())
  assert int(lines["COUNT"]) >= 40, out.stdout
  names = set(lines["NAMES"].split(","))
  missing = [m for m in _EXPECTED if f"tensor2robot_tpu_torch.{m}" not in names]
  assert not missing, missing
  assert lines["BAD"] == "", f"port imported {lines['BAD']}"


def test_chip_smoke_imports_no_jax():
  """Every import statement in chip_smoke.py, wherever it sits (the
  script imports inside functions), names no JAX module."""
  with open(os.path.join(_REPO, "chip_smoke.py")) as f:
    tree = ast.parse(f.read())
  imported = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      imported.update(alias.name for alias in node.names)
    elif isinstance(node, ast.ImportFrom):
      imported.add(node.module)
  assert {"tensor2robot_tpu_torch.ops.flash_attention",
          "tensor2robot_tpu_torch.research.qtopt.train_qtopt",
          "tensor2robot_tpu_torch.train_eval",
          "tensor2robot_tpu_torch.bin", "tensor2robot_tpu_torch.replay",
          "tensor2robot_tpu_torch.utils"} <= imported
  bad = sorted(m for m in imported if forbidden(m))  # noqa: F821
  assert not bad, bad


@pytest.mark.parametrize("name,bad", [
    ("tensor2robot_tpu_torch", False),
    ("tensor2robot_tpu_torch.ops.cem_select", False),
    ("tensor2robot_tpu", True),
    ("tensor2robot_tpu.ops.cem_select", True),
    ("jax", True), ("jax.numpy", True), ("jaxlib", False),
    ("flax.linen", True), ("absl", True), ("absl.flags", True),
    ("abslx", False), ("tensorflow", True), ("tensorflow.io", True),
    ("tensorflow_probability", False), ("google.protobuf", True),
    ("google.protobuf.message", True), ("google", False), ("PIL", True),
    ("PIL.Image", True), ("ml_dtypes", True),
])
def test_forbidden_matches_packages_not_prefixes(name, bad):
  """The port's own name starts with "tensor2robot_tpu" and must not
  count as the JAX package; the JAX package's modules must."""
  assert forbidden(name) is bad  # noqa: F821 — defined by exec above


def test_trainer_binary_and_registry_load_nothing_forbidden():
  """What `python -m tensor2robot_tpu_torch.bin.run_t2r_trainer` loads
  before it parses a config: the package, the registry, the binary and
  every default family."""
  probe = _FORBIDDEN + (
      "import sys\n"
      "import tensor2robot_tpu_torch\n"
      "from tensor2robot_tpu_torch import config\n"
      "from tensor2robot_tpu_torch.bin import run_t2r_trainer\n"
      "run_t2r_trainer.import_configurable_families()\n"
      "print('BAD=' + ','.join(sorted(m for m in sys.modules "
      "if forbidden(m))))\n")
  out = subprocess.run([sys.executable, "-c", probe], cwd=_REPO,
                       env=dict(os.environ, PYTHONPATH=_REPO),
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr
  assert out.stdout.split() == ["BAD="], out.stdout


@pytest.mark.parametrize("module", [
    "tensor2robot_tpu_torch.meta_learning",
    "tensor2robot_tpu_torch.research.vrgripper",
    "tensor2robot_tpu_torch.layers.snail",
    "tensor2robot_tpu_torch.layers.mdn",
    "tensor2robot_tpu_torch.research.pose_env.pose_env_maml_models",
])
def test_meta_and_vrgripper_families_alone_load_nothing_forbidden(module):
  """Each of the meta-learning / VRGripper family's packages, imported
  first in a fresh process."""
  probe = _FORBIDDEN + (
      "import importlib, sys\n"
      f"importlib.import_module({module!r})\n"
      "print('BAD=' + ','.join(sorted(m for m in sys.modules "
      "if forbidden(m))))\n")
  out = subprocess.run([sys.executable, "-c", probe], cwd=_REPO,
                       env=dict(os.environ, PYTHONPATH=_REPO),
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr
  assert out.stdout.split("BAD=", 1)[1].strip() == "", out.stdout


@pytest.mark.parametrize("module", [
    "tensor2robot_tpu_torch.fleet",
    "tensor2robot_tpu_torch.fleet.actor",
    "tensor2robot_tpu_torch.fleet.pod",
    "tensor2robot_tpu_torch.telemetry.sentinel",
])
def test_fleet_alone_loads_nothing_forbidden(module):
  """The fleet package (what the binary and every spawned fleet child
  import) and the actor's module, imported first in a fresh process:
  nothing forbidden, and no CUDA initialized by the import."""
  probe = _FORBIDDEN + (
      "import importlib, sys\n"
      f"importlib.import_module({module!r})\n"
      "import torch\n"
      "print('CUDA=%d' % torch.cuda.is_initialized())\n"
      "print('BAD=' + ','.join(sorted(m for m in sys.modules "
      "if forbidden(m))))\n")
  out = subprocess.run([sys.executable, "-c", probe], cwd=_REPO,
                       env=dict(os.environ, PYTHONPATH=_REPO),
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr
  assert "CUDA=0" in out.stdout.split()
  assert out.stdout.split("BAD=", 1)[1].strip() == "", out.stdout
