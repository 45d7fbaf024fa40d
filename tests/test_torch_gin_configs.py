"""Every shipped `.gin` file against the port's registry.

  * The twelve configs the port runs as written (`qtopt_int8.gin`,
    `train_pose_env.gin`, `serving_multitenant.gin`,
    `train_vrgripper_transformer.gin`, `train_grasp2vec.gin`,
    `train_vrgripper_bc.gin`, `train_vrgripper_meta.gin`,
    `train_vrgripper_wtl.gin`, `qtopt_anakin.gin`,
    `qtopt_anakin_pod.gin`, `train_vrgripper_transformer_moe.gin`,
    `qtopt_anakin_shardmap.gin`) parse strictly in the port's registry.
    Their bindings equal the JAX registry's, binding by binding, and
    every name in them resolves to the port's counterpart of the JAX
    class or function.
  * Six fleet configs (`qtopt_fleet.gin`, `qtopt_fleet_elastic.gin`,
    `qtopt_fleet_tcp.gin`, `qtopt_serving_replicated.gin`,
    `qtopt_fleet_autopilot.gin`, `qtopt_fleet_hybrid.gin`) parse
    strictly, with JAX's bindings, and are refused at `Fleet`
    construction, before any process is spawned, by a `FleetUnported`
    naming what the port lacks: the `mujoco_pose` env they bind (A10a)
    and nothing else, but for `qtopt_fleet_hybrid.gin` its pods and
    learner group (A13 rest, A11). With `FleetConfig.env = "pose"` bound
    the first five run; no refusal names fronts or control any more.
  * The other two report exactly the configurables and parameters the
    port still lacks (the table in ROADMAP.md).
  * `run_t2r_trainer --validate_only` exits 0 on the twelve and the six
    and 1 on the others; the trainers, flags and programs that are not
    ported raise, naming their ROADMAP item; `--trainer=anakin` trains
    `qtopt_anakin.gin` (CPU, small widths bound on top).
"""

import glob
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from tensor2robot_tpu import config as jax_gin  # noqa: E402
from tensor2robot_tpu.config import ginlite as jax_ginlite  # noqa: E402
from tensor2robot_tpu_torch import config as port_gin  # noqa: E402
from tensor2robot_tpu_torch.bin import run_t2r_trainer  # noqa: E402
from tensor2robot_tpu_torch.config import ginlite as port_ginlite  # noqa: E402
from tensor2robot_tpu_torch.config import validate  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CONFIGS = "tensor2robot_tpu/"
_AS_WRITTEN = (
    "research/qtopt/configs/qtopt_int8.gin",
    "research/pose_env/configs/train_pose_env.gin",
    "serving/configs/serving_multitenant.gin",
    "research/vrgripper/configs/train_vrgripper_transformer.gin",
    "research/grasp2vec/configs/train_grasp2vec.gin",
    "research/vrgripper/configs/train_vrgripper_bc.gin",
    "research/vrgripper/configs/train_vrgripper_meta.gin",
    "research/vrgripper/configs/train_vrgripper_wtl.gin",
    "research/qtopt/configs/qtopt_anakin.gin",
    "research/qtopt/configs/qtopt_anakin_pod.gin",
    "research/vrgripper/configs/train_vrgripper_transformer_moe.gin",
    "research/qtopt/configs/qtopt_anakin_shardmap.gin",
)
# Fleet configs that parse in the port's registry, and what `Fleet`
# refuses in each: as written (the physics env), and with
# `FleetConfig.env = "pose"` bound on top.
_POSE = 'FleetConfig.env = "pose"'
# The physics env, and nothing after it.
_A10A_ONLY = (r"yet: env='mujoco_pose' needs MuJoCoPoseEnv \(ROADMAP "
              r"A10a\); bind FleetConfig\.env = 'pose' for the numpy "
              r"PoseEnv$")
_FLEET_REFUSED = {
    "research/qtopt/configs/qtopt_fleet.gin": (_A10A_ONLY, None),
    "research/qtopt/configs/qtopt_fleet_elastic.gin": (_A10A_ONLY, None),
    "research/qtopt/configs/qtopt_fleet_tcp.gin": (_A10A_ONLY, None),
    "research/qtopt/configs/qtopt_serving_replicated.gin": (_A10A_ONLY, None),
    "research/qtopt/configs/qtopt_fleet_autopilot.gin": (_A10A_ONLY, None),
    "research/qtopt/configs/qtopt_fleet_hybrid.gin": (_A10A_ONLY, None),
}
# What each other shipped config needs that the port lacks.
_UNPORTED = {
    "research/pose_env/configs/train_pose_env_physics.gin":
        {"MuJoCoPoseEnv"},
    "research/vrgripper/configs/train_vrgripper_transformer_pipeline.gin":
        {"VRGripperTransformerModel.mesh",
         "VRGripperTransformerModel.pipeline_microbatches"},
}
_JAX_FAMILIES = ("tensor2robot_tpu.models", "tensor2robot_tpu.data",
                 "tensor2robot_tpu.envs",
                 "tensor2robot_tpu.hooks", "tensor2robot_tpu.meta_learning",
                 "tensor2robot_tpu.serving",
                 "tensor2robot_tpu.train_eval",
                 "tensor2robot_tpu.research.grasp2vec",
                 "tensor2robot_tpu.research.pose_env",
                 "tensor2robot_tpu.research.qtopt",
                 "tensor2robot_tpu.research.vrgripper")


def unported_names(findings):
  """The configurables (``Name``) and parameters (``Name.param``) that
  findings GIN101/102/104 name: what a config needs that is missing."""
  out = set()
  for f in findings:
    if f.rule in ("GIN101", "GIN104") and f.name:
      out.add(f.name)
    elif f.rule == "GIN102":
      out.add(f"{f.name}.{f.param}")
  return out


@pytest.fixture(scope="module", autouse=True)
def families():
  import importlib
  for module in _JAX_FAMILIES:
    importlib.import_module(module)
  run_t2r_trainer.import_configurable_families()


@pytest.fixture(autouse=True)
def clean():
  jax_gin.clear_config()
  port_gin.clear_config()
  yield
  jax_gin.clear_config()
  port_gin.clear_config()


def test_every_shipped_config_is_in_one_table():
  shipped = sorted(os.path.relpath(p, os.path.join(_REPO, _CONFIGS))
                   for p in glob.glob(os.path.join(_REPO, _CONFIGS, "**",
                                                   "*.gin"), recursive=True))
  assert len(shipped) == 20
  assert sorted(set(_AS_WRITTEN) | set(_FLEET_REFUSED)
                | set(_UNPORTED)) == shipped


def _plain(value, ginlite):
  """A parsed gin value with references and macros as tuples, so the
  two registries' values compare."""
  if isinstance(value, ginlite._Reference):
    return ("@", value.scope, value.name, value.evaluate)
  if isinstance(value, ginlite._Macro):
    return ("%", value.name)
  if isinstance(value, (list, tuple)):
    return type(value)(_plain(v, ginlite) for v in value)
  if isinstance(value, dict):
    return {_plain(k, ginlite): _plain(v, ginlite) for k, v in value.items()}
  return value


def _bindings(ginlite):
  return {key: {p: _plain(v, ginlite) for p, v in params.items()}
          for key, params in ginlite._REGISTRY.bindings.items()}


def _references(value, ginlite):
  if isinstance(value, ginlite._Reference):
    yield value.name
  elif isinstance(value, (list, tuple)):
    for v in value:
      yield from _references(v, ginlite)
  elif isinstance(value, dict):
    for k, v in value.items():
      yield from _references(k, ginlite)
      yield from _references(v, ginlite)


@pytest.mark.parametrize("config", _AS_WRITTEN)
def test_config_runs_as_written_in_the_port(config):
  path = _CONFIGS + config
  assert validate.validate_config_file(path) == []
  port_gin.parse_config_file(path)  # strict: skip_unknown=False
  jax_gin.parse_config_file(path)
  port, jax = _bindings(port_ginlite), _bindings(jax_ginlite)
  assert port == jax and port
  names = {name for _, name in port_ginlite._REGISTRY.bindings}
  for params in port_ginlite._REGISTRY.bindings.values():
    for value in params.values():
      names.update(_references(value, port_ginlite))
  for name in names:
    port_fn = port_ginlite._lookup_configurable(name).fn
    jax_fn = jax_ginlite._lookup_configurable(name).fn
    assert port_fn.__module__ == jax_fn.__module__.replace(
        "tensor2robot_tpu.", "tensor2robot_tpu_torch.", 1), name
    assert port_fn.__qualname__ == jax_fn.__qualname__


@pytest.mark.parametrize("config", sorted(_UNPORTED) + sorted(_FLEET_REFUSED))
def test_config_reports_exactly_what_the_port_lacks(config):
  """The fleet configs lack nothing in the registry (they are refused
  at `Fleet` construction instead: the test below)."""
  findings = validate.validate_config_file(_CONFIGS + config)
  assert unported_names(findings) == _UNPORTED.get(config, set())
  assert {f.rule for f in findings} <= {"GIN101", "GIN102", "GIN104"}


@pytest.mark.parametrize("config", sorted(_FLEET_REFUSED))
def test_fleet_config_is_refused_before_any_spawn(config, tmp_path):
  """Parsed with JAX's bindings, every name the port's counterpart;
  `Fleet` (and `run_fleet`) then refuse it before any process or
  directory is made, naming what the port lacks, as written and with
  the pose env bound."""
  import multiprocessing as mp

  from tensor2robot_tpu_torch.fleet import orchestrator
  path = _CONFIGS + config
  port_gin.parse_config_file(path)  # strict
  jax_gin.parse_config_file(path)
  assert _bindings(port_ginlite) == _bindings(jax_ginlite)
  for name in ("FleetConfig", "run_fleet"):
    fn = port_ginlite._lookup_configurable(name).fn
    assert fn.__module__ == "tensor2robot_tpu_torch.fleet.orchestrator"
  children = set(mp.active_children())
  model_dir = str(tmp_path / "fleet")
  as_written, with_pose = _FLEET_REFUSED[config]
  for bindings, item in (((), as_written), ((_POSE,), with_pose)):
    port_gin.clear_config()
    port_gin.parse_config_files_and_bindings([path], list(bindings))
    if item is None:
      assert orchestrator.unported(orchestrator.FleetConfig()) == []
      orchestrator.Fleet(orchestrator.FleetConfig(), model_dir)
      continue
    with pytest.raises(orchestrator.FleetUnported, match=item) as refused:
      orchestrator.run_fleet(model_dir=model_dir)
    assert not re.search("front|control", str(refused.value))
  assert set(mp.active_children()) == children
  assert not os.path.exists(model_dir)


@pytest.mark.parametrize("config", sorted(_AS_WRITTEN) + sorted(_UNPORTED)
                         + sorted(_FLEET_REFUSED))
def test_validate_only_exit_code(config, capsys):
  code = run_t2r_trainer.main(["--validate_only",
                               "--gin_configs", _CONFIGS + config])
  assert code == (1 if config in _UNPORTED else 0)
  assert "validate_only:" in capsys.readouterr().out
  assert port_ginlite._REGISTRY.bindings == {}  # nothing was bound


def test_validate_only_from_the_command_line_takes_a_comma_list():
  configs = ",".join(_CONFIGS + c for c in _AS_WRITTEN[:2])
  out = subprocess.run(
      [sys.executable, "-m", "tensor2robot_tpu_torch.bin.run_t2r_trainer",
       "--validate_only", "--gin_configs", configs,
       "--gin_configs", _CONFIGS + _AS_WRITTEN[2]],
      cwd=_REPO, env=dict(os.environ, PYTHONPATH=_REPO),
      capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr
  assert "validate_only: 0 finding(s) in 3 config(s)" in out.stdout
  bad = subprocess.run(
      [sys.executable, "-m", "tensor2robot_tpu_torch.bin.run_t2r_trainer",
       "--validate_only", "--gin_configs",
       _CONFIGS + "research/pose_env/configs/train_pose_env_physics.gin"],
      cwd=_REPO, env=dict(os.environ, PYTHONPATH=_REPO),
      capture_output=True, text=True, timeout=300)
  assert bad.returncode == 1
  assert "MuJoCoPoseEnv" in bad.stdout


def test_a_typo_is_a_finding(tmp_path):
  path = tmp_path / "typo.gin"
  path.write_text("PoseEnvRegressionModel.image_sie = 64\n"
                  "train_eval_model.model = @NoSuchModel()\n"
                  "train_eval_model.batch_size = %UNDEFINED\n")
  findings = validate.validate_config_file(str(path))
  assert sorted(f.rule for f in findings) == ["GIN102", "GIN103", "GIN104"]
  assert unported_names(findings) == {
      "PoseEnvRegressionModel.image_sie", "NoSuchModel"}


_SMALL_ANAKIN = (
    "QTOptLearner.device = 'cpu'", "GraspingQModel.image_size = 16",
    "GraspingQModel.torso_filters = (8,)", "GraspingQModel.head_filters = (8,)",
    "GraspingQModel.dense_sizes = (16,)", "QTOptLearner.cem_population = 8",
    "QTOptLearner.cem_elites = 2", "train_anakin.num_envs = 16",
    "train_anakin.batch_size = 16", "train_anakin.max_train_steps = 8",
    "train_anakin.log_every_steps = 4",
    "train_anakin.save_checkpoints_steps = 4",
    "ScenarioSuccessEvalHook.num_scenarios = 16")


def _bindings_argv(bindings):
  return [a for b in bindings for a in ("--gin_bindings", b)]


@pytest.mark.parametrize("argv,item", [
    # The hybrid fleet runs with the pose env bound; as written its
    # physics env is refused.
    (["--trainer=fleet", "--gin_configs",
      _CONFIGS + "research/qtopt/configs/qtopt_fleet_hybrid.gin",
      "--gin_bindings", "run_fleet.model_dir = '/nonexistent'"], "A10a"),
    # The mesh is the data axis only.
    (["--trainer=qtopt", "--gin_configs",
      _CONFIGS + "research/qtopt/configs/qtopt_int8.gin",
      "--gin_bindings", "train_qtopt.model_dir = '/nonexistent'",
      "--gin_bindings", "QTOptLearner.device = 'cpu'",
      "--gin_bindings", "train_qtopt.mesh = @create_mesh()",
      "--gin_bindings",
      "create_mesh.axis_shapes = {'data': 1, 'stage': 1}"], "A11 rest"),
    (["--trainer=anakin", "--gin_configs",
      _CONFIGS + "research/qtopt/configs/qtopt_anakin_shardmap.gin",
      "--gin_bindings", "train_anakin.model_dir = '/nonexistent'",
      "--gin_bindings", "train_anakin.num_devices = 2"]
     + _bindings_argv(_SMALL_ANAKIN), "A11"),
])
def test_unported_trainers_and_flags_raise_naming_the_roadmap_item(argv,
                                                                   item):
  with pytest.raises(NotImplementedError, match=item):
    run_t2r_trainer.main(argv)


@pytest.mark.parametrize("config,hook", [("qtopt_anakin.gin", False),
                                         ("qtopt_anakin_pod.gin", True),
                                         ("qtopt_anakin_shardmap.gin", True)])
def test_anakin_trainer_runs_the_shipped_gin(tmp_path, config, hook):
  """`--trainer=anakin` on the shipped file, small widths and the CPU
  bound on top: records every 4 steps, checkpoints, and (pod) one
  scenario sweep line per checkpoint. The shardmap file's pod program at
  D = 1 resolves the qtopt rules table on the pod mesh."""
  from tensor2robot_tpu_torch.telemetry.records import read_records

  code = run_t2r_trainer.main(
      ["--trainer=anakin", "--gin_configs",
       _CONFIGS + "research/qtopt/configs/" + config, "--gin_bindings",
       f"train_anakin.model_dir = '{tmp_path}'"]
      + _bindings_argv(_SMALL_ANAKIN))
  assert code == 0
  rows = read_records(str(tmp_path / "metrics_train.jsonl"))
  assert [r["step"] for r in rows] == [4, 8]
  assert all(r["param_refresh_lag_steps"] == 0.0 for r in rows)
  assert ("devices" in rows[0]) == hook
  assert sorted(os.listdir(tmp_path / "ckpt")) == ["4", "8"]
  sweeps = tmp_path / "success_protocol" / "scenarios_by_checkpoint.jsonl"
  assert sweeps.exists() == hook
  if hook:
    assert len(sweeps.read_text().splitlines()) == 2


def test_the_moe_gin_trains_from_tfrecords_on_the_cpu(tmp_path):
  """`train_vrgripper_transformer_moe.gin` (8 experts on every other
  block) from TFRecords, on the CPU for 2 steps with the trunk's width
  bound down to 32: the records carry the aux loss, and the default
  overlapped startup writes its timings."""
  import json

  from tensor2robot_tpu_torch.research.vrgripper import collect_demo_episodes
  demos = collect_demo_episodes(str(tmp_path / "demos.tfrecord"),
                                num_episodes=20, seed=0)
  model_dir = tmp_path / "run"
  try:
    code = run_t2r_trainer.main([
        "--gin_configs", _CONFIGS + "research/vrgripper/configs/"
        "train_vrgripper_transformer_moe.gin",
        "--gin_bindings", f"train_eval_model.model_dir='{model_dir}'",
        "--gin_bindings",
        f"train/TFRecordEpisodeInputGenerator.file_patterns='{demos}'",
        "--gin_bindings", "train_eval_model.device='cpu'",
        "--gin_bindings", "VRGripperTransformerModel.width=32",
        "--gin_bindings", "train_eval_model.max_train_steps=2"])
    assert port_gin.query_parameter(
        "VRGripperTransformerModel.moe_experts") == 8
  finally:
    port_gin.clear_config()
  assert code == 0
  with open(model_dir / "metrics_train.jsonl") as f:
    payload = json.loads(f.readline())["payload"]
  assert 0.0 < payload["aux_loss"] <= 16.0
  assert payload["loss"] > payload["mse"]
  with open(model_dir / "startup_timings.json") as f:
    timings = json.load(f)
  assert timings["mode"] == "overlapped"
  assert set(timings["phase_seconds"]) == {"compile", "input"}
