"""The pipeline strategy through `train_eval_model` and the trainer
binary, on the CPU, at `tests/test_pipeline_config.py`'s tiny model (24
pixel images, width 32, depth 4 in 2 stages, 2 heads, 2 microbatches,
f32, reference attention).

  * `train_eval_model(mesh=, sharding_strategy="pipeline")` over a
    `data 2 × stage 2` mesh of four spawned CPU ranks
    (`tests/torch_pipeline_worker.py`) takes 4 steps, then resumes from
    its checkpoint for 4 more at `steps_per_dispatch` K = 2. Every
    logged loss equals the one-process run's on the same batches (8
    steps, no mesh: the sequential fallback) within 1e-5 relative,
    though the two data rows' ranks hold episodes of different lengths
    (the masked loss's global denominator, ROADMAP trap 63). Only rank
    0 writes the run's files. The checkpoint is in the one-device layout
    (every `stages` leaf and its Adam mirrors with a leading 2) and its
    params equal the one-process run's; served on the mesh-free model,
    its predictions equal the ranks' own forward on the same batch. Ranks
    whose generators give different global batches raise at the first
    step.
  * The shipped pipeline gin through `run_t2r_trainer` on the CPU with
    its mesh bound smaller (`data 2 × stage 2`, 2 stages: four ranks,
    not the gin's eight) and tiny widths: the binary starts the ranks,
    all exit 0, rank 0 writes records and a one-device checkpoint. A
    rank that cannot run (the card asked for where there is none, or a
    data plane of two workers, whose batch order no seed fixes) fails
    the run with its exit code.
"""

import multiprocessing as mp
import os
import queue as queue_lib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensor2robot_tpu_torch.bin import run_t2r_trainer  # noqa: E402
from tensor2robot_tpu_torch.parallel import distributed  # noqa: E402
from tensor2robot_tpu_torch.research.vrgripper import (  # noqa: E402
    VRGripperTransformerModel,
    collect_demo_episodes,
)
from tensor2robot_tpu_torch.telemetry.records import read_records  # noqa: E402
from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib  # noqa: E402

import torch_pipeline_worker as worker  # noqa: E402

_SHAPES = {"data": 2, "stage": 2}
_TIMEOUT = 240.0
_GIN = ("tensor2robot_tpu/research/vrgripper/configs/"
        "train_vrgripper_transformer_pipeline.gin")


def _batches(n=4, b=8, t=8):
  """Seeded global batches (a cycle of 4, so a resumed run meets the
  batches of the uninterrupted one); in each, data rank 0's rows (0, 1,
  4, 5) hold short episodes and rank 1's long ones."""
  rng = np.random.default_rng(5)
  lengths = np.array([2, 3, 8, 7, 2, 1, 8, 6], np.int64)
  out = []
  for _ in range(n):
    features = {
        "image": rng.integers(0, 255, (b, t, 24, 24, 3)).astype(np.uint8),
        "gripper_pose": rng.standard_normal((b, t, 3)).astype(np.float32),
        "sequence_length": lengths}
    labels = {"action": rng.standard_normal((b, t, 3)).astype(np.float32)}
    out.append((features, labels))
  return out


def _spawn(ranks, *args, target=worker.train_run):
  """`target(address, world, rank, *args, out)` (`worker.train_run`) in
  `ranks` spawned processes (one, world 0, for `ranks` 0); their items by
  rank."""
  ctx = mp.get_context("spawn")
  out = ctx.Queue()
  address = distributed.ephemeral_coordinator_address()
  procs = [ctx.Process(target=target,
                       args=(address, ranks, r) + args + (out,), daemon=True)
           for r in range(max(ranks, 1))]
  for p in procs:
    p.start()
  items = {}
  try:
    for _ in procs:
      item = out.get(timeout=_TIMEOUT)
      items[item[0]] = item
  except queue_lib.Empty:
    raise AssertionError(f"exit codes {[p.exitcode for p in procs]}") from None
  finally:
    for p in procs:
      p.join(timeout=30)
      if p.is_alive():
        p.kill()
        p.join()
  assert [p.exitcode for p in procs] == [0] * len(procs)
  return items


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  root = tmp_path_factory.mktemp("pipeline_runs")
  batches = _batches()
  one_dir, mesh_dir = str(root / "one"), str(root / "mesh")
  one = _spawn(0, None, one_dir, batches, 8, 1)
  first = _spawn(4, _SHAPES, mesh_dir, batches, 4, 1)
  resumed = _spawn(4, _SHAPES, mesh_dir, batches, 8, 2)
  return batches, one_dir, mesh_dir, one, first, resumed


def test_ranks_that_read_different_batches_raise(tmp_path):
  items = _spawn(4, _SHAPES, str(tmp_path / "run"), _batches(),
                 target=worker.skewed_run)
  for rank in range(4):
    assert "different global batches at step 0" in items[rank][1], items
  assert ckpt_lib.latest_step(str(tmp_path / "run")) is None


def _losses(model_dir):
  return {r["step"]: r["loss"]
          for r in read_records(os.path.join(model_dir,
                                             "metrics_train.jsonl"))}


def test_the_mesh_run_equals_the_one_process_run(runs):
  _, one_dir, mesh_dir, one, first, resumed = runs
  want = _losses(one_dir)
  got = _losses(mesh_dir)
  assert sorted(want) == list(range(1, 9))
  assert sorted(got) == [1, 2, 3, 4, 6, 8]  # K = 1 to 4, then K = 2
  for step, loss in got.items():
    assert abs(loss - want[step]) <= 1e-5 * abs(want[step]), step
  assert {item[4] for item in first.values()} == {4}
  assert {item[4] for item in resumed.values()} == {8}
  assert sorted(os.listdir(mesh_dir)) == [
      "ckpt", "metrics_train.jsonl", "startup_timings.json"]


def test_the_checkpoint_is_the_one_device_layout(runs):
  _, one_dir, mesh_dir, _, _, _ = runs
  assert ckpt_lib.list_steps(mesh_dir) == [2, 4, 8]
  want = ckpt_lib._load_leaves(one_dir, 8)
  got = ckpt_lib._load_leaves(mesh_dir, 8)
  assert sorted(got) == sorted(want)
  stacked = [k for k in got if ".stages." in k]
  assert len(stacked) == 3 * 22  # params, mu, nu of 2 blocks a stage
  for k, v in got.items():
    if not isinstance(v, torch.Tensor):
      assert v == want[k], k
      continue
    assert v.shape == want[k].shape, k
    if k in stacked:
      assert v.shape[0] == 2, k
    scale = max(float(want[k].abs().max()), 1e-12)
    assert float((v - want[k]).abs().max()) <= 1e-5 * scale, k


def test_the_checkpoint_serves_on_the_mesh_free_model(runs):
  batches, _, mesh_dir, _, _, resumed = runs
  model = VRGripperTransformerModel(device_dtype=torch.float32,
                                    **worker.MODEL)
  state = model.create_inference_state(device="cpu")
  variables = ckpt_lib.restore_variables(
      mesh_dir, like={"params": state.params, "batch_stats": {}})
  state = state.__class__(step=8, params=variables["params"],
                          batch_stats={})
  features = {k: torch.from_numpy(v) for k, v in batches[0][0].items()}
  served = model.predict_step(state, features)["action"].numpy()
  ranks = np.zeros_like(served)
  for _, coords, rows, predictions, _ in resumed.values():
    ranks[rows] = predictions
  np.testing.assert_allclose(served, ranks, atol=1e-5, rtol=1e-5)


_TINY = (
    "create_mesh.axis_shapes = {'data': 2, 'stage': 2}",
    "VRGripperTransformerModel.pipeline_stages = 2",
    "train_eval_model.device = 'cpu'",
    "train_eval_model.max_train_steps = 4",
    "train_eval_model.save_checkpoints_steps = 4",
    "train_eval_model.log_every_steps = 2",
    "train_eval_model.batch_size = 8",
    "train/TFRecordEpisodeInputGenerator.sequence_length = 8",
    "train/TFRecordEpisodeInputGenerator.batch_size = 8",
    "VRGripperTransformerModel.image_size = 24",
    "VRGripperTransformerModel.filters = (8,)",
    "VRGripperTransformerModel.embedding_size = 16",
    "VRGripperTransformerModel.width = 32",
    "VRGripperTransformerModel.num_heads = 2",
    "VRGripperTransformerModel.max_context_length = 64",
)


def _argv(model_dir, demos, extra=()):
  argv = ["--gin_configs", _GIN]
  for binding in (f"train_eval_model.model_dir = '{model_dir}'",
                  f"train/TFRecordEpisodeInputGenerator.file_patterns = "
                  f"'{demos}'") + _TINY + tuple(extra):
    argv += ["--gin_bindings", binding]
  return argv


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
  return collect_demo_episodes(
      str(tmp_path_factory.mktemp("demos") / "demos.tfrecord"),
      num_episodes=16, image_size=24, seed=7, action_noise=0.1)


def test_the_binary_starts_the_gins_ranks(tmp_path, demos, capfd):
  model_dir = str(tmp_path / "run")
  assert run_t2r_trainer.main(_argv(model_dir, demos)) == 0
  out = capfd.readouterr().out
  assert '"world": 4' in out and "ranks exited: [0, 0, 0, 0]" in out
  records = read_records(os.path.join(model_dir, "metrics_train.jsonl"))
  assert [r["step"] for r in records] == [2, 4]
  assert all(np.isfinite(r["loss"]) for r in records)
  leaves = ckpt_lib._load_leaves(model_dir, 4)
  assert leaves["params/trunk.stages.block0.attn.qkv.weight"].shape[0] == 2


@pytest.mark.parametrize("binding", [
    "train_eval_model.device = 'cuda'",
    "train/TFRecordEpisodeInputGenerator.num_workers = 2",
], ids=["the_card_where_there_is_none", "a_data_plane_of_two_workers"])
def test_a_rank_that_fails_fails_the_run(tmp_path, demos, capfd, binding):
  code = run_t2r_trainer.main(_argv(str(tmp_path / "run"), demos,
                                    (binding,)))
  assert code == 1
  assert "ranks exited: [" in capfd.readouterr().out
  assert not os.path.exists(tmp_path / "run" / "ckpt")


@pytest.mark.parametrize("num_workers", [0, 1, 2])
def test_only_a_seeded_order_takes_the_groups_seed(num_workers):
  """A data plane of two workers delivers in completion order, so its
  `fix_seed` raises; with none or one the seed fixes the order."""
  from tensor2robot_tpu_torch.data import TFRecordEpisodeInputGenerator
  gen = TFRecordEpisodeInputGenerator(num_workers=num_workers)
  if num_workers > 1:
    with pytest.raises(ValueError, match="completion order"):
      gen.fix_seed(3)
  else:
    gen.fix_seed(3)
    assert gen._seed == 3


def _two_rank_mesh():
  from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
  return mesh_lib.Mesh(axis_names=("data", "stage"),
                       shape={"data": 1, "stage": 2}, local_devices=(None,),
                       world_size=2, rank=0, coords={"data": 0, "stage": 0})


@pytest.mark.parametrize("case", ["model_without_the_mesh", "eval",
                                  "exporters", "strategy"])
def test_a_mesh_run_refuses_what_it_cannot_do(tmp_path, case):
  """Before any collective: a model not built on the mesh (it would not
  reduce over the ranks), evaluation and exporters on a mesh of several
  ranks, and a strategy other than "pipeline" raise."""
  from tensor2robot_tpu_torch import train_eval
  mesh = _two_rank_mesh()
  model = VRGripperTransformerModel(
      mesh=None if case == "model_without_the_mesh" else mesh,
      device_dtype=torch.float32, **worker.MODEL)
  kwargs = dict(model=model, model_dir=str(tmp_path / "run"), mesh=mesh,
                sharding_strategy="pipeline", device="cpu")
  error, match = NotImplementedError, "evaluation and exporters"
  if case == "model_without_the_mesh":
    error, match = ValueError, "same mesh"
  elif case == "eval":
    kwargs["input_generator_eval"] = object()
  elif case == "exporters":
    kwargs["create_exporters_fn"] = lambda m: ()
  else:
    kwargs["sharding_strategy"] = "fsdp"
    match = "A11 rest"
  with pytest.raises(error, match=match):
    train_eval.train_eval_model(**kwargs)
  assert not os.path.exists(tmp_path / "run")
