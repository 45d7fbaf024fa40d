"""The port's Anakin trainer (`tensor2robot_tpu_torch/envs/rollout.py`) on
the CPU, at test size (16×16 images, filters (8,), 8-16 envs, rollout 2,
K = 2-4, batch 8-16).

The wire spec and `_check_wire_spec`; the rollout's terminal frames;
the ring's writes, wrap, fill and sample bounds; one Bellman step of the
iteration against `QTOptLearner.train_step` on the same rows with the
same noise injected (that step is pinned against JAX in
`test_torch_qtopt_train.py`); `train_anakin` end to end with records,
checkpoints and exact resume; the pod and weight-update options on one
device, the shard_map pod program and the rules seam at D = 1; cadence
validation; each ROADMAP A11 raise; a statistical
check that Anakin training beats the random baseline on the pose
bandit, as the JAX package's slow test does; and the success protocol's
`envs` and `gripper` modes and `seedcheck` halves at test size.
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from tensor2robot_tpu_torch import envs  # noqa: E402
from tensor2robot_tpu_torch.envs import rollout as rollout_lib  # noqa: E402
from tensor2robot_tpu_torch.models import optimizers as opt_lib  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import (  # noqa: E402
    GraspingQModel,
    QTOptLearner,
    ReplayBuffer,
)
from tensor2robot_tpu_torch.telemetry.records import read_records  # noqa: E402
from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib  # noqa: E402


def _tiny_learner(**learner_kwargs):
  model = GraspingQModel(image_size=16, torso_filters=(8,),
                         head_filters=(8,), dense_sizes=(16,), action_dim=2)
  learner_kwargs.setdefault("cem_population", 8)
  learner_kwargs.setdefault("cem_iterations", 1)
  learner_kwargs.setdefault("cem_elites", 2)
  return QTOptLearner(model, device="cpu", **learner_kwargs)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """One intra-op thread: the tests' tensors are small, and the test
  workers share the host's cores."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


RUN = dict(env_family="pose", num_envs=16, rollout_length=2,
           train_batches_per_iter=4, batch_size=16, replay_capacity=128,
           max_train_steps=16, log_every_steps=8, save_checkpoints_steps=16,
           seed=0)


def _params_equal(a, b):
  pa, pb = a.train_state.params, b.train_state.params
  return set(pa) == set(pb) and all(torch.equal(pa[k], pb[k]) for k in pa)


def test_collected_batch_matches_the_wire_spec():
  learner = _tiny_learner()
  init_fn, collect_fn = envs.make_collect_fn(
      learner, envs.PoseBanditEnv(image_size=16), num_envs=4,
      rollout_length=3, epsilon=0.5)
  states = init_fn(torch.Generator().manual_seed(0))
  _, batch = collect_fn(learner.create_state(0), states,
                        torch.Generator().manual_seed(2))
  spec = learner.transition_specification().to_flat_dict()
  assert set(batch) == set(spec) == set(rollout_lib.WIRE_KEYS)
  for key, sp in spec.items():
    assert tuple(batch[key].shape) == (12,) + tuple(sp.shape), key
    assert batch[key].numpy().dtype == sp.dtype, key
    assert not batch[key].is_inference(), key
  replay = ReplayBuffer(learner.transition_specification(), capacity=64)
  replay.add({k: v.numpy() for k, v in batch.items()})
  assert len(replay) == 12


def test_extra_state_features_are_refused(tmp_path):
  model = GraspingQModel(image_size=16, torso_filters=(8,),
                         head_filters=(8,), dense_sizes=(16,), action_dim=2,
                         extra_state_features={"gripper": (1,)})
  learner = QTOptLearner(model, cem_population=4, cem_iterations=1,
                         cem_elites=2, device="cpu")
  with pytest.raises(ValueError, match="extra keys"):
    envs.train_anakin(learner=learner, model_dir=str(tmp_path),
                      num_envs=4, rollout_length=1, train_batches_per_iter=1,
                      batch_size=4, max_train_steps=1, log_every_steps=1,
                      save_checkpoints_steps=1)
  with pytest.raises(ValueError, match="extra keys"):
    envs.make_collect_fn(learner, envs.PoseBanditEnv(image_size=16), 4, 1)


def test_rollout_terminal_frames_and_continuations():
  """`next_image` is the post-step frame: the following acting frame
  where the episode goes on, the old episode's last frame where it
  ended (never the reset frame)."""
  env = envs.PoseBanditEnv(image_size=8, noise=0.0, max_episode_steps=2)
  batched = envs.make_batched(env, 6)
  g = torch.Generator().manual_seed(3)
  states = batched.reset(g)

  def policy(obs, gen):
    return torch.rand((6, 2), generator=gen) * 2 - 1

  _, traj = rollout_lib.rollout(batched, policy, states, g, 4)
  done = traj["done"][..., 0].bool()
  assert done[1].all() and done[3].all() and not done[0].any()
  # Continuing: next frame = the next step's acting frame.
  assert torch.equal(traj["next_image"][0], traj["image"][1])
  # Ended: the terminal frame is the old block, the next acting frame a
  # fresh one.
  assert not torch.equal(traj["next_image"][1], traj["image"][2])
  assert torch.equal(traj["next_image"][1], traj["image"][1])
  flat = envs.flatten_time(traj)
  assert flat["image"].shape == (24, 8, 8, 3)
  assert set(torch.unique(flat["reward"]).tolist()) <= {0.0, 1.0}


def test_ring_writes_wrap_and_fill():
  spec = {"x": type("S", (), {"shape": (2,), "dtype": np.float32})()}
  ring = rollout_lib.empty_ring(spec, 12, "cpu")
  fill = torch.zeros((), dtype=torch.int64)
  ptr = torch.zeros((), dtype=torch.int64)
  fills, ptrs = [], []
  for i in range(5):
    batch = {"x": torch.full((4, 2), float(i + 1))}
    fill, ptr = rollout_lib.ring_insert(ring, batch, fill, ptr)
    fills.append(int(fill))
    ptrs.append(int(ptr))
  assert fills == [4, 8, 12, 12, 12]
  assert ptrs == [4, 8, 0, 4, 8]
  # Slots: rows 0-3 batch 4, 4-7 batch 5, 8-11 batch 3.
  assert ring["x"][:, 0].tolist() == [4.0] * 4 + [5.0] * 4 + [3.0] * 4
  assert rollout_lib.ring_capacity(100, 16, 24) == 120
  assert rollout_lib.ring_capacity(16384, 256, 4096) == 16384
  assert rollout_lib.ring_capacity(10, 64, 8) == 64


def test_ring_samples_only_the_filled_prefix():
  spec = {"x": type("S", (), {"shape": (), "dtype": np.int64})()}
  ring = rollout_lib.empty_ring(spec, 64, "cpu")
  fill, ptr = rollout_lib.ring_insert(
      ring, {"x": torch.arange(1, 9)}, torch.zeros((), dtype=torch.int64),
      torch.zeros((), dtype=torch.int64))
  g = torch.Generator().manual_seed(0)
  drawn = torch.cat([rollout_lib.ring_sample(ring, fill, 256, g)["x"]
                     for _ in range(8)])
  assert drawn.min() >= 1 and drawn.max() <= 8  # never an empty row
  assert set(drawn.tolist()) == set(range(1, 9))  # every filled row
  counts = torch.bincount(drawn, minlength=9)[1:].float()
  assert counts.min() > 0.6 * counts.mean()  # roughly uniform


def test_one_bellman_step_equals_the_learner_step():
  """The iteration's Bellman half on injected transitions: rows
  `floor(u · fill)` of the ring, then `QTOptLearner.train_step` with the
  CEM noise drawn next from the same generator."""
  learner = _tiny_learner(cem_iterations=2)
  state = learner.create_state(0)
  spec = learner.transition_specification().to_flat_dict()
  rng = np.random.default_rng(0)
  rows = {
      "image": torch.from_numpy(rng.integers(0, 256, (24, 16, 16, 3),
                                             dtype=np.uint8)),
      "action": torch.from_numpy(rng.uniform(-1, 1, (24, 2)).astype(
          np.float32)),
      "reward": torch.from_numpy((rng.random((24, 1)) < 0.3).astype(
          np.float32)),
      "done": torch.ones((24, 1)),
  }
  rows["next_image"] = torch.flip(rows["image"], (0,))
  ring = rollout_lib.empty_ring(spec, 48, "cpu")
  zero = torch.zeros((), dtype=torch.int64)
  fill, _ = rollout_lib.ring_insert(ring, rows, zero, zero)
  got, got_metrics = rollout_lib.anakin_train_steps(
      learner, state, ring, fill, 8, [torch.Generator().manual_seed(5)])

  g = torch.Generator().manual_seed(5)
  idx = (torch.rand((8,), generator=g) * 24).long()
  noise = torch.stack([torch.randn((8, 8, 2), generator=g)
                       for _ in range(2)])
  want, want_metrics = learner.train_step(
      state, {k: v[idx] for k, v in rows.items()}, noise=noise)
  assert _params_equal(got, want)
  for key, value in want.target_params.items():
    assert torch.equal(got.target_params[key], value), key
  for key, value in want_metrics.items():
    assert torch.equal(got_metrics[key], value), key


def test_train_anakin_records_checkpoints_and_exact_resume(tmp_path):
  state = envs.train_anakin(learner=_tiny_learner(),
                            model_dir=str(tmp_path), **RUN)
  assert int(state.step) == 16
  rows = read_records(str(tmp_path / "metrics_train.jsonl"))
  assert [r["step"] for r in rows] == [8, 16]
  for row in rows:
    assert row["param_refresh_lag_steps"] == 0.0
    assert 0.0 < row["replay_fill"] <= 1.0
    assert row["env_steps_per_sec"] > 0 and row["grad_steps_per_sec"] > 0
    assert np.isfinite(row["loss"]) and 0.0 <= row["collect_reward_mean"] <= 1
    assert "devices" not in row
  with open(tmp_path / "metrics_train.jsonl") as f:
    assert json.loads(f.readline())["role"] == "anakin"
  assert ckpt_lib.latest_step(str(tmp_path)) == 16
  # A second call at the same max step trains nothing: the checkpoint.
  resumed = envs.train_anakin(learner=_tiny_learner(),
                              model_dir=str(tmp_path), **RUN)
  assert int(resumed.step) == 16 and _params_equal(state, resumed)


def test_resume_continues_from_a_checkpoint(tmp_path):
  half = dict(RUN, max_train_steps=8, save_checkpoints_steps=8)
  envs.train_anakin(learner=_tiny_learner(), model_dir=str(tmp_path), **half)
  state = envs.train_anakin(learner=_tiny_learner(),
                            model_dir=str(tmp_path), **RUN)
  assert int(state.step) == 16
  assert [r["step"] for r in read_records(
      str(tmp_path / "metrics_train.jsonl"))] == [8, 16]
  assert sorted(ckpt_lib.list_steps(str(tmp_path))) == [8, 16]


def test_graphed_and_eager_iterations_agree(tmp_path):
  a = envs.train_anakin(learner=_tiny_learner(),
                        model_dir=str(tmp_path / "a"), **RUN)
  b = envs.train_anakin(learner=_tiny_learner(),
                        model_dir=str(tmp_path / "b"), graphs=False, **RUN)
  assert _params_equal(a, b)


@pytest.mark.parametrize("option", [dict(num_devices=0),
                                    dict(num_devices=1),
                                    dict(shard_weight_update=True),
                                    dict(pod_program="pmap")])
def test_one_device_options_are_the_single_program(tmp_path, option):
  """The pod program at D = 1 and the weight-update sharding on one
  device are the single program bit for bit."""
  base = envs.train_anakin(learner=_tiny_learner(),
                           model_dir=str(tmp_path / "base"), **RUN)
  other = envs.train_anakin(learner=_tiny_learner(),
                            model_dir=str(tmp_path / "other"),
                            **dict(RUN, **option))
  assert _params_equal(base, other)
  rows = read_records(str(tmp_path / "other" / "metrics_train.jsonl"))
  if "num_devices" in option:
    for row in rows:
      assert row["devices"] == 1 and row["global_batch_size"] == 16
      assert row["bellman_batches_per_sec"] == row["grad_steps_per_sec"]


def _tree_equal(a, b):
  if isinstance(a, torch.Tensor):
    return torch.equal(a, b)
  if isinstance(a, dict):
    return set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
  if isinstance(a, (tuple, list)):
    return len(a) == len(b) and all(map(_tree_equal, a, b))
  return a == b


def test_shard_map_at_one_device_is_the_single_program(tmp_path):
  """`qtopt_anakin_shardmap.gin`'s options at D = 1 (the shard_map pod
  program, the qtopt rules table, the weight-update sharding) train bit
  for bit what the default single program trains: params, Adam state,
  batch statistics and target params (JAX pins its shard_map program at
  D = 1 to the pmap one, which is the single program)."""
  base = envs.train_anakin(learner=_tiny_learner(),
                           model_dir=str(tmp_path / "base"), **RUN)
  shard_map = envs.train_anakin(
      learner=_tiny_learner(), model_dir=str(tmp_path / "shard_map"),
      **dict(RUN, num_devices=1, pod_program="shard_map",
             sharding_rules="qtopt", shard_weight_update=True))
  a, b = base.train_state, shard_map.train_state
  assert a.step == b.step == 16
  for name in ("params", "batch_stats", "opt_state"):
    assert _tree_equal(getattr(a, name), getattr(b, name)), name
  assert _tree_equal(base.target_params, shard_map.target_params)
  rows = read_records(str(tmp_path / "shard_map" / "metrics_train.jsonl"))
  assert [r["devices"] for r in rows] == [1, 1]


@pytest.mark.parametrize("table,error", [
    ("nope", "unknown model family"),
    ("sharded", "shards"),
    ("uncovered", "no partition rule matched")])
def test_the_rules_seam_refuses_what_jax_refuses(tmp_path, monkeypatch,
                                                 table, error):
  """An unknown family, a table that places a param on the pod axis, and
  a table that leaves a param unmatched raise before training."""
  from tensor2robot_tpu_torch.parallel import rules
  tables = dict(rules.FAMILY_RULES)
  tables["sharded"] = ((r"torso_conv_0/kernel$", rules.P("pod")),
                       (r".*", rules.Replicate()))
  tables["uncovered"] = ((r"/kernel$", rules.Replicate()),)
  monkeypatch.setattr(rules, "FAMILY_RULES", tables)
  with pytest.raises(ValueError, match=error):
    envs.train_anakin(learner=_tiny_learner(), model_dir=str(tmp_path),
                      **dict(RUN, num_devices=0, pod_program="shard_map",
                             sharding_rules=table))
  assert not os.path.exists(tmp_path / "metrics_train.jsonl")


def test_rules_are_ignored_outside_the_shard_map_program(tmp_path):
  """As in JAX, only the shard_map pod program reads `sharding_rules`."""
  state = envs.train_anakin(learner=_tiny_learner(), model_dir=str(tmp_path),
                            **dict(RUN, sharding_rules="nope"))
  assert int(state.step) == 16


def test_cadences_must_divide(tmp_path):
  with pytest.raises(ValueError):
    envs.train_anakin(learner=_tiny_learner(), model_dir=str(tmp_path),
                      num_envs=4, rollout_length=1, train_batches_per_iter=4,
                      batch_size=4, max_train_steps=10, log_every_steps=4,
                      save_checkpoints_steps=4)


@pytest.mark.parametrize("kwargs", [
    dict(num_devices=2),
    dict(num_devices=2, pod_program="shard_map"),
    dict(num_devices=2, pod_program="shard_map", sharding_rules="qtopt")])
def test_pod_programs_raise_naming_a11(tmp_path, kwargs):
  """Both pod programs over more than one device are A11 (at D = 1 they
  are the single program: the tests below)."""
  with pytest.raises(NotImplementedError, match="A11"):
    envs.train_anakin(learner=_tiny_learner(), model_dir=str(tmp_path),
                      **dict(RUN, **kwargs))


def test_anakin_collect_fn_one_device_and_a11():
  learner = _tiny_learner()
  env = envs.PoseBanditEnv(image_size=16)
  init_fn, collect_fn = envs.make_anakin_collect_fn(
      learner, env, num_envs=4, rollout_length=2, devices=["cpu"])
  states = init_fn(torch.Generator().manual_seed(0))
  assert states.pose.shape == (1, 4, 2)
  _, batch = collect_fn(learner.create_state(0), states,
                        torch.Generator().manual_seed(1))
  flat = envs.flatten_devices(batch)
  assert flat["image"].shape == (8, 16, 16, 3)
  assert flat["action"].shape == (8, 2)
  with pytest.raises(NotImplementedError, match="A11"):
    envs.make_anakin_collect_fn(learner, env, 4, 2, devices=["cpu", "cpu"])


def test_bad_family_and_pod_program(tmp_path):
  with pytest.raises(ValueError, match="env_family"):
    envs.train_anakin(learner=_tiny_learner(), model_dir=str(tmp_path),
                      **dict(RUN, env_family="nope"))
  with pytest.raises(ValueError, match="pod_program"):
    envs.train_anakin(learner=_tiny_learner(), model_dir=str(tmp_path),
                      **dict(RUN, pod_program="nope"))


def test_int8_learner_calibrates_on_rendered_frames(tmp_path):
  learner = _tiny_learner(cem_inference="int8")
  assert learner.needs_calibration
  state = envs.train_anakin(learner=learner, model_dir=str(tmp_path),
                            **dict(RUN, max_train_steps=8,
                                   save_checkpoints_steps=8))
  assert not learner.needs_calibration and int(state.step) == 8


def test_anakin_learns_the_pose_bandit(tmp_path):
  """On-device online QT-Opt beats the random baseline on the pose
  bandit (the recipe of the JAX package's slow test: its towers, lr, CEM
  and threshold; 32 envs and batch 32 for 400 steps in place of 128
  for 600)."""
  model = GraspingQModel(
      image_size=16, action_dim=2, torso_filters=(16, 32),
      head_filters=(32,), dense_sizes=(32, 32),
      device_dtype=torch.float32,
      create_optimizer_fn=lambda: opt_lib.create_optimizer(
          learning_rate=1e-3))
  learner = QTOptLearner(model, cem_population=16, cem_iterations=2,
                         cem_elites=4, device="cpu")
  env = envs.PoseBanditEnv(image_size=16, action_dim=2,
                           success_threshold=0.15)
  state = envs.train_anakin(
      learner=learner, model_dir=str(tmp_path), env=env, num_envs=32,
      rollout_length=2, train_batches_per_iter=4, batch_size=32,
      replay_capacity=2048, max_train_steps=400, log_every_steps=400,
      save_checkpoints_steps=400, epsilon=0.3, seed=0)
  sweep = envs.evaluate_scenarios(learner, state, env=env,
                                  num_scenarios=256, seed=9,
                                  cem_population=64, cem_iterations=3)
  assert sweep["success_rate"] > max(
      3 * sweep["random_baseline_success_rate"], 0.5), sweep
  assert os.path.exists(tmp_path / "metrics_train.jsonl")


@pytest.mark.parametrize("mode,artifacts", [
    ("envs", ["qtopt_envs_scenarios.jsonl"]),
    ("gripper", ["vrgripper_bc_success_eval.jsonl",
                 "vrgripper_transformer_success_eval.jsonl"]),
])
def test_success_protocol_modes_at_test_size(tmp_path, capsys, mode,
                                             artifacts):
  from tensor2robot_tpu_torch.bin import run_success_protocol as protocol
  assert protocol.main([mode, "--small", "--device", "cpu",
                        "--out_dir", str(tmp_path)]) == 0
  emitted = [json.loads(line)["artifact"]
             for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"artifact"')]
  assert emitted == artifacts
  rows = [json.loads(line)
          for line in open(tmp_path / artifacts[0]).read().splitlines()]
  if mode == "envs":
    buckets, summary = rows[:-1], rows[-1]
    assert [r["scenario_bucket"] for r in buckets] == ["0", "1", "2", "3"]
    assert sum(r["count"] for r in buckets) == 64
    assert summary["train_steps"] == 8
    assert summary["param_refresh_lag_steps"] == 0.0
    assert 0.0 <= summary["random_baseline_success_rate"] <= 1.0
  else:
    assert rows[-1]["num_episodes"] == 4.0


def test_seedcheck_holds_the_envs_and_anakin_halves(capsys):
  from tensor2robot_tpu_torch.bin import run_success_protocol as protocol
  out = protocol.run_seedcheck(device="cpu", cem_select="lax")
  assert out["reproducible"] and out["run_a"] == out["run_b"]
  run = out["run_a"]
  assert run["pod_visible_devices"] == 1
  assert run["pod_params_sha256_devices_2"] == (
      "skipped: not enough local devices")
  for key in ("scenario_sweep_action_sha256",
              "scenario_sweep_scenario_sha256",
              "pod_params_sha256_devices_1"):
    assert len(run[key]) == 64, key
