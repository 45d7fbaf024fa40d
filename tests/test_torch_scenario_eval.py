"""The scenario sweep, its hook and the bandit seam of the port's envs
against the JAX package.

`evaluate_scenarios` on the JAX sweep's own scenarios (its states carried
over) with JAX's CEM noise injected must give JAX's per-bucket counts and
success, its random baseline and its scenario digest (f32 models, one
set of weights); the port's digests reproduce from a seed;
`ScenarioSuccessEvalHook` writes its metrics file and appends to the
success-protocol artifact; `JaxEnvBandit` serves `GraspActor`.
"""

import functools
import json

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensor2robot_tpu import envs as jax_envs  # noqa: E402
from tensor2robot_tpu.research.qtopt import GraspingQModel as JaxModel  # noqa: E402
from tensor2robot_tpu.research.qtopt import QTOptLearner as JaxLearner  # noqa: E402
from tensor2robot_tpu_torch import envs  # noqa: E402
from tensor2robot_tpu_torch.hooks import ScenarioSuccessEvalHook  # noqa: E402
from tensor2robot_tpu_torch.models import convert  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import (  # noqa: E402
    GraspActor,
    GraspingQModel,
    QTOptLearner,
    ReplayBuffer,
)
from tensor2robot_tpu_torch.telemetry.records import read_records  # noqa: E402

_WIDTHS = dict(image_size=16, torso_filters=(8,), head_filters=(8,),
               dense_sizes=(16,), action_dim=2)
_CEM = dict(cem_population=16, cem_iterations=2, cem_elites=4)


def _t(x):
  return torch.from_numpy(np.array(x))


def _tiny_learner(**kwargs):
  return QTOptLearner(GraspingQModel(**_WIDTHS), device="cpu",
                      **dict(dict(cem_population=8, cem_iterations=1,
                                  cem_elites=2), **kwargs))


@functools.lru_cache(maxsize=None)
def _jax_side():
  """An f32 JAX learner with its state and a port learner holding the
  same weights (built once per module)."""
  learner = JaxLearner(JaxModel(device_dtype=jnp.float32, **_WIDTHS),
                       **_CEM)
  state = jax.jit(functools.partial(learner.create_state, batch_size=2))(
      jax.random.PRNGKey(0))
  ts = state.train_state
  variables = {"params": jax.device_get(ts.params),
               "batch_stats": jax.device_get(ts.batch_stats)}
  port = QTOptLearner(GraspingQModel(device_dtype=torch.float32, **_WIDTHS),
                      device="cpu", **_CEM)
  return learner, state, port, convert.convert_variables(variables)


def test_sweep_equals_jax_on_its_scenarios():
  jax_learner, jax_state, learner, ts = _jax_side()
  # A wide threshold: the untrained policy's grasps succeed often
  # enough that per-bucket success compares non-trivially.
  env_kwargs = dict(image_size=16, action_dim=2, success_threshold=0.35)
  jenv = jax_envs.ProcGenGraspEnv(**env_kwargs)
  env = envs.ProcGenGraspEnv(**env_kwargs)
  n, seed = 96, 3
  want = jax_envs.evaluate_scenarios(jax_learner, jax_state, env=jenv,
                                     num_scenarios=n, seed=seed)
  # The sweep's own draws: scenarios from split(key)[0], CEM from [1].
  key_env, key_cem = jax.random.split(jax.random.PRNGKey(seed))
  js = jax.jit(jax.vmap(jenv.reset))(jax.random.split(key_env, n))
  normal = jax.jit(jax.vmap(lambda k: jax.random.normal(k, (16, 16, 3))))(
      js.noise_key)
  states = env.scenario(_t(js.pose), _t(js.distractors),
                        _t(js.num_distractors), _t(js.half_extent),
                        _t(js.noise), _t(js.drift), _t(js.workspace),
                        normal=_t(normal))
  noise = torch.stack([
      _t(jax.random.normal(k, (n, 16, 2)))
      for k in jax.random.split(key_cem, 2)])
  got = envs.score_scenarios(learner, ts, env, states, seed=seed,
                             noise=noise)
  assert got["per_bucket"] == want["per_bucket"]
  assert sum(b["count"] for b in got["per_bucket"].values()) == n
  assert len(got["per_bucket"]) == 4
  for key in ("success_rate", "random_baseline_success_rate",
              "num_scenarios", "scenario_digest"):
    assert got[key] == want[key], key
  assert 0.0 < got["success_rate"] < 1.0
  assert all(0.0 < b["success_rate"] < 1.0
             for b in got["per_bucket"].values())


def test_digests_reproduce_from_a_seed():
  learner = _tiny_learner()
  state = learner.create_state(0)
  env = envs.ProcGenGraspEnv(image_size=16, action_dim=2)
  a = envs.evaluate_scenarios(learner, state, env=env, num_scenarios=32,
                              seed=3)
  b = envs.evaluate_scenarios(learner, state, env=env, num_scenarios=32,
                              seed=3)
  c = envs.evaluate_scenarios(learner, state, env=env, num_scenarios=32,
                              seed=4)
  assert a == b
  assert a["scenario_digest"] != c["scenario_digest"]
  assert a["action_digest"] != c["action_digest"]
  assert sum(row["count"] for row in a["per_bucket"].values()) == 32
  # A bucketless env sweeps as one bucket.
  pose = envs.evaluate_scenarios(learner, state,
                                 env=envs.PoseBanditEnv(image_size=16),
                                 num_scenarios=16, seed=0)
  assert list(pose["per_bucket"]) == ["0"]
  assert pose["per_bucket"]["0"]["count"] == 16


def test_hook_logs_and_appends_per_checkpoint(tmp_path):
  learner = _tiny_learner()
  state = learner.create_state(0)
  hook = ScenarioSuccessEvalHook(
      learner=learner, env=envs.ProcGenGraspEnv(image_size=16, action_dim=2),
      num_scenarios=32, seed=3)
  hook.begin(learner.model, str(tmp_path))
  # train_anakin hands hooks the critic TrainState.
  hook.after_checkpoint(500, state.train_state, str(tmp_path))
  hook.after_checkpoint(1000, state.train_state, str(tmp_path))
  rows = read_records(str(tmp_path / "metrics_scenario_eval.jsonl"))
  assert [r["step"] for r in rows] == [500, 1000]
  assert 0.0 <= rows[0]["success_rate"] <= 1.0
  assert "random_baseline_success_rate" in rows[0]
  assert any(k.startswith("bucket_") for k in rows[0])
  art = tmp_path / "success_protocol" / "scenarios_by_checkpoint.jsonl"
  records = [json.loads(line) for line in open(art)]
  assert [r["step"] for r in records] == [500, 1000]
  assert records[0]["phase"] == "checkpoint_sweep"
  assert records[0]["scenario_family"] == "ProcGenGraspEnv"
  assert records[0]["per_bucket"]
  assert records[0]["scenario_digest"] == records[1]["scenario_digest"]


def test_hook_thins_to_every_n_checkpoints(tmp_path):
  learner = _tiny_learner()
  state = learner.create_state(0)
  hook = ScenarioSuccessEvalHook(
      learner=learner, env=envs.ProcGenGraspEnv(image_size=16, action_dim=2),
      num_scenarios=16, seed=1, every_n_checkpoints=2,
      artifacts_path=str(tmp_path / "sweeps.jsonl"))
  hook.begin(learner.model, str(tmp_path))
  for step in (100, 200, 300):
    hook.after_checkpoint(step, state.train_state, str(tmp_path))
  rows = read_records(str(tmp_path / "metrics_scenario_eval.jsonl"))
  assert [r["step"] for r in rows] == [100, 300]
  assert len(open(tmp_path / "sweeps.jsonl").readlines()) == 2


def test_bandit_interface():
  bandit = envs.JaxEnvBandit(env=envs.ProcGenGraspEnv(image_size=16),
                             seed=0, device="cpu")
  obs, poses = bandit.reset_batch(8)
  assert obs["image"].shape == (8, 16, 16, 3)
  assert obs["image"].dtype == np.uint8
  assert poses.shape == (8, 2) and poses.dtype == np.float32
  assert bandit.last_buckets is not None and bandit.last_buckets.shape == (8,)
  rewards = bandit.grade(poses / np.float32(0.4), poses)
  np.testing.assert_array_equal(rewards, np.ones(8, np.float32))
  transitions = bandit.sample_transitions(8)
  assert set(transitions) == {"image", "action", "reward", "done",
                              "next_image"}
  assert transitions["reward"].shape == (8, 1)
  # Two bandits with one seed serve the same scenarios.
  other = envs.JaxEnvBandit(env=envs.ProcGenGraspEnv(image_size=16),
                            seed=0, device="cpu")
  np.testing.assert_array_equal(other.reset_batch(8)[1], poses)


def test_bandit_defaults_to_the_card():
  if torch.cuda.is_available():
    pytest.skip("a card is visible")
  with pytest.raises(RuntimeError, match="cuda"):
    envs.JaxEnvBandit(seed=0)


def test_grasp_actor_collects_through_the_bandit():
  learner = _tiny_learner()
  replay = ReplayBuffer(learner.transition_specification(), capacity=128)
  actor = GraspActor(
      learner, replay,
      env=envs.JaxEnvBandit(env=envs.ProcGenGraspEnv(image_size=16), seed=1,
                            device="cpu"),
      batch_episodes=8, epsilon=0.5, seed=2)
  actor.collect_once()  # bootstrap (random policy)
  actor.update_state(learner.create_state(0))
  actor.collect_once()  # the CEM policy through the adapter
  assert len(replay) == 16
  assert actor.episodes_collected == 16
