"""The port's online QT-Opt path against the JAX package's.

`ToyGraspEnv` draws the same images, positions and grades bit for bit;
`GraspActor` commits the same transitions and counts in its bootstrap
phase, and — with both packages' CEM policies made to return one array —
the same ε-greedy mix in its greedy phase; crash and restart count the
same; `evaluate_grasp_policy` on converted weights with JAX's CEM noise
injected scores the same success rate and the same random baseline; the
success hooks write what JAX's write. Then the port alone: a tiny online
`train_qtopt` with the refresh hook and a service, and the
`run_success_protocol` entry point at test size on the CPU.

Tolerances: exact, except the SuccessEvalHook's stub policy, whose
float32 products are compared to 1e-6 (XLA may contract a multiply-add).
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.hooks import (  # noqa: E402
    QTOptSuccessEvalHook as JaxQTOptHook,
)
from tensor2robot_tpu.hooks import SuccessEvalHook as JaxSuccessHook  # noqa: E402
from tensor2robot_tpu.replay import (  # noqa: E402
    ReplayWriteService as JaxService,
)
from tensor2robot_tpu.research.qtopt import (  # noqa: E402
    GraspingQModel as JaxGraspingQModel,
)
from tensor2robot_tpu.research.qtopt import QTOptLearner as JaxLearner  # noqa: E402
from tensor2robot_tpu.research.qtopt import ReplayBuffer as JaxReplay  # noqa: E402
from tensor2robot_tpu.research.qtopt import actor as jax_actor_lib  # noqa: E402
from tensor2robot_tpu.research.qtopt import (  # noqa: E402
    grasping_env as jax_env_lib,
)
from tensor2robot_tpu.research.vrgripper import (  # noqa: E402
    evaluate_gripper_policy as jax_evaluate_gripper,
)
from tensor2robot_tpu_torch.bin import run_success_protocol as protocol  # noqa: E402
from tensor2robot_tpu_torch.data import prefetch as prefetch_lib  # noqa: E402
from tensor2robot_tpu_torch.hooks import (  # noqa: E402
    Hook,
    QTOptSuccessEvalHook,
    SuccessEvalHook,
)
from tensor2robot_tpu_torch.models import TrainState, convert  # noqa: E402
from tensor2robot_tpu_torch.replay import ReplayWriteService  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import (  # noqa: E402
    ActorStateRefreshHook,
    GraspActor,
    GraspingQModel,
    QTOptLearner,
    ReplayBuffer,
    ToyGraspEnv,
    evaluate_grasp_policy,
    train_qtopt,
)
from tensor2robot_tpu_torch.research.qtopt.actor import acting_copy  # noqa: E402
from tensor2robot_tpu_torch.research.vrgripper import (  # noqa: E402
    evaluate_gripper_policy,
)
from tensor2robot_tpu_torch.serving import CEMPolicyServer  # noqa: E402
from tensor2robot_tpu_torch.telemetry.records import read_records  # noqa: E402

_SMALL = dict(image_size=16, torso_filters=(8,), head_filters=(8,),
              dense_sizes=(16,), action_dim=2)
_CEM = dict(cem_population=8, cem_iterations=1, cem_elites=2)


def _port_learner(cem_select="lax"):
  return QTOptLearner(GraspingQModel(device_dtype=torch.float32, **_SMALL),
                      cem_select=cem_select, device="cpu", **_CEM)


def _jax_learner(cem_select="lax"):
  return JaxLearner(JaxGraspingQModel(device_dtype=jnp.float32, **_SMALL),
                    cem_select=cem_select, **_CEM)


# ---- the env ----


@pytest.mark.parametrize("image_size,action_dim,seed", [(16, 2, 0),
                                                        (64, 4, 5),
                                                        (24, 3, 123)])
def test_toy_grasp_env_equals_jax(image_size, action_dim, seed):
  env = ToyGraspEnv(image_size=image_size, action_dim=action_dim, seed=seed)
  ref = jax_env_lib.ToyGraspEnv(image_size=image_size,
                                action_dim=action_dim, seed=seed)
  for n in (1, 7, 33):
    (obs, pos), (want_obs, want_pos) = env.reset_batch(n), ref.reset_batch(n)
    np.testing.assert_array_equal(obs["image"], want_obs["image"])
    np.testing.assert_array_equal(pos, want_pos)
    actions = np.random.default_rng(n).uniform(-1, 1, (n, action_dim))
    np.testing.assert_array_equal(env.grade(actions, pos),
                                  ref.grade(actions, want_pos))
  got, want = env.sample_transitions(40), ref.sample_transitions(40)
  assert list(got) == list(want)
  for key in want:
    assert got[key].dtype == want[key].dtype, key
    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
  assert env.action_dim == action_dim


# ---- the actor ----


def _rows(store):
  """Every live row of a store, shard by shard (storage order)."""
  out = {}
  for shard in store._shards:
    for key, arr in shard.storage.items():
      out.setdefault(key, []).append(arr[:shard.size])
  return {key: np.concatenate(v) for key, v in out.items()}


def _actor_pair(sink, greedy):
  """(JAX actor, its replay, port actor, its replay), same seeds; with
  `greedy`, both hold a state and their policies return one array."""
  jax_learner, learner = _jax_learner(), _port_learner()
  jax_replay = JaxReplay(jax_learner.transition_specification(),
                         capacity=64, seed=1)
  replay = ReplayBuffer(learner.transition_specification(), capacity=64,
                        seed=1)
  jax_sink, port_sink = jax_replay, replay
  if sink == "service":
    jax_sink = JaxService(jax_replay.store, queue_batches=64)
    port_sink = ReplayWriteService(replay.store, queue_batches=64)
  kwargs = dict(batch_episodes=8, epsilon=0.3, seed=11)
  jax_actor = jax_actor_lib.GraspActor(
      jax_learner, jax_sink,
      env=jax_env_lib.ToyGraspEnv(image_size=16, seed=123), **kwargs)
  actor = GraspActor(learner, port_sink,
                     env=ToyGraspEnv(image_size=16, seed=123), **kwargs)
  if greedy:
    fixed = np.random.default_rng(3).uniform(-1, 1, (8, 2)).astype(
        np.float32)
    jax_actor.update_state("acting")
    actor.update_state("acting")
    jax_actor._policy = lambda state, obs, key: jnp.asarray(fixed)
    actor._policy = lambda state, obs, generator=None: torch.from_numpy(
        fixed)
  return jax_actor, jax_sink, jax_replay, actor, port_sink, replay


@pytest.mark.parametrize("greedy", [False, True])
@pytest.mark.parametrize("sink", ["buffer", "service"])
def test_actor_commits_what_jax_commits(sink, greedy):
  jax_actor, jax_sink, jax_replay, actor, port_sink, replay = _actor_pair(
      sink, greedy)
  rewards = [(jax_actor.collect_once(), actor.collect_once())
             for _ in range(4)]
  for a, b in rewards:
    assert a == b
  if sink == "service":
    for s in (jax_sink, port_sink):
      s.close()
    assert port_sink.metrics_scalars() == jax_sink.metrics_scalars()
  want, got = _rows(jax_replay.store), _rows(replay.store)
  assert list(got) == list(want)
  for key in want:
    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
  assert (actor.episodes_collected, actor.episodes_dropped,
          actor.reward_sum) == (jax_actor.episodes_collected,
                                jax_actor.episodes_dropped,
                                jax_actor.reward_sum) == (32, 0,
                                                          actor.reward_sum)
  if greedy:
    # ε=0.3 mixed random and greedy actions: both kinds landed.
    actions = got["action"][:8]
    fixed = np.random.default_rng(3).uniform(-1, 1, (8, 2))
    greedy_rows = np.all(actions == fixed.astype(np.float32), axis=1)
    assert 0 < greedy_rows.sum() < 8


class _FlakyEnv(ToyGraspEnv):
  """Raises on its 3rd reset only."""

  calls = 0

  def reset_batch(self, n):
    self.calls += 1
    if self.calls == 3:
      raise RuntimeError("env crashed")
    return super().reset_batch(n)


class _JaxFlakyEnv(jax_env_lib.ToyGraspEnv):
  calls = 0

  def reset_batch(self, n):
    self.calls += 1
    if self.calls == 3:
      raise RuntimeError("env crashed")
    return super().reset_batch(n)


def _wait(cond, secs=60.0):
  deadline = time.monotonic() + secs
  while not cond():
    assert time.monotonic() < deadline, "timed out"
    time.sleep(0.005)


def test_actor_crash_and_restart_count_as_in_jax():
  counts = []
  for learner, replay_cls, service_cls, actor_cls, env_cls in (
      (_jax_learner(), JaxReplay, JaxService, jax_actor_lib.GraspActor,
       _JaxFlakyEnv),
      (_port_learner(), ReplayBuffer, ReplayWriteService, GraspActor,
       _FlakyEnv)):
    replay = replay_cls(learner.transition_specification(), capacity=512)
    service = service_cls(replay.store, queue_batches=64)
    actor = actor_cls(learner, service, env=env_cls(image_size=16, seed=1),
                      batch_episodes=4, seed=2, name="robot")
    actor.start()
    _wait(lambda: actor.crashed)
    assert "env crashed" in repr(actor.crash_error)
    crashed_at = actor.episodes_collected
    actor.start()                       # the restart
    _wait(lambda: actor.episodes_collected >= crashed_at + 8)
    actor.stop()
    assert not actor.crashed and actor._thread is None
    service.close()
    scalars = service.metrics_scalars()
    counts.append((crashed_at, scalars["replay_actor_restarts"],
                   scalars["replay_aborted_episodes"]))
  assert counts[0] == counts[1] == (8, 1.0, 0.0)


def test_server_wired_actor_chunks_and_attributes_params_versions():
  learner = _port_learner("fused")
  state = learner.create_state(seed=0)
  server = CEMPolicyServer(learner, state.train_state, max_batch=4, seed=7,
                           device="cpu")
  replay = ReplayBuffer(learner.transition_specification(), capacity=64)
  actor = GraspActor(learner, replay, env=ToyGraspEnv(image_size=16, seed=1),
                     batch_episodes=10, epsilon=0.0, seed=3,
                     policy_server=server)
  try:
    d0 = server.engine.dispatch_count
    actor.collect_once()                 # served before any handoff
    assert server.engine.dispatch_count - d0 == 3   # chunks of 4, 4, 2
    actor.update_state(acting_copy(state.train_state))
    actor.collect_once()
  finally:
    server.close()
  assert actor.episodes_by_policy_version == {0: 10, 1: 10}
  assert actor.last_policy_version == 1 == server.params_version
  assert len(replay) == 20


def test_refresh_hook_hands_a_copy_without_the_optimizer():
  learner = _port_learner()
  ts = learner.create_state(seed=0).train_state
  received = []

  class Sink:
    def update_state(self, state):
      received.append(state)

    def start(self):
      received.append("started")

    def stop(self):
      received.append("stopped")

  hook = ActorStateRefreshHook(Sink())
  hook.begin(learner.model, "unused")
  hook.after_checkpoint(4, ts, "unused")
  hook.end(4, ts, "unused")
  started, acting, stopped = received
  assert (started, stopped) == ("started", "stopped")
  assert acting.opt_state is None and ts.opt_state is not None
  for key, value in ts.params.items():
    assert torch.equal(acting.params[key], value)
    assert acting.params[key].data_ptr() != value.data_ptr()
  assert ActorStateRefreshHook.drives_online_collection


# ---- evaluation and the hooks ----


def _converted_pair(cem_select):
  jax_learner = _jax_learner(cem_select)
  jax_state = jax.jit(lambda k: jax_learner.create_state(k, batch_size=2))(
      jax.random.PRNGKey(0))
  ts = jax_state.train_state
  stats = jax.device_get(ts.batch_stats)
  modules = {m for m, _ in convert._walk(stats)}
  port_ts = TrainState(
      step=0, params=convert.convert_params(jax.device_get(ts.params),
                                            modules),
      batch_stats=convert.convert_batch_stats(stats))
  return jax_learner, ts, _port_learner(cem_select), port_ts


def _jax_noise(seed, iterations, shape):
  """The noise JAX's policy draws from `PRNGKey(seed)`."""
  keys = jax.random.split(jax.random.PRNGKey(seed), iterations)
  return torch.from_numpy(np.stack(
      [np.asarray(jax.random.normal(k, shape)) for k in keys]))


@pytest.mark.parametrize("cem_select", ["lax", "fused"])
def test_evaluate_grasp_policy_equals_jax(cem_select):
  jax_learner, jax_ts, learner, ts = _converted_pair(cem_select)
  kwargs = dict(num_episodes=64, image_size=16, seed=3)
  want = jax_env_lib.evaluate_grasp_policy(jax_learner, jax_ts, **kwargs)
  got = evaluate_grasp_policy(learner, ts,
                              noise=_jax_noise(3, 1, (64, 8, 2)), **kwargs)
  assert got == want
  assert 0.0 < want["random_baseline_success_rate"] < 1.0
  # With the learner's own generator: the same baseline, a valid rate.
  own = evaluate_grasp_policy(learner, ts, **kwargs)
  assert own["random_baseline_success_rate"] == got[
      "random_baseline_success_rate"]
  assert 0.0 <= own["success_rate"] <= 1.0


def test_qtopt_success_hook_writes_what_jax_writes(tmp_path):
  jax_learner, jax_ts, learner, ts = _converted_pair("lax")
  eval_kwargs = dict(num_episodes=32, image_size=16, seed=5)
  jax_hook = JaxQTOptHook(jax_learner, eval_kwargs=eval_kwargs,
                          every_n_checkpoints=2)
  hook = QTOptSuccessEvalHook(
      learner, eval_kwargs=dict(eval_kwargs,
                                noise=_jax_noise(5, 1, (32, 8, 2))),
      every_n_checkpoints=2)
  for h, state, d in ((jax_hook, jax_ts, "jax"), (hook, ts, "port")):
    h.begin(None, str(tmp_path / d))
    for step in (10, 20, 30):
      h.after_checkpoint(step, state, str(tmp_path / d))
  want, got = (read_records(str(tmp_path / d / "metrics_success_eval.jsonl"))
               for d in ("jax", "port"))
  assert [r["step"] for r in got] == [10, 30]
  for row in got + want:
    row.pop("wall")   # the write's time
  assert got == want


class _JaxStubModel:
  """action = (−w · gripper xy, 1): the stub policy of the hook test."""

  @staticmethod
  def predict_step(state, features):
    pose = features["gripper_pose"][:, :2]
    return {"action": jnp.concatenate(
        [-pose * state["w"], jnp.ones((pose.shape[0], 1))], axis=1)}


class _StubModel:

  @staticmethod
  def predict_step(state, features):
    pose = features["gripper_pose"][:, :2]
    return {"action": torch.cat(
        [-pose * state.params["w"], torch.ones((pose.shape[0], 1))], dim=1)}


def test_success_hook_drives_the_gripper_eval_as_jax(tmp_path):
  kwargs = dict(num_episodes=3, image_size=24, seed=4)
  jax_hook = JaxSuccessHook(jax_evaluate_gripper, eval_kwargs=kwargs,
                            tag="gripper")
  hook = SuccessEvalHook(evaluate_gripper_policy, eval_kwargs=kwargs,
                         tag="gripper")
  jax_hook.begin(_JaxStubModel(), str(tmp_path / "jax"))
  jax_hook.after_checkpoint(7, {"w": jnp.float32(5.0)}, str(tmp_path / "jax"))
  hook.begin(_StubModel(), str(tmp_path / "port"))
  hook.after_checkpoint(7, TrainState(step=7, params={"w": torch.tensor(5.0)},
                                      batch_stats={}), str(tmp_path / "port"))
  (want,), (got,) = (read_records(str(tmp_path / d / "metrics_gripper.jsonl"))
                     for d in ("jax", "port"))
  assert set(got) == set(want)
  for key in ("success_rate", "mean_final_distance", "num_episodes"):
    np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
  assert got["step"] == want["step"] == 7


# ---- the online loop and the entry point ----


def test_online_train_qtopt_with_refresh_hook_and_service(tmp_path,
                                                          monkeypatch):
  learner = _port_learner()
  env = ToyGraspEnv(image_size=16, seed=0)
  replay = ReplayBuffer(learner.transition_specification(), capacity=256,
                        seed=0)
  replay.add(env.sample_transitions(64))
  service = ReplayWriteService(replay.store, queue_batches=4)
  actor = GraspActor(learner, service, env=ToyGraspEnv(image_size=16, seed=1),
                     batch_episodes=8, epsilon=0.3, seed=2)
  depths = []
  real = prefetch_lib.DevicePrefetcher

  def recording_prefetcher(stream, device, buffer_size):
    depths.append(buffer_size)
    return real(stream, device, buffer_size=buffer_size)

  monkeypatch.setattr(prefetch_lib, "DevicePrefetcher", recording_prefetcher)

  class Probe(Hook):
    alive = []

    def after_step(self, step, metrics):
      if step == 4:   # the actor collects while the learner trains
        _wait(lambda: actor.episodes_collected > 0)
      self.alive.append(actor._thread is not None
                        and actor._thread.is_alive())

  model_dir = str(tmp_path / "online")
  state = train_qtopt(
      learner, model_dir, replay_buffer=replay, max_train_steps=8,
      batch_size=16, save_checkpoints_steps=4, log_every_steps=4,
      hooks=[QTOptSuccessEvalHook(learner, eval_kwargs=dict(
          num_episodes=16, image_size=16)),
             ActorStateRefreshHook([actor]), Probe()])
  service.close()
  assert state.step == 8
  assert Probe.alive == [True] * 8
  assert actor._thread is None and not actor.crashed
  assert actor.episodes_collected > 0 and len(replay) > 64
  assert depths == [1]
  train = read_records(os.path.join(model_dir, "metrics_train.jsonl"))
  assert [r["step"] for r in train] == [4, 8]
  assert {"replay_fill", "replay_adds_per_sec", "replay_size",
          "replay_staleness_mean_steps", "replay_sampled_batches",
          "input_wait_fraction"} <= set(train[-1])
  evals = read_records(os.path.join(model_dir, "metrics_success_eval.jsonl"))
  assert [r["step"] for r in evals] == [4, 8]
  assert {"success_rate", "random_baseline_success_rate"} <= set(evals[0])


def test_run_success_protocol_online_and_qtopt_at_test_size(tmp_path, capsys):
  assert protocol.main(["online", "--small", "--device", "cpu",
                        "--out_dir", str(tmp_path)]) == 0
  with open(tmp_path / "qtopt_online_vs_offline.jsonl") as f:
    rows = [json.loads(line) for line in f]
  assert [r["phase"] for r in rows] == ["offline"] * 2 + ["online"] * 2 + [
      "summary"]
  assert [r["step"] for r in rows[:4]] == [4, 8, 12, 16]
  summary = rows[-1]
  online = summary["online"]
  assert summary["online_episodes_collected"] == online[
      "episodes_collected"] > 0
  assert not online["actor_crashed"] and online["serving_dispatches"] > 0
  assert online["ingestion"]["replay_committed_transitions"] >= online[
      "episodes_collected"]
  assert online["staleness"]["rows"] > 0
  for phase in ("offline", "online"):
    assert 0.0 <= summary[phase]["input_wait_fraction"] <= 1.0
    assert summary[phase]["grad_steps_per_sec"] > 0
    assert summary[phase]["grad_steps_per_wall_sec"] > 0
  assert protocol.main(["qtopt", "--small", "--device", "cpu",
                        "--out_dir", str(tmp_path / "q"),
                        "--cem_select", "lax"]) == 0
  with open(tmp_path / "q" / "qtopt_flagship_success_eval.jsonl") as f:
    assert [json.loads(line)["step"] for line in f] == [4, 8]
  printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
  assert [p["artifact"] for p in printed] == [
      "qtopt_online_vs_offline.jsonl", "qtopt_flagship_success_eval.jsonl"]


def test_protocol_rates_are_total_steps_over_total_time(tmp_path):
  """A phase's rate is its steps past the first log interval over their
  wall time, and its wait share the wait over that time: a slow
  interval (a checkpoint's evaluation, a stall) moves them, where it
  leaves the median of the intervals as it was."""
  from tensor2robot_tpu_torch.train_eval import MetricLogger
  logger = MetricLogger(str(tmp_path))
  # (step, steps/s, wait share): the first interval holds the capture.
  for step, rate, wait in ((200, 10.0, 0.5), (300, 100.0, 0.2),
                           (400, 100.0, 0.2), (500, 20.0, 0.8),
                           (600, 100.0, 0.2), (700, 50.0, 0.6)):
    logger.write("train", step, {"grad_steps_per_sec": rate,
                                 "input_wait_fraction": wait})
  logger.close()
  rates = protocol._rates(str(tmp_path), 100, 600)
  secs = [1.0, 1.0, 5.0, 1.0]  # the intervals past the first
  assert rates["grad_steps_per_sec"] == pytest.approx(400 / sum(secs))
  assert rates["input_wait_fraction"] == pytest.approx(
      (0.2 + 0.2 + 0.8 * 5 + 0.2) / sum(secs))
  assert rates["median_grad_steps_per_sec"] == 100.0
  assert rates["median_input_wait_fraction"] == pytest.approx(0.2)
  assert rates["per_interval_grad_steps_per_sec"] == [10.0, 100.0, 100.0,
                                                      20.0, 100.0]


def _jax_seedcheck_pass():
  """The JAX protocol's seedcheck pass (`scripts/run_success_protocol.py`
  `one_pass`), its sample schedule and staleness."""
  from tensor2robot_tpu.replay import ReplayBatchSampler as JaxSampler

  learner = JaxLearner(JaxGraspingQModel(**_SMALL), **_CEM)
  replay = JaxReplay(learner.transition_specification(), capacity=1024,
                     seed=0)
  service = JaxService(replay.store, queue_batches=8, overflow="drop")
  actor = jax_actor_lib.GraspActor(
      learner, service, env=jax_env_lib.ToyGraspEnv(image_size=16, seed=123),
      batch_episodes=16, epsilon=0.3, seed=11)
  sampler = JaxSampler(replay.store, batch_size=32, record_schedule=True)
  actor.update_state(learner.create_state(jax.random.PRNGKey(0)))
  for cycle in range(6):
    actor.collect_once()
    service.flush()
    replay.store.set_learner_step(cycle)
    sampler.sample()
  service.close()
  return (sampler.schedule_digest(),
          sampler.staleness_snapshot()["mean_age_steps"],
          actor.episodes_collected)


@pytest.mark.parametrize("cem_select", ["lax", "fused"])
def test_seedcheck_is_reproducible_and_draws_the_jax_schedule(cem_select,
                                                              capsys):
  assert protocol.main(["seedcheck", "--device", "cpu", "--cem_select",
                        cem_select]) == 0
  out = json.loads(capsys.readouterr().out.splitlines()[-1])
  assert out["reproducible"] and out["run_a"] == out["run_b"]
  # The rows drawn are the store's, whatever the policy acted: the
  # schedule, the staleness and the episodes equal the JAX pass's.
  digest, staleness, episodes = _jax_seedcheck_pass()
  assert (out["run_a"]["sample_schedule_sha256"],
          out["run_a"]["staleness_mean"],
          out["run_a"]["episodes"]) == (digest, staleness, episodes) == (
              digest, staleness, 96)


def test_entry_points_default_to_the_card():
  with pytest.raises(RuntimeError, match="cuda"):
    protocol.build_learner(protocol.SMALL, 1e-3)
