"""The port's replay plane publishes the JAX package's registry twins.

  * One scripted sequence of learner-step sets, adds (evicting, into
    several shards), samples and param-refresh-lag records goes through
    the JAX `ReplayStore`/`LagStats` and the port's: the `replay.*` and
    `fleet.param_refresh_lag_steps*` entries of the two packages'
    registry snapshots are equal, exactly.
  * The write service's twins (`replay.dropped_transitions`,
    `replay.aborted_episodes`, `replay.ingest_queue_depth`) after one
    drop and one aborted episode, made deterministic by holding the
    store's shard lock while the writer is parked on it: equal too.
  * A fleet at test width on the CPU lists `replay.adds` and
    `replay.fill` in its aggregated poll (`fleet_metrics.jsonl`), which
    the sentinel's `replay_overflow` watch and the control plane's
    actor rules read.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensor2robot_tpu import specs as jax_specs  # noqa: E402
from tensor2robot_tpu.replay import service as jax_service  # noqa: E402
from tensor2robot_tpu.replay import store as jax_store  # noqa: E402
from tensor2robot_tpu.telemetry import metrics as jax_tmetrics  # noqa: E402
from tensor2robot_tpu_torch import specs  # noqa: E402
from tensor2robot_tpu_torch.replay import service  # noqa: E402
from tensor2robot_tpu_torch.replay import store  # noqa: E402
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402

_PREFIXES = ("replay.", "fleet.param_refresh_lag_steps")
_SHAPES = {"image": ((4, 4, 3), np.uint8), "action": ((2,), np.float32),
           "reward": ((1,), np.float32)}


@pytest.fixture(autouse=True)
def _isolate():
  tmetrics.reset_for_tests()
  jax_tmetrics.reset_for_tests()
  yield
  tmetrics.reset_for_tests()
  jax_tmetrics.reset_for_tests()


def _spec(module):
  st = module.TensorSpecStruct()
  for key, (shape, dtype) in _SHAPES.items():
    st[key] = module.ExtendedTensorSpec(shape=shape, dtype=dtype, name=key)
  return st


def _batch(n, seed):
  rng = np.random.default_rng(seed)
  return {"image": rng.integers(0, 256, (n, 4, 4, 3), dtype=np.uint8),
          "action": rng.standard_normal((n, 2)).astype(np.float32),
          "reward": rng.random((n, 1)).astype(np.float32)}


def _twins(registry):
  """The replay-plane entries of a registry snapshot, by section."""
  snapshot = registry.snapshot()
  return {section: {name: value for name, value in entries.items()
                    if name.startswith(_PREFIXES)}
          for section, entries in snapshot.items()}


# (learner step, rows added, batch size sampled, (lag, rows, hop) records)
_SCRIPT = ((0, 5, 0, ()),
           (3, 9, 4, ((0, 5, None),)),
           (7, 13, 8, ((2, 9, 0), (5, 4, 1))),
           (12, 30, 16, ((1, 13, 0), (40, 2, 2), (0, 1, None))),
           (12, 2, 3, ()),
           (30, 11, 24, ((300, 11, 1), (5000, 3, 0))))


@pytest.mark.parametrize("num_shards", [1, 3])
def test_store_and_lag_twins_equal_jax(num_shards):
  stores = (jax_store.ReplayStore(_spec(jax_specs), capacity=24,
                                  num_shards=num_shards, seed=7),
            store.ReplayStore(_spec(specs), capacity=24,
                              num_shards=num_shards, seed=7))
  lags = (jax_service.LagStats(), service.LagStats())
  for i, (step, rows, sample, records) in enumerate(_SCRIPT):
    for s, lag_stats in zip(stores, lags):
      s.set_learner_step(step)
      s.add(_batch(rows, seed=i))
      if sample:
        s.sample_with_ages(sample)
      for lag, n, hop in records:
        lag_stats.record(lag, n, hop=hop)
  jax_twins = _twins(jax_tmetrics.registry())
  port_twins = _twins(tmetrics.registry())
  assert port_twins == jax_twins
  counters, gauges = port_twins["counters"], port_twins["gauges"]
  # A batch larger than the store keeps its last `capacity` rows.
  assert counters["replay.adds"] == sum(min(r, 24) for _, r, _, _ in _SCRIPT)
  assert counters["replay.evictions"] > 0
  assert counters["replay.samples"] == sum(b for _, _, b, _ in _SCRIPT)
  assert gauges["replay.fill"] == 1.0 and gauges["replay.learner_step"] == 30
  assert {"fleet.param_refresh_lag_steps",
          "fleet.param_refresh_lag_steps.hop0",
          "fleet.param_refresh_lag_steps.hop1",
          "fleet.param_refresh_lag_steps.hop2"} == set(
              port_twins["histograms"])
  # The plain fields are unchanged beside their twins.
  assert stores[1].metrics_snapshot() == stores[0].metrics_snapshot()


def _parked_service(module, store_module, spec_module):
  """A service whose writer holds one batch, parked on the store's
  shard lock (held by the caller), with an empty queue of one slot."""
  s = store_module.ReplayStore(_spec(spec_module), capacity=64, seed=0)
  svc = module.ReplayWriteService(s, queue_batches=1, overflow="drop")
  return s, svc


def test_service_twins_equal_jax():
  runs = []
  for module, store_module, spec_module, registry in (
      (jax_service, jax_store, jax_specs, jax_tmetrics.registry()),
      (service, store, specs, tmetrics.registry())):
    s, svc = _parked_service(module, store_module, spec_module)
    lock = s._shards[0].lock
    with lock:
      assert svc.put(_batch(3, seed=0))
      deadline = time.monotonic() + 30.0
      while svc._queue.qsize() and time.monotonic() < deadline:
        time.sleep(0.005)  # the writer takes the batch, then parks
      assert svc._queue.qsize() == 0
      assert svc.put(_batch(4, seed=1))       # the one queue slot
      assert not svc.put(_batch(5, seed=2))   # full: dropped, counted
      session = svc.session("actor-0")
      session.begin_episode()
      session.append(_batch(2, seed=3))
      svc.session("actor-0")                  # a restart aborts it
    assert svc.flush(timeout_secs=30.0)
    svc.close()
    runs.append(_twins(registry))
  jax_twins, port_twins = runs
  assert port_twins == jax_twins
  assert port_twins["counters"]["replay.dropped_transitions"] == 5
  assert port_twins["counters"]["replay.aborted_episodes"] == 1
  assert port_twins["gauges"]["replay.ingest_queue_depth"] == 1
  assert port_twins["counters"]["replay.adds"] == 7


def test_fleet_poll_lists_replay_twins(tmp_path):
  from tensor2robot_tpu_torch.fleet import orchestrator as orch
  config = orch.FleetConfig(
      num_actors=1, env="toy_grasp", image_size=16, action_dim=2,
      torso_filters=(8,), head_filters=(8,), dense_sizes=(16,),
      cem_population=8, cem_iterations=1, cem_elites=2,
      batch_size=16, max_train_steps=8, min_replay_size=32,
      publish_every_steps=8, log_every_steps=8, batch_episodes=8,
      serve_max_batch=4, replay_capacity=512, replay_shards=1,
      heartbeat_timeout_secs=0.0, launch_timeout_secs=240.0,
      run_timeout_secs=300.0, telemetry_poll_secs=0.5, seed=0,
      device="cpu")
  model_dir = str(tmp_path / "fleet")
  result = orch.run_fleet(model_dir=model_dir, config=config)
  assert result.clean_shutdown
  with open(os.path.join(model_dir, "telemetry", "fleet_metrics.jsonl")) as f:
    polls = [json.loads(line)["payload"] for line in f if line.strip()]
  last = polls[-1]
  # The last poll lands when the learner finishes; actors commit until
  # the shutdown barrier drains them.
  assert 0 < last["replay.adds"] <= result.metrics["store"]["adds_total"]
  assert last["replay.fill"] == pytest.approx(
      min(last["replay.adds"], config.replay_capacity)
      / config.replay_capacity)
  assert 0 < last["replay.learner_step"] <= config.max_train_steps
  assert last["fleet.param_refresh_lag_steps_count"] > 0
