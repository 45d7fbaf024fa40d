"""The port's alert sentinel and flight recorder (`telemetry/sentinel.py`,
`telemetry/flightrec.py`) against the JAX package's, on the CPU.

  * On the same scalar series, the port's `Sentinel` fires on the same
    evaluations and writes the same `alerts.jsonl` records as JAX's
    (every field but the wall-clock stamp), for each rule kind, warm-up,
    sustain, hysteresis, role-prefixed keys, and the act/page tiers.
  * `default_watches()` and `fleet_watches()` equal JAX's, at their
    defaults and with gin bindings.
  * `flightrec.dump` / `read_dumps` round-trip in JAX's format: each
    package reads the other's dumps.
  * Each trainer (`train_qtopt`, `train_eval_model`, `train_anakin`)
    runs the sentinel at log cadence: a forced breach (an RSS budget of
    one byte) lands in `<model_dir>/telemetry/alerts.jsonl` with JAX's
    record fields and dumps a flight record.
"""

import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from tensor2robot_tpu import config as jax_gin  # noqa: E402
from tensor2robot_tpu.telemetry import flightrec as jax_flightrec  # noqa: E402
from tensor2robot_tpu.telemetry import sentinel as jax_sentinel  # noqa: E402
from tensor2robot_tpu_torch import config as port_gin  # noqa: E402
from tensor2robot_tpu_torch import envs  # noqa: E402
from tensor2robot_tpu_torch import train_eval  # noqa: E402
from tensor2robot_tpu_torch.data import RandomInputGenerator  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import (  # noqa: E402
    GraspingQModel,
    QTOptLearner,
)
from tensor2robot_tpu_torch.research.qtopt.train_qtopt import (  # noqa: E402
    train_qtopt,
)
from tensor2robot_tpu_torch.telemetry import core as tcore  # noqa: E402
from tensor2robot_tpu_torch.telemetry import flightrec  # noqa: E402
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402
from tensor2robot_tpu_torch.telemetry import perf as perf_lib  # noqa: E402
from tensor2robot_tpu_torch.telemetry import sentinel  # noqa: E402
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel  # noqa: E402

# Every field of an alert record but its wall-clock stamp.
_STAMP = "wall"


@pytest.fixture(autouse=True)
def _isolated():
  tcore.reset_for_tests()
  tmetrics.reset_for_tests()
  perf_lib.stop_resource_sampler()
  perf_lib.set_plane_enabled(None)
  yield
  perf_lib.stop_resource_sampler()
  perf_lib.set_plane_enabled(None)
  tcore.reset_for_tests()
  tmetrics.reset_for_tests()
  port_gin.clear_config()
  jax_gin.clear_config()


def _series(kind, seed, n=24):
  """A seeded scalar series with a regime change half way: healthy
  values around 1, then a drop (or a rise) the rule should see."""
  rng = np.random.default_rng(seed)
  base = 1.0 + 0.02 * rng.standard_normal(n)
  shift = {"ewma_drop": 0.4, "below": 0.4, "ewma_spike": 1.8,
           "above": 1.8, "increase": 1.0}[kind]
  if kind == "increase":
    return list(np.cumsum(rng.integers(0, 2, n)).astype(float))
  out = list(base)
  for i in range(n // 2, n):
    out[i] = out[i] * shift
  # A recovery, then a second breach: hysteresis must re-arm.
  out[-4] = 1.0
  out[-3:] = [v * shift for v in out[-3:]]
  return [float(v) for v in out]


_WATCHES = [
    dict(name="drop", metric="m", kind="ewma_drop", threshold=0.25,
         warmup=3, sustain=2),
    dict(name="spike", metric="m", kind="ewma_spike", threshold=0.3,
         warmup=2, sustain=1, alpha=0.5),
    dict(name="hi", metric="m", kind="above", threshold=1.5, sustain=2),
    dict(name="lo", metric="m", kind="below", threshold=0.5, warmup=0),
    dict(name="inc", metric="m", kind="increase", threshold=0.0),
    dict(name="paged", metric="m", kind="above", threshold=1.5,
         severity="page"),
    dict(name="acted", metric="m", kind="ewma_spike", threshold=0.3,
         severity="act"),
    dict(name="logged", metric="m", kind="below", threshold=0.5,
         severity="log"),
]


def _run(module, watch_kwargs, series, path, handled):
  pages, acts = [], []

  def on_act(record):
    acts.append(record["rule"])
    return handled

  s = module.Sentinel([module.Watch(**watch_kwargs)], alerts_path=path,
                      on_page=lambda r: pages.append(r["rule"]),
                      on_act=on_act)
  fired = []
  for step, value in enumerate(series):
    # Role-prefixed twins (the fleet's aggregated view) ride along.
    scalars = {"m": value, "actor-1/m": value * 1.01, "other": 0.0}
    fired.append([r["metric"] for r in s.evaluate(scalars, step=step)])
  s.close()
  return fired, pages, acts, module.read_alerts(path)


@pytest.mark.parametrize("handled", [False, True], ids=["open", "handled"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("watch", _WATCHES, ids=[w["name"] for w in _WATCHES])
def test_same_series_same_alert_records(tmp_path, watch, seed, handled):
  series = _series(watch["kind"], seed)
  port = _run(sentinel, watch, series, str(tmp_path / "port.jsonl"),
              handled)
  jax = _run(jax_sentinel, watch, series, str(tmp_path / "jax.jsonl"),
             handled)
  assert port[:3] == jax[:3]
  strip = lambda rs: [{k: v for k, v in r.items() if k != _STAMP}  # noqa: E731
                      for r in rs]
  assert strip(port[3]) == strip(jax[3])
  assert any(port[0]) or watch["kind"] in ("below",)


def test_watch_validation_messages_equal_jax():
  for kwargs in (dict(kind="sideways"), dict(severity="shrug"),
                 dict(alpha=0.0)):
    with pytest.raises(ValueError) as port:
      sentinel.Watch(name="x", metric="m", **kwargs)
    with pytest.raises(ValueError) as jax:
      jax_sentinel.Watch(name="x", metric="m", **kwargs)
    assert str(port.value) == str(jax.value)


def _asdicts(watches):
  return [dataclasses.asdict(w) for w in watches]


def test_standing_watch_sets_equal_jax():
  assert _asdicts(sentinel.default_watches()) == _asdicts(
      jax_sentinel.default_watches())
  assert _asdicts(sentinel.fleet_watches()) == _asdicts(
      jax_sentinel.fleet_watches())
  bindings = ("default_watches.host_rss_budget_bytes = 1e9",
              "default_watches.recompile_severity = 'page'",
              "fleet_watches.rpc_timeout_severity = 'page'",
              "fleet_watches.replay_fill_max = 0.9")
  port_gin.parse_config("\n".join(bindings))
  jax_gin.parse_config("\n".join(bindings))
  assert _asdicts(sentinel.default_watches()) == _asdicts(
      jax_sentinel.default_watches())
  assert _asdicts(sentinel.fleet_watches()) == _asdicts(
      jax_sentinel.fleet_watches())
  assert sentinel.ALERTS_FILENAME == jax_sentinel.ALERTS_FILENAME


def test_flight_records_round_trip_between_packages(tmp_path):
  tmetrics.counter("fleet.rpc.retries").inc(3)
  tcore.configure("learner")
  with tcore.span("learner.step", step=4):
    pass
  port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
  path = flightrec.dump(port_dir, "learner: RuntimeError('x')",
                        extra={"fault": "learner_crash"})
  assert os.path.basename(path) == f"learner-{os.getpid()}.json"
  jax_flightrec.dump(jax_dir, "learner: RuntimeError('x')",
                     extra={"fault": "learner_crash"}, role="learner")
  (port_read,) = jax_flightrec.read_dumps(port_dir)
  (jax_read,) = flightrec.read_dumps(jax_dir)
  assert set(port_read) == set(jax_read)
  assert port_read["role"] == jax_read["role"] == "learner"
  assert port_read["extra"] == {"fault": "learner_crash"}
  assert port_read["metrics"]["counters"]["fleet.rpc.retries"] == 3.0
  assert [s["name"] for s in port_read["spans"]] == ["learner.step"]
  assert flightrec.flightrec_dir("/m") == jax_flightrec.flightrec_dir("/m")
  # A torn or foreign file is skipped, not raised.
  with open(os.path.join(port_dir, "torn.json"), "w") as f:
    f.write("{")
  assert len(flightrec.read_dumps(port_dir)) == 1


def _jax_record_keys():
  """The fields of a page-severity record as JAX's sentinel writes it."""
  s = jax_sentinel.Sentinel([jax_sentinel.Watch(
      name="rss_over_budget", metric="rsrc.host_rss_bytes", kind="above",
      threshold=1.0, warmup=0, sustain=1, severity="page")])
  (record,) = s.evaluate({"rsrc.host_rss_bytes": 2.0}, step=1)
  return set(record)


def _tiny_learner():
  return QTOptLearner(
      GraspingQModel(image_size=16, torso_filters=(8,), head_filters=(8,),
                     dense_sizes=(16,), action_dim=2),
      cem_population=8, cem_iterations=1, cem_elites=2, device="cpu")


def _train_qtopt(model_dir):
  train_qtopt(learner=_tiny_learner(), model_dir=model_dir,
              prefill_random=True, max_train_steps=8, batch_size=16,
              log_every_steps=4, save_checkpoints_steps=8, seed=0)


def _train_eval(model_dir):
  train_eval.train_eval_model(
      model=MockT2RModel(), model_dir=model_dir,
      input_generator_train=RandomInputGenerator(batch_size=16),
      max_train_steps=8, log_every_steps=4, save_checkpoints_steps=8,
      eval_steps=0, device="cpu")


def _train_anakin(model_dir):
  envs.train_anakin(learner=_tiny_learner(), model_dir=model_dir,
                    env_family="pose", num_envs=16, rollout_length=2,
                    train_batches_per_iter=4, batch_size=16,
                    replay_capacity=128, max_train_steps=8,
                    log_every_steps=4, save_checkpoints_steps=8, seed=0)


@pytest.mark.parametrize("trainer", [_train_qtopt, _train_eval,
                                     _train_anakin],
                         ids=["train_qtopt", "train_eval_model",
                              "train_anakin"])
def test_trainer_lands_a_forced_breach_in_alerts_jsonl(tmp_path, trainer):
  port_gin.bind_parameter("default_watches.host_rss_budget_bytes", 1.0)
  model_dir = str(tmp_path)
  trainer(model_dir)
  alerts = sentinel.read_alerts(
      os.path.join(model_dir, "telemetry", sentinel.ALERTS_FILENAME))
  assert jax_sentinel.read_alerts(
      os.path.join(model_dir, "telemetry", "alerts.jsonl")) == alerts
  # Fired once, at the second log (the first is the rule's warm-up).
  (alert,) = [a for a in alerts if a["rule"] == "rss_over_budget"]
  assert set(alert) == _jax_record_keys()
  assert alert["step"] == 8
  assert alert["severity"] == alert["escalation"] == "page"
  assert alert["metric"] == "rsrc.host_rss_bytes" and alert["value"] > 1.0
  # The page tier dumped this process's flight record.
  dumps = flightrec.read_dumps(flightrec.flightrec_dir(model_dir))
  assert any("sentinel page: alert.rss_over_budget" in d["reason"]
             for d in dumps)
  assert tmetrics.registry().snapshot()["counters"]["alert.paged"] == 1.0


def test_plane_off_builds_no_sentinel(tmp_path):
  perf_lib.set_plane_enabled(False)
  assert sentinel.build_for_run(str(tmp_path)) is None
  perf_lib.set_plane_enabled(True)
  assert sentinel.build_for_run(str(tmp_path), enabled=False) is None
  assert isinstance(sentinel.build_for_run(str(tmp_path)),
                    sentinel.Sentinel)
