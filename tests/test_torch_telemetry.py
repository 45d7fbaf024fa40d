"""The port's telemetry (span tracer, metrics registry) against the JAX
package's `telemetry/core.py` and `telemetry/metrics.py`.

The same observations go into both registries: the snapshots must be
equal (bucket counts, sums, min/max, the interpolated p50/p95), and so
must `scalars_from_snapshot`. A span or an event recorded by both
tracers writes the same keys to `trace_<role>.jsonl`. The two registries
and tracers are distinct objects: a process that imports both packages
shares nothing between them.
"""

import json
import os
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from tensor2robot_tpu.telemetry import core as jax_core  # noqa: E402
from tensor2robot_tpu.telemetry import metrics as jax_metrics  # noqa: E402
from tensor2robot_tpu_torch import telemetry  # noqa: E402
from tensor2robot_tpu_torch.telemetry import core  # noqa: E402
from tensor2robot_tpu_torch.telemetry import metrics  # noqa: E402


@pytest.fixture(autouse=True)
def _isolated():
  core.reset_for_tests()
  metrics.reset_for_tests()
  yield
  core.reset_for_tests()
  metrics.reset_for_tests()


def _observations(seed):
  rng = np.random.default_rng(seed)
  # Log-spread latencies across every bucket, exact bounds and overflow.
  values = list(np.exp(rng.uniform(np.log(0.01), np.log(20000.0), 400)))
  values += list(metrics.DEFAULT_MS_BOUNDS) + [0.0, 1e6]
  return [float(v) for v in values]


@pytest.mark.parametrize("bounds", [metrics.DEFAULT_MS_BOUNDS,
                                    metrics.DEFAULT_STEP_BOUNDS,
                                    (1, 2, 4, 8, 16, 32, 64, 128, 256)])
def test_histograms_and_quantiles_match_jax(bounds):
  assert metrics.DEFAULT_MS_BOUNDS == jax_metrics.DEFAULT_MS_BOUNDS
  assert metrics.DEFAULT_STEP_BOUNDS == jax_metrics.DEFAULT_STEP_BOUNDS
  ours, theirs = metrics.Histogram(bounds), jax_metrics.Histogram(bounds)
  for i, value in enumerate(_observations(len(bounds))):
    n = 1 + i % 3
    ours.observe(value, n=n)
    theirs.observe(value, n=n)
  assert ours.snapshot() == theirs.snapshot()
  for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
    assert ours.quantile(q) == theirs.quantile(q), q
  assert metrics.Histogram(bounds).quantile(0.5) == 0.0


def test_registry_snapshot_and_scalars_match_jax():
  ours, theirs = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
  for reg in (ours, theirs):
    reg.counter("serving.a.dispatches").inc(3)
    reg.counter("serving.a.dispatches").inc()
    reg.gauge("serving.arena.resident_models").set(2)
    reg.gauge("serving.arena.resident_models").set(3)
    hist = reg.histogram("serving.a.bucket_8_ms")
    for value in (0.2, 0.4, 1.0, 3.0, 90.0):
      hist.observe(value)
    reg.histogram("serving.empty_ms")  # no observations: no scalars
  snap = ours.snapshot()
  assert snap == theirs.snapshot()
  assert set(snap) == {"counters", "gauges", "histograms"}
  assert snap["counters"]["serving.a.dispatches"] == 4.0
  assert snap["gauges"]["serving.arena.resident_models"] == 3.0
  for kwargs in ({}, {"prefix": "host/"}, {"name_filter": "serving.a."}):
    assert (metrics.scalars_from_snapshot(snap, **kwargs)
            == jax_metrics.scalars_from_snapshot(snap, **kwargs))
  flat = ours.scalars()
  assert flat["serving.a.bucket_8_ms_count"] == 5.0
  assert "serving.empty_ms_p50" not in flat
  assert ours.scalars("serving.arena.") == {
      "serving.arena.resident_models": 3.0}
  ours.reset()
  assert ours.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_module_accessors_use_the_port_registry_alone():
  metrics.counter("shared.name").inc(2)
  metrics.gauge("g").set(1.5)
  metrics.histogram("h_ms").observe(3.0)
  assert metrics.registry() is telemetry.registry()
  assert metrics.registry() is not jax_metrics.registry()
  snap = metrics.registry().snapshot()
  assert snap["counters"]["shared.name"] == 2.0
  assert "shared.name" not in jax_metrics.registry().snapshot()["counters"]
  metrics.reset_for_tests()
  assert metrics.registry().snapshot()["counters"] == {}


def test_counter_exact_under_threads():
  counter = metrics.MetricsRegistry().counter("c")
  threads = [threading.Thread(
      target=lambda: [counter.inc() for _ in range(5_000)])
      for _ in range(8)]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  assert counter.value == 40_000.0


def _lines(path):
  with open(path) as f:
    return [json.loads(line) for line in f]


def test_trace_lines_have_the_jax_keys(tmp_path):
  """Span, event and meta lines of both tracers carry the same keys and
  values (but times, pid and thread), in `trace_<role>.jsonl`."""
  records = {}
  for name, mod in (("port", core), ("jax", jax_core)):
    out = tmp_path / name
    tracer = mod.Tracer().configure("host", trace_dir=str(out))
    with tracer.span("serving.dispatch", bucket=8, rows=3):
      pass
    tracer.event("serving.swap_state", version=2, learner_step=7)
    tracer.set_clock_offset(0.25)
    with pytest.raises(ValueError):
      with tracer.span("failing"):
        raise ValueError("boom")
    tracer.close()
    records[name] = _lines(out / "trace_host.jsonl")
  port, ref = records["port"], records["jax"]
  assert len(port) == len(ref) == 5
  volatile = {"ts", "dur", "pid", "tid", "wall0", "mono0"}
  for got, want in zip(port, ref):
    assert set(got) == set(want)
    assert ({k: v for k, v in got.items() if k not in volatile}
            == {k: v for k, v in want.items() if k not in volatile})
  spans = [r for r in port if r["ph"] == "X"]
  assert [s["name"] for s in spans] == ["serving.dispatch",
                                        "serving.swap_state", "failing"]
  assert spans[0]["args"] == {"bucket": 8, "rows": 3}
  assert spans[1]["dur"] == 0.0
  assert spans[2]["args"] == {"error": "ValueError"}
  assert all(s["role"] == "host" and s["pid"] == os.getpid() for s in spans)
  metas = [r for r in port if r["ph"] == "M"]
  assert [m["clock_offset"] for m in metas] == [0.0, 0.25]


def test_ring_bound_and_accounting_under_threads():
  tracer = core.Tracer().configure("churn", capacity=256)
  per_thread = 2000

  def hammer(i):
    for _ in range(per_thread):
      with tracer.span("work", thread=i):
        pass

  threads = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  total = 4 * per_thread
  assert tracer.capacity == 256
  assert tracer.spans_recorded == total
  assert tracer.pending == 256
  assert tracer.spans_dropped == total - 256
  assert all(s["name"] == "work" and s["role"] == "churn"
             for s in tracer.snapshot_spans())


def test_auto_flush_writes_every_span(tmp_path):
  tracer = core.Tracer().configure("w", trace_dir=str(tmp_path))
  for _ in range(3 * core.FLUSH_BATCH):
    tracer.event("tick")
  assert tracer.spans_dropped == 0
  assert tracer.pending < core.FLUSH_BATCH
  tracer.close()
  spans = [r for r in _lines(tmp_path / "trace_w.jsonl") if r["ph"] == "X"]
  assert len(spans) == 3 * core.FLUSH_BATCH


def test_module_level_tracer_role_and_disabled_path(tmp_path):
  assert core.current_role() == "trainer"
  with telemetry.span("ignored"):
    pass
  telemetry.event("ignored")
  assert core.get_tracer().pending == 0  # disabled until configured
  telemetry.configure("learner", trace_dir=str(tmp_path))
  assert core.current_role() == "learner"
  with telemetry.span("step", k=1):
    pass
  core.get_tracer().close()
  spans = [r for r in _lines(tmp_path / "trace_learner.jsonl")
           if r["ph"] == "X"]
  assert [s["name"] for s in spans] == ["step"]


@pytest.mark.parametrize("t_before,t_after,host", [
    (10.0, 10.5, 10.25), (3.0, 3.0, 5.0), (100.0, 100.002, 99.0)])
def test_clock_offset_matches_jax(t_before, t_after, host):
  assert (core.clock_offset_from_handshake(host, t_before, t_after)
          == jax_core.clock_offset_from_handshake(host, t_before, t_after))


def test_engine_and_batcher_publish_their_metrics():
  """The engine's dispatch/swap counters, per-bucket histogram, span and
  swap event; the batcher's queue-depth gauge, rows histogram and span —
  under the names the JAX modules use."""
  import torch
  from tensor2robot_tpu_torch.models.abstract_model import TrainState
  from tensor2robot_tpu_torch.serving import BucketedServingEngine
  from tensor2robot_tpu_torch.serving import MicroBatcher

  state = TrainState(step=0, params={"w": torch.eye(4) * 3.0},
                     batch_stats={})
  engine = BucketedServingEngine(
      lambda st, feats: {"y": feats["x"] @ st.params["w"]}, state,
      {"x": np.zeros((1, 4), np.float32)}, max_batch=4, device="cpu",
      metric_prefix="serving.t.")
  core.configure("host")
  engine.warmup()
  engine.predict({"x": np.ones((3, 4), np.float32)})
  engine.swap_state(state, learner_step=5)
  with MicroBatcher(engine, max_wait_us=0) as batcher:
    batcher.predict({"x": np.ones((1, 4), np.float32)})
  snap = metrics.registry().snapshot()
  # Warm-up runs each bucket once but counts no dispatch (the JAX
  # engine's warm-up compiles and dispatches nothing).
  assert snap["counters"]["serving.t.dispatches"] == 2.0
  assert snap["counters"]["serving.t.swaps"] == 1.0
  assert snap["histograms"]["serving.t.bucket_4_ms"]["count"] == 1
  assert snap["histograms"]["serving.t.bucket_1_ms"]["count"] == 1
  assert snap["histograms"]["serving.microbatch_rows"]["count"] == 1
  assert "serving.microbatch_queue_depth" in snap["gauges"]
  names = [s["name"] for s in core.get_tracer().snapshot_spans()]
  assert names.count("serving.dispatch") == 2
  assert names.count("serving.swap_state") == 1
  assert names.count("serving.microbatch_dispatch") == 1
  swap = [s for s in core.get_tracer().snapshot_spans()
          if s["name"] == "serving.swap_state"][0]
  assert swap["args"] == {"version": 1, "learner_step": 5}


# ---- the metrics-record envelope (records.py) ----


def test_records_carry_the_process_role(tmp_path):
  """`make_record` and `MetricLogger` default to the configured role,
  as the JAX package's do; an explicit role wins."""
  from tensor2robot_tpu_torch.telemetry import records
  from tensor2robot_tpu_torch.train_eval import MetricLogger

  assert records.make_record(1, {"x": 1.0})["role"] == "trainer"
  telemetry.configure("learner")
  assert records.make_record(1, {"x": 1.0})["role"] == "learner"
  assert records.make_record(1, {}, role="actor-0")["role"] == "actor-0"
  for role, sub in ((None, "default"), ("evaluator", "explicit")):
    logger = MetricLogger(str(tmp_path / sub), role=role)
    logger.write("train", 3, {"loss": 0.5})
    logger.close()
    [record] = _lines(tmp_path / sub / "metrics_train.jsonl")
    assert record["role"] == (role or "learner")
    assert records.validate_record(record) == []


_RECORDS = [
    {"step": 1, "wall": 2.5, "role": "trainer", "payload": {"loss": 0.1}},
    {"step": 1, "wall": 2, "role": "learner", "payload": {}},
    {"step": 1, "wall": 2.5, "role": "trainer"},
    {"step": 1.0, "wall": 2.5, "role": "trainer", "payload": {}},
    {"step": True, "wall": 2.5, "role": "trainer", "payload": {}},
    {"step": 1, "wall": "now", "role": "", "payload": {"a": "b"}},
    {"step": 1, "wall": 2.5, "role": "trainer", "payload": [1.0]},
    {"step": 1, "wall": 2.5, "role": "trainer", "payload": {"ok": True},
     "extra": 1},
    {"step": 1, "wall": 2.5, "role": "trainer", "payload": {3: 1.0}},
    {"step": 7, "loss": 0.25, "grad_norm": 1.5},
    {"step": 7, "wall": 1.0, "success_rate": 0.5},
    [1, 2],
    "not a record",
]


@pytest.mark.parametrize("record", _RECORDS, ids=range(len(_RECORDS)))
def test_validate_and_normalize_record_match_jax(record):
  from tensor2robot_tpu.telemetry import records as jax_records
  from tensor2robot_tpu_torch.telemetry import records

  assert records.validate_record(record) == jax_records.validate_record(
      record)
  assert records.ENVELOPE_KEYS == jax_records.ENVELOPE_KEYS
  if isinstance(record, dict) and not isinstance(
      record.get("payload", {}), list):
    assert records.normalize_record(record) == (
        jax_records.normalize_record(record))


def test_read_records_normalizes_legacy_flat_records(tmp_path):
  from tensor2robot_tpu.telemetry import records as jax_records
  from tensor2robot_tpu_torch.telemetry import records

  path = tmp_path / "metrics_train.jsonl"
  lines = [records.make_record(5, {"loss": 0.5}, wall=1.0),
           {"step": 10, "loss": 0.25, "grad_norm": 2.0}]
  path.write_text("".join(json.dumps(r) + "\n" for r in lines) + "\n")
  got = records.read_records(str(path))
  assert got == jax_records.read_records(str(path))
  assert got[1] == {"step": 10, "loss": 0.25, "grad_norm": 2.0}
