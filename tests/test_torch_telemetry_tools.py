"""The port's run-reading tools against the JAX package's, on one run
directory written by the port's own telemetry (per-role traces with
handshake clock offsets and RPC pairs, a trainer's metrics records, the
orchestrator's aggregated polls, sentinel alerts, flight records):

  * `merge.merge_traces` gives the JAX tool's merged Chrome trace, and
    both command lines write the same file;
  * `report.build_report`, `render_markdown` and `has_content` give the
    JAX tool's report;
  * `prometheus.render_text` gives the JAX adapter's scrape body, byte
    for byte, and the endpoint serves it;
  * `run_t2r_trainer --prometheus_port 0` serves the process's registry
    (with the replay plane's `replay_adds`) for the run and stops after.
"""

import json
import os
import re
import socket
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

from tensor2robot_tpu.telemetry import merge as jax_merge  # noqa: E402
from tensor2robot_tpu.telemetry import prometheus as jax_prometheus  # noqa: E402
from tensor2robot_tpu.telemetry import report as jax_report  # noqa: E402
from tensor2robot_tpu_torch.bin import run_t2r_trainer  # noqa: E402
from tensor2robot_tpu_torch.telemetry import core as tcore  # noqa: E402
from tensor2robot_tpu_torch.telemetry import flightrec  # noqa: E402
from tensor2robot_tpu_torch.telemetry import merge  # noqa: E402
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402
from tensor2robot_tpu_torch.telemetry import prometheus  # noqa: E402
from tensor2robot_tpu_torch.telemetry import records as trecords  # noqa: E402
from tensor2robot_tpu_torch.telemetry import report  # noqa: E402
from tensor2robot_tpu_torch.telemetry import sentinel as sentinel_lib  # noqa: E402


@pytest.fixture(autouse=True)
def _isolate():
  tmetrics.reset_for_tests()
  yield
  tmetrics.reset_for_tests()
  tcore.reset_for_tests()


def _write_records(path, rows, role):
  with open(path, "w") as f:
    for step, payload in rows:
      f.write(json.dumps(trecords.make_record(
          step, payload, role=role, wall=1000.0 + step)) + "\n")


@pytest.fixture()
def run_dir(tmp_path):
  """One fleet-shaped run directory, written by the port."""
  run = tmp_path / "run"
  telemetry_dir = run / "telemetry"
  telemetry_dir.mkdir(parents=True)
  tracers = {}
  for role, offset in (("host", 0.0), ("actor-0", 0.25), ("learner", -0.5)):
    tracer = tcore.Tracer().configure(role, trace_dir=str(telemetry_dir))
    tracer.set_clock_offset(offset)
    tracers[role] = tracer
  for i in range(4):
    req = f"77-ab-{i}"
    with tracers["actor-0"].span("rpc_call.act", req=req):
      with tracers["host"].span("rpc.act", req=req):
        with tracers["host"].span("serving.dispatch", bucket=4, rows=i + 1):
          pass
    with tracers["learner"].span("learner.step", step=i):
      pass
  with tracers["actor-0"].span("rpc_call.commit", req="77-ab-dropped"):
    pass  # a dropped send: no handler twin, no flow
  tracers["host"].event("fleet.param_publish", step=8)
  for tracer in tracers.values():
    tracer.close()
  _write_records(str(run / "metrics_train.jsonl"), [
      (step, {"grad_steps_per_sec": 90.0 + step, "perf.mfu": 0.2 + step / 1e3,
              "perf.device_time_fraction": 0.75, "stall_fraction": 0.125,
              "rsrc.host_rss_bytes_peak": 2.0e9 + step})
      for step in (10, 20, 30)], role="learner")
  _write_records(str(telemetry_dir / "fleet_metrics.jsonl"), [
      (step, {"replay.adds": 64.0 * step, "replay.fill": step / 100.0,
              "learner/perf.mfu": 0.25, "host/rsrc.device_bytes_peak": 1.5e9,
              "front0/serving.policy.request_ms_p95": 12.5 + step})
      for step in (0, 8, 16)], role="orchestrator")
  sentinel = sentinel_lib.Sentinel(
      [sentinel_lib.Watch(name="fill", metric="replay.fill", kind="above",
                          threshold=0.1, warmup=0, severity="warn")],
      alerts_path=str(telemetry_dir / sentinel_lib.ALERTS_FILENAME),
      registry=tmetrics.MetricsRegistry())
  sentinel.evaluate({"replay.fill": 0.16})
  sentinel.close()
  tcore.get_tracer().configure("orchestrator")
  flightrec.dump(flightrec.flightrec_dir(str(run)), "fleet latched: demo",
                 extra={"heartbeat_ages_secs": {"host": 0.5}})
  return str(run)


def _jsonable(value):
  return json.loads(json.dumps(value))


def test_merge_traces_equals_jax(run_dir, tmp_path):
  trace_dir = os.path.join(run_dir, "telemetry")
  got = merge.merge_traces(trace_dir)
  want = jax_merge.merge_traces(trace_dir)
  assert _jsonable(got) == _jsonable(want)
  assert got["metadata"]["rpc_flows"] == 4
  assert merge.roles_in(got) == jax_merge.roles_in(want)
  assert merge.roles_with_spans(got) == ["actor-0", "host", "learner"]
  ts = [e["ts"] for e in got["traceEvents"] if e["ph"] == "X"]
  assert ts == sorted(ts)
  outs = []
  for main, name in ((merge.main, "port.json"), (jax_merge.main, "jax.json")):
    out = str(tmp_path / name)
    assert main(["--trace-dir", trace_dir, "--out", out]) == 0
    with open(out) as f:
      outs.append(json.load(f))
  assert outs[0] == outs[1]
  # A run that kept only its gzipped merge still reports its spans.
  kept = tmp_path / "kept"
  kept.mkdir()
  merge.merge_traces(trace_dir, out_path=str(kept / "merged_trace.json.gz"))
  assert report.build_report(str(kept))["span_summary"] == (
      report.build_report(run_dir)["span_summary"])


def test_report_equals_jax(run_dir, tmp_path):
  got = report.build_report(run_dir)
  want = jax_report.build_report(run_dir)
  assert _jsonable(got) == _jsonable(want)
  assert report.render_markdown(got) == jax_report.render_markdown(want)
  assert report.has_content(got) and jax_report.has_content(want)
  markdown = report.render_markdown(got)
  for heading in ("## Rates", "## Alerts", "## Span summary"):
    assert heading in markdown
  assert got["alerts"] and got["flight_records"]
  out_md, out_json = str(tmp_path / "r.md"), str(tmp_path / "r.json")
  assert report.main(["--run-dir", run_dir, "--out", out_md,
                      "--json", out_json]) == 0
  with open(out_md) as f:
    assert f.read().startswith("# Run report")
  empty = tmp_path / "empty"
  empty.mkdir()
  assert report.main(["--run-dir", str(empty)]) == 1


def _populated_snapshot():
  registry = tmetrics.MetricsRegistry()
  rng = np.random.default_rng(0)
  registry.counter("replay.adds").inc(4096)
  registry.counter("serving.policy.admission.admitted").inc(37)
  registry.counter("serving.batch.admission.dropped").inc(3)
  registry.counter("fleet.param_publishes").inc(4)
  registry.gauge("replay.fill").set(0.4375)
  registry.gauge("serving.arena.resident_models").set(2)
  registry.gauge("serving.front.goodput_rows_per_sec").set(120.5)
  for name in ("serving.policy.request_ms", "serving.batch.request_ms",
               "serving.policy.bucket_4_ms"):
    hist = registry.histogram(name)
    for value in rng.gamma(2.0, 8.0, size=50):
      hist.observe(float(value))
  lag = registry.histogram("fleet.param_refresh_lag_steps",
                           tmetrics.DEFAULT_STEP_BOUNDS)
  lag.observe(3, n=40)
  lag.observe(70, n=2)
  registry.histogram("rpc.act-ms").observe(1.25)
  return registry.snapshot()


def test_render_text_equals_jax_byte_for_byte():
  snapshot = _populated_snapshot()
  got = prometheus.render_text(snapshot)
  assert got == jax_prometheus.render_text(snapshot)
  assert got == jax_prometheus.render_text(snapshot, prefix="t2r_")
  assert prometheus.render_text(snapshot, prefix="x_") == (
      jax_prometheus.render_text(snapshot, prefix="x_"))
  assert 't2r_serving_request_ms_bucket{tenant="policy",le="+Inf"} 50' in got
  assert "# TYPE t2r_replay_adds_total counter" in got
  assert prometheus.RESERVED_SERVING_NAMESPACES == (
      jax_prometheus.RESERVED_SERVING_NAMESPACES)


def test_endpoint_serves_the_registry():
  tmetrics.counter("replay.adds").inc(5)
  endpoint = prometheus.serve(port=0)
  try:
    with urllib.request.urlopen(
        f"http://127.0.0.1:{endpoint.port}/metrics", timeout=30) as reply:
      assert reply.headers["Content-Type"] == prometheus.CONTENT_TYPE
      body = reply.read().decode()
    assert body == prometheus.render_text()
    with pytest.raises(urllib.error.HTTPError):
      urllib.request.urlopen(f"http://127.0.0.1:{endpoint.port}/other",
                             timeout=30)
  finally:
    endpoint.close()


def test_prometheus_port_flag_serves_the_run(monkeypatch, capsys, tmp_path):
  """`--prometheus_port 0` starts the endpoint before the trainer runs
  and stops it after: the scrape taken during the run lists the replay
  store's `replay_adds`."""
  scraped = {}

  def trainer(name, configs):
    from tensor2robot_tpu_torch import specs
    from tensor2robot_tpu_torch.replay.store import ReplayStore
    spec = specs.TensorSpecStruct()
    spec["x"] = specs.ExtendedTensorSpec(shape=(2,), dtype=np.float32,
                                         name="x")
    ReplayStore(spec, capacity=8).add({"x": np.ones((3, 2), np.float32)})
    port = int(re.search(r"serving /metrics on port (\d+)",
                         capsys.readouterr().out).group(1))
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as reply:
      scraped["body"] = reply.read().decode()
    scraped["port"] = port
    scraped["trainer"] = name

  monkeypatch.setattr(run_t2r_trainer, "_run_trainer", trainer)
  assert run_t2r_trainer.main(["--prometheus_port", "0",
                               "--trainer=qtopt"]) == 0
  assert scraped["trainer"] == "qtopt"
  assert "t2r_replay_adds_total 3" in scraped["body"]
  assert "t2r_replay_fill 0.375" in scraped["body"]
  with pytest.raises(OSError):
    socket.create_connection(("127.0.0.1", scraped["port"]), timeout=2.0)
