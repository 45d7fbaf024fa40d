"""Prometheus text-format adapter over `MetricsRegistry.snapshot()`
(port of `telemetry/prometheus.py`).

The registry every subsystem publishes into (replay, serving, trainers,
the fleet) becomes scrapeable by an external Prometheus: this module
only translates the fixed snapshot schema (telemetry/metrics.py) into
the text exposition format (version 0.0.4), byte for byte as the JAX
module does:

  * counters  → ``<name>_total`` with ``# TYPE ... counter``;
  * gauges    → ``<name>`` with ``# TYPE ... gauge``;
  * histograms → CUMULATIVE ``<name>_bucket{le="..."}`` series (the
    registry stores per-bucket counts; Prometheus wants running
    totals) plus ``_sum``/``_count``, with ``le="+Inf"`` closing the
    series.

Metric names sanitize to ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (dots and
dashes — the registry's namespacing convention — become underscores).

PER-TENANT LABELS: the serving tier publishes tenant-scoped metrics
under ``serving.<tenant>.<rest>`` (engine dispatch histograms, front
completion counters, admission shed counters). The
adapter renders the tenant as a LABEL instead of a name: every tenant's
``serving.a.bucket_8_ms`` / ``serving.b.bucket_8_ms`` lands in ONE
``t2r_serving_bucket_8_ms`` family with ``tenant="a"`` / ``tenant="b"``
series — the Prometheus data model for the same metric across
entities, so dashboards aggregate and alert across tenants without
per-tenant queries. The segments ``arena``/``front``/``admission`` are
RESERVED namespaces (arena pool gauges etc.), never tenants; tenant
ids are validated against the reservation at registration
(`serving.arena.RESERVED_TENANT_IDS` — kept in sync by a cross-module
test).

`serve()` is the ~endpoint: a daemon-threaded stdlib HTTP server
answering ``GET /metrics``, snapshotting at scrape time. It imports
neither torch nor CUDA, so an actor can expose its own scrape port.
"""

from __future__ import annotations

import http.server
import re
import threading
from typing import Dict, Optional

from tensor2robot_tpu_torch.telemetry import metrics as metrics_lib

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Middle segments of `serving.<x>.*` that are serving SUBSYSTEM
# namespaces, not tenants. Must cover serving/arena.py's
# RESERVED_TENANT_IDS (tenant registration rejects these ids; a
# cross-module test pins the two sets against each other).
RESERVED_SERVING_NAMESPACES = frozenset({"arena", "front", "admission"})


def _sanitize(name: str) -> str:
  name = _NAME_RE.sub("_", name)
  if not name or name[0].isdigit():
    name = "_" + name
  return name


def _fmt(value) -> str:
  return repr(float(value))


def _split_tenant(name: str):
  """`serving.<tenant>.<rest>` → (`serving.<rest>`, tenant); anything
  else (incl. the reserved serving namespaces) passes through."""
  parts = name.split(".")
  if (len(parts) >= 3 and parts[0] == "serving"
      and parts[1] not in RESERVED_SERVING_NAMESPACES):
    return "serving." + ".".join(parts[2:]), parts[1]
  return name, None


def _escape_label(value: str) -> str:
  return (value.replace("\\", r"\\").replace('"', r'\"')
          .replace("\n", r"\n"))


def _labels(tenant: Optional[str], extra: str = "") -> str:
  items = []
  if tenant is not None:
    items.append(f'tenant="{_escape_label(tenant)}"')
  if extra:
    items.append(extra)
  return "{" + ",".join(items) + "}" if items else ""


def render_text(snapshot: Optional[Dict] = None,
                prefix: str = "t2r_") -> str:
  """One scrape body from a registry snapshot (default: the
  process-wide registry, snapshotted now). Tenant-scoped serving
  metrics merge into one family per metric with a ``tenant`` label;
  each family's ``# TYPE`` line is emitted exactly once."""
  if snapshot is None:
    snapshot = metrics_lib.registry().snapshot()
  lines = []

  def families_of(section):
    """name → family metric + per-series (tenant, payload) rows,
    grouped so multi-tenant series share one TYPE header."""
    families: Dict[str, list] = {}
    for name, payload in section.items():
      base, tenant = _split_tenant(name)
      families.setdefault(base, []).append((tenant, payload))
    for base in sorted(families):
      # Stable series order: unlabeled first, then tenants sorted.
      series = sorted(families[base],
                      key=lambda row: (row[0] is not None, row[0]))
      yield base, series

  for base, series in families_of(snapshot.get("counters", {})):
    metric = prefix + _sanitize(base)
    if not metric.endswith("_total"):
      metric += "_total"
    lines.append(f"# TYPE {metric} counter")
    for tenant, value in series:
      lines.append(f"{metric}{_labels(tenant)} {_fmt(value)}")
  for base, series in families_of(snapshot.get("gauges", {})):
    metric = prefix + _sanitize(base)
    lines.append(f"# TYPE {metric} gauge")
    for tenant, value in series:
      lines.append(f"{metric}{_labels(tenant)} {_fmt(value)}")
  for base, series in families_of(snapshot.get("histograms", {})):
    metric = prefix + _sanitize(base)
    lines.append(f"# TYPE {metric} histogram")
    for tenant, hist in series:
      running = 0
      for bound, count in zip(hist["bounds"], hist["counts"]):
        running += count
        bucket_labels = _labels(tenant, f'le="{_fmt(bound)}"')
        lines.append(f"{metric}_bucket{bucket_labels} {running}")
      inf_labels = _labels(tenant, 'le="+Inf"')
      lines.append(f'{metric}_bucket{inf_labels} {hist["count"]}')
      lines.append(f"{metric}_sum{_labels(tenant)} {_fmt(hist['sum'])}")
      lines.append(f"{metric}_count{_labels(tenant)} {hist['count']}")
  return "\n".join(lines) + "\n"


class PrometheusEndpoint:
  """``GET /metrics`` over a daemon-threaded stdlib HTTP server."""

  def __init__(self, port: int = 0, host: str = "127.0.0.1",
               prefix: str = "t2r_"):
    endpoint = self

    class Handler(http.server.BaseHTTPRequestHandler):

      def do_GET(self):  # noqa: N802 — stdlib handler contract
        if self.path.split("?")[0] != "/metrics":
          self.send_error(404)
          return
        body = render_text(prefix=endpoint._prefix).encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

      def log_message(self, *args):  # scrapes stay out of stderr
        del args

    self._prefix = prefix
    self._server = http.server.ThreadingHTTPServer((host, port),
                                                   Handler)
    self.port = self._server.server_address[1]
    self._thread = threading.Thread(
        target=self._server.serve_forever, name="prometheus-scrape",
        daemon=True)
    self._thread.start()

  def close(self) -> None:
    self._server.shutdown()
    self._server.server_close()
    self._thread.join(timeout=5.0)


def serve(port: int = 0, host: str = "127.0.0.1",
          prefix: str = "t2r_") -> PrometheusEndpoint:
  """Starts (and returns) the scrape endpoint; `port=0` picks a free
  one (read it back from ``.port``)."""
  return PrometheusEndpoint(port=port, host=host, prefix=prefix)


def default_port(port: Optional[int] = None) -> Optional[int]:
  """The gin-backed default for `run_t2r_trainer --prometheus_port`:
  bind ``default_port.port`` in a config to start the
  scrape endpoint in ANY trainer/fleet process without passing the
  flag (0 = ephemeral port, None = off)."""
  return port


# Registered at import (the sentinel's watches already load the config
# engine with the telemetry package).
from tensor2robot_tpu_torch import config as _gin  # noqa: E402

default_port = _gin.configurable(default_port)
