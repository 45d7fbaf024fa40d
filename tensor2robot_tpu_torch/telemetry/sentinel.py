"""Alert sentinel (port of `telemetry/sentinel.py`): rule evaluation
over the metrics stream.

`Watch` rules (rolling-baseline EWMA and absolute bounds,
gin-configurable) are evaluated at the trainers' log cadence and the
fleet orchestrator's poll cadence over the flat scalar view the
registry produces. A breach

  * emits an ``alert.<rule>`` telemetry event and bumps the shared
    ``alert.fired`` counter and a per-rule counter,
  * appends one JSON record to ``alerts.jsonl`` beside the run's other
    telemetry files (the JAX package's record fields),
  * escalates through the severity tiers: ``log`` → record only;
    ``warn`` → the warning log; ``act`` → the caller's act hook;
    ``page`` → the act hook first (a remediation that reports the alert
    handled demotes the page to the act tier), and only an unremediated
    breach invokes the page hook. The trainers' page hook dumps a flight
    record; the fleet orchestrator dumps its own view and asks the host
    to dump, naming the offending role. The record's ``escalation``
    field names the tier reached.

Rule grammar:

  kind        breach condition
  ----------  ----------------------------------------------------
  above       value > threshold (absolute bound)
  below       value < threshold
  increase    value > last_value + threshold (counters: any warm-path
              increment with threshold 0)
  ewma_drop   value < ewma · (1 − threshold)  (threshold = fraction)
  ewma_spike  value > ewma · (1 + threshold)

`warmup` evaluations establish the baseline and can never fire;
`sustain` consecutive breaching evaluations are required to fire; a
fired rule holds (no re-fire) until one non-breaching evaluation re-arms
it, so a sustained regression fires exactly once. The EWMA baseline
only absorbs non-breaching values: a sustained drop cannot drag its own
baseline down and silence itself.

In the fleet's aggregated view metrics arrive role-prefixed
(``actor-0/fleet.rpc.timeouts``); a watch matches the bare metric in
every role, keeps per-role state, and the alert names the role.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.telemetry import core
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics
from tensor2robot_tpu_torch.telemetry import perf as perf_lib

log = logging.getLogger(__name__)

ALERTS_FILENAME = "alerts.jsonl"
KINDS = ("above", "below", "increase", "ewma_drop", "ewma_spike")
# Escalation tiers, mildest first. "act" asks the act hook to
# remediate and never pages; "page" tries the act hook first and pages
# only when unremediated.
SEVERITIES = ("log", "warn", "act", "page")


@gin.configurable
@dataclasses.dataclass(frozen=True)
class Watch:
  """One sentinel rule (see the module-docstring grammar)."""

  name: str = gin.REQUIRED        # -> alert.<name>
  metric: str = gin.REQUIRED      # flat scalar key (histograms: _p50/_p95)
  kind: str = "above"
  threshold: float = 0.0
  warmup: int = 1                 # evaluations before the rule can fire
  sustain: int = 1                # consecutive breaches required
  alpha: float = 0.2              # EWMA smoothing factor
  severity: str = "warn"

  def __post_init__(self):
    if self.kind not in KINDS:
      raise ValueError(f"watch {self.name!r}: kind must be one of "
                       f"{KINDS}, got {self.kind!r}")
    if self.severity not in SEVERITIES:
      raise ValueError(f"watch {self.name!r}: severity must be one of "
                       f"{SEVERITIES}, got {self.severity!r}")
    if not 0.0 < self.alpha <= 1.0:
      raise ValueError(f"watch {self.name!r}: alpha must be in (0, 1]")


class _WatchState:
  """Per-(watch, metric-key) evaluation state."""

  __slots__ = ("seen", "ewma", "last", "streak", "fired")

  def __init__(self):
    self.seen = 0
    self.ewma: Optional[float] = None
    self.last: Optional[float] = None
    self.streak = 0
    self.fired = False


class Sentinel:
  """Evaluates watches over flat scalar views at log cadence.

  `on_act(record) -> bool` is the remediation hook: it runs for
  ``act`` and ``page`` severities, and returning True on a page
  demotes it (the remediation acted, so no flight records).
  `on_page(record)` runs only for alerts that escalate to the page
  tier: the flight-recorder trigger stays terminal. Evaluation is
  cheap (a dict scan per watch) and never raises: a broken rule must
  not take down the train loop it instruments.
  """

  def __init__(self,
               watches: Sequence[Watch],
               alerts_path: Optional[str] = None,
               on_page: Optional[Callable[[Dict[str, Any]], None]] = None,
               registry: Optional[tmetrics.MetricsRegistry] = None,
               tracer: Optional[core.Tracer] = None,
               on_act: Optional[Callable[[Dict[str, Any]], bool]] = None):
    self.watches = list(watches)
    self._alerts_path = alerts_path
    self._on_page = on_page
    self._on_act = on_act
    # `tracer`: where alert.<rule> events land. None = the
    # process-global tracer; the fleet orchestrator passes its private
    # one (it may supervise from inside a process with its own
    # telemetry identity).
    self._tracer = tracer
    self._registry = registry or tmetrics.registry()
    self._states: Dict[tuple, _WatchState] = {}
    # One owner thread by design (the train loop or orchestrator poll
    # that calls evaluate()), like RpcClient: no lock is held across
    # the alert append's file I/O.
    self._file: Optional[Any] = None
    self.alerts: List[Dict[str, Any]] = []

  # ---- evaluation ----

  def _keys_for(self, metric: str,
                scalars: Dict[str, float]) -> List[str]:
    """The bare metric plus every role-prefixed twin (`role/metric`,
    the orchestrator's aggregated view)."""
    suffix = "/" + metric
    return [key for key in scalars
            if key == metric or key.endswith(suffix)]

  def _breach(self, watch: Watch, state: _WatchState,
              value: float) -> tuple:
    """(breached, baseline) for one observation; updates state's
    baseline bookkeeping (EWMA absorbs only non-breaching values)."""
    warming = state.seen < watch.warmup
    baseline: Optional[float] = None
    breached = False
    if watch.kind == "above":
      breached = value > watch.threshold
    elif watch.kind == "below":
      breached = value < watch.threshold
    elif watch.kind == "increase":
      baseline = state.last
      breached = (state.last is not None
                  and value > state.last + watch.threshold)
      state.last = value
    else:  # ewma_drop / ewma_spike
      baseline = state.ewma
      if state.ewma is not None:
        if watch.kind == "ewma_drop":
          breached = value < state.ewma * (1.0 - watch.threshold)
        else:
          breached = value > state.ewma * (1.0 + watch.threshold)
      if state.ewma is None:
        state.ewma = value
      elif warming or not breached:
        # The baseline only absorbs healthy values: a sustained
        # breach cannot normalize itself away.
        state.ewma += watch.alpha * (value - state.ewma)
    state.seen += 1
    if warming:
      return False, baseline  # warmup can never fire
    return breached, baseline

  def evaluate(self, scalars: Optional[Dict[str, float]] = None,
               step: Optional[int] = None) -> List[Dict[str, Any]]:
    """One evaluation pass; returns the alerts fired THIS pass.

    ``scalars`` defaults to this process's registry flat view; the
    orchestrator passes its aggregated role-prefixed payload instead.
    """
    if scalars is None:
      scalars = self._registry.scalars()
    fired: List[Dict[str, Any]] = []
    for watch in self.watches:
      for key in self._keys_for(watch.metric, scalars):
        try:
          value = float(scalars[key])
        except (TypeError, ValueError):
          continue
        state = self._states.setdefault((watch.name, key),
                                        _WatchState())
        breached, baseline = self._breach(watch, state, value)
        if not breached:
          state.streak = 0
          state.fired = False  # recovery re-arms the rule
          continue
        state.streak += 1
        if state.streak < watch.sustain or state.fired:
          continue  # not sustained yet / hysteresis hold
        state.fired = True
        fired.append(self._fire(watch, key, value, baseline, step))
    return fired

  # ---- firing ----

  def _fire(self, watch: Watch, key: str, value: float,
            baseline: Optional[float],
            step: Optional[int]) -> Dict[str, Any]:
    role = key.rsplit("/", 1)[0] if "/" in key else core.current_role()
    record: Dict[str, Any] = {
        "rule": watch.name,
        "metric": key,
        "role": role,
        "value": value,
        "baseline": baseline,
        "threshold": watch.threshold,
        "kind": watch.kind,
        "severity": watch.severity,
        "wall": time.time(),
    }
    if step is not None:
      record["step"] = int(step)
    log.log(logging.INFO if watch.severity == "log" else logging.WARNING,
            "sentinel alert.%s: %s=%.6g (baseline %s, %s %s) "
            "severity=%s", watch.name, key, value, baseline,
            watch.kind, watch.threshold, watch.severity)
    (self._tracer.event if self._tracer is not None else core.event)(
        f"alert.{watch.name}", metric=key,
        value=round(value, 6), severity=watch.severity)
    self._registry.counter("alert.fired").inc()
    self._registry.counter(f"alert.{watch.name}").inc()
    # Escalation: act/page severities offer the alert to the
    # remediation hook first; a handled page demotes to the act tier
    # and flight records stay terminal.
    escalation = watch.severity
    if watch.severity in ("act", "page") and self._on_act is not None:
      handled = False
      try:
        handled = bool(self._on_act(record))
      except Exception:  # noqa: BLE001 — a broken remediation must
        # not mask the alert (nor block the page below).
        log.warning("sentinel act hook failed", exc_info=True)
      record["handled"] = handled
      if handled:
        self._registry.counter("alert.remediated").inc()
        if watch.severity == "page":
          escalation = "act"
    record["escalation"] = escalation
    self.alerts.append(record)
    self._append(record)
    if escalation == "page":
      self._registry.counter("alert.paged").inc()
      if self._on_page is not None:
        try:
          self._on_page(record)
        except Exception:  # noqa: BLE001 — forensics must not mask
          log.warning("sentinel page hook failed", exc_info=True)
    return record

  def _append(self, record: Dict[str, Any]) -> None:
    if not self._alerts_path:
      return
    try:
      if self._file is None:
        os.makedirs(os.path.dirname(self._alerts_path) or ".",
                    exist_ok=True)
        self._file = open(self._alerts_path, "a")
      self._file.write(json.dumps(record) + "\n")
      self._file.flush()
    except OSError:
      log.warning("could not append to %s; alert kept in memory only",
                  self._alerts_path, exc_info=True)

  def close(self) -> None:
    if self._file is not None:
      self._file.close()
      self._file = None


def read_alerts(path: str) -> List[Dict[str, Any]]:
  """All alert records of one ``alerts.jsonl`` (the report tool's
  reader; [] for a missing file — a quiet run writes none)."""
  alerts: List[Dict[str, Any]] = []
  if not os.path.exists(path):
    return alerts
  with open(path) as f:
    for line in f:
      line = line.strip()
      if not line:
        continue
      try:
        alerts.append(json.loads(line))
      except ValueError:
        continue  # a torn line from a dying writer
  return alerts


@gin.configurable
def default_watches(
    mfu_drop_fraction: float = 0.25,
    mfu_warmup: int = 4,
    mfu_sustain: int = 3,
    stall_fraction_max: float = 0.5,
    stall_sustain: int = 3,
    host_rss_budget_bytes: float = 0.0,
    recompile_severity: str = "warn",
) -> List[Watch]:
  """The trainers' standing rule set (gin-tunable thresholds).

  ``host_rss_budget_bytes=0`` disables the RSS budget watch (there is
  no universal default budget); set it per deployment.
  """
  watches = [
      # Sustained live-MFU drop vs the run's own rolling baseline.
      Watch(name="mfu_drop", metric="perf.mfu", kind="ewma_drop",
            threshold=mfu_drop_fraction, warmup=mfu_warmup,
            sustain=mfu_sustain),
      # Stall spike: the loop is losing most of its wall to
      # save/eval/log stalls.
      Watch(name="stall_spike", metric="train.stall_fraction",
            kind="above", threshold=stall_fraction_max,
            sustain=stall_sustain),
      # Any warm-path recompile: compile_cache.misses moved after the
      # first log interval.
      Watch(name="warm_recompile", metric="compile_cache.misses",
            kind="increase", threshold=0.0, warmup=1, sustain=1,
            severity=recompile_severity),
  ]
  if host_rss_budget_bytes:
    watches.append(
        Watch(name="rss_over_budget", metric="rsrc.host_rss_bytes",
              kind="above", threshold=host_rss_budget_bytes,
              sustain=1, severity="page"))
  return watches


@gin.configurable
def fleet_watches(
    recovery_p95_ms_max: float = 60000.0,
    rpc_timeout_severity: str = "warn",
    replay_fill_max: float = 1.01,
) -> List[Watch]:
  """The orchestrator's standing rules over the aggregated view.

  ``rpc_timeout_severity`` defaults to ``warn`` so routine chaos
  rehearsal (fault plans inject RPC faults on purpose) does not page;
  deployments that want the flight record set it to ``page``.
  """
  return [
      # `above 0`, not `increase`: the timeouts counter is CREATED
      # lazily by the first timeout, so the first value a poll ever
      # sees is already nonzero — an increase rule would baseline on
      # it and stay silent forever. Above-zero fires once (hysteresis
      # holds while the counter stays breached) — exactly one alert
      # per run with timeouts.
      Watch(name="rpc_timeouts", metric="fleet.rpc.timeouts",
            kind="above", threshold=0.0, warmup=0, sustain=1,
            severity=rpc_timeout_severity),
      Watch(name="recovery_p95", metric="fleet.recovery_ms_p95",
            kind="above", threshold=recovery_p95_ms_max, sustain=1),
      Watch(name="replay_overflow", metric="replay.fill",
            kind="above", threshold=replay_fill_max, sustain=2),
  ]


@gin.configurable(denylist=("model_dir",))
def build_for_run(model_dir: str,
                  enabled: bool = True,
                  watches: Optional[Sequence[Watch]] = None,
                  on_page: Optional[Callable] = None
                  ) -> Optional[Sentinel]:
  """The trainers' sentinel factory: default watches, alerts.jsonl
  under ``<model_dir>/telemetry/``, and a page hook that dumps this
  process's flight record to ``<model_dir>/flightrec/`` — the same
  artifact a crash gets. None when disabled (gin) or when the perf
  plane is off (`perf.plane_enabled`)."""
  if not enabled or not perf_lib.plane_enabled():
    return None
  if on_page is None:
    from tensor2robot_tpu_torch.telemetry import flightrec

    def on_page(record: Dict[str, Any]) -> None:
      flightrec.dump(
          flightrec.flightrec_dir(model_dir),
          f"sentinel page: alert.{record['rule']} on "
          f"{record['metric']} = {record['value']:.6g} "
          f"(role {record['role']})")

  return Sentinel(
      watches if watches is not None else default_watches(),
      alerts_path=os.path.join(model_dir, "telemetry",
                               ALERTS_FILENAME),
      on_page=on_page)
