"""ControlRule (port of `control/rules.py`): the policy plane's
condition→action grammar.

A rule watches ONE metric of the orchestrator's aggregated scalar
view (the exact payload `fleet_metrics.jsonl` records) and names the
actuator to drive when its condition holds. The grammar extends the
sentinel's (telemetry/sentinel.py) with the three properties a loop
that ACTS — instead of merely alerting — cannot live without:

  * WINDOWS — the condition is evaluated over the rolling mean of the
    last `window` observations, so one noisy poll cannot actuate;
  * HYSTERESIS — after a rule fires it DISARMS until the windowed
    value crosses back over the `clear` bound (defaults to the
    threshold itself; set a band, e.g. fire above 150 ms / re-arm
    below 120 ms, to keep a signal hovering at the threshold from
    flapping the actuator);
  * COOLDOWNS — `cooldown_secs` is the minimum spacing between two
    actuations of the SAME rule, even across re-arms, so an actuator
    whose effect takes time to land (a scale-up warming a replica)
    is never stacked.

Condition kinds:

  kind        fires while
  ----------  ----------------------------------------------------
  above       windowed value > threshold
  below       windowed value < threshold
  ewma_drop   windowed value < ewma · (1 − threshold)
  ewma_spike  windowed value > ewma · (1 + threshold)
  rate_above  per-second delta of a counter > threshold
  rate_below  per-second delta of a counter < threshold

Like the sentinel, the EWMA baseline absorbs only NON-breaching
values (a sustained drop cannot normalize itself away) and `warmup`
evaluations can never fire. `sustain` consecutive breaching
evaluations are required before the rule triggers.

In the aggregated view metrics arrive role-prefixed
(``front0/serving.policy.request_ms_p95``). `aggregate` chooses how
the matching keys combine: ``mean``/``max``/``min``/``sum`` fold them
into one fleet-wide value, while ``each`` evaluates every key
separately with per-key state — the slow-host shape, where the
decision carries the offending ROLE so a targeted actuator
(kill-and-respawn) knows whom to kick.

The package imports neither torch nor CUDA.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

from tensor2robot_tpu_torch import config as gin

KINDS = ("above", "below", "ewma_drop", "ewma_spike",
         "rate_above", "rate_below")
AGGREGATES = ("mean", "max", "min", "sum", "each")


@gin.configurable
@dataclasses.dataclass(frozen=True)
class ControlRule:
  """One ordered condition→action rule (see the module docstring)."""

  name: str = gin.REQUIRED
  metric: str = gin.REQUIRED    # flat scalar key (histograms: _p50/_p95)
  action: str = gin.REQUIRED    # actuator name (controller validates)
  kind: str = "above"
  threshold: float = 0.0
  # Hysteresis re-arm bound; None = the threshold (re-arm as soon as
  # the condition stops holding). Must sit on the HEALTHY side of the
  # threshold; ignored by the ewma/rate kinds (they re-arm on any
  # non-breaching evaluation, like the sentinel).
  clear: Optional[float] = None
  window: int = 1               # rolling-mean width (observations)
  warmup: int = 0               # evaluations before the rule can fire
  sustain: int = 1              # consecutive breaches required
  alpha: float = 0.2            # EWMA smoothing factor
  cooldown_secs: float = 60.0   # min spacing between actuations
  aggregate: str = "mean"       # fold role-prefixed twins, or "each"
  # Opaque kwargs handed to the actuator (e.g. {"delta": 1, "max": 8}).
  action_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
  # Sentinel alert name this rule REMEDIATES: when the sentinel is
  # about to page for `alert`, the controller tries this rule first
  # and a successful actuation demotes the page to the act tier
  # (the escalation path). "" = not an alert remediation.
  alert: str = ""

  def __post_init__(self):
    if self.kind not in KINDS:
      raise ValueError(f"rule {self.name!r}: kind must be one of "
                       f"{KINDS}, got {self.kind!r}")
    if self.aggregate not in AGGREGATES:
      raise ValueError(f"rule {self.name!r}: aggregate must be one of "
                       f"{AGGREGATES}, got {self.aggregate!r}")
    if self.window < 1 or self.sustain < 1:
      raise ValueError(
          f"rule {self.name!r}: window and sustain must be >= 1")
    if self.warmup < 0 or self.cooldown_secs < 0:
      raise ValueError(
          f"rule {self.name!r}: warmup and cooldown_secs must be >= 0")
    if not 0.0 < self.alpha <= 1.0:
      raise ValueError(f"rule {self.name!r}: alpha must be in (0, 1]")
    if self.clear is not None:
      if self.kind == "above" and self.clear > self.threshold:
        raise ValueError(
            f"rule {self.name!r}: clear ({self.clear}) must be <= "
            f"threshold ({self.threshold}) for kind='above'")
      if self.kind == "below" and self.clear < self.threshold:
        raise ValueError(
            f"rule {self.name!r}: clear ({self.clear}) must be >= "
            f"threshold ({self.threshold}) for kind='below'")


class RuleState:
  """Per-(rule, metric-key) evaluation state."""

  __slots__ = ("values", "ewma", "last", "last_t", "seen", "streak",
               "armed", "last_fired")

  def __init__(self, window: int):
    self.values = collections.deque(maxlen=window)
    self.ewma: Optional[float] = None
    self.last: Optional[float] = None     # rate kinds: previous value
    self.last_t: Optional[float] = None   # ...and its monotonic stamp
    self.seen = 0
    self.streak = 0
    self.armed = True
    self.last_fired = float("-inf")       # monotonic actuation stamp


def resolve_metric(metric: str, aggregate: str,
                   scalars: Dict[str, float]) -> List[Tuple[str, float]]:
  """The (key, value) targets one rule evaluates this pass.

  Matches the bare metric plus every role-prefixed twin (the
  sentinel's matching rule); `aggregate="each"` returns every match,
  anything else folds them into one value keyed by the bare metric.
  Empty when the metric is absent (a rule over a not-yet-published
  metric simply does not evaluate).
  """
  suffix = "/" + metric
  found: List[Tuple[str, float]] = []
  for key in scalars:
    if key == metric or key.endswith(suffix):
      try:
        found.append((key, float(scalars[key])))
      except (TypeError, ValueError):
        continue
  if not found:
    return []
  found.sort()
  if aggregate == "each":
    return found
  values = [v for _, v in found]
  if aggregate == "max":
    folded = max(values)
  elif aggregate == "min":
    folded = min(values)
  elif aggregate == "sum":
    folded = sum(values)
  else:
    folded = sum(values) / len(values)
  return [(metric, folded)]


def evaluate(rule: ControlRule, state: RuleState, observed: float,
             now: Optional[float] = None) -> Dict[str, Any]:
  """One observation through one rule's window/hysteresis machinery.

  Returns ``{"triggered", "value", "baseline", "breached"}`` —
  `value` is the windowed mean actually compared, `baseline` the EWMA
  or rate denominator where applicable. Cooldown is NOT applied here
  (the controller owns the actuation clock); `triggered` means the
  condition held, sustained, while armed — and the rule has now
  DISARMED itself until the clear bound is crossed.
  """
  if now is None:
    now = time.monotonic()
  state.values.append(float(observed))
  value = sum(state.values) / len(state.values)
  warming = state.seen < rule.warmup
  baseline: Optional[float] = None
  breached = False
  if rule.kind == "above":
    breached = value > rule.threshold
  elif rule.kind == "below":
    breached = value < rule.threshold
  elif rule.kind in ("rate_above", "rate_below"):
    if state.last is not None and state.last_t is not None:
      span = max(now - state.last_t, 1e-9)
      rate = (value - state.last) / span
      baseline = rate
      breached = (rate > rule.threshold if rule.kind == "rate_above"
                  else rate < rule.threshold)
    state.last = value
    state.last_t = now
  else:  # ewma_drop / ewma_spike
    baseline = state.ewma
    if state.ewma is not None:
      if rule.kind == "ewma_drop":
        breached = value < state.ewma * (1.0 - rule.threshold)
      else:
        breached = value > state.ewma * (1.0 + rule.threshold)
    if state.ewma is None:
      state.ewma = value
    elif warming or not breached:
      # The baseline only absorbs healthy values: a sustained breach
      # cannot drag its own baseline along and silence itself.
      state.ewma += rule.alpha * (value - state.ewma)
  state.seen += 1
  if warming:
    return {"triggered": False, "value": value, "baseline": baseline,
            "breached": False}
  if not state.armed:
    # Disarmed (the rule fired): re-arm only once the windowed value
    # crosses the clear bound on the healthy side. The ewma/rate
    # kinds re-arm on any non-breaching evaluation — their baseline
    # moves, so a fixed clear bound has no stable meaning.
    clear = rule.threshold if rule.clear is None else rule.clear
    if rule.kind == "above":
      rearmed = value <= clear
    elif rule.kind == "below":
      rearmed = value >= clear
    else:
      rearmed = not breached
    if rearmed:
      state.armed = True
      state.streak = 0
    return {"triggered": False, "value": value, "baseline": baseline,
            "breached": breached}
  if not breached:
    state.streak = 0
    return {"triggered": False, "value": value, "baseline": baseline,
            "breached": False}
  state.streak += 1
  if state.streak < rule.sustain:
    return {"triggered": False, "value": value, "baseline": baseline,
            "breached": True}
  state.armed = False  # hysteresis: hold until the clear bound
  state.streak = 0
  return {"triggered": True, "value": value, "baseline": baseline,
          "breached": True}
