"""The port's control plane (`tensor2robot_tpu_torch.control`) against the
JAX package's.

  * Counterparts of `tests/test_control.py`'s `TestRuleGrammar`,
    `TestController`, the escalation tiers, the degradation ladder and
    the standing policy table, on the port's modules.
  * One scripted stream of aggregated scalars, under one injected clock
    (each `step` is handed its `now`), through JAX's `Controller` and the
    port's, each over `fleet_rules()` and the `FleetConfig` control
    knobs parsed from `qtopt_fleet_autopilot.gin` by its own registry,
    with the standard actuators over one fake fleet each: the tables are
    equal, the decisions and their records equal field for field
    (timestamps aside), and `actors_scale_down`, `front_p95_scale_up`,
    `tenant_slo_retune`, `overload_shed` and `recovered_restore` each
    actuate. Dry run over the same stream charges the budget and never
    touches the fleet.
  * `import tensor2robot_tpu_torch.control` loads no JAX and initializes
    no CUDA (a new process).

No test waits on a clock: rule windows, cooldowns and the budget read
the `now` each call is given.
"""

import dataclasses
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from tensor2robot_tpu import config as jax_gin  # noqa: E402
from tensor2robot_tpu import control as jax_control  # noqa: E402
from tensor2robot_tpu.fleet import orchestrator as jax_orch  # noqa: E402
from tensor2robot_tpu.telemetry import metrics as jax_tmetrics  # noqa: E402
from tensor2robot_tpu_torch import config as port_gin  # noqa: E402
from tensor2robot_tpu_torch import control  # noqa: E402
from tensor2robot_tpu_torch.control import policies as policies_lib  # noqa: E402
from tensor2robot_tpu_torch.control import rules as rules_lib  # noqa: E402
from tensor2robot_tpu_torch.control.actuators import (  # noqa: E402
    ActuationError,
    Actuator,
    DegradationLadder,
    fleet_actuators,
)
from tensor2robot_tpu_torch.control.controller import (  # noqa: E402
    OUTCOMES,
    Controller,
    read_decisions,
)
from tensor2robot_tpu_torch.control.rules import ControlRule, RuleState  # noqa: E402
from tensor2robot_tpu_torch.fleet import orchestrator as orch  # noqa: E402
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402
from tensor2robot_tpu_torch.telemetry import records as trecords  # noqa: E402
from tensor2robot_tpu_torch.telemetry import sentinel as sentinel_lib  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_AUTOPILOT = "tensor2robot_tpu/research/qtopt/configs/qtopt_fleet_autopilot.gin"


def _rule(**kw):
  base = dict(name="r", metric="m", action="act", kind="above",
              threshold=10.0)
  base.update(kw)
  return ControlRule(**base)


def _evaluate_series(rule, values, t0=1000.0, dt=1.0):
  state = RuleState(rule.window)
  return [rules_lib.evaluate(rule, state, value, now=t0 + i * dt)["triggered"]
          for i, value in enumerate(values)]


class _Lever:
  """One recording actuator; optionally always raises."""

  def __init__(self, fail=False):
    self.calls = []
    self._fail = fail

  def __call__(self, params, decision):
    if self._fail:
      raise ActuationError("broken lever")
    self.calls.append((dict(params), decision["rule"]))
    return {"ok": True}


def _controller(rules, lever=None, **kw):
  lever = lever if lever is not None else _Lever()
  kw.setdefault("registry", tmetrics.MetricsRegistry())
  return Controller(rules, {"act": Actuator("act", lever)}, **kw), lever


class TestRuleGrammar:

  def test_window_mean_and_sustain(self):
    rule = _rule(window=2, sustain=2)
    assert _evaluate_series(rule, [20.0, 0.0, 30.0, 30.0]) == [
        False, False, False, True]

  def test_hysteresis_rearm_band(self):
    rule = _rule(threshold=10.0, clear=5.0, cooldown_secs=0.0)
    assert _evaluate_series(rule, [12.0, 12.0, 7.0, 4.0, 12.0]) == [
        True, False, False, False, True]

  def test_clear_must_sit_on_healthy_side(self):
    with pytest.raises(ValueError):
      _rule(kind="above", threshold=10.0, clear=11.0)
    with pytest.raises(ValueError):
      _rule(kind="below", threshold=10.0, clear=9.0)

  def test_ewma_drop_baseline_ignores_breaches(self):
    rule = _rule(kind="ewma_drop", threshold=0.5, warmup=2, alpha=0.5,
                 cooldown_secs=0.0)
    state = RuleState(rule.window)
    for i, value in enumerate([1.0, 1.0]):
      assert not rules_lib.evaluate(rule, state, value,
                                    now=1000.0 + i)["triggered"]
    result = rules_lib.evaluate(rule, state, 0.3, now=1002.0)
    assert result["triggered"]
    assert result["baseline"] == pytest.approx(1.0)
    assert state.ewma == pytest.approx(1.0)

  def test_rate_above_per_second(self):
    rule = _rule(kind="rate_above", threshold=5.0, warmup=1,
                 cooldown_secs=0.0)
    state = RuleState(rule.window)
    assert not rules_lib.evaluate(rule, state, 100.0, now=1000.0)["triggered"]
    result = rules_lib.evaluate(rule, state, 120.0, now=1002.0)
    assert result["triggered"]
    assert result["baseline"] == pytest.approx(10.0)

  def test_each_aggregate_resolves_roles(self):
    scalars = {"front0/perf.mfu": 0.4, "front1/perf.mfu": 0.1,
               "learner/perf.mfu": 0.5, "perf.mfux": 9.9}
    assert rules_lib.resolve_metric("perf.mfu", "each", scalars) == [
        ("front0/perf.mfu", 0.4), ("front1/perf.mfu", 0.1),
        ("learner/perf.mfu", 0.5)]
    assert rules_lib.resolve_metric("perf.mfu", "max", scalars) == [
        ("perf.mfu", 0.5)]
    assert rules_lib.resolve_metric("perf.mfu", "sum", scalars) == [
        ("perf.mfu", pytest.approx(1.0))]
    assert rules_lib.resolve_metric("absent", "mean", scalars) == []

  def test_bad_kind_aggregate_window_alpha_rejected(self):
    for bad in (dict(kind="sideways"), dict(aggregate="median"),
                dict(window=0), dict(sustain=0), dict(warmup=-1),
                dict(cooldown_secs=-1.0), dict(alpha=0.0)):
      with pytest.raises(ValueError):
        _rule(**bad)


class TestController:

  def test_cooldown_pin(self):
    ctrl, lever = _controller([_rule(cooldown_secs=60.0)], max_actions=10)
    ctrl.step({"m": 20.0}, now=1000.0)
    ctrl.step({"m": 20.0}, now=1001.0)
    assert [d["outcome"] for d in ctrl.decisions] == ["actuated"]
    ctrl.step({"m": 1.0}, now=1002.0)
    ctrl.step({"m": 20.0}, now=1003.0)
    assert [d["outcome"] for d in ctrl.decisions] == ["actuated", "cooldown"]
    assert ctrl.decisions[-1]["cooldown_remaining_secs"] > 0
    assert len(lever.calls) == 1
    ctrl.step({"m": 1.0}, now=1070.0)
    ctrl.step({"m": 20.0}, now=1071.0)
    assert len(lever.calls) == 2

  def test_global_budget_and_rule_order_determinism(self):
    rules = [_rule(name="first", cooldown_secs=0.0),
             _rule(name="second", cooldown_secs=0.0)]
    for _ in range(3):
      ctrl, lever = _controller(list(rules), max_actions=1,
                                budget_window_secs=0.0)
      ctrl.step({"m": 20.0}, now=1000.0)
      assert {d["rule"]: d["outcome"] for d in ctrl.decisions} == {
          "first": "actuated", "second": "budget"}
      assert [r for _, r in lever.calls] == ["first"]
      assert ctrl.budget_remaining(1000.0) == 0

  def test_budget_window_slides(self):
    ctrl, lever = _controller([_rule(cooldown_secs=0.0)], max_actions=1,
                              budget_window_secs=30.0)
    ctrl.step({"m": 20.0}, now=1000.0)
    ctrl.step({"m": 1.0}, now=1001.0)
    ctrl.step({"m": 20.0}, now=1002.0)
    assert [d["outcome"] for d in ctrl.decisions] == ["actuated", "budget"]
    ctrl.step({"m": 1.0}, now=1030.0)
    ctrl.step({"m": 20.0}, now=1040.0)
    assert ctrl.decisions[-1]["outcome"] == "actuated"
    assert len(lever.calls) == 2

  def test_dry_run_never_actuates_but_charges(self):
    ctrl, _ = _controller(
        [_rule(name="a", cooldown_secs=0.0), _rule(name="b", cooldown_secs=0.0)],
        lever=_Lever(fail=True), dry_run=True, max_actions=1,
        budget_window_secs=0.0)
    ctrl.step({"m": 20.0}, now=1000.0)
    assert {d["rule"]: d["outcome"] for d in ctrl.decisions} == {
        "a": "would_act", "b": "budget"}
    assert ctrl.stats()["actuated"] == 0 and ctrl.stats()["would_act"] == 1

  def test_actuator_error_is_contained(self):
    ctrl, _ = _controller([_rule()], lever=_Lever(fail=True))
    ctrl.step({"m": 20.0}, now=1000.0)
    assert ctrl.decisions[-1]["outcome"] == "error"
    assert "broken lever" in ctrl.decisions[-1]["error"]
    assert ctrl.stats()["error"] == 1

  def test_unknown_action_and_duplicates_rejected(self):
    with pytest.raises(ValueError, match="unknown actuator"):
      Controller([_rule(action="warp_core")],
                 {"act": Actuator("act", _Lever())},
                 registry=tmetrics.MetricsRegistry())
    with pytest.raises(ValueError, match="duplicate"):
      Controller([_rule(), _rule()], {"act": Actuator("act", _Lever())},
                 registry=tmetrics.MetricsRegistry())
    with pytest.raises(ValueError, match="max_actions"):
      Controller([_rule()], {"act": Actuator("act", _Lever())},
                 max_actions=0, registry=tmetrics.MetricsRegistry())

  def test_maybe_step_honours_the_cadence(self, monkeypatch):
    import time
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    ctrl, _ = _controller([_rule(cooldown_secs=0.0)], cadence_secs=5.0)
    assert ctrl.maybe_step({"m": 20.0})
    now[0] += 1.0
    assert ctrl.maybe_step({"m": 1.0}) == [] and ctrl.stats()["steps"] == 1
    now[0] += 5.0
    ctrl.maybe_step({"m": 1.0})
    assert ctrl.stats()["steps"] == 2

  def test_decision_records_validate(self, tmp_path):
    path = str(tmp_path / control.DECISIONS_FILENAME)
    ctrl, _ = _controller([_rule(cooldown_secs=60.0, aggregate="each")],
                          max_actions=10, decisions_path=path)
    ctrl.step({"front0/m": 20.0, "front1/m": 1.0}, step=7, now=1000.0)
    ctrl.step({"front0/m": 1.0}, now=1001.0)
    ctrl.step({"front0/m": 20.0}, now=1002.0)
    ctrl.close()
    records = read_decisions(path)
    assert len(records) == 2
    assert all(trecords.validate_record(r) == [] for r in records)
    assert records[0]["step"] == 7 and records[0]["role"] == "front0"
    assert records[0]["payload"]["control.r.outcome"] == float(
        OUTCOMES.index("actuated"))
    assert records[0]["payload"]["control.r.actuated"] == 1.0
    assert records[1]["payload"]["control.r.outcome"] == float(
        OUTCOMES.index("cooldown"))
    assert read_decisions(str(tmp_path / "absent.jsonl")) == []

  def test_handle_alert_remediation_and_fallthrough(self):
    ctrl, lever = _controller([_rule(alert="mfu_drop", cooldown_secs=0.0)],
                              max_actions=10)
    assert ctrl.handle_alert({"rule": "mfu_drop", "metric": "front0/perf.mfu",
                              "value": 0.1, "role": "front0"}) is True
    assert lever.calls[-1][1] == "r"
    assert ctrl.handle_alert({"rule": "who", "value": 0.0}) is False
    assert ctrl.stats()["alert_handled"] == 1
    assert ctrl.stats()["alert_unhandled"] == 0

  def test_dry_run_alert_never_silences_pages(self):
    ctrl, _ = _controller([_rule(alert="mfu_drop", cooldown_secs=0.0)],
                          dry_run=True)
    assert ctrl.handle_alert({"rule": "mfu_drop", "value": 0.1}) is False
    assert ctrl.stats()["alert_unhandled"] == 1


class TestEscalationTiers:

  def _watch(self, severity):
    return sentinel_lib.Watch(name="w", metric="m", kind="above",
                              threshold=10.0, warmup=0, severity=severity)

  def test_remediated_page_demotes(self):
    paged, registry = [], tmetrics.MetricsRegistry()
    sentinel = sentinel_lib.Sentinel(
        [self._watch("page")], on_act=lambda a: True,
        on_page=paged.append, registry=registry)
    [record] = sentinel.evaluate({"m": 20.0})
    assert record["escalation"] == "act" and not paged

  def test_unremediated_page_escalates(self):
    paged = []
    sentinel = sentinel_lib.Sentinel(
        [self._watch("page")], on_act=lambda a: False,
        on_page=paged.append, registry=tmetrics.MetricsRegistry())
    [record] = sentinel.evaluate({"m": 20.0})
    assert record["escalation"] == "page" and paged


class TestDegradationLadder:

  def test_shed_order_exhaustion_and_restore(self):
    retunes = []
    ladder = DegradationLadder(
        ("bulk", "batch"),
        retune=lambda t, rate_rps=None: retunes.append((t, rate_rps)),
        shed_rate_rps=2.0)
    assert ladder.shed_next() == "bulk"
    assert ladder.shed_next() == "batch"
    assert ladder.shed_next() is None
    assert retunes == [("bulk", 2.0), ("batch", 2.0)]
    assert ladder.restore() == ("bulk", "batch")
    assert retunes[-2:] == [("bulk", None), ("batch", None)]
    assert ladder.shed == ()


class _FakeFleet:
  """The duck-typed surface `fleet_actuators` drives, recording calls."""

  def __init__(self):
    self.num_actors, self.num_fronts = 2, 2
    self.calls = []

  def scale_to(self, n):
    self.calls.append(("scale_to", n))
    self.num_actors = n

  def scale_fronts_to(self, n):
    self.calls.append(("scale_fronts_to", n))
    self.num_fronts = n

  def kick(self, role):
    self.calls.append(("kick", role))

  def retune_admission(self, tenant, rate_rps=None, factor=None,
                       min_rate_rps=1.0, max_rate_rps=None):
    self.calls.append(("retune", tenant, rate_rps, factor))
    return {"front0": {"tenant": tenant, "rate_rps": rate_rps}}


class TestStandardPolicyTable:

  def test_fleet_rules_resolve_against_fleet_actuators(self):
    rules = policies_lib.fleet_rules(env_steps_per_sec_min=10.0,
                                     env_steps_per_sec_max=100.0)
    ctrl = Controller(rules, fleet_actuators(_FakeFleet()),
                      registry=tmetrics.MetricsRegistry())
    slow = ctrl.rules[0]
    assert slow.name == "slow_host_respawn"
    assert slow.alert == "mfu_drop" and slow.aggregate == "each"
    names = [r.name for r in ctrl.rules]
    assert names.index("overload_shed") < names.index("recovered_restore")
    assert all(r.action != "page" for r in ctrl.rules)

  def test_offered_load_prescale_rule(self):
    assert "front_offered_prescale" not in [
        r.name for r in policies_lib.fleet_rules()]
    rules = policies_lib.fleet_rules(offered_load_slope_max=200.0,
                                     max_fronts=3)
    names = [r.name for r in rules]
    assert names.index("front_offered_prescale") < names.index(
        "front_p95_scale_up")
    rule = rules[names.index("front_offered_prescale")]
    assert (rule.kind, rule.metric, rule.aggregate) == (
        "rate_above", "serving.policy.admission.admitted", "max")
    assert rule.action_params == {"delta": 1, "min": 1, "max": 3}

  @pytest.mark.parametrize("kwargs", [
      {}, dict(offered_load_slope_max=50.0, env_steps_per_sec_min=5.0,
               env_steps_per_sec_max=500.0, tenant="batch", slo_ms=20.0)])
  def test_fleet_rules_equal_jax(self, kwargs):
    port = [dataclasses.asdict(r) for r in policies_lib.fleet_rules(**kwargs)]
    jax = [dataclasses.asdict(r)
           for r in jax_control.policies.fleet_rules(**kwargs)]
    assert port == jax
    assert policies_lib.degradation_priorities(("a",), 2.0) == (
        jax_control.policies.degradation_priorities(("a",), 2.0))

  def test_respawn_role_requires_concrete_role(self):
    acts = fleet_actuators(object())
    with pytest.raises(ActuationError):
      acts["respawn_role"].apply({}, {"role": "fleet"})
    with pytest.raises(ActuationError):
      acts["shed_tenant"].apply({}, {})
    with pytest.raises(ActuationError):
      acts["page"].apply({}, {})

  def test_scale_actuators_clamp_at_bounds(self):
    fleet = _FakeFleet()
    acts = fleet_actuators(fleet)
    assert acts["scale_actors"].apply({"delta": -1, "min": 2}, {}) == {
        "noop": "at_bound", "actors": 2}
    assert acts["scale_fronts"].apply({"delta": 1, "max": 4}, {}) == {
        "fronts_before": 2, "fronts_after": 3}
    assert fleet.calls == [("scale_fronts_to", 3)]


# The scripted stream: one aggregated poll every 10 s of the injected
# clock. Latency stays at 300 ms (> 2× the 100 ms SLO) and the adds
# counter climbs 300 rows/s for 30 polls, then latency recovers to
# 20 ms and the rate falls inside the [20, 200] band.
def _stream():
  adds = 0.0
  for k in range(45):
    high = k < 30
    adds += (300.0 if high else 100.0) * 10.0
    p95 = 300.0 if high else 20.0
    yield 1000.0 + 10.0 * k, {
        "front0/serving.policy.request_ms_p95": p95,
        "front1/serving.policy.request_ms_p95": p95 * 0.5,
        "front0/serving.policy.queue_depth": 5.0,
        "front1/serving.policy.queue_depth": 3.0,
        "shard0/replay.adds": adds,
        "learner/perf.mfu": 0.3,
        "replay.learner_step": float(10 * k),
    }


def _autopilot(gin_module, orch_module, control_module, registry_cls,
               decisions_path, dry_run):
  gin_module.clear_config()
  gin_module.parse_config_file(_AUTOPILOT)
  try:
    config = orch_module.FleetConfig()
    rules = control_module.fleet_rules()
  finally:
    gin_module.clear_config()
  fleet = _FakeFleet()
  pages = []
  ladder = control_module.DegradationLadder(
      config.control_shed_priorities,
      retune=lambda t, rate_rps=None: fleet.retune_admission(
          t, rate_rps=rate_rps),
      shed_rate_rps=config.control_shed_rate_rps)
  ctrl = control_module.Controller(
      rules, control_module.fleet_actuators(
          fleet, on_page=pages.append, degradation=ladder),
      cadence_secs=config.control_cadence_secs, dry_run=dry_run,
      max_actions=config.control_max_actions,
      budget_window_secs=config.control_budget_window_secs,
      decisions_path=decisions_path, registry=registry_cls())
  for now, scalars in _stream():
    ctrl.step(scalars, step=int(scalars["replay.learner_step"]), now=now)
  ctrl.close()
  return rules, ctrl, fleet, pages


def _without_wall(decision):
  return {k: v for k, v in decision.items() if k != "wall"}


_REQUIRED = ("actors_scale_down", "front_p95_scale_up", "tenant_slo_retune",
             "overload_shed", "recovered_restore")


def test_autopilot_decisions_equal_jax(tmp_path):
  jax_rules, jax_ctrl, jax_fleet, jax_pages = _autopilot(
      jax_gin, jax_orch, jax_control, jax_tmetrics.MetricsRegistry,
      str(tmp_path / "jax.jsonl"), dry_run=False)
  rules, ctrl, fleet, pages = _autopilot(
      port_gin, orch, control, tmetrics.MetricsRegistry,
      str(tmp_path / "port.jsonl"), dry_run=False)
  assert [dataclasses.asdict(r) for r in rules] == [
      dataclasses.asdict(r) for r in jax_rules]
  got = [_without_wall(d) for d in ctrl.decisions]
  want = [_without_wall(d) for d in jax_ctrl.decisions]
  assert got == want
  records = read_decisions(str(tmp_path / "port.jsonl"))
  jax_records = read_decisions(str(tmp_path / "jax.jsonl"))
  assert [_without_wall(r) for r in records] == [
      _without_wall(r) for r in jax_records]
  assert all(trecords.validate_record(r) == [] for r in records)
  assert ctrl.stats() == jax_ctrl.stats()
  assert fleet.calls == jax_fleet.calls and pages == jax_pages == []
  actuated = {d["rule"] for d in got if d["outcome"] == "actuated"}
  assert set(_REQUIRED) <= actuated
  # The shipped budget: at most 4 actuations in any 300 s window.
  times = sorted(1000.0 + 10.0 * (d["step"] // 10) for d in got
                 if d["outcome"] == "actuated")
  assert all(sum(1 for u in times if t - 300.0 < u <= t) <= 4 for t in times)
  assert fleet.num_actors == 1
  assert fleet.num_fronts == 3


def test_autopilot_dry_run_charges_the_budget_and_never_actuates(tmp_path):
  _, live, _, _ = _autopilot(port_gin, orch, control,
                             tmetrics.MetricsRegistry,
                             str(tmp_path / "live.jsonl"), dry_run=False)
  _, dry, fleet, pages = _autopilot(port_gin, orch, control,
                                    tmetrics.MetricsRegistry,
                                    str(tmp_path / "dry.jsonl"), dry_run=True)
  assert fleet.calls == [] and pages == []
  assert dry.stats()["actuated"] == 0
  assert dry.stats()["would_act"] == live.stats()["actuated"]
  schedule = [(d["rule"], d["step"], d["budget_remaining"])
              for d in dry.decisions]
  assert schedule == [(d["rule"], d["step"], d["budget_remaining"])
                      for d in live.decisions]
  assert {d["outcome"] for d in dry.decisions} <= {"would_act", "budget",
                                                   "cooldown"}


def test_control_package_loads_no_jax_and_no_cuda():
  code = (
      "import sys, torch\n"
      "import tensor2robot_tpu_torch.control\n"
      "import tensor2robot_tpu_torch.control.rules, "
      "tensor2robot_tpu_torch.control.controller, "
      "tensor2robot_tpu_torch.control.actuators, "
      "tensor2robot_tpu_torch.control.policies\n"
      "assert 'jax' not in sys.modules, 'jax loaded'\n"
      "assert not [m for m in sys.modules "
      "if m.startswith('tensor2robot_tpu.')], 'JAX package loaded'\n"
      "assert not torch.cuda.is_initialized(), 'CUDA initialized'\n"
      "print('CLEAN')\n")
  env = dict(os.environ, PYTHONPATH=_REPO)
  env.pop("CUDA_VISIBLE_DEVICES", None)
  result = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=_REPO, env=env)
  assert result.returncode == 0, result.stderr
  assert "CLEAN" in result.stdout
