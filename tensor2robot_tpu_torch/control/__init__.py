"""Closed-loop control plane (port of `control/`): the policy layer over
the fleet's telemetry and its actuators.

  * `rules` — the `ControlRule` grammar: a condition over metric windows
    → an action, with hysteresis bands, per-rule cooldowns and
    sustained-breach semantics;
  * `controller` — the `Controller` loop: ordered rule evaluation over
    the orchestrator's aggregated scalar view, a global rate-based
    actuation budget, dry-run mode, and decision records (envelope
    records, `control.*` counters, flight-record extras);
  * `actuators` — the lever catalog over the fleet's seams
    (`Fleet.scale_to`, front scale and respawn, admission retune, the
    degradation ladder, page as the fallback);
  * `policies` — the standing gin-tunable fleet rule table
    (`qtopt_fleet_autopilot.gin` binds it).

The package imports neither torch nor CUDA: the supervising process
steps it, and opens no CUDA context.
"""

from tensor2robot_tpu_torch.control import actuators
from tensor2robot_tpu_torch.control import controller
from tensor2robot_tpu_torch.control import policies
from tensor2robot_tpu_torch.control import rules
from tensor2robot_tpu_torch.control.actuators import (
    ActuationError,
    Actuator,
    DegradationLadder,
    fleet_actuators,
)
from tensor2robot_tpu_torch.control.controller import (
    DECISIONS_FILENAME,
    OUTCOMES,
    Controller,
    read_decisions,
)
from tensor2robot_tpu_torch.control.policies import fleet_rules
from tensor2robot_tpu_torch.control.rules import ControlRule, RuleState

__all__ = [
    "ActuationError",
    "Actuator",
    "ControlRule",
    "Controller",
    "DECISIONS_FILENAME",
    "DegradationLadder",
    "OUTCOMES",
    "RuleState",
    "actuators",
    "controller",
    "fleet_actuators",
    "fleet_rules",
    "policies",
    "read_decisions",
    "rules",
]
