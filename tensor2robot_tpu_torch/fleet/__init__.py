"""The learner/actor fleet on one card (port of `fleet/`).

N actor processes (each a `GraspActor` driving an env through its RPC
seams, with no CUDA context) pull actions from, and commit atomic
episodes into, a replay/serving host process (`CEMPolicyServer` and
`ReplayWriteService`/`ReplayStore`), which feeds a learner process
running the unmodified `train_qtopt`; each checkpoint's params flow back
as a publication the host copies into its serving engine's idle slot,
stamped with the learner step so `param_refresh_lag` is measured next to
replay staleness. Front replicas serve external callers through a
`ServingRouter`, fed by the same publications; a controller can steer the
fleet (`control/`). Anakin pods collect whole rollout segments on the
card beside (or instead of) the actors, and the learner may be a group
of processes that average their gradients. Only the host(s), the fronts,
the learner's ranks and the pods touch the card.

  * `orchestrator`: `FleetConfig` / `Fleet` / `run_fleet`: the launch
    gate, the refusals of what is not ported, heartbeat and exit-code
    supervision, the crash policies and restart budgets, and the
    zero-leak shutdown barrier.
  * `host`: the replay/serving host, serving replicas and replay shards.
  * `front`: the front replicas (`front_main`) and the standalone
    `FrontTier`.
  * `traffic`: a fleet run with router traffic on its fronts
    (`drive_fleet`, and a command line).
  * `actor`: the actor process and its RPC policy-server and
    replay-session seams.
  * `learner`: `RemoteReplay` and `ParamPublishHook` around
    `train_qtopt`, and the learner group's per-rank plan.
  * `pod`: the Anakin pod process (`pod_main`) and its `acting_state`
    param client.
  * `rpc` / `transport`: loopback and TCP request/response.
  * `faults`: the deterministic fault plan.

Not ported: the `mujoco_pose` env (ROADMAP A10a).

This package init stays light: `run_t2r_trainer` imports it for gin
registration in every mode, `--validate_only` included.
"""

from tensor2robot_tpu_torch.fleet.orchestrator import (
    Fleet,
    FleetConfig,
    FleetError,
    FleetResult,
    run_fleet,
)
from tensor2robot_tpu_torch.fleet.rpc import RpcClient, RpcError, RpcServer

__all__ = [
    "Fleet",
    "FleetConfig",
    "FleetError",
    "FleetResult",
    "RpcClient",
    "RpcError",
    "RpcServer",
    "run_fleet",
]
