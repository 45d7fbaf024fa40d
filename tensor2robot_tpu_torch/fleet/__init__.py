"""The learner/actor fleet on one card (port of `fleet/`).

N actor processes (each a `GraspActor` driving an env through its RPC
seams, with no CUDA context) pull actions from, and commit atomic
episodes into, a replay/serving host process (`CEMPolicyServer` and
`ReplayWriteService`/`ReplayStore`), which feeds a learner process
running the unmodified `train_qtopt`; each checkpoint's params flow back
as a publication the host copies into its serving engine's idle slot,
stamped with the learner step so `param_refresh_lag` is measured next to
replay staleness. Only the host(s) and the learner touch the card.

  * `orchestrator`: `FleetConfig` / `Fleet` / `run_fleet`: the launch
    gate, the refusals of what is not ported, heartbeat and exit-code
    supervision, the crash policies and restart budgets, and the
    zero-leak shutdown barrier.
  * `host`: the replay/serving host, serving replicas and replay shards.
  * `actor`: the actor process and its RPC policy-server and
    replay-session seams.
  * `learner`: `RemoteReplay` and `ParamPublishHook` around
    `train_qtopt`.
  * `rpc` / `transport`: loopback and TCP request/response.
  * `faults`: the deterministic fault plan.

Not ported (ROADMAP A13 rest): the front replicas, the Anakin pods and
the control plane; learner groups are A11.

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
