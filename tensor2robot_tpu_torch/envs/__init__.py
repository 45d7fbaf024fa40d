"""Batched functional environments on the card (port of `envs/`): the
contract and its wrappers (core.py), the pose/grasp bandit and the
procedural scenario family (pose.py, procgen.py), and the Anakin
rollout engine, `train_anakin` (`--trainer=anakin`) and the scenario
sweep (rollout.py).

The `rollout` function is reached as `envs.rollout.rollout`: the
submodule of that name is the package attribute."""

from tensor2robot_tpu_torch.envs.core import (
    AutoResetEnv,
    BatchedEnv,
    FunctionalEnv,
    select_state,
)
from tensor2robot_tpu_torch.envs.pose import (
    PoseBanditEnv,
    PoseState,
    host_parity_env,
)
from tensor2robot_tpu_torch.envs.procgen import (
    ProcGenGraspEnv,
    ProcGenState,
)
from tensor2robot_tpu_torch.envs.rollout import (
    JaxEnvBandit,
    evaluate_scenarios,
    flatten_devices,
    flatten_time,
    make_anakin_collect_fn,
    make_batched,
    make_collect_fn,
    score_scenarios,
    train_anakin,
)

__all__ = ["AutoResetEnv", "BatchedEnv", "FunctionalEnv", "JaxEnvBandit",
           "PoseBanditEnv", "PoseState", "ProcGenGraspEnv", "ProcGenState",
           "evaluate_scenarios", "flatten_devices", "flatten_time",
           "host_parity_env", "make_anakin_collect_fn", "make_batched",
           "make_collect_fn", "score_scenarios", "select_state",
           "train_anakin"]
