"""Trainer hooks: the `Hook` protocol, `HookList`, and the
per-checkpoint success evaluations."""

from tensor2robot_tpu_torch.hooks.hook import Hook, HookList
from tensor2robot_tpu_torch.hooks.success_eval_hook import (
    QTOptSuccessEvalHook,
    ScenarioSuccessEvalHook,
    SuccessEvalHook,
)

__all__ = ["Hook", "HookList", "QTOptSuccessEvalHook",
           "ScenarioSuccessEvalHook", "SuccessEvalHook"]
