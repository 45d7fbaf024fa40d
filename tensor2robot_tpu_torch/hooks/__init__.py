"""Trainer hooks: the `Hook` protocol, `HookList`, the per-checkpoint
success evaluations and the async export hook."""

from tensor2robot_tpu_torch.hooks.async_export_hook import AsyncExportHook
from tensor2robot_tpu_torch.hooks.hook import Hook, HookList
from tensor2robot_tpu_torch.hooks.success_eval_hook import (
    QTOptSuccessEvalHook,
    ScenarioSuccessEvalHook,
    SuccessEvalHook,
)

__all__ = ["AsyncExportHook", "Hook", "HookList", "QTOptSuccessEvalHook",
           "ScenarioSuccessEvalHook", "SuccessEvalHook"]
