"""Trainer hooks: the `Hook` protocol and `HookList`."""

from tensor2robot_tpu_torch.hooks.hook import Hook, HookList

__all__ = ["Hook", "HookList"]
