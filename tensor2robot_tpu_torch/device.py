"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
  """`None` means the CUDA card. Raises when CUDA is asked for and absent.

  There is no silent fallback to the CPU: a caller that wants the CPU
  (the tests) says ``device="cpu"``.
  """
  dev = torch.device("cuda" if device is None else device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        f"device {dev} requested but torch.cuda.is_available() is False; "
        "pass device='cpu' to run on the host.")
  return dev


def synchronize(device: Optional[torch.device]) -> None:
  """Waits for queued work on `device` (a no-op for the CPU)."""
  if device is not None and torch.device(device).type == "cuda":
    torch.cuda.synchronize(device)
