"""The data axis's collectives over a `torch.distributed` group: what
the JAX package's GSPMD program does implicitly over a mesh's `data`
axis, written out for a learner group.

Every collective here moves ONE flat buffer, staged through host memory:
a learner group on one card has every rank on `cuda:0`, which NCCL
refuses, and gloo reduces host buffers. The ranks compute on the card;
only the flat reduction runs on the host. A failed collective raises
(gloo's error, or its timeout): nothing here falls back.

  * `data_parallel(group)`: the context a training step runs in. Inside
    it `layers.vision_layers.BatchNorm` in train mode normalizes with
    the GLOBAL batch's moments (`global_moments`), and
    `QTOptLearner.train_grads` averages the gradients and metrics over
    the group (`all_reduce_mean`).
  * `AllReduceSum`: a differentiable sum over the group. Its backward
    is the same sum of the incoming gradients: every rank's loss depends
    on every rank's rows through the global moments, so the gradient a
    rank's rows receive is the sum over the ranks' losses, as
    `SyncBatchNorm`'s backward computes it.
  * `broadcast_object(obj, src)` / `all_gather_object(obj)`: picklable
    objects across the group (the learner group's initial state, its
    int8 calibration batch, and each rank's final params digests).
  * `distinct_devices(device)`: how many physical devices the group
    spans (the peak `perf.mfu` divides by).

Outside `data_parallel`, or in a group of one process, nothing changes.
"""

from __future__ import annotations

import contextlib
import socket
import threading
from typing import Dict, Iterator, Optional

import torch

_ACTIVE = threading.local()


def active_group():
  """The process group of the enclosing `data_parallel`, or None."""
  return getattr(_ACTIVE, "group", None)


def group_size(group=None) -> int:
  """The size of `group` (the default group when None); 1 without an
  initialized group."""
  import torch.distributed as dist

  if not (dist.is_available() and dist.is_initialized()):
    return 1
  return dist.get_world_size() if group is None else dist.get_world_size(
      group)


@contextlib.contextmanager
def data_parallel(group=None) -> Iterator[Optional[object]]:
  """Runs the body as one data-parallel shard of `group` (the default
  group when None). A group of one process is no group: the body runs
  as on one process, bit for bit. Yields the group or None."""
  import torch.distributed as dist

  active = group_size(group) > 1
  previous = active_group()
  _ACTIVE.group = (group or dist.group.WORLD) if active else None
  try:
    yield _ACTIVE.group
  finally:
    _ACTIVE.group = previous


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
  """The sum of `tensor` over `group`, a new tensor on `tensor`'s device
  and dtype; the reduction runs on a host copy."""
  import torch.distributed as dist

  host = tensor.detach().to("cpu", copy=True)
  dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
  return host.to(tensor.device)


class AllReduceSum(torch.autograd.Function):
  """Differentiable sum over a group: forward and backward both sum."""

  @staticmethod
  def forward(ctx, tensor, group):
    ctx.group = group
    return all_reduce_sum(tensor, group)

  @staticmethod
  def backward(ctx, grad):
    return all_reduce_sum(grad.contiguous(), ctx.group), None


def global_moments(xf: torch.Tensor, group) -> tuple:
  """(mean, E[x²]) of f32 `xf` over every axis but the last and over
  every rank of `group`: the local sums of x and x² and the row count in
  one buffer, summed over the group (differentiably), over the total
  count."""
  axes = tuple(range(xf.dim() - 1))
  count = torch.full((1,), float(xf.numel() // xf.shape[-1]),
                     device=xf.device, dtype=torch.float32)
  sums = AllReduceSum.apply(
      torch.cat([xf.sum(dim=axes), (xf * xf).sum(dim=axes), count]), group)
  c = xf.shape[-1]
  total = sums[2 * c]
  return sums[:c] / total, sums[c:2 * c] / total


def all_reduce_mean(tensors: Dict[str, torch.Tensor],
                    group=None) -> Dict[str, torch.Tensor]:
  """Each tensor's mean over `group`, from one flat f32 buffer summed
  once; each comes back in its own shape, dtype and device."""
  if not tensors:
    return {}
  keys = list(tensors)
  flat = torch.cat([tensors[k].detach().float().reshape(-1) for k in keys])
  mean = all_reduce_sum(flat, group) / float(group_size(group))
  out, offset = {}, 0
  for k in keys:
    t = tensors[k]
    n = t.numel()
    out[k] = mean[offset:offset + n].reshape(t.shape).to(t.dtype)
    offset += n
  return out


def broadcast_object(obj, src: int = 0, group=None):
  """Rank `src`'s picklable `obj` on every rank of `group` (tensors in
  it arrive on the CPU)."""
  import torch.distributed as dist

  box = [obj]
  dist.broadcast_object_list(box, src=src, group=group)
  return box[0]


def distinct_devices(device, group=None) -> int:
  """The number of physical devices the ranks of `group` compute on:
  ranks that share a card count it once (a learner group on one card
  spans one device). Every rank of the group must call it."""
  if group_size(group) == 1:
    return 1
  device = torch.device(device)
  key = (socket.gethostname(), str(device))
  if device.type == "cuda":
    props = torch.cuda.get_device_properties(device)
    key = (key[0], str(getattr(props, "uuid", "")) or str(device))
  return len(set(all_gather_object(key, group)))


def all_gather_object(obj, group=None) -> list:
  """Every rank's picklable `obj`, in rank order, on every rank."""
  import torch.distributed as dist

  out = [None] * group_size(group)
  dist.all_gather_object(out, obj, group=group)
  return out
