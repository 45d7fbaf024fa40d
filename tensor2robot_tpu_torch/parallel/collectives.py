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
  * `all_equal(values)`: whether every rank holds the same integers
    (a pipeline group's digests of each step's global batch).
  * `all_reduce_sum_dict`: the pipeline's gradient sums over a data
    group; `StageShift`, `StageBroadcast`, `StageReplicate`: the stage
    ring's hops and edges (`parallel.pipeline`), each an
    `autograd.Function` whose backward runs the hop in reverse.
  * `RingShift`, `SeqShard`, `SeqGather`, `RingAnchor`: the seq ring's
    hops (`parallel.ring_attention`), paired so that every layer outside
    attention computes the same values and gradients on every seq rank.

Outside `data_parallel`, or in a group of one process, nothing changes.
"""

from __future__ import annotations

import contextlib
import socket
import threading
from typing import Dict, Iterator, Optional, Sequence

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
  return _all_reduce_flat(tensors, group, mean=True)


def all_reduce_sum_dict(tensors: Dict[str, torch.Tensor],
                        group=None) -> Dict[str, torch.Tensor]:
  """Each tensor's sum over `group`, from one flat f32 buffer summed
  once; each comes back in its own shape, dtype and device."""
  return _all_reduce_flat(tensors, group, mean=False)


def _all_reduce_flat(tensors, group, mean: bool):
  if not tensors:
    return {}
  keys = list(tensors)
  flat = torch.cat([tensors[k].detach().float().reshape(-1) for k in keys])
  total = all_reduce_sum(flat, group)
  if mean:
    total = total / float(group_size(group))
  out, offset = {}, 0
  for k in keys:
    t = tensors[k]
    n = t.numel()
    out[k] = total[offset:offset + n].reshape(t.shape).to(t.dtype)
    offset += n
  return out


# ---- the stage ring (parallel.pipeline's GPipe schedule) ----
#
# The pipeline's values are replicated over the stage ring where JAX's
# shard_map declares them so (the trunk's input and output): every stage
# rank of a data row computes the same loss, and a replicated value's
# cotangent is the same on every rank (JAX's convention). So the output
# edge (`StageBroadcast`) sums in the forward and passes the rank's own
# cotangent back, and the input edge (`StageReplicate`) passes the value
# through and sums the cotangents, of which only stage 0's is not zero.


def _wire(tensor: torch.Tensor) -> torch.Tensor:
  """A host copy gloo moves: bf16 travels as its int16 bits."""
  host = tensor.detach().to("cpu", copy=True).contiguous()
  return host.view(torch.int16) if host.dtype == torch.bfloat16 else host


def _meta(x: torch.Tensor):
  """What `_zeros` needs to remake a tensor like `x` in a backward."""
  return x.shape, x.dtype, x.device


def _zeros(meta) -> torch.Tensor:
  """The zero cotangent of a tensor `_meta` described: it anchors a
  rank's chain of hops to its loss, so their backwards run on every
  rank in one order."""
  shape, dtype, device = meta
  return torch.zeros(shape, dtype=dtype, device=device)


def _exact_sum(tensor: torch.Tensor, group) -> torch.Tensor:
  """`all_reduce_sum` in f32 for a bf16 tensor (one rank's value plus
  zeros, so exact), in the tensor's own dtype otherwise."""
  if tensor.dtype == torch.bfloat16:
    return all_reduce_sum(tensor.float(), group).to(torch.bfloat16)
  return all_reduce_sum(tensor, group)


def exchange(send: Optional[torch.Tensor], dst: Optional[int],
             like: torch.Tensor, src: Optional[int]) -> Optional[torch.Tensor]:
  """Sends `send` to global rank `dst` and receives a tensor shaped and
  typed as `like` from `src` (either may be None), on `like`'s device.
  Both are posted before either is waited on (`isend` / `irecv`), so two
  neighbours that send to each other cannot deadlock (ROADMAP trap 65).
  Returns the received tensor, or None."""
  import torch.distributed as dist

  works = []
  if send is not None and dst is not None:
    works.append(dist.isend(_wire(send), dst))
  box = None
  if src is not None:
    box = torch.empty(like.shape, dtype=like.dtype)
    wire = box.view(torch.int16) if box.dtype == torch.bfloat16 else box
    works.append(dist.irecv(wire, src))
  for work in works:
    work.wait()
  return None if box is None else box.to(like.device)


class StageShift(torch.autograd.Function):
  """One tick's hop of the GPipe schedule: sends `y` (this stage's
  output) to the next stage's rank `dst` and returns what the previous
  stage's rank `src` sent, or `fallback` where nothing is received
  (`dst` / `src` None). The backward runs the hop in reverse: the
  cotangent of the received value goes back to `src`, and `y`'s
  cotangent comes from `dst` (zeros where `y` was not sent, so the
  rank's chain of hops stays connected to its loss)."""

  @staticmethod
  def forward(ctx, y, fallback, dst, src):
    ctx.dst, ctx.src = dst, src
    received = exchange(y, dst, y, src)
    return fallback.clone() if received is None else received

  @staticmethod
  def backward(ctx, grad):
    grad_y = exchange(grad if ctx.src is not None else None, ctx.src,
                      grad, ctx.dst)
    if grad_y is None:
      grad_y = torch.zeros_like(grad)
    grad_fallback = grad if ctx.src is None else None
    return grad_y, grad_fallback, None, None


class StageBroadcast(torch.autograd.Function):
  """The pipeline's output edge: the last stage's collected rows summed
  over the stage ring (`out` is zeros elsewhere), so every stage rank
  holds them. The backward gives each rank's own cotangent back to its
  `out` (only the last stage's reached real rows) and zeros to `tail`,
  the rank's last schedule value, whose graph runs the rank's hops
  backward."""

  @staticmethod
  def forward(ctx, out, tail, group):
    ctx.tail = _meta(tail)
    return _exact_sum(out, group)

  @staticmethod
  def backward(ctx, grad):
    return grad, _zeros(ctx.tail), None


class StageReplicate(torch.autograd.Function):
  """The pipeline's input edge: the value as it is on every stage rank;
  the backward sums the cotangents over the stage ring (stage 0 ingests
  the microbatches, so only its cotangent is not zero), so every stage
  rank's layers before the trunk get the whole gradient."""

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    return x.view_as(x)

  @staticmethod
  def backward(ctx, grad):
    return _exact_sum(grad.contiguous(), ctx.group), None


# ---- the seq ring (parallel.ring_attention) ----
#
# Outside attention every seq rank of a data row holds the whole time
# axis (the value is replicated over `seq`, as JAX's GSPMD program treats
# it). `SeqShard` takes this rank's T-slice into the ring and gathers the
# slices' cotangents back in the backward, so the cotangent upstream is
# the whole one on every rank; `SeqGather` gathers the ring's output
# slices and passes this rank's slice of the (replicated) cotangent back.
# `RingShift` rotates K/V blocks one step along the ring; its backward
# rotates the cotangents the other way, so each block's dK/dV arrive at
# the rank that holds the block. `RingAnchor` hangs the last rotation on
# the output, so every rank runs every rotation's backward, in one order,
# whichever blocks it attended (trap 65's pairing holds in the backward).


def _all_gather_cat(tensor: torch.Tensor, dim: int, group) -> torch.Tensor:
  """Every rank's `tensor` of `group`, concatenated along `dim` in group
  rank order, on `tensor`'s device: one host all-gather of its `_wire`
  copy (bf16 as its 2 bytes an element: gloo gathers no int16, and the
  bytes of an element stay together along any `dim`)."""
  import torch.distributed as dist

  wire = _wire(tensor)
  if wire.dtype == torch.int16:
    wire = wire.view(torch.uint8)
  parts = [torch.empty_like(wire) for _ in range(group_size(group))]
  dist.all_gather(parts, wire, group=group)
  return torch.cat(parts, dim=dim).view(tensor.dtype).to(tensor.device)


class SeqShard(torch.autograd.Function):
  """This rank's slice `index` of `size` equal slices of `x` along `dim`
  (x replicated over `group`). The backward all-gathers the slices'
  cotangents over `group`: the whole cotangent, on every rank."""

  @staticmethod
  def forward(ctx, x, dim, index, size, group):
    ctx.dim, ctx.group = dim, group
    chunk = x.shape[dim] // size
    return x.narrow(dim, index * chunk, chunk).contiguous()

  @staticmethod
  def backward(ctx, grad):
    return (_all_gather_cat(grad.contiguous(), ctx.dim, ctx.group),
            None, None, None, None)


class SeqGather(torch.autograd.Function):
  """The slices of `group` (this rank's is `x`, slice `index`)
  concatenated along `dim`, on every rank. The backward takes this
  rank's slice of the (replicated) cotangent."""

  @staticmethod
  def forward(ctx, x, dim, index, group):
    ctx.dim, ctx.index, ctx.chunk = dim, index, x.shape[dim]
    return _all_gather_cat(x.contiguous(), dim, group)

  @staticmethod
  def backward(ctx, grad):
    return (grad.narrow(ctx.dim, ctx.index * ctx.chunk, ctx.chunk)
            .contiguous(), None, None, None)


class RingShift(torch.autograd.Function):
  """One step of the ring: sends (k, v) to global rank `dst` (seq index
  j − 1) and returns the blocks received from `src` (seq index j + 1),
  in one buffer. The backward is the transpose of JAX's `ppermute`: the
  received blocks' cotangents go back to `src`, and the sent blocks'
  cotangents come from `dst`."""

  @staticmethod
  def forward(ctx, k, v, dst, src):
    ctx.dst, ctx.src = dst, src
    both = torch.stack([k, v])
    got = exchange(both, dst, both, src)
    return got[0], got[1]

  @staticmethod
  def backward(ctx, grad_k, grad_v):
    both = torch.stack([grad_k, grad_v])
    got = exchange(both, ctx.src, both, ctx.dst)
    return got[0], got[1], None, None


class RingAnchor(torch.autograd.Function):
  """`out` as it is, hung on the ring's last blocks: the backward gives
  them zero cotangents, so every rotation's backward runs on every rank
  even where the blocks were skipped."""

  @staticmethod
  def forward(ctx, out, k, v):
    ctx.k, ctx.v = _meta(k), _meta(v)
    return out.view_as(out)

  @staticmethod
  def backward(ctx, grad):
    return grad, _zeros(ctx.k), _zeros(ctx.v)


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


def all_equal(values: Sequence[int], group=None) -> bool:
  """Whether every rank of `group` holds the same `values` (ints that
  fit int64), by one max-reduction of the values and their negations;
  every rank gets the same answer."""
  import torch.distributed as dist

  n = len(values)
  host = torch.tensor([*values, *(-v for v in values)], dtype=torch.int64)
  dist.all_reduce(host, op=dist.ReduceOp.MAX, group=group)
  return bool(torch.equal(host[:n], -host[n:]))


def all_gather_object(obj, group=None) -> list:
  """Every rank's picklable `obj`, in rank order, on every rank."""
  import torch.distributed as dist

  out = [None] * group_size(group)
  dist.all_gather_object(out, obj, group=group)
  return out
