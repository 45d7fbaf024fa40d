"""Ring attention: sequence parallelism over the `seq` mesh axis (port of
`parallel/ring_attention.py`).

The mesh's seq ranks (gloo processes, `parallel.mesh`) each hold one
slice of the time axis inside attention. A rank keeps its Q block and
consumes the K/V blocks as they rotate around the ring
(`collectives.RingShift`, JAX's `ppermute` to seq index j − 1), so the
result is exact attention without any rank materializing the `[T, T]`
scores. Outside attention every seq rank holds the whole time axis:
`collectives.SeqShard` takes the rank's slice in, `collectives.SeqGather`
gathers the slices out, and their backwards are each other's forwards,
so every layer around the ring computes the same values and gradients on
every seq rank (JAX's GSPMD program gets this from its shardings).

Two block bodies, as in JAX:
  * "reference" (`_ring_attention_local`): the f32 online softmax over
    the P blocks (running max, normalizer and accumulator), masked by
    global position under `causal` with the finite −1e30 sentinel; P
    rotations, the last of which sends the blocks home.
  * "flash" (`_ring_attention_local_flash`): each block through
    `ops.flash_attention.flash_attention_with_lse`, which launches the
    hand-written `csrc/flash_attention.cu` on a CUDA tensor (its plain
    version on a CPU tensor). Step 0 is the diagonal block (`causal`
    there); under `causal` a later block from an earlier slice (src <
    idx) is attended in full and one from a later slice is skipped: no
    launch, a zero output and lse −1e30, while K/V still rotate (P − 1
    rotations). The partials merge by `softmax(lse)` over the blocks,
    so the merge's cotangent reaches each block's lse (dlse ≠ 0) and
    the backward kernels (`csrc/flash_attention_bwd.cu`) take it in
    δ = rowsum(dO·O) − dlse. Under `causal` seq rank r attends 1 + r
    blocks: it launches the forward, dK/dV and dQ kernels 1 + r times a
    layer and a step (JAX's imbalance, kept).

`ring_attention(q, k, v, mesh)` takes full `[B, T, H, D]` values
replicated over the mesh, as JAX's takes global arrays, and returns the
full output on every rank. With `shard_batch` the batch is split over
`data` when it divides (a rank's data rows are a contiguous block, as
JAX's `P("data", "seq")`), replicated silently at B = 1 and with a
`RuntimeWarning` otherwise. A model whose rows are already its data
rows passes `shard_batch=False`. No mesh, or a seq axis of 1, is one
device's attention: `attention_reference` for "reference" blocks, as in
JAX, and `ops.flash_attention.flash_attention` for "flash" blocks, so a
CUDA tensor still launches the kernel. JAX's `flash_interpret` has no
counterpart: "flash" blocks on the CPU run the plain flash version.
"""

from __future__ import annotations

import math
import warnings
from typing import Tuple

import torch

from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS

_NEG_INF = -1e30  # finite sentinel, as in the JAX package


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
  """Plain softmax attention in f32: q, k, v [B, T, H, D] → [B, T, H, D]
  in q's dtype. The probabilities stay f32 (no rounding to v's dtype)."""
  scale = 1.0 / math.sqrt(q.shape[-1])
  s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
  if causal:
    t = q.shape[1]
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, _NEG_INF)
  p = torch.softmax(s, dim=-1)
  out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
  return out.to(q.dtype)


def _block_attend(q, k, v, mask, m, l, o, scale):
  """One online-softmax update of the (m, l, o) running state: q [B, Tq,
  H, D]; k, v [B, Tk, H, D]; mask [Tq, Tk] bool or None; m, l [B, H,
  Tq]; o [B, H, Tq, D] (f32)."""
  s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
  if mask is not None:
    s = torch.where(mask, s, _NEG_INF)
  m_new = torch.maximum(m, s.amax(dim=-1))
  # Rows masked so far keep m at the sentinel; exp underflows to 0.
  p = torch.exp(s - m_new[..., None])
  if mask is not None:
    p = torch.where(mask, p, 0.0)
  alpha = torch.exp(m - m_new)
  l_new = alpha * l + p.sum(dim=-1)
  o_new = (alpha[..., None] * o
           + torch.einsum("bhqk,bkhd->bhqd", p, v.float()))
  return m_new, l_new, o_new


def _neighbours(mesh, axis_name: str) -> Tuple[int, int, int, int]:
  """(ring size, this rank's index, global rank of index j − 1, of
  j + 1) on `axis_name`."""
  ring = mesh.axis_ranks(axis_name)
  size, idx = len(ring), mesh.axis_index(axis_name)
  return size, idx, ring[(idx - 1) % size], ring[(idx + 1) % size]


def _ring_attention_local(q, k, v, mesh, axis_name: str, causal: bool):
  """The rank's body: its Q block against the P rotating K/V blocks in
  the f32 online softmax; the last rotation sends the blocks home."""
  size, idx, dst, src_rank = _neighbours(mesh, axis_name)
  batch, t_local, heads, dim = q.shape
  scale = 1.0 / math.sqrt(dim)
  rows = idx * t_local + torch.arange(t_local, device=q.device)
  m = torch.full((batch, heads, t_local), _NEG_INF, dtype=torch.float32,
                 device=q.device)
  l = torch.zeros((batch, heads, t_local), dtype=torch.float32,
                  device=q.device)
  o = torch.zeros((batch, heads, t_local, dim), dtype=torch.float32,
                  device=q.device)
  for s in range(size):
    src = (idx + s) % size
    mask = None
    if causal:
      cols = src * t_local + torch.arange(t_local, device=q.device)
      mask = cols[None, :] <= rows[:, None]
    m, l, o = _block_attend(q, k, v, mask, m, l, o, scale)
    k, v = collectives.RingShift.apply(k, v, dst, src_rank)
  # Rows with zero mass (possible only under exotic masks) output 0.
  out = o / l[..., None].clamp_min(1e-30)
  out = collectives.RingAnchor.apply(out, k, v)
  return out.transpose(1, 2).to(q.dtype)


def _ring_attention_local_flash(q, k, v, mesh, axis_name: str,
                                causal: bool):
  """The rank's body on the flash kernel: step 0 the diagonal block, a
  later block attended in full or skipped (causal, from a later slice),
  P − 1 rotations, the partials merged by their logsumexps."""
  from tensor2robot_tpu_torch.ops.flash_attention import (
      flash_attention_with_lse,
  )

  size, idx, dst, src_rank = _neighbours(mesh, axis_name)
  batch, t_local, heads, _ = q.shape
  outs, lses = [], []
  for s in range(size):
    if causal and s > 0 and (idx + s) % size > idx:
      # A block from a later slice is fully masked: no launch; the
      # rotation still runs.
      o_s = torch.zeros_like(q)
      lse_s = torch.full((batch, heads, t_local), _NEG_INF,
                         dtype=torch.float32, device=q.device)
    else:
      o_s, lse_s = flash_attention_with_lse(q, k, v,
                                            causal=causal and s == 0)
    outs.append(o_s)
    lses.append(lse_s)
    if s < size - 1:
      k, v = collectives.RingShift.apply(k, v, dst, src_rank)
  weights = torch.softmax(torch.stack(lses), dim=0)       # [S, B, H, T]
  out = torch.einsum("sbht,sbthd->bthd", weights,
                     torch.stack(outs).float())
  return collectives.RingAnchor.apply(out, k, v).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh=None, axis_name: str = SEQ_AXIS,
                   causal: bool = False, shard_batch: bool = True,
                   block_impl: str = "reference") -> torch.Tensor:
  """Exact attention with the time axis split over `axis_name`.

  Args:
    q, k, v: [B, T, H, D], the same on every rank of the mesh; T must
      divide by the `axis_name` size.
    mesh: a `parallel.mesh.Mesh`; None (or no or a trivial `axis_name`
      axis) is `attention_reference`, the same math on one device.
    causal: causal masking by global position.
    shard_batch: split B over the mesh's `data` axis too (when it
      divides; the module docstring).
    block_impl: "reference" (the f32 online softmax) or "flash" (the
      flash kernel per block, partials merged by logsumexp).

  Returns [B, T, H, D] in q's dtype, the same on every rank.
  """
  if (mesh is None or axis_name not in mesh.axis_names
      or mesh.shape[axis_name] == 1):
    if block_impl == "flash":
      # One block: the flash kernel on a CUDA tensor, never the plain
      # attention (JAX's fallback runs no kernel either way).
      from tensor2robot_tpu_torch.ops.flash_attention import (
          flash_attention,
      )
      return flash_attention(q, k, v, causal=causal)
    return attention_reference(q, k, v, causal=causal)
  size = mesh.shape[axis_name]
  if q.shape[1] % size:
    raise ValueError(
        f"Sequence length {q.shape[1]} must divide the {axis_name!r} "
        f"axis size {size}.")
  if block_impl == "flash":
    local = _ring_attention_local_flash
  elif block_impl == "reference":
    local = _ring_attention_local
  else:
    raise ValueError(f"Unknown block_impl: {block_impl!r}")
  rows, _ = sequence_rows(mesh, q.shape[0], q.shape[1], axis_name,
                          shard_batch=shard_batch, warn=True)
  data = rows != slice(0, q.shape[0])
  idx = mesh.axis_index(axis_name)
  group = mesh.group(axis_name)
  # One hop for q, k and v: their cotangents gather in one collective,
  # after every rotation's backward.
  qkv = torch.stack([q, k, v])
  if data:
    qkv = collectives.SeqShard.apply(
        qkv, 1, mesh.axis_index(DATA_AXIS), mesh.axis_size(DATA_AXIS),
        mesh.group(DATA_AXIS))
  qkv = collectives.SeqShard.apply(qkv, 2, idx, size, group)
  out = local(qkv[0], qkv[1], qkv[2], mesh, axis_name, causal)
  out = collectives.SeqGather.apply(out, 1, idx, group)
  if data:
    out = collectives.SeqGather.apply(out, 0, mesh.axis_index(DATA_AXIS),
                                      mesh.group(DATA_AXIS))
  return out


def sequence_rows(mesh, batch: int, length: int,
                  axis_name: str = SEQ_AXIS, shard_batch: bool = True,
                  warn: bool = False) -> Tuple[slice, slice]:
  """(rows, steps): this rank's batch rows and T-slice under
  `ring_attention`'s layout (JAX's `sequence_sharding`, `P("data",
  "seq")`). The rows are the whole batch unless `shard_batch` and the
  batch divides by `data`; with `warn` an indivisible batch other than
  1 warns, as JAX's does."""
  rows = slice(0, batch)
  data_size = mesh.axis_size(DATA_AXIS)
  if shard_batch and DATA_AXIS in mesh.axis_names and data_size > 1:
    if batch % data_size == 0:
      per = batch // data_size
      d = mesh.axis_index(DATA_AXIS)
      rows = slice(d * per, (d + 1) * per)
    elif warn and batch != 1:
      warnings.warn(
          f"ring_attention: batch {batch} does not divide the "
          f"{DATA_AXIS!r} axis size {data_size}; replicating the batch "
          "across it (correct but axis_size× redundant compute). Fine "
          "for small-batch serving; a training batch should be a "
          "multiple of the data axis.", RuntimeWarning, stacklevel=3)
  size = mesh.axis_size(axis_name)
  per_t = length // size
  i = mesh.axis_index(axis_name)
  return rows, slice(i * per_t, (i + 1) * per_t)

