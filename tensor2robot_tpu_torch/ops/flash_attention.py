"""Flash attention: exact attention with an online softmax, and its
gradient.

Port of `tensor2robot_tpu/ops/flash_attention.py`. The forward
(`flash_attention` / `flash_attention_with_lse`) launches the
hand-written Hopper kernel `csrc/flash_attention.cu` (which replaces the
Pallas `_flash_kernel`); the backward launches `csrc/flash_attention_bwd.cu`
(which replaces `_dkdv_kernel` and `_dq_kernel`). Each wrapper takes
its plain version only because its tensors lie on the CPU. There is no
fallback: a CUDA tensor launches the kernel or raises.

Forward contract (both versions): q, k, v `[B, T, H, D]` → out
`[B, T, H, D]` in q's dtype and lse `[B, H, T]` f32. Scores `(q·k)/√D`
in f32, causal scores past the diagonal −1e30, probabilities rounded to
v's dtype before the f32-accumulated PV product, `out = acc / max(l,
1e-30)`, `lse = m + log(max(l, 1e-30))`. The kernel runs the softmax
online over 64-key tiles, a running max per tile (bf16: QKᵀ and PV on
tensor cores, `wgmma`, with K/V tiles brought in by TMA, whose rule of
16-byte aligned bases and strides the wrapper checks; f32: on CUDA
cores, which keep the products in full f32); the plain version in one
pass, so in bf16 the two round p against different running maxima and
agree to bf16 rounding.

Backward contract, the `_flash_lse` custom VJP's: differentiable in
both outputs. δ = rowsum(dO·O) − dlse (one torch expression over the
saved `out` in its own dtype; a None dlse counts as zeros), p = exp(s −
lse) recomputed from the saved lse, ds = p·(dO·vᵀ − δ)/√D; p rounded to
dO's dtype before dv = pᵀ·dO, ds to q's dtype before dk = dsᵀ·q and to
k's dtype before dq = ds·k, all accumulated in f32 (bf16: the five
products on tensor cores, `wgmma`, with q, k, v and dO tiles brought in
by TMA; a bf16 operand outside TMA's rule, such as a dO that autograd
hands over with odd strides, is copied dense first; f32: on CUDA
cores). `flash_attention` and `flash_attention_with_lse` go through the
`torch.autograd.Function` `FlashAttention` whenever autograd records
(grad mode on and an input requiring grad); otherwise they call the
forward alone. The forward is one `torch.library` operator,
`torch.ops.t2r.flash_attention_fwd(q, k, v, causal) -> (out, lse)`: its
CUDA implementation pads, chunks and launches the kernel (and counts
each launch), its CPU implementation is the plain version, and its fake
implementation gives the shapes, so `torch.export` keeps it as one node
of an exported program and the kernel launches when that program runs.

Head dims: the kernels take D ∈ {16, 32, 64, 128}. The public path
(`_forward`, `FlashAttention`, `flash_attention_backward`) takes any D ≤
128 on the card: it zero-pads q, k, v (and out, dO) to the next kernel D
(`kernel_head_dim`), keeps the score scale 1/√D of the true D, and
slices the outputs back; zero columns add exact zeros to every product.
It also launches B·H above the grid's 65,535 in batch chunks
(`batch_chunks`). D > 128 raises on the card; the plain versions take
any D.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from tensor2robot_tpu_torch.ops import build, counters

_NEG_INF = -1e30
FORWARD_OP = "t2r::flash_attention_fwd"
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GRID_Y = 65535
_DTYPES = (torch.bfloat16, torch.float32)

_ARGTYPES = {
    "t2r_flash_attention_fwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]),
}
_STRIDES = ctypes.POINTER(ctypes.c_longlong)  # 16 strides: q, k, v, dO
_BWD_ARGTYPES = {
    "t2r_flash_attention_bwd_dkdv": (
        ctypes.c_int,
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
        + [_STRIDES, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_void_p]),
    "t2r_flash_attention_bwd_dq": (
        ctypes.c_int,
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
        + [_STRIDES, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_void_p]),
}

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _causal_mask(t: int, device) -> torch.Tensor:
  return torch.ones((t, t), dtype=torch.bool, device=device).tril()


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The kernel's contract in plain torch, the softmax in one pass;
  materializes the `[B, H, T, T]` scores the kernel never writes.
  `scale` defaults to 1/√D."""
  if scale is None:
    scale = 1.0 / math.sqrt(q.shape[-1])
  s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
  if causal:
    mask = _causal_mask(q.shape[1], q.device)
    s = s.masked_fill(~mask, _NEG_INF)
  m = s.amax(dim=-1, keepdim=True)
  p = torch.exp(s - m)
  if causal:
    p = p.masked_fill(~mask, 0.0)
  l_final = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
  acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
  out = (acc / l_final).transpose(1, 2).to(q.dtype)
  lse = (m + torch.log(l_final))[..., 0]
  return out, lse


def _probs(q, k, lse, causal, scale=None):
  """p = exp(s − lse) [B, H, T, T] f32, as the backward kernels
  recompute it, and the score scale (default 1/√D)."""
  if scale is None:
    scale = 1.0 / math.sqrt(q.shape[-1])
  s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
  if causal:
    mask = _causal_mask(q.shape[1], q.device)
    s = s.masked_fill(~mask, _NEG_INF)
  p = torch.exp(s - lse[..., None])
  if causal:
    p = p.masked_fill(~mask, 0.0)
  return p, scale


def _ds(p, scale, v, do, delta):
  dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
  return p * (dp - delta[..., None]) * scale


def flash_attention_bwd_dkdv_reference(q, k, v, do, lse, delta,
                                       causal: bool = False, scale=None
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
  """`_dkdv_kernel` in plain torch: (dk, dv) in k's and v's dtype."""
  p, scale = _probs(q, k, lse, causal, scale)
  dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
  ds = _ds(p, scale, v, do, delta)
  dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
  return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                     causal: bool = False,
                                     scale=None) -> torch.Tensor:
  """`_dq_kernel` in plain torch: dq in q's dtype."""
  p, scale = _probs(q, k, lse, causal, scale)
  ds = _ds(p, scale, v, do, delta)
  dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
  return dq.to(q.dtype)


def _delta(out: torch.Tensor, do: torch.Tensor,
           dlse: Optional[torch.Tensor]) -> torch.Tensor:
  """δ = rowsum(dO·O) − dlse, [B, H, T] f32 (`_flash_bwd_impl`'s row
  term, over the saved `out` in its own dtype)."""
  delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2)
  if dlse is not None:
    delta = delta - dlse.float()
  return delta.contiguous()


def flash_attention_backward_reference(q, k, v, out, lse, do, dlse=None,
                                       causal: bool = False) -> Tensors3:
  """`_flash_bwd_impl` in plain torch: (dq, dk, dv), materializing p
  from lse with the kernels' roundings."""
  delta = _delta(out, do, dlse)
  dk, dv = flash_attention_bwd_dkdv_reference(q, k, v, do, lse, delta,
                                              causal)
  dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal)
  return dq, dk, dv


def _check(q, k, v):
  if q.dim() != 4:
    raise ValueError(f"q must be [B, T, H, D], got {tuple(q.shape)}")
  if k.shape != q.shape or v.shape != q.shape:
    raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                     f"{tuple(k.shape)}, {tuple(v.shape)}")
  if k.device != q.device or v.device != q.device:
    raise ValueError("q, k, v must share one device")


def _check_launch(*tensors):
  """What every kernel takes: one dtype of (bf16, f32), D in _HEAD_DIMS,
  a non-empty problem, B·H within the grid."""
  dtype = tensors[0].dtype
  if dtype not in _DTYPES:
    raise ValueError(f"q dtype {dtype} not in (bfloat16, float32)")
  if any(t.dtype != dtype for t in tensors):
    raise ValueError("q, k, v (and dO) must share one dtype")
  b, t, h, d = tensors[0].shape
  if d not in _HEAD_DIMS:
    raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
  if b * t * h == 0:
    raise ValueError(f"empty attention input {tuple(tensors[0].shape)}")
  if b * h > _MAX_GRID_Y:
    raise ValueError(f"B·H = {b * h} > {_MAX_GRID_Y}")


def kernel_head_dim(d: int) -> int:
  """The kernel head dim that a head dim `d` runs at: the least of
  `_HEAD_DIMS` that holds it (its columns past `d` zero)."""
  for kd in _HEAD_DIMS:
    if d <= kd:
      return kd
  raise ValueError(f"head dim {d} > {_HEAD_DIMS[-1]}: no flash kernel "
                   "takes it on the card")


def batch_chunks(b: int, h: int, max_grid: int = _MAX_GRID_Y):
  """[start, stop) batch ranges whose B·H each fits the grid's y limit."""
  if h > max_grid:
    raise ValueError(f"H = {h} > {max_grid}")
  step = max_grid // h
  return [(i, min(i + step, b)) for i in range(0, b, step)]


def _pad_head(x: torch.Tensor, d: int) -> torch.Tensor:
  """x with its last dim zero-padded to `d` (x itself when it is d)."""
  if x.shape[-1] == d:
    return x
  return torch.nn.functional.pad(x, (0, d - x.shape[-1]))


def _padded_chunked_forward(launch, q, k, v, causal,
                            max_grid: int = _MAX_GRID_Y):
  """`launch(q, k, v, causal, scale)` over q, k, v padded to the kernel
  head dim and cut into batch chunks within the grid; (out, lse) of the
  true D, scale 1/√D."""
  b, _, h, d = q.shape
  kd = kernel_head_dim(d)
  scale = 1.0 / math.sqrt(d)
  q, k, v = (_pad_head(x, kd) for x in (q, k, v))
  parts = [launch(q[i:j], k[i:j], v[i:j], causal, scale)
           for i, j in batch_chunks(b, h, max_grid)]
  out, lse = (parts[0] if len(parts) == 1 else
              tuple(torch.cat(xs) for xs in zip(*parts)))
  return (out if kd == d else out[..., :d]), lse


@torch.library.custom_op(
    FORWARD_OP, mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, bool causal) -> (Tensor, Tensor)")
def _forward_op(q, k, v, causal):
  """The forward as one opaque operator (`torch.ops.t2r.
  flash_attention_fwd`), so a `torch.export` program holds one node that
  launches the kernel when the program runs. CPU: the plain version."""
  out, lse = flash_attention_reference(q, k, v, causal=causal)
  return out.contiguous(), lse.contiguous()


@_forward_op.register_kernel("cuda")
def _forward_op_cuda(q, k, v, causal):
  """CUDA: the kernel (each launch counted where it happens, so a loaded
  program's launches count when it runs, not when it was traced)."""
  out, lse = _padded_chunked_forward(_launch, q, k, v, causal)
  return out.contiguous(), lse


@_forward_op.register_fake
def _forward_op_fake(q, k, v, causal):
  """Shapes and dtypes for tracing: out like q (dense), lse [B, H, T]
  f32."""
  b, t, h, _ = q.shape
  return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
          torch.empty((b, h, t), dtype=torch.float32, device=q.device))


def _forward(q, k, v, causal):
  if q.device.type not in ("cpu", "cuda"):
    raise ValueError(f"flash_attention: unsupported device {q.device}")
  return torch.ops.t2r.flash_attention_fwd(q, k, v, causal)


class FlashAttention(torch.autograd.Function):
  """The `_flash_lse` custom VJP: (out, lse) forward, and a backward in
  both cotangents (a None one counts as zeros). Saves q, k, v, out and
  lse; recomputes p in the backward."""

  @staticmethod
  def forward(ctx, q, k, v, causal):
    out, lse = _forward(q, k, v, causal)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal = causal
    ctx.set_materialize_grads(False)
    return out, lse

  @staticmethod
  def backward(ctx, dout, dlse):
    q, k, v, out, lse = ctx.saved_tensors
    if dout is None:
      dout = torch.zeros_like(out)
    dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout, dlse,
                                          causal=ctx.causal)
    return dq, dk, dv, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Exact attention and its logsumexp: (out [B, T, H, D], lse [B, H, T]).

  On CUDA tensors this launches `csrc/flash_attention.cu` on the current
  stream (one CTA per batch·head and 64-row q block) and adds one to
  `flash_attention.launches`; on CPU tensors it returns
  `flash_attention_reference`. Differentiable in both outputs through
  `FlashAttention` (backward: `flash_attention_backward`).
  """
  _check(q, k, v)
  if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
    return FlashAttention.apply(q, k, v, causal)
  return _forward(q, k, v, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
  """Exact attention, [B, T, H, D] → same (see `flash_attention_with_lse`)."""
  return flash_attention_with_lse(q, k, v, causal=causal)[0]


def flash_attention_backward(q, k, v, out, lse, do, dlse=None,
                             causal: bool = False) -> Tensors3:
  """(dq, dk, dv) of `flash_attention_with_lse` from its saved out and
  lse and the cotangents dO (and dlse, None = zeros).

  δ is one torch expression; then `flash_attention_bwd_dkdv` and
  `flash_attention_bwd_dq` launch their kernels on CUDA tensors (or run
  their plain versions on CPU tensors).
  """
  _check(q, k, v)
  if do.shape != q.shape or out.shape != q.shape:
    raise ValueError(f"dO {tuple(do.shape)} and out {tuple(out.shape)} "
                     f"must be {tuple(q.shape)}")
  delta = _delta(out, do, dlse)
  if q.device.type == "cpu":
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    return dq, dk, dv
  return _padded_chunked_backward(_launch_bwd, q, k, v, do, lse, delta,
                                  causal)


def _padded_chunked_backward(launch_bwd, q, k, v, do, lse, delta, causal,
                             max_grid: int = _MAX_GRID_Y) -> Tensors3:
  """`launch_bwd(dkdv, q, k, v, do, lse, delta, causal, scale)` (the
  dK/dV then the dQ launch) over operands padded to the kernel head dim
  and cut into batch chunks within the grid; (dq, dk, dv) of the true D,
  scale 1/√D. Zero columns of q and k leave every score as it is, and
  zero columns of v and dO leave dO·vᵀ as it is."""
  b, _, h, d = q.shape
  kd = kernel_head_dim(d)
  scale = 1.0 / math.sqrt(d)
  q, k, v, do = (_pad_head(x, kd) for x in (q, k, v, do))
  parts = []
  for i, j in batch_chunks(b, h, max_grid):
    ops = (q[i:j], k[i:j], v[i:j], do[i:j], lse[i:j], delta[i:j], causal,
           scale)
    dk, dv = launch_bwd(True, *ops)
    dq = launch_bwd(False, *ops)[0]
    parts.append((dq, dk, dv))
  grads = (parts[0] if len(parts) == 1 else
           tuple(torch.cat(xs) for xs in zip(*parts)))
  return tuple(g if kd == d else g[..., :d] for g in grads)


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(dk, dv): on CUDA tensors launches the dK/dV kernel (one CTA per
  batch·head and 64-key block) and adds one to
  `flash_attention_bwd_dkdv.launches`; on CPU tensors the plain version."""
  if q.device.type == "cpu":
    return flash_attention_bwd_dkdv_reference(q, k, v, do, lse, delta, causal)
  return _launch_bwd(True, q, k, v, do, lse, delta, causal)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = False
                           ) -> torch.Tensor:
  """dq: on CUDA tensors launches the dQ kernel (one CTA per batch·head
  and 64-row q block) and adds one to `flash_attention_bwd_dq.launches`;
  on CPU tensors the plain version."""
  if q.device.type == "cpu":
    return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal)
  return _launch_bwd(False, q, k, v, do, lse, delta, causal)[0]


flash_attention.launches = 0
flash_attention_bwd_dkdv.launches = 0
flash_attention_bwd_dq.launches = 0


def _dense_strides(x):
  """x's batch, time and head strides in elements; a dim of size 1 is
  never stepped along and gets its dense stride."""
  _, t, h, d = x.shape
  return tuple(s if n > 1 else dense for s, n, dense in
               zip(x.stride()[:3], x.shape[:3], (t * h * d, h * d, d)))


def _meets_tma_rule(x) -> bool:
  """TMA (the bf16 kernels' loads) takes a dense last dim, a 16-byte
  aligned base, and batch, time and head strides of a multiple of 16
  bytes."""
  return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s * x.element_size() % 16 == 0 for s in _dense_strides(x)))


def _view_strides(name, x):
  """x's batch, time and head strides in elements, as the forward kernel
  reads them. The last dim must be dense; bf16 must also meet TMA's rule
  (`_meets_tma_rule`): anything else raises."""
  if x.stride(-1) != 1:
    raise ValueError(f"{name} needs a dense last (head_dim) axis, "
                     f"strides {x.stride()}")
  if x.dtype == torch.bfloat16 and not _meets_tma_rule(x):
    raise ValueError(
        f"{name}: the bf16 forward loads by TMA, which needs a 16-byte "
        f"aligned base and batch, time and head strides of a multiple of "
        f"16 bytes; got base % 16 = {x.data_ptr() % 16} and strides "
        f"{x.stride()} of {x.element_size()}-byte elements")
  return _dense_strides(x)


def _bwd_operand(x):
  """A backward operand as its kernel reads it: f32 through its four
  strides as it is; bf16 in place where it meets TMA's rule, else a dense
  copy (autograd may hand over any dO)."""
  if x.dtype == torch.bfloat16 and not _meets_tma_rule(x):
    x = x.clone(memory_format=torch.contiguous_format)
  return x


def load_libraries() -> None:
  """Builds (where not built yet) and loads the forward and backward
  kernel libraries, ahead of a first launch (no capture may be open)."""
  build.load("flash_attention", _ARGTYPES)
  build.load("flash_attention_bwd", _BWD_ARGTYPES)


def _launch(q, k, v, causal, scale=None):
  """One forward launch at a kernel head dim; `scale` defaults to 1/√D."""
  _check_launch(q, k, v)
  b, t, h, d = q.shape
  strides = [s for name, x in (("q", q), ("k", k), ("v", v))
             for s in _view_strides(name, x)]
  lib = build.load("flash_attention", _ARGTYPES)
  out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
  lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.t2r_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, t, h, d, *strides, int(causal),
        int(q.dtype == torch.bfloat16),
        1.0 / math.sqrt(d) if scale is None else scale, stream)
  if err != 0:
    raise RuntimeError(
        f"flash_attention kernel launch failed: CUDA error {err}")
  counters.count(flash_attention)
  return out, lse


def _launch_bwd(dkdv: bool, q, k, v, do, lse, delta, causal, scale=None):
  """Launches the dK/dV (`dkdv`) or the dQ kernel; q, k, v and dO are
  read in place through their strides (bf16 ones that TMA cannot read are
  copied dense first), lse and δ must be dense [B, H, T] f32; `scale`
  defaults to 1/√D."""
  _check_launch(q, k, v, do)
  b, t, h, d = q.shape
  for name, x in (("lse", lse), ("delta", delta)):
    if (x.shape != (b, h, t) or x.dtype != torch.float32
        or not x.is_contiguous() or x.device != q.device):
      raise ValueError(f"{name} must be a dense [B, H, T] f32 tensor on "
                       f"{q.device}, got {tuple(x.shape)} {x.dtype}")
  if q.device.type != "cuda":
    raise ValueError(f"flash_attention backward: unsupported device "
                     f"{q.device}")
  q, k, v, do = (_bwd_operand(x) for x in (q, k, v, do))
  lib = build.load("flash_attention_bwd", _BWD_ARGTYPES)
  strides = (ctypes.c_longlong * 16)(
      *(s for x in (q, k, v, do) for s in _dense_strides(x) + (x.stride(3),)))
  fn_name = ("t2r_flash_attention_bwd_dkdv" if dkdv
             else "t2r_flash_attention_bwd_dq")
  outs = [torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
          for _ in range(2 if dkdv else 1)]
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn_name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
        b, t, h, d, strides, int(causal), int(q.dtype == torch.bfloat16),
        1.0 / math.sqrt(d) if scale is None else scale, stream)
  if err != 0:
    raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err}")
  counter = flash_attention_bwd_dkdv if dkdv else flash_attention_bwd_dq
  counters.count(counter)
  return outs
