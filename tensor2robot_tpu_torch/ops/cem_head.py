"""Fused CEM population-head tail: everything after the merge GEMM.

Port of `tensor2robot_tpu/ops/cem_head.py`. `fused_cem_head_tail`
launches the hand-written Hopper kernel `csrc/cem_head.cu` (which
replaces the Pallas `_cem_head_kernel`) on a CUDA tensor, and takes the
plain version `fused_cem_head_tail_reference` only because its tensor
lies on the CPU. There is no fallback: a CUDA tensor launches the kernel
or raises.

Contract (both versions): the merge GEMM's output `act [B, P, h1, w1,
C1]` (compute dtype bf16 or f32, any strides: the Q-network's P-major
`[P, B, ...]` tensor is passed as `act_pm.transpose(0, 1)`), the
batch-normed `enc0 [B, h1, w1, C1]`, the remaining head conv's HWIO
kernel `[3, 3, C1, C2]`, its eval-BN affine `bn_scale`, `bn_shift [C2]`
(f32) and the q-head `((w [in, out], b [out]), ..., (w [H, 1], b [1]))`
→ Q `[B, P]` f32. In order: the enc0 add in f32, relu, rounding to the
compute dtype; the 3×3 stride-2 SAME conv (XLA's (0, 1) padding) with
exact products summed in f32; the BN affine on the f32 accumulator; relu; the
f32 spatial mean, rounded once; the dense head with f32 sums and bias,
relu and rounding between layers. This is not the order of
`GraspingQNetwork.score_population`, which adds enc0 in the compute
dtype and rounds the conv output before batch norm: the two agree to
bf16 tolerance, and in f32 to summation order.

`launch_plan` picks the kernel's path by an explicit rule: bf16 at the
Q-network's shape (h1·w1 = 64, C1 and C2 in {32, 64}) on `wgmma` with
act, enc0 and the taps read by TMA; other bf16 on `mma.sync`; f32 on
CUDA cores. A bf16 act view outside TMA's rule is copied dense first.

The Mosaic-only arguments of the JAX function (`interpret`, `block_b`
and with it the batch's divisibility, the `[B, P, 128]` broadcast
output) have no counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch.ops import build, counters
from tensor2robot_tpu_torch.ops.cem_select import (
    _align,
    _aligned16,
    _mlp_f32,
    qhead_smem,
)

_MAX_LAYERS = 8
_MAX_SMEM = 232448  # 227 KB per block
_HALF_SMEM = 233472 // 2 - 1024  # two blocks on one SM
_PATHS = {"cuda_cores": 0, "mma_sync": 1, "wgmma": 2}
_WGMMA_CHANNELS = (32, 64)  # C1 and C2 the wgmma path is built for
_WGMMA_PIXELS = 64  # h1·w1: 16 output positions, 4 members per product

_ARGTYPES = {
    "t2r_cem_head_tail": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
         ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
         ctypes.c_void_p] + [ctypes.c_int] * 11
        + [ctypes.c_size_t, ctypes.c_void_p]),
}

Dense = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def _check(act, enc0, conv_kernel, bn_scale, bn_shift, dense):
  """The JAX wrapper's contract checks (odd spatial dims raise the same
  ValueError) and the shapes the two versions rely on."""
  if act.dim() != 5:
    raise ValueError(f"act must be [B, P, h1, w1, C1], got {tuple(act.shape)}")
  b, p, h1, w1, c1 = act.shape
  if h1 % 2 or w1 % 2:
    raise ValueError(f"head conv input spatial dims must be even; got "
                     f"({h1}, {w1})")
  if tuple(enc0.shape) != (b, h1, w1, c1):
    raise ValueError(f"enc0 {tuple(enc0.shape)} != {(b, h1, w1, c1)}")
  if tuple(conv_kernel.shape[:3]) != (3, 3, c1) or conv_kernel.dim() != 4:
    raise ValueError(f"conv_kernel {tuple(conv_kernel.shape)} != "
                     f"[3, 3, {c1}, C2]")
  c2 = conv_kernel.shape[-1]
  if tuple(bn_scale.shape) != (c2,) or tuple(bn_shift.shape) != (c2,):
    raise ValueError(f"bn_scale/bn_shift must be [{c2}]")
  width = c2
  for i, (w, bias) in enumerate(dense):
    if w.shape[0] != width or tuple(bias.reshape(-1).shape) != (w.shape[1],):
      raise ValueError(f"q-head layer {i}: w {tuple(w.shape)}, "
                       f"b {tuple(bias.shape)} do not chain from {width}")
    width = w.shape[1]
  if width != 1:
    raise ValueError("q-head MLP must end at width 1")


def fused_cem_head_tail_reference(act: torch.Tensor, enc0: torch.Tensor,
                                  conv_kernel: torch.Tensor,
                                  bn_scale: torch.Tensor,
                                  bn_shift: torch.Tensor,
                                  dense_params: Dense) -> torch.Tensor:
  """The kernel's contract in plain torch, in its rounding order; the
  conv as the TPU kernel writes it, nine tap products over the
  (0, 1)-padded input, each an f32 matmul."""
  b, p, h1, w1, c1 = act.shape
  dtype = act.dtype
  x = torch.relu(act.float() + enc0.float()[:, None]).to(dtype)
  x = F.pad(x.reshape(b * p, h1, w1, c1), (0, 0, 0, 1, 0, 1))
  h2, w2 = h1 // 2, w1 // 2
  kernel = conv_kernel.float()
  acc = None
  for di in range(3):
    for dj in range(3):
      tap = x[:, di:di + 2 * h2:2, dj:dj + 2 * w2:2, :].float()
      prod = tap @ kernel[di, dj]
      acc = prod if acc is None else acc + prod
  y = torch.relu(acc * bn_scale.float() + bn_shift.float())
  pooled = y.mean(dim=(1, 2)).to(dtype)
  dense = [(w, bias.reshape(-1)) for w, bias in dense_params]
  return _mlp_f32(pooled, dense).reshape(b, p)


def fused_cem_head_tail(act: torch.Tensor, enc0: torch.Tensor,
                        conv_kernel: torch.Tensor, bn_scale: torch.Tensor,
                        bn_shift: torch.Tensor,
                        dense_params: Dense) -> torch.Tensor:
  """Fused population tail → Q `[B, P]` f32.

  On a CUDA `act` this launches `csrc/cem_head.cu` on the current stream
  and adds one to `fused_cem_head_tail.launches`; on a CPU `act` it
  returns `fused_cem_head_tail_reference`.
  """
  _check(act, enc0, conv_kernel, bn_scale, bn_shift, dense_params)
  if act.device.type == "cpu":
    return fused_cem_head_tail_reference(act, enc0, conv_kernel, bn_scale,
                                         bn_shift, dense_params)
  if act.device.type != "cuda":
    raise ValueError(f"fused_cem_head_tail: unsupported device {act.device}")
  return _launch(act, enc0, conv_kernel, bn_scale, bn_shift, dense_params)


fused_cem_head_tail.launches = 0


def _tail_smem(off, rows, c2, max_width):
  """Per-member spatial sums and the dense head's two buffers (f32)."""
  off = _align(off + rows * c2 * 4, 16)
  off = _align(off + rows * max_width * 4, 16)
  return _align(off + rows * max_width * 4, 16)


def _mma_smem(h1, w1, c1, c2, max_width, rows):
  """The mma.sync path's bytes (`mma_layout` in csrc/cem_head.cu)."""
  npos = (h1 // 2) * (w1 // 2)
  c1p, c2p = _align(c1, 16), _align(c2, 8)
  row = c1p + 8
  off = _align(rows * h1 * w1 * row * 2, 16)
  off = _align(off + row * 2, 16)
  off = _align(off + 9 * c2p * row * 2, 16)
  off = _align(off + _align(rows * npos, 16) * c2p * 4, 16)
  return _tail_smem(off, rows, c2, max_width)


def _core_smem(h1, w1, c1, c2, max_width, rows, nc):
  """The CUDA-core path's bytes (`core_layout` in csrc/cem_head.cu)."""
  groups = -(-((h1 // 2) * (w1 // 2)) // 4)
  c1p = _align(c1, 4)
  ncp = _align(nc, 4)
  off = _align(rows * h1 * w1 * (c1p + 4) * 4, 16)
  off = _align(off + c1p * 4, 16)
  off = _align(off + 9 * c1p * ncp * 4, 16)
  off = _align(off + rows * groups * ncp * 4, 16)
  return _tail_smem(off, rows, c2, max_width)


def _wgmma_smem(c1, c2, dense_widths, stages):
  """The wgmma path's bytes (`wg_layout` in csrc/cem_head.cu): taps, enc0
  and `stages` groups of 4 members with the q-head laid over them, the
  pooled tile, BN, a zero row, the mbarriers and 1 KB of alignment."""
  off = _align(9 * c1 * c2 * 2, 1024) + _WGMMA_PIXELS * c1 * 2
  off = _align(off, 1024) + stages * 4 * _WGMMA_PIXELS * c1 * 2
  off = _align(max(off, qhead_smem(dense_widths, 0)), 1024) + 64 * c2 * 2
  off = _align(off + 2 * c2 * 4, 16) + 16
  return _align(_align(off, 8) + 8 * (stages + 1), 16) + 1024


def launch_plan(act_shape, c2: int, dense_widths, dtype) -> dict:
  """How `csrc/cem_head.cu` runs a shape, by an explicit rule.

  - "wgmma": bf16 with h1·w1 = 64 (16 output positions), C1 and C2 in
    {32, 64}, at least one hidden dense layer and hidden widths that are
    multiples of 16 up to 256: the conv on `wgmma` from TMA-staged
    members, `stages` groups of 4 members in flight (4, else 2: two
    warpgroups take alternate groups, each with its own stages).
  - "mma_sync": other bf16 whose taps fit in shared memory whole (`rows`
    members per chunk, the most up to 4 that let two CTAs share an SM,
    else that fit).
  - "cuda_cores": f32 and the rest, `rows` members and `channels` output
    channels per chunk, the largest that fit.
  `tensor_cores` is True on the first two. Raises ValueError when dtype,
  depth or shared memory (227 KB) rule every path out.
  """
  _, _, h1, w1, c1 = act_shape
  widths = [int(w) for w in dense_widths]
  if dtype not in (torch.bfloat16, torch.float32):
    raise ValueError(f"act dtype {dtype} not in (bfloat16, float32)")
  if len(widths) - 1 > _MAX_LAYERS:
    raise ValueError(f"q-head has {len(widths) - 1} layers > {_MAX_LAYERS}")
  bf16 = dtype == torch.bfloat16
  max_width = max(widths)
  hidden = widths[1:-1]

  def plan(path, rows, channels, smem, stages=0):
    return {"path": path, "tensor_cores": path != "cuda_cores",
            "rows": rows, "channels": channels, "stages": stages,
            "smem": smem}

  if (bf16 and h1 * w1 == _WGMMA_PIXELS and c1 in _WGMMA_CHANNELS
      and c2 in _WGMMA_CHANNELS and hidden
      and all(h % 16 == 0 and h <= 256 for h in hidden)):
    for stages in (4, 2):
      smem = _wgmma_smem(c1, c2, widths, stages)
      if smem <= _MAX_SMEM:
        return plan("wgmma", 4, c2, smem, stages)
  if bf16:
    for limit in (_HALF_SMEM, _MAX_SMEM):
      for rows in (4, 2, 1):
        smem = _mma_smem(h1, w1, c1, c2, max_width, rows)
        if smem <= limit:
          return plan("mma_sync", rows, c2, smem)
  for rows in (4, 2, 1):
    n = c2
    while True:
      smem = _core_smem(h1, w1, c1, c2, max_width, rows, n)
      if smem <= _MAX_SMEM:
        return plan("cuda_cores", rows, n, smem)
      if n <= 4:
        break
      n = _align((n + 1) // 2, 4)
  raise ValueError(f"fused_cem_head_tail: no launch plan fits 227 KB of "
                   f"shared memory for {h1}x{w1}x{c1} -> {c2}, q-head "
                   f"{widths}")


def _act_strides(act):
  """act's five element strides, a size-1 dim's replaced by its dense
  stride (it is never stepped along)."""
  dense, step = [], 1
  for n in reversed(act.shape):
    dense.insert(0, step)
    step *= n
  return tuple(st if n > 1 else d
               for st, n, d in zip(act.stride(), act.shape, dense))


def meets_tma_rule(act) -> bool:
  """TMA (the wgmma path's loads of act) takes a dense channel dim, a
  16-byte aligned base, and positive strides of a multiple of 16 bytes
  for the other four dims; the kernel's map lists the dims innermost
  first (C1, w1, h1, then P and B by stride), so the w1 stride must not
  exceed the h1 stride, nor that one P's or B's."""
  st = _act_strides(act)
  return (st[4] == 1 and act.data_ptr() % 16 == 0
          and all(x > 0 and x * act.element_size() % 16 == 0
                  for x in st[:4])
          and st[3] <= st[2] <= min(st[0], st[1]))


def needs_dense_copy(act, plan) -> bool:
  """Whether the wrapper copies act dense before the launch: only on the
  wgmma path, for a view outside TMA's rule (never refused)."""
  return plan["path"] == "wgmma" and not meets_tma_rule(act)


def _launch(act, enc0, conv_kernel, bn_scale, bn_shift, dense_params):
  dtype = act.dtype
  b, p, h1, w1, c1 = act.shape
  c2 = conv_kernel.shape[-1]
  n = len(dense_params)
  widths = [c2] + [w.shape[1] for w, _ in dense_params]
  plan = launch_plan(tuple(act.shape), c2, widths, dtype)  # raises if none
  same_dtype = [enc0, conv_kernel] + [t for pair in dense_params
                                      for t in pair]
  for t in same_dtype:
    if t.device != act.device or t.dtype != dtype:
      raise ValueError("enc0, conv_kernel and the q-head must share act's "
                       f"device and dtype ({act.device}, {dtype})")
    if not t.is_contiguous():
      raise ValueError("fused_cem_head_tail needs contiguous enc0, "
                       "conv_kernel and q-head (act may be strided)")
  for t in (bn_scale, bn_shift):
    if (t.device != act.device or t.dtype != torch.float32
        or not t.is_contiguous()):
      raise ValueError("bn_scale/bn_shift must be contiguous f32 on act's "
                       "device")
  if plan["path"] == "wgmma":
    if needs_dense_copy(act, plan):
      act = act.clone(memory_format=torch.contiguous_format)
    enc0, conv_kernel = _aligned16(enc0), _aligned16(conv_kernel)
    dense_params = [(_aligned16(w), bias) for w, bias in dense_params]
  dims = (ctypes.c_int * (n + 1))(*widths)
  lib = build.load("cem_head", _ARGTYPES)
  q = torch.empty((b, p), dtype=torch.float32, device=act.device)
  strides = (ctypes.c_longlong * 5)(*_act_strides(act))
  ws = (ctypes.c_void_p * n)(*[w.data_ptr() for w, _ in dense_params])
  bs = (ctypes.c_void_p * n)(*[bias.data_ptr() for _, bias in dense_params])
  with torch.cuda.device(act.device):
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.t2r_cem_head_tail(
        act.data_ptr(), strides, enc0.data_ptr(), conv_kernel.data_ptr(),
        bn_scale.data_ptr(), bn_shift.data_ptr(), n, ws, bs, dims,
        q.data_ptr(), b, p, h1, w1, c1, c2, int(dtype == torch.bfloat16),
        _PATHS[plan["path"]], plan["rows"], plan["channels"],
        plan["stages"], plan["smem"], stream)
  if err != 0:
    raise RuntimeError(f"cem_head kernel launch failed: CUDA error {err}")
  counters.count(fused_cem_head_tail)
  return q
