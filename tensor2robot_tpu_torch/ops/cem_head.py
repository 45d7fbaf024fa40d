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

The Mosaic-only arguments of the JAX function (`interpret`, `block_b`
and with it the batch's divisibility, the `[B, P, 128]` broadcast
output) have no counterpart here.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch.ops import build
from tensor2robot_tpu_torch.ops.cem_select import _mlp_f32

_MAX_LAYERS = 8

_ARGTYPES = {
    "t2r_cem_head_plan": (
        ctypes.c_int,
        [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        + [ctypes.POINTER(ctypes.c_int)] * 3
        + [ctypes.POINTER(ctypes.c_size_t)]),
    "t2r_cem_head_tail": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
         ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
         ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]),
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
_COUNT_LOCK = threading.Lock()


def launch_plan(act_shape, c2: int, dense_widths, dtype) -> dict:
  """How `csrc/cem_head.cu` runs a shape: the conv on tensor cores (bf16
  when its taps fit in shared memory whole) or on CUDA cores, population
  members per CTA chunk, output channels per tap chunk and shared-memory
  bytes. Raises when no plan fits in 227 KB."""
  b, p, h1, w1, c1 = act_shape
  dims = (ctypes.c_int * len(dense_widths))(*dense_widths)
  lib = build.load("cem_head", _ARGTYPES)
  out = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_size_t()]
  if lib.t2r_cem_head_plan(b, p, h1, w1, c1, c2, len(dense_widths) - 1, dims,
                           int(dtype == torch.bfloat16),
                           *[ctypes.byref(x) for x in out]) != 0:
    raise ValueError(f"fused_cem_head_tail: no launch plan fits 227 KB of "
                     f"shared memory for {h1}x{w1}x{c1} -> {c2}, q-head "
                     f"{list(dense_widths)}")
  return {"tensor_cores": bool(out[0].value), "rows": out[1].value,
          "channels": out[2].value, "smem": out[3].value}


def _launch(act, enc0, conv_kernel, bn_scale, bn_shift, dense_params):
  dtype = act.dtype
  if dtype not in (torch.bfloat16, torch.float32):
    raise ValueError(f"act dtype {dtype} not in (bfloat16, float32)")
  if len(dense_params) > _MAX_LAYERS:
    raise ValueError(f"q-head has {len(dense_params)} layers > {_MAX_LAYERS}")
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
  b, p, h1, w1, c1 = act.shape
  c2 = conv_kernel.shape[-1]
  n = len(dense_params)
  widths = [c2] + [w.shape[1] for w, _ in dense_params]
  dims = (ctypes.c_int * (n + 1))(*widths)
  is_bf16 = int(dtype == torch.bfloat16)
  lib = build.load("cem_head", _ARGTYPES)
  launch_plan(tuple(act.shape), c2, widths, dtype)  # raises if none fits
  q = torch.empty((b, p), dtype=torch.float32, device=act.device)
  strides = (ctypes.c_longlong * 5)(*act.stride())
  ws = (ctypes.c_void_p * n)(*[w.data_ptr() for w, _ in dense_params])
  bs = (ctypes.c_void_p * n)(*[bias.data_ptr() for _, bias in dense_params])
  with torch.cuda.device(act.device):
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.t2r_cem_head_tail(
        act.data_ptr(), strides, enc0.data_ptr(), conv_kernel.data_ptr(),
        bn_scale.data_ptr(), bn_shift.data_ptr(), n, ws, bs, dims,
        q.data_ptr(), b, p, h1, w1, c1, c2, is_bf16, stream)
  if err != 0:
    raise RuntimeError(f"cem_head kernel launch failed: CUDA error {err}")
  with _COUNT_LOCK:
    fused_cem_head_tail.launches += 1
  return q
