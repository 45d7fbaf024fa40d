"""Flash attention forward: exact attention with an online softmax.

Port of the forward half of `tensor2robot_tpu/ops/flash_attention.py`.
`flash_attention` / `flash_attention_with_lse` launch the hand-written
Hopper kernel `csrc/flash_attention.cu` (which replaces the Pallas
`_flash_kernel`) on a CUDA tensor, and take the plain version
`flash_attention_reference` only because their tensors lie on the CPU.
There is no fallback: a CUDA tensor launches the kernel or raises.

Contract (both versions): q, k, v `[B, T, H, D]` → out `[B, T, H, D]`
in q's dtype and lse `[B, H, T]` f32. Scores `(q·k)/√D` in f32, causal
scores past the diagonal −1e30, probabilities rounded to v's dtype
before the f32-accumulated PV product, `out = acc / max(l, 1e-30)`,
`lse = m + log(max(l, 1e-30))`. The kernel runs the softmax online over
64-key tiles; the plain version in one pass, so in bf16 the two round
p against different running maxima and agree to bf16 rounding.

The backward kernels (dK/dV and dQ) are not ported yet (ROADMAP B3b):
a CUDA input that requires grad raises instead of running without one.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Tuple

import torch

from tensor2robot_tpu_torch.ops import build

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
_MAX_GRID_Y = 65535

_ARGTYPES = {
    "t2r_flash_attention_fwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]),
}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The kernel's contract in plain torch, the softmax in one pass;
  materializes the `[B, H, T, T]` scores the kernel never writes."""
  scale = 1.0 / math.sqrt(q.shape[-1])
  s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
  if causal:
    t = q.shape[1]
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
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


def _check(q, k, v):
  if q.dim() != 4:
    raise ValueError(f"q must be [B, T, H, D], got {tuple(q.shape)}")
  if k.shape != q.shape or v.shape != q.shape:
    raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                     f"{tuple(k.shape)}, {tuple(v.shape)}")
  if k.device != q.device or v.device != q.device:
    raise ValueError("q, k, v must share one device")


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Exact attention and its logsumexp: (out [B, T, H, D], lse [B, H, T]).

  On CUDA tensors this launches `csrc/flash_attention.cu` on the current
  stream (one CTA per batch·head and 64-row q block) and adds one to
  `flash_attention.launches`; on CPU tensors it returns
  `flash_attention_reference`.
  """
  _check(q, k, v)
  if q.device.type == "cpu":
    return flash_attention_reference(q, k, v, causal=causal)
  if q.device.type != "cuda":
    raise ValueError(f"flash_attention: unsupported device {q.device}")
  return _launch(q, k, v, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
  """Exact attention, [B, T, H, D] → same (see `flash_attention_with_lse`)."""
  return flash_attention_with_lse(q, k, v, causal=causal)[0]


flash_attention.launches = 0
_COUNT_LOCK = threading.Lock()


def _launch(q, k, v, causal):
  if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
    raise NotImplementedError(
        "flash_attention has no backward on CUDA yet: the dK/dV and dQ "
        "kernels are ROADMAP B3b. Run under torch.inference_mode() or "
        "torch.no_grad().")
  dtype = q.dtype
  if dtype not in (torch.bfloat16, torch.float32):
    raise ValueError(f"q dtype {dtype} not in (bfloat16, float32)")
  if k.dtype != dtype or v.dtype != dtype:
    raise ValueError("q, k, v must share one dtype")
  b, t, h, d = q.shape
  if d not in _HEAD_DIMS:
    raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
  if b * t * h == 0:
    raise ValueError(f"empty attention input {tuple(q.shape)}")
  if b * h > _MAX_GRID_Y:
    raise ValueError(f"B·H = {b * h} > {_MAX_GRID_Y}")
  for name, x in (("q", q), ("k", k), ("v", v)):
    if x.stride(-1) != 1:
      raise ValueError(f"{name} needs a dense last (head_dim) axis, "
                       f"strides {x.stride()}")
  lib = build.load("flash_attention", _ARGTYPES)
  out = torch.empty((b, t, h, d), dtype=dtype, device=q.device)
  lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.t2r_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, t, h, d, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], int(causal), int(dtype == torch.bfloat16),
        1.0 / math.sqrt(d), stream)
  if err != 0:
    raise RuntimeError(
        f"flash_attention kernel launch failed: CUDA error {err}")
  with _COUNT_LOCK:
    flash_attention.launches += 1
  return out, lse
