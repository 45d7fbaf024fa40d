"""Fused CEM iteration tail: q-head scoring + top-E + elite statistics.

Port of `tensor2robot_tpu/ops/cem_select.py`. `fused_cem_select`
launches the hand-written Hopper kernel `csrc/cem_select.cu` (which
replaces the Pallas `_cem_select_kernel`) on a CUDA tensor, and takes
the plain version `cem_select_reference` only because its tensor lies
on the CPU. There is no fallback: a CUDA tensor launches the kernel or
raises. `_plan` picks the kernel's path by an explicit rule: bf16 q-heads
of the widths `wgmma` takes run on tensor cores (version 2), everything
else on CUDA cores (version 1); shapes neither fits raise before
anything is built.

Contract (both versions): pooled population features `[P, B, C]`
(P-major, compute dtype bf16 or f32), candidate actions `[B, P, A]`,
q-head `((w [in, out], b [out]), ..., (w [H, 1], b [1]))` in pooled's
dtype → `(mean, std, best_action)` `[B, A]` f32 and `best_score` `[B]`
f32. MLP products accumulate in f32 with hidden activations rounded to
the compute dtype; the optional sigmoid runs before selection; ties go
to the lower sample index; std uses ddof 0, floored at `min_std`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from tensor2robot_tpu_torch.ops import build, counters

_MAX_LAYERS = 8
_MAX_SMEM = 232448 - 64  # 227 KB, less version 1's static scratch
_ROWS = 64  # a wgmma tile's rows: population members per tile
_WGMMA_WIDTHS = (16, 32, 64, 128, 256)  # pooled widths C (TMA boxes)
_MAX_ELITES = 64  # warp 0 keeps two elites per lane

_ARGTYPES = {
    "t2r_cem_select": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
         ctypes.POINTER(ctypes.c_int),
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_size_t, ctypes.c_void_p]),
}

Dense = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def _mlp_f32(x: torch.Tensor, dense: Dense) -> torch.Tensor:
  """The q-head MLP with f32 accumulation; x [N, C] → [N] f32."""
  h = x
  for i, (w, b) in enumerate(dense):
    h = h.float() @ w.float() + b.float()
    if i < len(dense) - 1:
      h = torch.relu(h).to(x.dtype)
  return h[:, 0]


def select_elites(scores: torch.Tensor, samples: torch.Tensor,
                  num_elites: int, min_std: float):
  """[B, P] scores → (mean, std, best_action, best_score) of the top
  `num_elites` samples. A stable descending sort gives `lax.top_k`'s
  tie order (`torch.topk` documents none); std uses ddof 0."""
  b, _, a_dim = samples.shape
  idx = torch.sort(scores, dim=1, descending=True, stable=True).indices
  idx = idx[:, :num_elites]
  elites = torch.gather(samples.float(), 1,
                        idx[..., None].expand(b, num_elites, a_dim))
  mean = elites.mean(dim=1)
  std = ((elites - mean[:, None]) ** 2).mean(dim=1).sqrt()
  return (mean, std.clamp_min(min_std), elites[:, 0],
          torch.gather(scores, 1, idx[:, :1])[:, 0])


def cem_select_reference(pooled: torch.Tensor, samples: torch.Tensor,
                         dense: Dense, num_elites: int,
                         min_std: float = 1e-2, sigmoid: bool = False):
  """The kernel's contract in plain torch (`cem_select_lax`'s twin);
  materializes the `[B, P]` scores the kernel never writes."""
  p, b, c = pooled.shape
  scores = _mlp_f32(pooled.reshape(p * b, c), dense).reshape(p, b).t()
  if sigmoid:
    scores = torch.sigmoid(scores)
  return select_elites(scores, samples, num_elites, min_std)


def _check(pooled, samples, dense, num_elites):
  """The JAX wrapper's guards; Mosaic-only limits are not carried over."""
  p, b, _ = pooled.shape
  if tuple(samples.shape[:2]) != (b, p):
    raise ValueError(f"samples {tuple(samples.shape)} != [B={b}, P={p}, A]")
  if num_elites > p:
    raise ValueError(f"num_elites {num_elites} > population {p}")
  if dense[-1][0].shape[-1] != 1:
    raise ValueError("q-head MLP must end at width 1")
  width = pooled.shape[-1]
  for i, (w, bias) in enumerate(dense):
    if w.shape[0] != width or tuple(bias.shape) != (w.shape[1],):
      raise ValueError(f"q-head layer {i}: w {tuple(w.shape)}, "
                       f"b {tuple(bias.shape)} do not chain from {width}")
    width = w.shape[1]


def _align(n: int, a: int) -> int:
  return -(-n // a) * a


def _core_smem(p: int, widths: Sequence[int], elem: int) -> int:
  """Version 1's shared-memory bytes (`smem_layout` in the .cu file):
  weights and biases, P rows (rounded up to 4) of input and two hidden
  buffers, then scores, taken flags and elites."""
  off = 0
  for k, n in zip(widths[:-1], widths[1:]):
    off = _align(off + k * n * elem, 16)
    off = _align(off + n * elem, 16)
  widest = max(widths[1:-1], default=0)
  rows = _align(p, 4)
  for width in (widths[0], widest, widest):
    off = _align(off + rows * width * elem, 16)
  for _ in range(3):
    off = _align(off + p * 4, 16)
  return off


def qhead_smem(widths: Sequence[int], off: int) -> int:
  """End of the q-head's weights placed from byte `off` (`qhead::layout`
  in csrc/qhead.cuh): each hidden layer's bf16 tile of K rows by its
  width padded to 64 (1024-B aligned; K is widths[0] for the first, the
  padded width before it after), the f32 biases, the f32 last column and
  its bias."""
  hidden = list(widths[1:-1])
  for i, n in enumerate(hidden):
    k = widths[0] if i == 0 else _align(widths[i], 64)
    off = _align(off, 1024) + k * _align(n, 64) * 2
  off += sum(_align(n, 64) * 4 for n in hidden)
  return _align(off + (_align(widths[-2], 64) + 4) * 4, 16)


def _wgmma_smem(p: int, widths: Sequence[int], a_dim: int) -> int:
  """Version 2's shared-memory bytes (`wg_layout` in the .cu file): one
  or two 64-row pooled stages, the q-head, 128 candidates' scores and
  indices, two mbarriers, the state's samples, 1 KB of alignment."""
  off = (2 if p > _ROWS else 1) * _ROWS * widths[0] * 2
  off = qhead_smem(widths, off) + 2 * (2 * _ROWS) * 4 + 16
  return _align(off + p * a_dim * 4, 16) + 1024


def _plan(p: int, widths: Sequence[int], dtype, num_elites: int = 1,
          a_dim: int = 1) -> dict:
  """The kernel's path for a shape, as a plain rule: `{"path", "smem"}`.

  "wgmma" (version 2, tensor cores) takes bf16 with C a power of two
  from 16 to 256, at least one hidden layer, every hidden width a
  multiple of 16 up to 256, at most 64 elites, within 227 KB. Everything
  else that fits takes "cuda_cores" (version 1: f32, odd widths, no
  hidden layer). Raises ValueError when neither fits.
  """
  widths = [int(w) for w in widths]
  if dtype not in (torch.bfloat16, torch.float32):
    raise ValueError(f"pooled dtype {dtype} not in (bfloat16, float32)")
  if len(widths) - 1 > _MAX_LAYERS:
    raise ValueError(f"q-head has {len(widths) - 1} layers > {_MAX_LAYERS}")
  hidden = widths[1:-1]
  if (dtype == torch.bfloat16 and widths[0] in _WGMMA_WIDTHS and hidden
      and all(h % 16 == 0 and h <= 256 for h in hidden)
      and num_elites <= _MAX_ELITES):
    smem = _wgmma_smem(p, widths, a_dim)
    if smem <= _MAX_SMEM:
      return {"path": "wgmma", "smem": smem}
  smem = _core_smem(p, widths, 2 if dtype == torch.bfloat16 else 4)
  if smem <= _MAX_SMEM:
    return {"path": "cuda_cores", "smem": smem}
  raise ValueError(f"fused_cem_select needs {smem} B of shared memory "
                   f"(P={p}, widths {widths}) > {_MAX_SMEM} B")


def _aligned16(x: torch.Tensor) -> torch.Tensor:
  """x itself when its data starts on a 16-byte boundary (TMA and the
  kernels' 16-byte loads need it), else an aligned copy."""
  return x if x.data_ptr() % 16 == 0 else x.clone()


def fused_cem_select(pooled: torch.Tensor, samples: torch.Tensor,
                     dense: Dense, num_elites: int, min_std: float = 1e-2,
                     sigmoid: bool = False):
  """Fused CEM iteration tail → (mean, std, best_action, best_score).

  On a CUDA `pooled` this launches `csrc/cem_select.cu` on the current
  stream (one CTA per state, on the path `_plan` picks) and adds one to
  `fused_cem_select.launches`; on a CPU `pooled` it returns
  `cem_select_reference`.
  """
  _check(pooled, samples, dense, num_elites)
  if pooled.device.type == "cpu":
    return cem_select_reference(pooled, samples, dense, num_elites,
                                min_std=min_std, sigmoid=sigmoid)
  if pooled.device.type != "cuda":
    raise ValueError(f"fused_cem_select: unsupported device {pooled.device}")
  return _launch(pooled, samples, dense, num_elites, min_std, sigmoid)


fused_cem_select.launches = 0


def _launch(pooled, samples, dense, num_elites, min_std, sigmoid):
  dtype = pooled.dtype
  p, b, c = pooled.shape
  a_dim = samples.shape[-1]
  widths = [c] + [w.shape[1] for w, _ in dense]
  plan = _plan(p, widths, dtype, num_elites, a_dim)  # raises if none fits
  tensors = [pooled] + [t for pair in dense for t in pair]
  for t in tensors:
    if t.device != pooled.device or t.dtype != dtype:
      raise ValueError("q-head params must share pooled's device and "
                       f"dtype ({pooled.device}, {dtype})")
    if not t.is_contiguous():
      raise ValueError("fused_cem_select needs contiguous tensors")
  if samples.device != pooled.device:
    raise ValueError("samples must be on pooled's device")
  samples = samples.float().contiguous()
  wgmma = plan["path"] == "wgmma"
  if wgmma:
    pooled = _aligned16(pooled)
    dense = [(_aligned16(w), bias) for w, bias in dense]
  lib = build.load("cem_select", _ARGTYPES)
  n = len(dense)
  dims = (ctypes.c_int * (n + 1))(*widths)
  out = torch.empty((3, b, a_dim), dtype=torch.float32, device=pooled.device)
  best_score = torch.empty((b,), dtype=torch.float32, device=pooled.device)
  ws = (ctypes.c_void_p * n)(*[w.data_ptr() for w, _ in dense])
  bs = (ctypes.c_void_p * n)(*[bias.data_ptr() for _, bias in dense])
  with torch.cuda.device(pooled.device):
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.t2r_cem_select(
        pooled.data_ptr(), samples.data_ptr(), n, ws, bs, dims,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        best_score.data_ptr(), p, b, a_dim, num_elites, float(min_std),
        int(sigmoid), int(dtype == torch.bfloat16), int(wgmma),
        plan["smem"], stream)
  if err != 0:
    raise RuntimeError(f"cem_select kernel launch failed: CUDA error {err}")
  counters.count(fused_cem_select)
  return out[0], out[1], out[2], best_score
