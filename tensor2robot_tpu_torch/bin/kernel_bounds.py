"""The least time an H100 could take for each kernel's work, from shapes.

    python -m tensor2robot_tpu_torch.bin.kernel_bounds

A kernel's bound is the larger of two times: the bytes it must move
(each input read once, each output written once) over the card's
memory rate, and the operations it does over the card's peak rate for
their type. Peaks of one H100 SXM at 700 W (NVIDIA data sheet): 3.35
TB/s HBM3, 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s f32
outside them. `chip_smoke.py` calls these functions with the shapes of
its own run; `main` prints one JSON line per TPU kernel of the JAX
package at the shapes the port's PERF.md reports. Needs no card.
"""

from __future__ import annotations

import json
from typing import Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

Bound = Tuple[float, str]  # (ms, "bytes" or "operations")


def bound(nbytes: float, ops: float, elem_bytes: int) -> Bound:
  """max(bytes / HBM rate, ops / peak of the element type), in ms."""
  peak = BF16_OPS_PER_S if elem_bytes == 2 else F32_OPS_PER_S
  mem_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
  return max(mem_ms, ops_ms), "bytes" if mem_ms >= ops_ms else "operations"


def cem_select(p: int, b: int, widths: Sequence[int], a_dim: int,
               elem_bytes: int) -> Bound:
  """`fused_cem_select`: pooled [P, B, C] and the q-head MLP (widths
  C, H0, ..., 1) in the compute dtype, f32 samples [B, P, A] in; mean,
  std, best action [B, A] and best score [B] f32 out."""
  pairs = list(zip(widths[:-1], widths[1:]))
  nbytes = (p * b * widths[0] * elem_bytes + b * p * a_dim * 4
            + sum((i * o + o) * elem_bytes for i, o in pairs)
            + (3 * b * a_dim + b) * 4)
  ops = sum(2 * p * b * i * o for i, o in pairs)
  return bound(nbytes, ops, elem_bytes)


def cem_head_tail(b: int, p: int, h1: int, w1: int, c1: int, c2: int,
                  dense_widths: Sequence[int], elem_bytes: int = 2) -> Bound:
  """`fused_cem_head_tail`: act [B, P, h1, w1, C1], enc0 [B, h1, w1, C1],
  3×3 taps [3, 3, C1, C2] and the dense head (widths C2, ..., 1) in the
  compute dtype, f32 BN scale/shift [C2] in; Q [B, P] f32 out.
  Operations: the stride-2 SAME conv and the head's products."""
  h2, w2 = -(-h1 // 2), -(-w1 // 2)
  pairs = list(zip(dense_widths[:-1], dense_widths[1:]))
  nbytes = (elem_bytes * (b * p * h1 * w1 * c1 + b * h1 * w1 * c1
                          + 9 * c1 * c2 + sum(i * o + o for i, o in pairs))
            + 2 * c2 * 4 + b * p * 4)
  ops = (2 * b * p * h2 * w2 * 9 * c1 * c2
         + sum(2 * b * p * i * o for i, o in pairs))
  return bound(nbytes, ops, elem_bytes)


def _qkv_bytes(b, t, h, d, elem_bytes):
  return b * t * h * d * elem_bytes


def flash_forward(b: int, t: int, h: int, d: int, elem_bytes: int,
                  causal: bool) -> Bound:
  """Flash forward: q, k, v in; out and f32 lse [B, H, T] out;
  4·B·H·T²·D operations (QKᵀ and PV), half of them when causal."""
  nbytes = 4 * _qkv_bytes(b, t, h, d, elem_bytes) + b * h * t * 4
  ops = 4 * b * h * t * t * d / (2 if causal else 1)
  return bound(nbytes, ops, elem_bytes)


def flash_backward_dkdv(b: int, t: int, h: int, d: int, elem_bytes: int,
                        causal: bool) -> Bound:
  """`_dkdv_kernel`: q, k, v, dO and f32 lse, δ in; dK, dV out;
  8·B·H·T²·D operations (recomputed QKᵀ, pᵀdO, dO·Vᵀ, dsᵀQ)."""
  nbytes = (6 * _qkv_bytes(b, t, h, d, elem_bytes) + 2 * b * h * t * 4)
  ops = 8 * b * h * t * t * d / (2 if causal else 1)
  return bound(nbytes, ops, elem_bytes)


def flash_backward_dq(b: int, t: int, h: int, d: int, elem_bytes: int,
                      causal: bool) -> Bound:
  """`_dq_kernel`: q, k, v, dO and f32 lse, δ in; dQ out;
  6·B·H·T²·D operations (recomputed QKᵀ, dO·Vᵀ, ds·K)."""
  nbytes = (5 * _qkv_bytes(b, t, h, d, elem_bytes) + 2 * b * h * t * 4)
  ops = 6 * b * h * t * t * d / (2 if causal else 1)
  return bound(nbytes, ops, elem_bytes)


def main():
  rows = [
      ("tensor2robot_tpu/ops/cem_select.py:181",
       "serving bucket B=8 / Bellman B=256, P=64, C=H=64, A=4, bf16",
       [cem_select(64, b, (64, 64, 64, 1), 4, 2) for b in (8, 256)]),
      ("tensor2robot_tpu/ops/cem_head.py:161",
       "bench.py:1327-1364 B=4 / Bellman target B=256: P=64, 8x8x64 -> 64, "
       "dense (64, 64, 1), bf16",
       [cem_head_tail(b, 64, 8, 8, 64, 64, (64, 64, 64, 1))
        for b in (4, 256)]),
      ("tensor2robot_tpu/ops/flash_attention.py:211",
       "context policy B=1 / B=16, T=512, H=4, D=32, bf16, causal",
       [flash_forward(b, 512, 4, 32, 2, True) for b in (1, 16)]),
      ("tensor2robot_tpu/ops/flash_attention.py:211",
       "gin training shape B=16, T=32, H=4, D=32, bf16, causal (forward)",
       [flash_forward(16, 32, 4, 32, 2, True)]),
      ("tensor2robot_tpu/ops/flash_attention.py:404",
       "gin training shape B=16, T=32, H=4, D=32, bf16, causal (dK, dV)",
       [flash_backward_dkdv(16, 32, 4, 32, 2, True)]),
      ("tensor2robot_tpu/ops/flash_attention.py:434",
       "gin training shape B=16, T=32, H=4, D=32, bf16, causal (dQ)",
       [flash_backward_dq(16, 32, 4, 32, 2, True)]),
  ]
  for kernel, shapes, bounds in rows:
    print(json.dumps({"kernel": kernel, "shapes": shapes,
                      "bound_ms": [ms for ms, _ in bounds],
                      "bound_by": [by for _, by in bounds]}))


if __name__ == "__main__":
  main()
