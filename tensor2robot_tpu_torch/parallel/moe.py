"""Mixture-of-experts feed-forward on one device (port of
`parallel/moe.py`).

The static-shape GShard/Switch formulation: top-k softmax gating with a
fixed per-call expert capacity C = ceil(k · tokens / E ·
capacity_factor); dispatch and combine are dense one-hot tensors over
`[tokens, E, C]`, so every shape is known before the data (a CUDA graph
captures the layer at one token count and keeps that capacity). Tokens
past an expert's capacity are dropped: their combine weight is zero and
the residual stream carries them (the Switch-transformer semantics).

Ported: `expert_capacity`, `top_k_routing`, `moe_mlp` (the functional
core), `MoEMLP` on one device (the JAX module's path without a mesh
`expert` axis) and `collect_aux_losses`. The load-balance loss travels
up through return values (`MoEMLP.forward` returns it beside the
output), where flax sows it into a collection, so it survives
`torch.func.functional_call` and a graph capture. Expert parallelism
over an `expert` axis waits for ROADMAP A11: a mesh with a non-trivial
`expert` axis raises.

Numerics follow the JAX module: the router and its logits are f32 (`x`
cast to f32 before the product), the routing arithmetic is f32, the
dispatch and combine tensors are cast to the compute dtype before the
einsums, the expert params are stored f32 and cast to the compute
dtype, and the expert MLP uses the tanh gelu (`jax.nn.gelu`'s default).
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.parallel.rules import EXPERT_AXIS

_EPS = 1e-9


def expert_capacity(num_tokens: int, num_experts: int, k: int,
                    capacity_factor: float) -> int:
  """Static per-group expert capacity (≥ 1, so every expert has a slot)."""
  return max(1, int(math.ceil(
      k * num_tokens / num_experts * capacity_factor)))


def _one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
  """f32 one-hot of `index` over `n` classes; an index ≥ n gives a zero
  row (`jax.nn.one_hot`'s rule), and no shape depends on the data."""
  classes = torch.arange(n, device=index.device)
  return (index[..., None] == classes).float()


def top_k_routing(logits: torch.Tensor, capacity: int, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Dense dispatch and combine tensors from router logits `[N, E]`.

  Returns ``(dispatch [N, E, C] 0/1 f32, combine [N, E, C] f32, aux)``:
  token n occupies slot c of expert e in `dispatch`; `combine` holds its
  gate weights at the occupied slots, renormalized over the token's kept
  choices (divided by ``max(gate_sum, 1e-9)``); `aux` is Switch's
  load-balance loss ``E · Σ_e f_e·p_e`` over the first choice (1.0 at
  perfect balance).

  Each choice takes the `argmax` of the gates with earlier choices
  zeroed (ties to the lower expert); tokens claim an expert's slots in
  token order, after the slots earlier choices filled
  (``cumsum(onehot) − onehot + counts``), and a slot at or past the
  capacity is dropped.
  """
  n, num_experts = logits.shape
  gates = torch.softmax(logits.float(), dim=-1)
  remaining = gates
  counts = torch.zeros((num_experts,), dtype=torch.float32,
                       device=logits.device)
  dispatch = torch.zeros((n, num_experts, capacity), dtype=torch.float32,
                         device=logits.device)
  combine = torch.zeros_like(dispatch)
  gate_sum = torch.zeros((n,), dtype=torch.float32, device=logits.device)
  aux = None
  for choice in range(k):
    onehot = _one_hot(torch.argmax(remaining, dim=-1), num_experts)
    if choice == 0:
      aux = num_experts * torch.sum(onehot.mean(dim=0) * gates.mean(dim=0))
    position = torch.cumsum(onehot, dim=0) - onehot + counts[None, :]
    slot = torch.sum(position * onehot, dim=-1).to(torch.int32)
    kept = (slot < capacity).float()
    gate = torch.sum(gates * onehot, dim=-1)
    hot = (kept[:, None, None] * onehot[:, :, None]
           * _one_hot(slot, capacity)[:, None, :])
    dispatch = dispatch + hot
    combine = combine + gate[:, None, None] * hot
    gate_sum = gate_sum + gate * kept
    counts = counts + torch.sum(onehot * kept[:, None], dim=0)
    remaining = remaining * (1.0 - onehot)
  combine = combine / torch.clamp(gate_sum, min=_EPS)[:, None, None]
  return dispatch, combine, aux


def moe_mlp(x: torch.Tensor, router: torch.Tensor, w_in: torch.Tensor,
            b_in: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
            *, k: int, capacity_factor: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Dense-dispatch MoE over one token group.

  x `[N, M]`; router `[M, E]` (f32); w_in `[E, M, H]`; b_in `[E, H]`;
  w_out `[E, H, M]`; b_out `[E, M]` (the expert params in x's dtype) →
  (`[N, M]` in x's dtype, the f32 aux loss)."""
  n = x.shape[0]
  num_experts = router.shape[-1]
  capacity = expert_capacity(n, num_experts, k, capacity_factor)
  logits = x.float() @ router
  dispatch, combine, aux = top_k_routing(logits, capacity, k)
  dtype = x.dtype
  xd = torch.einsum("nm,nec->ecm", x, dispatch.to(dtype))
  h = F.gelu(torch.einsum("ecm,emh->ech", xd, w_in) + b_in[:, None, :],
             approximate="tanh")
  y = torch.einsum("ech,ehm->ecm", h, w_out) + b_out[:, None, :]
  out = torch.einsum("ecm,nec->nm", y, combine.to(dtype))
  return out.to(dtype), aux


def _lecun_normal_(param: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
  """flax `lecun_normal()`: a normal truncated to ±2 standard deviations,
  scaled so the result's variance is 1 / fan_in."""
  std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
  nn.init.trunc_normal_(param, 0.0, std, -2 * std, 2 * std,
                        generator=generator)


class MoEMLP(nn.Module):
  """Switch/GShard-style MoE feed-forward, a drop-in for the dense MLP of
  a transformer block, on one device.

  Params, named as the flax module's (so `models.convert` carries them
  over unchanged, in the einsum layout): ``router`` `[M, E]` and the
  expert stack ``moe_expert_w_in`` `[E, M, H]`, ``moe_expert_b_in``
  `[E, H]`, ``moe_expert_w_out`` `[E, H, M]`, ``moe_expert_b_out`` `[E,
  M]`, all stored f32. `forward(x [B, T, M])` returns ``(out [B, T, M],
  aux)``. `mesh` may describe a mesh (`parallel.rules.MeshShape`): one
  with an `expert` axis above 1 asks for expert parallelism, which is
  ROADMAP A11 and raises.
  """

  def __init__(self, model_dim: int, num_experts: int, hidden_dim: int,
               k: int = 2, capacity_factor: float = 2.0, mesh=None,
               dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    if (mesh is not None and EXPERT_AXIS in mesh.axis_names
        and mesh.shape[EXPERT_AXIS] > 1):
      raise NotImplementedError(
          f"MoEMLP over a mesh {EXPERT_AXIS!r} axis of "
          f"{mesh.shape[EXPERT_AXIS]}: expert parallelism is not ported "
          "yet (ROADMAP A11).")
    e, m, h = num_experts, model_dim, hidden_dim
    self.num_experts = e
    self.k = k
    self.capacity_factor = capacity_factor
    self.dtype = dtype
    self.router = nn.Parameter(torch.zeros(m, e))
    self.moe_expert_w_in = nn.Parameter(torch.zeros(e, m, h))
    self.moe_expert_b_in = nn.Parameter(torch.zeros(e, h))
    self.moe_expert_w_out = nn.Parameter(torch.zeros(e, h, m))
    self.moe_expert_b_out = nn.Parameter(torch.zeros(e, m))

  def init_raw_parameters(self, generator: torch.Generator) -> None:
    """flax's init: `lecun_normal` for the router and the expert kernels,
    zeros for the biases. flax's variance scaling counts every axis but
    the last two of a kernel as receptive field, so the fan-in of
    ``w_in [E, M, H]`` is E·M and of ``w_out [E, H, M]`` E·H; the
    router's is M."""
    with torch.no_grad():
      for param in (self.router, self.moe_expert_w_in,
                    self.moe_expert_w_out):
        _lecun_normal_(param, param[..., 0].numel(), generator)
      self.moe_expert_b_in.zero_()
      self.moe_expert_b_out.zero_()

  def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t, m = x.shape
    dtype = self.dtype
    out, aux = moe_mlp(
        x.to(dtype).reshape(b * t, m), self.router,
        self.moe_expert_w_in.to(dtype), self.moe_expert_b_in.to(dtype),
        self.moe_expert_w_out.to(dtype), self.moe_expert_b_out.to(dtype),
        k=self.k, capacity_factor=self.capacity_factor)
    return out.reshape(b, t, m), aux


def collect_aux_losses(losses: Iterable[Optional[torch.Tensor]]
                       ) -> torch.Tensor:
  """The f32 sum of every aux loss given, in order (None entries
  skipped); a CPU 0.0 when there is none, as the JAX function on a model
  that sows none. The sum starts from the first loss (0.0 + a is a), so
  nothing crosses from the host inside a graph capture."""
  total = None
  for loss in losses:
    if loss is not None:
      loss = torch.sum(loss.float())
      total = loss if total is None else total + loss
  return torch.zeros((), dtype=torch.float32) if total is None else total
