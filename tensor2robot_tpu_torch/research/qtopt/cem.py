"""Cross-entropy-method action optimization (port of
`research/qtopt/cem.py`).

The JAX version is one `lax.scan`; here the 2-3 refinement iterations
are a Python loop of device ops. Noise: `jax.random` cannot be
reproduced in torch, so `cem_maximize` takes either a `torch.Generator`
(on the device the work runs on) or the whole noise tensor
`[iterations, B, P, A]`, which lets a test feed both packages the same
samples.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from tensor2robot_tpu_torch.device import resolve_device
from tensor2robot_tpu_torch.ops.cem_select import select_elites


class CEMResult(NamedTuple):
  best_action: torch.Tensor   # [B, A]
  best_score: torch.Tensor    # [B]
  mean: torch.Tensor          # [B, A] final distribution mean
  std: torch.Tensor           # [B, A]


def cem_maximize(
    score_fn: Optional[Callable[[torch.Tensor], torch.Tensor]],
    batch_size: int,
    action_dim: int,
    iterations: int = 3,
    population: int = 64,
    num_elites: int = 6,
    low: float = -1.0,
    high: float = 1.0,
    init_mean: Optional[torch.Tensor] = None,
    init_std: Optional[torch.Tensor] = None,
    min_std: float = 1e-2,
    select_fn: Optional[Callable] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    device=None,
) -> CEMResult:
  """Maximizes `score_fn` over actions per batch element.

  Args mirror the JAX function, with the PRNG key replaced by either
  `generator` (draws `[B, P, A]` standard normals per iteration) or
  `noise` `[iterations, B, P, A]`. `select_fn(samples, min_std)` is the
  fused replacement of the score → top-k → elite-stats tail
  (`ops.fused_cem_select` through the learner). `device` defaults to
  the noise's or generator's device; with neither, to the CUDA card
  (`resolve_device(None)`, which raises without one): the CPU only when
  asked for.
  """
  if score_fn is None and select_fn is None:
    raise ValueError("one of score_fn / select_fn is required")
  if noise is not None:
    expect = (iterations, batch_size, population, action_dim)
    if tuple(noise.shape) != expect:
      raise ValueError(f"noise {tuple(noise.shape)} != {expect}")
    device = noise.device
  elif device is None:
    device = (generator.device if generator is not None
              else resolve_device(None))
  f32 = dict(dtype=torch.float32, device=device)
  mean = (torch.full((batch_size, action_dim), (low + high) / 2.0, **f32)
          if init_mean is None else init_mean)
  std = (torch.full((batch_size, action_dim), (high - low) / 2.0, **f32)
         if init_std is None else init_std)
  best_action = torch.zeros((batch_size, action_dim), **f32)
  best_score = torch.full((batch_size,), float("-inf"), **f32)
  for it in range(iterations):
    eps = (noise[it].float() if noise is not None else torch.randn(
        (batch_size, population, action_dim), generator=generator, **f32))
    samples = (mean[:, None, :] + std[:, None, :] * eps).clamp(low, high)
    if select_fn is not None:
      mean, std, it_best, it_best_score = select_fn(samples, min_std)
    else:
      mean, std, it_best, it_best_score = select_elites(
          score_fn(samples), samples, num_elites, min_std)
    improved = it_best_score > best_score
    best_action = torch.where(improved[:, None], it_best, best_action)
    best_score = torch.maximum(best_score, it_best_score)
  return CEMResult(best_action, best_score, mean, std)


def draw_noise(generator: torch.Generator, iterations: int, batch_size: int,
               population: int, action_dim: int) -> torch.Tensor:
  """The `[iterations, B, P, A]` noise `cem_maximize` draws from
  `generator` (one `[B, P, A]` standard-normal draw per iteration), as a
  tensor to pass as its `noise`."""
  return torch.stack([torch.randn(
      (batch_size, population, action_dim), generator=generator,
      dtype=torch.float32, device=generator.device)
                      for _ in range(iterations)])


def make_encoded_q_score_fn(network, state_features
                            ) -> Callable[[torch.Tensor], torch.Tensor]:
  """Score fn over an encode/head-split Q-network (a bound module).

  The torso (`network.encode`) runs ONCE per state and the population
  is scored by `score_population` — no tiled torso maps. (The JAX
  version also has a tiled `head` path for networks without
  `score_population`; the port has no such network yet.)
  """
  flat_state = dict(state_features.to_flat_dict()
                    if hasattr(state_features, "to_flat_dict")
                    else state_features)
  encoded = network.encode(flat_state.pop("image"))
  # A stale "action" among the state features would become an extra
  # input; the candidates replace it, so drop it.
  extras = {k: v for k, v in flat_state.items() if k != "action"}
  return lambda actions: network.score_population(  # noqa: E731
      encoded, extras, actions)
