"""Mixture-density-network head (port of `layers/mdn.py`).

A diagonal-Gaussian mixture over `output_size` action dims, written
directly in torch ops (log_softmax + logsumexp), op for op as the JAX
module: the projection in the compute dtype, the f32 cast right after
it, then the log-scale clip. `mdn_mode` breaks ties between equally
likely components toward the lower index (`torch.argmax`, as
`jnp.argmax`). `mdn_sample` draws from an explicit `torch.Generator`
(Gumbel-max for the component, a normal for the noise), where the JAX
function splits a key: the same distribution, other numbers.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from tensor2robot_tpu_torch.layers.core import dense

_LOG_2PI = math.log(2.0 * math.pi)


class MDNParams(NamedTuple):
  """Mixture parameters: shapes (..., K), (..., K, D), (..., K, D)."""

  logits: torch.Tensor
  means: torch.Tensor
  log_scales: torch.Tensor


class MDNHead(nn.Module):
  """Projects [..., in_features] features to mixture params over
  `output_size` dims; the projection is named ``mdn_proj`` as in flax."""

  def __init__(self, in_features: int, num_components: int,
               output_size: int, min_log_scale: float = -5.0,
               max_log_scale: float = 2.0,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.num_components = num_components
    self.output_size = output_size
    self.min_log_scale = min_log_scale
    self.max_log_scale = max_log_scale
    self.dtype = dtype
    self.mdn_proj = nn.Linear(in_features,
                              num_components * (1 + 2 * output_size))

  def forward(self, features: torch.Tensor) -> MDNParams:
    k, d = self.num_components, self.output_size
    raw = dense(self.mdn_proj, features, self.dtype).float()
    lead = tuple(raw.shape[:-1])
    logits = raw[..., :k]
    means = raw[..., k:k + k * d].reshape(lead + (k, d))
    log_scales = raw[..., k + k * d:].reshape(lead + (k, d))
    log_scales = torch.clamp(log_scales, self.min_log_scale,
                             self.max_log_scale)
    return MDNParams(logits, means, log_scales)


def mdn_log_prob(params: MDNParams, targets: torch.Tensor) -> torch.Tensor:
  """log p(targets) under the mixture; targets (..., D) -> (...)."""
  t = targets[..., None, :]  # broadcast over components
  inv_scales = torch.exp(-params.log_scales)
  z = (t - params.means) * inv_scales
  comp_lp = -0.5 * torch.sum(z * z + _LOG_2PI, dim=-1) - torch.sum(
      params.log_scales, dim=-1)
  mix_lp = torch.log_softmax(params.logits, dim=-1)
  return torch.logsumexp(mix_lp + comp_lp, dim=-1)


def mdn_loss(params: MDNParams, targets: torch.Tensor) -> torch.Tensor:
  """Mean negative log likelihood."""
  return -torch.mean(mdn_log_prob(params, targets))


def _take_component(values: torch.Tensor,
                    index: torch.Tensor) -> torch.Tensor:
  """values (..., K, D) at component index (...) -> (..., D)."""
  idx = index[..., None, None].expand(
      tuple(index.shape) + (1, values.shape[-1]))
  return torch.gather(values, -2, idx).squeeze(-2)


def mdn_mode(params: MDNParams) -> torch.Tensor:
  """Mean of the most likely component: the standard greedy action.
  Ties go to the lower component index."""
  return _take_component(params.means, torch.argmax(params.logits, dim=-1))


def mdn_mean(params: MDNParams) -> torch.Tensor:
  """Full mixture mean."""
  weights = torch.softmax(params.logits, dim=-1)
  return torch.sum(weights[..., None] * params.means, dim=-2)


def mdn_sample(params: MDNParams,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
  """Draws one sample per leading batch element from `generator` (on the
  params' device): a component by Gumbel-max over the logits, then its
  mean plus its scale times a standard normal."""
  logits = params.logits
  uniform = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=torch.float32)
  tiny = torch.finfo(torch.float32).tiny
  gumbel = -torch.log(-torch.log(uniform.clamp_min(tiny)))
  comp = torch.argmax(logits.float() + gumbel, dim=-1)
  means = _take_component(params.means, comp)
  log_scales = _take_component(params.log_scales, comp)
  eps = torch.randn(means.shape, generator=generator, device=means.device,
                    dtype=means.dtype)
  return means + torch.exp(log_scales) * eps
