"""QT-Opt grasping Q-network (port of `research/qtopt/networks.py`).

The bf16/f32 tower: camera image + proposed action (+ extra state
floats) → grasp-success Q logit, split at the action merge into
`encode(image)` (action-independent torso, run once per state) and
`head(encoded, features)`; `score_population` / `pool_population`
score a whole CEM population through the linearity-split merge
without tiling the torso map, and `head_tail_params` hands the tail
after the merge to `ops.fused_cem_head_tail`. The int8 CEM tower
(`quantize_tower`, `quantized_encode`, `quantized_score_population`,
`quantized_pool_population`) is at the end of the module; its
activation scales come from `GraspingQNetwork.calibration_stats`.

Layouts follow the JAX package at every public method — NHWC maps,
P-major `[P, B, C]` pooled features, `[B, P]` scores — so converted
weights (`models/convert.py`) give the same numbers. Parameter names
are the flax names (``torso_conv_0``, ``head_bn_1``, ``q_head.dense_0``
...).

Numerics mirror flax layer by layer: each layer casts input and f32
master weights to the compute dtype; batch norm runs in f32 and rounds
its output to the compute dtype; spatial means accumulate in f32 and
round once. SAME padding, batch norm and the spatial mean are the
shared ones of `layers/vision_layers.py`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from tensor2robot_tpu_torch.layers import MLP, dense
from tensor2robot_tpu_torch.layers.vision_layers import (
    _BN_EPS,
    BatchNorm,
    conv2d_same,
    conv_same,
    spatial_mean,
)
from tensor2robot_tpu_torch.models.critic_model import Q_VALUE


def _gather_action_extras(features, dtype: torch.dtype) -> torch.Tensor:
  """Flattens action + every non-image float feature, sorted by key."""
  flat = (features.to_flat_dict() if hasattr(features, "to_flat_dict")
          else dict(features))
  action = flat["action"]
  extras = [action.reshape(action.shape[0], -1).to(dtype)]
  for key in sorted(flat):
    if key in ("image", "action"):
      continue
    value = flat[key]
    if value.is_floating_point():
      extras.append(value.reshape(value.shape[0], -1).to(dtype))
  return torch.cat(extras, dim=-1)


class GraspingQNetwork(nn.Module):
  """Image + action → Q logit, QT-Opt-paper style.

  `forward` in train mode (`network.train()`, the critic's loss) batch-
  norms with batch statistics, as flax's `__call__(train=True)`; the
  population paths are eval-only (running statistics), as in JAX.
  Unlike flax, torch needs input widths up front: `action_dim` and
  `extra_features_dim` (the flattened width of every float extra state
  feature) size the action embedding.
  """

  def __init__(self,
               action_dim: int,
               extra_features_dim: int = 0,
               torso_filters: Sequence[int] = (32, 64),
               head_filters: Sequence[int] = (64, 64),
               action_embedding_size: int = 64,
               dense_sizes: Sequence[int] = (64, 64),
               use_batch_norm: bool = True,
               space_to_depth: int = 1,
               image_channels: int = 3,
               dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    self.torso_filters = tuple(torso_filters)
    self.head_filters = tuple(head_filters)
    self.use_batch_norm = use_batch_norm
    self.space_to_depth = space_to_depth
    self.dtype = dtype
    in_c = image_channels * space_to_depth ** 2
    for i, f in enumerate(self.torso_filters):
      stride = 1 if i == 0 and space_to_depth > 1 else 2
      self._add_conv(f"torso_conv_{i}", in_c, f, stride)
      self._add_bn(f"torso_bn_{i}", f)
      in_c = f
    # The merge adds the embedded action onto the torso's output
    # channels (the raw image channels when the torso is empty).
    self.merge_channels = in_c if self.torso_filters else image_channels
    for i, f in enumerate(self.head_filters):
      self._add_conv(f"head_conv_{i}", in_c, f, 2)
      self._add_bn(f"head_bn_{i}", f)
      in_c = f
    self.action_embed_0 = nn.Linear(action_dim + extra_features_dim,
                                    action_embedding_size)
    self.action_embed_1 = nn.Linear(action_embedding_size,
                                    self.merge_channels)
    self.q_head = MLP(in_c, dense_sizes, output_size=1, dtype=dtype)

  def _add_conv(self, name: str, in_c: int, out_c: int, stride: int):
    self.add_module(name, nn.Conv2d(in_c, out_c, 3, stride=stride,
                                    bias=not self.use_batch_norm))

  def _add_bn(self, name: str, features: int):
    if self.use_batch_norm:
      self.add_module(name, BatchNorm(features, self.dtype))

  def _conv_bn_relu(self, kind: str, i: int, x: torch.Tensor):
    x = conv_same(getattr(self, f"{kind}_conv_{i}"), x, self.dtype)
    if self.use_batch_norm:
      x = getattr(self, f"{kind}_bn_{i}")(x)
    return torch.relu(x)

  def encode(self, image: torch.Tensor,
             taps: Optional[Dict[str, torch.Tensor]] = None
             ) -> torch.Tensor:
    """Action-independent half: image → torso feature map [B,h,w,C].

    `taps` (optional dict) records each conv's INPUT under
    ``torso_in_<i>``: the int8 calibration points
    (`calibration_stats`); passing it changes nothing else."""
    x = image.to(self.dtype) / 255.0
    s = self.space_to_depth
    if s > 1:
      b, h, w, c = x.shape
      if h % s or w % s:
        raise ValueError(f"Image {h}x{w} must divide space_to_depth={s}.")
      x = x.reshape(b, h // s, s, w // s, s, c).permute(
          0, 1, 3, 2, 4, 5).reshape(b, h // s, w // s, s * s * c)
    for i in range(len(self.torso_filters)):
      if taps is not None:
        taps[f"torso_in_{i}"] = x
      x = self._conv_bn_relu("torso", i, x)
    return x

  def head(self, encoded: torch.Tensor, features) -> Dict[str, torch.Tensor]:
    """Action-dependent half: (torso features, action+extras) → Q."""
    a = _gather_action_extras(features, self.dtype)
    a = torch.relu(dense(self.action_embed_0, a, self.dtype))
    a = dense(self.action_embed_1, a, self.dtype)
    x = encoded + a[:, None, None, :]
    for i in range(len(self.head_filters)):
      x = self._conv_bn_relu("head", i, x)
    logit = self.q_head(spatial_mean(x))
    return {Q_VALUE: logit[..., 0].float()}

  def forward(self, features) -> Dict[str, torch.Tensor]:
    return self.head(self.encode(features["image"]), features)

  def score_population(self, encoded, extras, actions) -> torch.Tensor:
    """[B, P] Q values of a CEM population (see `pool_population`)."""
    b, p, _ = actions.shape
    pooled = self.pool_population(encoded, extras, actions)
    logit = self.q_head(pooled.reshape(p * b, -1))
    return logit[..., 0].float().reshape(p, b).t()

  def _population_action_embed(self, extras, actions) -> torch.Tensor:
    """Action + extras → merge-channel embedding a [B, P, C]."""
    b, p, _ = actions.shape
    parts = [actions.to(self.dtype)]
    for key in sorted(extras):
      value = extras[key]
      if value.is_floating_point():
        tiled = value.reshape(b, 1, -1).to(self.dtype)
        parts.append(tiled.expand(b, p, tiled.shape[-1]))
    a = torch.relu(dense(self.action_embed_0, torch.cat(parts, -1),
                         self.dtype))
    return dense(self.action_embed_1, a, self.dtype)

  def _population_merge(self, encoded, a) -> torch.Tensor:
    """The linearity-split merge: relu'd [P·B, h', w', C'] tensor,
    rows P-major (see `_population_merge_parts`)."""
    act, enc0 = self._population_merge_parts(encoded, a)
    p, b = act.shape[:2]
    # P-major rows make the enc0 addend the axis-0 replication of enc0
    # (the JAX package concatenates p copies); broadcasting over the
    # leading P axis adds the same values without materializing them.
    return torch.relu(act + enc0).reshape((p * b,) + act.shape[2:])

  def _population_merge_parts(self, encoded, a
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge before its add: (act [P, B, h', w', C'], enc0
    [B, h', w', C']), both in the compute dtype and batch-normed (eval),
    so that the merged tensor is relu(act + enc0) — what
    `ops.fused_cem_head_tail` takes as `act.transpose(0, 1)` and enc0.

    conv0(encoded + broadcast(a)) = conv0(encoded) + Σ_c a_c · V[c],
    with V the per-position tap sums, computed border-exactly by
    pushing a one-hot channel basis through conv0.
    """
    b, p, c = a.shape
    conv0 = self.head_conv_0
    enc0 = conv_same(conv0, encoded, self.dtype)   # [B, h', w', C']
    basis = torch.eye(c, dtype=self.dtype, device=encoded.device)
    basis = basis[:, None, None, :].expand((c,) + encoded.shape[1:])
    v = conv_same(conv0, basis, self.dtype)        # [C, h', w', C']
    if not self.use_batch_norm:  # bias active ⇒ remove from basis rows
      zero = torch.zeros((1,) + encoded.shape[1:], dtype=self.dtype,
                         device=encoded.device)
      v = v - conv_same(conv0, zero, self.dtype)
    else:
      # Eval BN is per-channel affine: BN(enc0 + act) = BN(enc0) + s·act,
      # with s taken as flax does, from BN outputs in the compute dtype.
      bn0 = self.head_bn_0
      out_c = v.shape[-1]
      ones = torch.ones((1, 1, 1, out_c), dtype=self.dtype,
                        device=encoded.device)
      shift = bn0(torch.zeros_like(ones))
      scale = bn0(ones) - shift
      enc0 = bn0(enc0)
      v = v * scale
    h2, w2, oc = v.shape[1:]
    a_pm = a.transpose(0, 1).reshape(p * b, c)
    return (a_pm @ v.reshape(c, -1)).reshape(p, b, h2, w2, oc), enc0

  def _population_tail(self, x: torch.Tensor,
                       taps: Optional[Dict[str, torch.Tensor]] = None
                       ) -> torch.Tensor:
    """Remaining head convs + spatial pool: [P·B, h', w', C'] →
    pooled [P·B, C'']. `taps` records each conv's input under
    ``head_in_<i>`` (int8 calibration points)."""
    for i in range(1, len(self.head_filters)):
      if taps is not None:
        taps[f"head_in_{i}"] = x
      x = self._conv_bn_relu("head", i, x)
    return spatial_mean(x)

  def pool_population(self, encoded, extras, actions) -> torch.Tensor:
    """`score_population` minus the q-head MLP: pooled population
    features in P-major [P, B, C''] — what `ops.fused_cem_select`
    consumes."""
    b, p, _ = actions.shape
    a = self._population_action_embed(extras, actions)
    if self.head_filters:
      return self._population_tail(
          self._population_merge(encoded, a)).reshape(p, b, -1)
    x = encoded[:, None] + a[:, :, None, None, :]
    x = x.reshape((b * p,) + x.shape[2:])
    return spatial_mean(x).reshape(b, p, -1).transpose(0, 1)

  def calibration_stats(self, features) -> Dict[str, torch.Tensor]:
    """Eval-mode forward recording max-abs at every int8 quantization
    point: the held-out-batch calibration `quantize_tower` consumes.

    `features` is a flat struct/dict with ``image``, ``action`` and any
    extra state floats; the batch's own actions stand in as a
    population of 1. Returns {point_name: f32 scalar tensor}.
    """
    taps: Dict[str, torch.Tensor] = {}
    flat = (features.to_flat_dict() if hasattr(features, "to_flat_dict")
            else dict(features))
    encoded = self.encode(flat["image"], taps=taps)
    action = flat["action"]
    actions = action.reshape(action.shape[0], 1, -1)
    extras = {k: v for k, v in flat.items() if k not in ("image", "action")}
    a = self._population_action_embed(extras, actions)
    if self.head_filters:
      self._population_tail(self._population_merge(encoded, a), taps=taps)
    return {k: v.abs().max().float() for k, v in taps.items()}


def _eval_bn_affine(bn: BatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
  """Eval-mode BN as per-channel (scale, shift) f32."""
  scale = bn.scale.float() / torch.sqrt(bn.var.float() + _BN_EPS)
  shift = bn.bias.float() - bn.mean.float() * scale
  return scale, shift


def q_head_dense_params(network: GraspingQNetwork, dtype=None):
  """((w [in, out], b [out]), ...) of the q-head MLP in layer order —
  the fused select kernel's scoring parameters, in flax's `[in, out]`
  layout and contiguous."""
  out = []
  for layer in network.q_head.layers():
    w, b = layer.weight.t(), layer.bias
    if dtype is not None:
      w, b = w.to(dtype), b.to(dtype)
    out.append((w.contiguous(), b.contiguous()))
  return tuple(out)


def head_tail_params(network: GraspingQNetwork):
  """(conv_kernel [3, 3, C1, C2], bn_scale, bn_shift [C2] f32, dense) of
  the population tail after the merge — `ops.fused_cem_head_tail`'s
  weights, for a network with batch norm and two head convs. The conv
  kernel (HWIO) and the q-head are in the compute dtype."""
  if len(network.head_filters) != 2 or not network.use_batch_norm:
    raise ValueError("the fused head tail needs batch norm and exactly two "
                     f"head convs (head_filters={network.head_filters})")
  kernel = network.head_conv_1.weight.permute(2, 3, 1, 0)
  scale, shift = _eval_bn_affine(network.head_bn_1)
  return (kernel.to(network.dtype).contiguous(), scale, shift,
          q_head_dense_params(network, dtype=network.dtype))


# ---------------------------------------------------------------------------
# int8 CEM inference tower (JAX `networks.py:283-534`)
#
# The CEM Q-tower forward is inference only (Bellman targets and
# acting). Its weights and activations are stored as int8: weights per
# output channel with scales computed from the network's CURRENT
# tensors on every call (a Polyak-drifting target network requantizes
# every step, inside a captured step too), activations per tensor with
# scales from a one-time calibration (`calibration_stats` →
# `scales_from_stats`). Each conv runs on the int8 values cast to the
# compute dtype (exact: int8 values are exact in bf16, and the products
# sum in f32), then folds activation, weight and batch-norm scales into
# one f32 multiplier. The merged population tensor, the hot one, is
# stored int8 between the merge and the next conv.
#
# Rounding (trap 8): `x / scale` is an f32 DIVISION by a tensor on x's
# device, never a product with a reciprocal (CUDA turns a division by
# a host scalar into one); `torch.round` rounds half to even like
# `jnp.round`; both clip to ±127.
# ---------------------------------------------------------------------------

Tower = Dict[str, list]


def _quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """Per-output-channel symmetric int8 of an OIHW kernel:
  w ≈ w_q · scale[c_out]."""
  w = w.float()
  amax = w.abs().amax(dim=tuple(range(1, w.dim())))
  scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
  w_q = torch.clamp(torch.round(w / scale.reshape((-1,) + (1,) * (w.dim() - 1))),
                    -127, 127).to(torch.int8)
  return w_q, scale


def _quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
  """Per-tensor symmetric int8 with a calibrated f32 scale (a tensor on
  x's device)."""
  return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
      torch.int8)


def scales_from_stats(stats) -> Dict[str, float]:
  """max-abs calibration stats → per-tensor int8 scales (host floats)."""
  return {k: max(float(v) / 127.0, 1e-8) for k, v in stats.items()}


def _scale_tensor(value: Any, device: torch.device) -> torch.Tensor:
  """A scale as an f32 0-dim tensor on `device` (a host float rounds to
  f32 as `jnp.asarray(value, jnp.float32)` does). A fill, not a copy from
  the host, so that a CUDA-graph capture may run it."""
  if isinstance(value, torch.Tensor):
    return value
  return torch.full((), float(value), dtype=torch.float32, device=device)


def quantize_tower(network: GraspingQNetwork, act_scales) -> Tower:
  """The int8 tower from the network's own tensors and the calibrated
  activation scales (host floats, or f32 0-dim tensors on the network's
  device). Each layer: ``w_q``
  int8 OIHW kernel, ``eff_scale`` f32 [c_out] (activation · weight · BN
  scales), ``shift`` f32 [c_out] (BN shift or conv bias), ``act_scale``
  f32 scalar of the layer's input quantizer."""

  def layer(kind: str, i: int):
    conv = getattr(network, f"{kind}_conv_{i}")
    w_q, w_scale = _quantize_weight(conv.weight)
    a_scale = _scale_tensor(act_scales[f"{kind}_in_{i}"],
                            conv.weight.device)
    if network.use_batch_norm:
      bn_scale, shift = _eval_bn_affine(getattr(network, f"{kind}_bn_{i}"))
      eff = a_scale * w_scale * bn_scale
    else:
      eff = a_scale * w_scale
      shift = conv.bias.float()
    return {"w_q": w_q, "eff_scale": eff, "shift": shift,
            "act_scale": a_scale}

  return {
      "torso": [layer("torso", i) for i in range(len(network.torso_filters))],
      "head": [layer("head", i) for i in range(1, len(network.head_filters))],
  }


def _int8_conv(x: torch.Tensor, layer: Dict[str, torch.Tensor], stride: int,
               dtype: torch.dtype) -> torch.Tensor:
  """quantize → int8-valued conv in `dtype` (rounded to `dtype`, as a
  JAX conv in bf16 returns bf16) → fold scales in f32 → relu."""
  x_q = _quantize_act(x, layer["act_scale"])
  y = conv2d_same(x_q.to(dtype), layer["w_q"].to(dtype), (stride, stride),
                  dtype)
  y = y.float() * layer["eff_scale"] + layer["shift"]
  return torch.relu(y).to(dtype)


def quantized_encode(network: GraspingQNetwork, tower: Tower,
                     image: torch.Tensor,
                     taps: Optional[Dict[str, torch.Tensor]] = None
                     ) -> torch.Tensor:
  """int8 twin of `GraspingQNetwork.encode` (eval mode). `taps` records
  each quantizer's input under ``torso_in_<i>``, as `encode` does."""
  dt = network.dtype
  x = image.to(dt) / torch.full((), 255.0, dtype=dt, device=image.device)
  s = network.space_to_depth
  if s > 1:
    b, h, w, c = x.shape
    x = x.reshape(b, h // s, s, w // s, s, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b, h // s, w // s, s * s * c)
  for i, layer in enumerate(tower["torso"]):
    if taps is not None:
      taps[f"torso_in_{i}"] = x
    x = _int8_conv(x, layer, 1 if i == 0 and s > 1 else 2, dt)
  return x


def _quantized_population_pooled(network: GraspingQNetwork, tower: Tower,
                                 encoded, extras, actions, taps=None
                                 ) -> torch.Tensor:
  """int8 twin of the population path up to the pooled features, with
  the same P-major layout: the merge on head conv 0's raw kernel (its
  batch norm folded in f32), then the int8 head convs. Returns pooled
  [P·B, C''] in the compute dtype."""
  dt = network.dtype
  b, p, _ = actions.shape
  a = network._population_action_embed(extras, actions)  # [B, P, C]
  if not network.head_filters:
    x = encoded[:, None] + a[:, :, None, None, :]
    x = x.reshape((b * p,) + x.shape[2:])
    return spatial_mean(x).reshape(b, p, -1).transpose(0, 1).reshape(p * b, -1)
  conv0 = network.head_conv_0
  k0 = conv0.weight.to(dt)
  c = encoded.shape[-1]
  enc0 = conv2d_same(encoded, k0, conv0.stride, dt)
  basis = torch.eye(c, dtype=dt, device=encoded.device)
  basis = basis[:, None, None, :].expand((c,) + encoded.shape[1:])
  v = conv2d_same(basis, k0, conv0.stride, dt)
  if network.use_batch_norm:
    bn_scale, bn_shift = _eval_bn_affine(network.head_bn_0)
    enc0 = (enc0.float() * bn_scale + bn_shift).to(dt)
    v = (v.float() * bn_scale).to(dt)
  else:
    enc0 = enc0 + conv0.bias.to(dt)
  h2, w2, oc = v.shape[1:]
  a_pm = a.transpose(0, 1).reshape(p * b, c)
  act = (a_pm @ v.reshape(c, -1)).reshape(p, b, h2, w2, oc)
  # The hot tensor: int8 from the first head-tail quantizer on. Adding
  # enc0 broadcast over the leading P axis gives the values of JAX's
  # axis-0 concatenation of p copies without materializing them.
  x = torch.relu(act + enc0).reshape(p * b, h2, w2, oc)
  for i, layer in enumerate(tower["head"], start=1):
    if taps is not None:
      taps[f"head_in_{i}"] = x
    x = _int8_conv(x, layer, 2, dt)
  return spatial_mean(x)


def quantized_score_population(network: GraspingQNetwork, tower: Tower,
                               encoded, extras, actions) -> torch.Tensor:
  """int8 twin of `GraspingQNetwork.score_population`: [B, P] Q (f32).
  The q-head MLP is not quantized."""
  b, p, _ = actions.shape
  pooled = _quantized_population_pooled(network, tower, encoded, extras,
                                        actions)
  return network.q_head(pooled)[..., 0].reshape(p, b).t()


def quantized_pool_population(network: GraspingQNetwork, tower: Tower,
                              encoded, extras, actions, taps=None
                              ) -> torch.Tensor:
  """int8 twin of `GraspingQNetwork.pool_population`: [P, B, C'']
  (`taps` records the head quantizers' inputs under ``head_in_<i>``)."""
  b, p, _ = actions.shape
  return _quantized_population_pooled(network, tower, encoded, extras,
                                      actions, taps).reshape(p, b, -1)
