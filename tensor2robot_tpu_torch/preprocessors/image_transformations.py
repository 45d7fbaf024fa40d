"""Batched image transformations on the device (port of
`preprocessors/image_transformations.py`).

NHWC batches in, on the tensors' device; every random draw comes from
an explicit `torch.Generator` on that device (where JAX takes a key).
Each random function draws first and then calls a deterministic
function of its draws (`crop_at`, `flip_where`, `photometric`), so a
test can feed JAX's draws in (torch's streams cannot match threefry,
ROADMAP trap 5). Nothing reads the host, so a captured step can hold
every function.

`resize` is `jax.image.resize(method="bilinear")`: half-pixel centres
and, when it shrinks an axis, a triangle filter widened by the scale
(antialiasing), which `F.interpolate(mode="bilinear", antialias=True,
align_corners=False)` computes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_RGB_TO_YIQ = ((0.299, 0.587, 0.114),
               (0.596, -0.274, -0.322),
               (0.211, -0.523, 0.312))
_YIQ_TO_RGB = ((1.0, 0.956, 0.621),
               (1.0, -0.272, -0.647),
               (1.0, -1.106, 1.703))
_GREY = (0.299, 0.587, 0.114)


def to_float(images: torch.Tensor,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """uint8 [0, 255] → float [0, 1]; other dtypes are only cast."""
  if images.dtype == torch.uint8:
    return images.to(dtype) / torch.full((), 255.0, dtype=dtype,
                                         device=images.device)
  return images.to(dtype)


def center_crop(images: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
  h, w = images.shape[-3], images.shape[-2]
  top = (h - height) // 2
  left = (w - width) // 2
  return images[..., top:top + height, left:left + width, :]


def crop_at(images: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
            height: int, width: int) -> torch.Tensor:
  """Image b cropped to `height` × `width` at (tops[b], lefts[b]), as
  JAX's vmapped `dynamic_slice` (starts clamped to fit)."""
  batch, h, w = images.shape[0], images.shape[1], images.shape[2]
  tops = tops.clamp(0, h - height)
  lefts = lefts.clamp(0, w - width)
  rows = tops[:, None] + torch.arange(height, device=images.device)
  cols = lefts[:, None] + torch.arange(width, device=images.device)
  index = torch.arange(batch, device=images.device)
  return images[index[:, None, None], rows[:, :, None], cols[:, None, :]]


def random_crop(generator: torch.Generator, images: torch.Tensor,
                height: int, width: int) -> torch.Tensor:
  """Per-image random crops (tops, then lefts, uniform over the valid
  starts)."""
  batch = images.shape[0]
  h, w = images.shape[-3], images.shape[-2]
  device = images.device
  tops = torch.randint(0, h - height + 1, (batch,), generator=generator,
                       device=device)
  lefts = torch.randint(0, w - width + 1, (batch,), generator=generator,
                        device=device)
  return crop_at(images, tops, lefts, height, width)


def resize(images: torch.Tensor, height: int, width: int,
           method: str = "bilinear") -> torch.Tensor:
  """[..., H, W, C] → [..., height, width, C] (the module docstring);
  float images."""
  if method != "bilinear":
    raise ValueError(f"resize method {method!r}: the port has 'bilinear'")
  lead = images.shape[:-3]
  x = images.reshape((-1,) + tuple(images.shape[-3:])).permute(0, 3, 1, 2)
  y = F.interpolate(x.float(), size=(height, width), mode="bilinear",
                    align_corners=False, antialias=True)
  y = y.permute(0, 2, 3, 1).to(images.dtype)
  return y.reshape(tuple(lead) + (height, width, images.shape[-1]))


def flip_where(images: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
  """Image b mirrored left-right where flips[b]."""
  return torch.where(flips[:, None, None, None], images.flip(-2), images)


def random_flip_left_right(generator: torch.Generator,
                           images: torch.Tensor) -> torch.Tensor:
  flips = torch.rand(images.shape[0], generator=generator,
                     device=images.device) < 0.5
  return flip_where(images, flips)


def _per_image(values: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
  return values.reshape((-1,) + (1,) * (images.dim() - 1)).to(images.dtype)


def _constant(rows, like: torch.Tensor) -> torch.Tensor:
  """A constant matrix on `like`'s device, made by fills (no host copy,
  so it can sit in a captured step)."""
  out = torch.empty((len(rows), len(rows[0])), dtype=like.dtype,
                    device=like.device)
  for i, row in enumerate(rows):
    for j, value in enumerate(row):
      out[i, j].fill_(value)
  return out


def adjust_brightness(images: torch.Tensor,
                      delta: torch.Tensor) -> torch.Tensor:
  return images + _per_image(delta, images)


def adjust_contrast(images: torch.Tensor,
                    factor: torch.Tensor) -> torch.Tensor:
  mean = images.mean(dim=(-3, -2), keepdim=True)
  return (images - mean) * _per_image(factor, images) + mean


def adjust_saturation(images: torch.Tensor,
                      factor: torch.Tensor) -> torch.Tensor:
  grey = (images * _constant((_GREY,), images)[0]).sum(dim=-1,
                                                        keepdim=True)
  return grey + (images - grey) * _per_image(factor, images)


def adjust_hue(images: torch.Tensor, radians: torch.Tensor) -> torch.Tensor:
  """Hue rotation in YIQ space (closed form, no HSV branches)."""
  radians = _per_image(radians, images)
  yiq = images @ _constant(_RGB_TO_YIQ, images).t()
  y, i, q = yiq[..., :1], yiq[..., 1:2], yiq[..., 2:3]
  cos, sin = torch.cos(radians), torch.sin(radians)
  i2 = i * cos - q * sin
  q2 = i * sin + q * cos
  return torch.cat([y, i2, q2], dim=-1) @ _constant(_YIQ_TO_RGB, images).t()


def add_gaussian_noise(generator: torch.Generator, images: torch.Tensor,
                       stddev: float) -> torch.Tensor:
  return images + stddev * torch.randn(
      images.shape, generator=generator, device=images.device,
      dtype=images.dtype)


def photometric(images: torch.Tensor,
                delta: Optional[torch.Tensor] = None,
                saturation: Optional[torch.Tensor] = None,
                hue: Optional[torch.Tensor] = None,
                contrast: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                clip: bool = True) -> torch.Tensor:
  """The distortions of given per-image draws (each None skipped), in
  JAX's fixed order: brightness → saturation → hue → contrast → noise
  (added as drawn) → clip to [0, 1]; f32 inside, `images`' dtype out."""
  out = images.float()
  if delta is not None:
    out = adjust_brightness(out, delta)
  if saturation is not None:
    out = adjust_saturation(out, saturation)
  if hue is not None:
    out = adjust_hue(out, hue)
  if contrast is not None:
    out = adjust_contrast(out, contrast)
  if noise is not None:
    out = out + noise
  if clip:
    out = out.clamp(0.0, 1.0)
  return out.to(images.dtype)


def _uniform(generator, batch, low, high, device) -> torch.Tensor:
  u = torch.rand(batch, generator=generator, device=device)
  return u * (high - low) + low


def apply_photometric_image_distortions(
    generator: torch.Generator,
    images: torch.Tensor,
    max_brightness_delta: float = 0.125,
    contrast_range: Optional[Tuple[float, float]] = (0.5, 1.5),
    saturation_range: Optional[Tuple[float, float]] = (0.5, 1.5),
    max_hue_delta: float = 0.2,
    noise_stddev: float = 0.0,
    clip: bool = True,
) -> torch.Tensor:
  """Random per-image brightness / saturation / hue / contrast (+ noise),
  drawn in that order from `generator` (`photometric` applies them)."""
  batch, device = images.shape[0], images.device
  draws = {}
  if max_brightness_delta > 0:
    draws["delta"] = _uniform(generator, batch, -max_brightness_delta,
                              max_brightness_delta, device)
  if saturation_range is not None:
    draws["saturation"] = _uniform(generator, batch, *saturation_range,
                                   device)
  if max_hue_delta > 0:
    draws["hue"] = _uniform(generator, batch, -max_hue_delta, max_hue_delta,
                            device)
  if contrast_range is not None:
    draws["contrast"] = _uniform(generator, batch, *contrast_range, device)
  if noise_stddev > 0:
    draws["noise"] = noise_stddev * torch.randn(
        images.shape, generator=generator, device=device)
  return photometric(images, clip=clip, **draws)


def random_crop_image_and_resize(
    generator: torch.Generator,
    images: torch.Tensor,
    crop_height: int,
    crop_width: int,
    out_height: Optional[int] = None,
    out_width: Optional[int] = None,
) -> torch.Tensor:
  """Random crop then (optional) resize — the standard train-time combo."""
  cropped = random_crop(generator, images, crop_height, crop_width)
  if out_height is not None and out_width is not None and (
      (out_height, out_width) != (crop_height, crop_width)):
    cropped = resize(cropped, out_height, out_width)
  return cropped


# Reference-compatible alias.
ApplyPhotometricImageDistortions = apply_photometric_image_distortions
