"""Spec-transformation image preprocessor (port of
`preprocessors/image_preprocessor.py`).

Declares uint8 wire images and emits cropped, distorted float (or
bfloat16) model images on the model's device, inside the model's step
(`AbstractT2RModel` calls `preprocess` first thing in its train, eval
and predict steps). TRAIN mode draws its random crops and distortions
from the generator the model hands it (the model's explicit generator);
without one it draws from a generator seeded 0, as JAX falls back to
`PRNGKey(0)`. EVAL and PREDICT draw nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.preprocessors import image_transformations as imt
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    AbstractPreprocessor,
)
from tensor2robot_tpu_torch.specs import packing
from tensor2robot_tpu_torch.specs.tensorspec import TensorSpecStruct


def _torch_dtype(dtype) -> torch.dtype:
  """A spec's dtype (numpy, or a torch dtype) as torch's."""
  if isinstance(dtype, torch.dtype):
    return dtype
  return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _flat(struct):
  return (struct.to_flat_dict() if hasattr(struct, "to_flat_dict")
          else dict(struct))


def _like(struct, flat):
  """`flat` as the kind of structure `struct` was."""
  if isinstance(struct, TensorSpecStruct):
    return TensorSpecStruct.from_flat_dict(flat)
  return flat


@gin.configurable
class ImagePreprocessor(AbstractPreprocessor):
  """Crop/distort the declared image keys, cast the rest.

  The model's out-spec image shapes define the target size. The wire
  (in-spec) image is `src_height × src_width` uint8; train mode random-
  crops to the target and applies photometric distortions, eval mode
  center-crops. Non-image features pass through with a dtype cast to
  their model spec's dtype.
  """

  draws_random = True

  def __init__(self,
               model_feature_specification_fn=None,
               model_label_specification_fn=None,
               image_keys: Optional[Sequence[str]] = None,
               src_height: int = 512,
               src_width: int = 640,
               distort: bool = True,
               max_brightness_delta: float = 0.125,
               contrast_range: Tuple[float, float] = (0.5, 1.5),
               saturation_range: Tuple[float, float] = (0.5, 1.5),
               max_hue_delta: float = 0.2,
               noise_stddev: float = 0.0):
    super().__init__(model_feature_specification_fn,
                     model_label_specification_fn)
    self._image_keys = list(image_keys) if image_keys else None
    self._src_height = src_height
    self._src_width = src_width
    self._distort = distort
    self._distort_kwargs = dict(
        max_brightness_delta=max_brightness_delta,
        contrast_range=contrast_range,
        saturation_range=saturation_range,
        max_hue_delta=max_hue_delta,
        noise_stddev=noise_stddev,
    )

  def _image_key_set(self, flat_specs) -> set:
    if self._image_keys is not None:
      return set(self._image_keys)
    return {k for k, s in flat_specs.items()
            if s.is_image or (len(s.shape) == 3 and s.shape[-1] in (1, 3))}

  def get_in_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    flat = self.model_feature_specification(mode).to_flat_dict()
    image_keys = self._image_key_set(flat)
    out = {}
    for key, spec in flat.items():
      if key in image_keys:
        out[key] = spec.replace(
            shape=(self._src_height, self._src_width, spec.shape[-1]),
            dtype=np.uint8)
      else:
        out[key] = spec
    return TensorSpecStruct.from_flat_dict(out)

  def get_in_label_specification(self, mode: Mode):
    return self.model_label_specification(mode)

  def get_out_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    return self.model_feature_specification(mode)

  def get_out_label_specification(self, mode: Mode):
    return self.model_label_specification(mode)

  def preprocess(self, features, labels, mode: Mode,
                 generator: Optional[torch.Generator] = None):
    out_specs = self.get_out_feature_specification(mode).to_flat_dict()
    image_keys = self._image_key_set(out_specs)
    flat = _flat(features)
    out = {}
    for key, value in flat.items():
      spec = out_specs.get(key)
      if spec is None or key not in image_keys:
        out[key] = value if spec is None else value.to(
            _torch_dtype(spec.dtype))
        continue
      th, tw = spec.shape[-3], spec.shape[-2]
      images = imt.to_float(value)
      if mode == Mode.TRAIN:
        if generator is None:
          generator = torch.Generator(device=images.device).manual_seed(0)
        if (images.shape[-3], images.shape[-2]) != (th, tw):
          images = imt.random_crop(generator, images, th, tw)
        if self._distort:
          distort_kwargs = dict(self._distort_kwargs)
          if images.shape[-1] != 3:
            # Hue rotation and saturation are RGB-only; grey or depth
            # channels keep brightness, contrast and noise.
            distort_kwargs["max_hue_delta"] = 0.0
            distort_kwargs["saturation_range"] = None
          images = imt.apply_photometric_image_distortions(
              generator, images, **distort_kwargs)
      elif (images.shape[-3], images.shape[-2]) != (th, tw):
        images = imt.center_crop(images, th, tw)
      out[key] = images.to(_torch_dtype(spec.dtype))
    return _like(features, out), labels


@gin.configurable
class TPUCompatPreprocessorWrapper(AbstractPreprocessor):
  """Keeps uint8 on the wire and casts to the model dtype on the device
  (scaled to [0, 1] with `scale`), after the base preprocessor."""

  def __init__(self, base: AbstractPreprocessor,
               model_dtype=torch.float32, scale: bool = True):
    super().__init__()
    self._base = base
    self._model_dtype = model_dtype
    self._scale = scale

  @property
  def draws_random(self) -> bool:
    return getattr(self._base, "draws_random", False)

  def get_in_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    return self._base.get_in_feature_specification(mode)

  def get_in_label_specification(self, mode: Mode):
    return self._base.get_in_label_specification(mode)

  def _cast_spec(self, spec_struct):
    if spec_struct is None:
      return None
    return packing.replace_dtype(spec_struct, np.uint8, self._model_dtype)

  def get_out_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    return self._cast_spec(self._base.get_out_feature_specification(mode))

  def get_out_label_specification(self, mode: Mode):
    return self._cast_spec(self._base.get_out_label_specification(mode))

  def _cast(self, struct):
    if struct is None:
      return None
    dtype = _torch_dtype(self._model_dtype)
    out = {}
    for key, value in _flat(struct).items():
      if value.dtype == torch.uint8:
        value = value.to(dtype)
        if self._scale:
          value = value / torch.full((), 255.0, dtype=dtype,
                                     device=value.device)
      out[key] = value
    return _like(struct, out)

  def preprocess(self, features, labels, mode: Mode,
                 generator: Optional[torch.Generator] = None):
    features, labels = self._base.preprocess(features, labels, mode,
                                             generator)
    return self._cast(features), self._cast(labels)
