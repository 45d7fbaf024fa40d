"""The image preprocessors (`preprocessors/image_transformations.py`,
`preprocessors/image_preprocessor.py`) and the colour-to-grey PNG
decode against the JAX package and TensorFlow, on the CPU.

  * Every transformation of the JAX module equals JAX's within 1e-6 of
    the image scale, JAX's random draws injected into the port's
    deterministic halves (`crop_at`, `flip_where`, `photometric`): torch's
    streams cannot match threefry (ROADMAP trap 5). The random functions
    draw within their ranges from an explicit generator.
  * `resize` is `jax.image.resize(method="bilinear")` (antialiased when it
    shrinks): within 1e-5 at an up and a down scale.
  * `ImagePreprocessor`'s in/out specs are JAX's; its outputs equal JAX's
    in EVAL (center crop, casts) and TRAIN (JAX's crop and distortion
    draws injected) modes, and `TPUCompatPreprocessorWrapper` casts as
    JAX's.
  * A colour PNG decoded to one channel is TF's `decode_png(channels=1)`
    (libpng's truncated weighted sum), bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.data.abstract_input_generator import (  # noqa: E402
    Mode as JaxMode,
)
from tensor2robot_tpu.preprocessors import (  # noqa: E402
    image_transformations as jimt,
)
from tensor2robot_tpu.preprocessors.image_preprocessor import (  # noqa: E402
    ImagePreprocessor as JaxImagePreprocessor,
    TPUCompatPreprocessorWrapper as JaxWrapper,
)
from tensor2robot_tpu.specs import (  # noqa: E402
    ExtendedTensorSpec as JaxSpec,
    TensorSpecStruct as JaxStruct,
)
from tensor2robot_tpu_torch.data import png  # noqa: E402
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode  # noqa: E402
from tensor2robot_tpu_torch.preprocessors import (  # noqa: E402
    ImagePreprocessor,
    TPUCompatPreprocessorWrapper,
)
from tensor2robot_tpu_torch.preprocessors import (  # noqa: E402
    image_transformations as imt,
)
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec  # noqa: E402
from tensor2robot_tpu_torch.specs import TensorSpecStruct  # noqa: E402

_B, _H, _W = 3, 12, 10


def _images(seed=0, shape=(_B, _H, _W, 3)):
  return np.random.default_rng(seed).random(shape).astype(np.float32)


def _close(got, want, tol=1e-6):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                             rtol=0, atol=tol)


def test_deterministic_transformations_equal_jax():
  x = _images()
  t = torch.from_numpy(x)
  u8 = (x * 255).astype(np.uint8)
  _close(imt.to_float(torch.from_numpy(u8)), jimt.to_float(jnp.asarray(u8)))
  _close(imt.center_crop(t, 7, 5), jimt.center_crop(jnp.asarray(x), 7, 5))
  values = np.array([0.1, -0.05, 0.2], np.float32)
  factors = np.array([0.6, 1.3, 1.0], np.float32)
  for port_fn, jax_fn, arg in (
      (imt.adjust_brightness, jimt.adjust_brightness, values),
      (imt.adjust_contrast, jimt.adjust_contrast, factors),
      (imt.adjust_saturation, jimt.adjust_saturation, factors),
      (imt.adjust_hue, jimt.adjust_hue, values)):
    _close(port_fn(t, torch.from_numpy(arg)),
           jax_fn(jnp.asarray(x), jnp.asarray(arg)))


def test_random_transformations_equal_jax_with_its_draws():
  x = _images(1)
  key = jax.random.PRNGKey(7)
  key_t, key_l = jax.random.split(key)
  tops = np.array(jax.random.randint(key_t, (_B,), 0, _H - 8 + 1))
  lefts = np.array(jax.random.randint(key_l, (_B,), 0, _W - 6 + 1))
  _close(imt.crop_at(torch.from_numpy(x), torch.from_numpy(tops),
                     torch.from_numpy(lefts), 8, 6),
         jimt.random_crop(key, jnp.asarray(x), 8, 6))
  flips = np.array(jax.random.bernoulli(key, 0.5, (_B,)))
  _close(imt.flip_where(torch.from_numpy(x), torch.from_numpy(flips)),
         jimt.random_flip_left_right(key, jnp.asarray(x)))
  keys = jax.random.split(key, 5)
  draws = {
      "delta": jax.random.uniform(keys[0], (_B,), minval=-0.125,
                                  maxval=0.125),
      "saturation": jax.random.uniform(keys[1], (_B,), minval=0.5,
                                       maxval=1.5),
      "hue": jax.random.uniform(keys[2], (_B,), minval=-0.2, maxval=0.2),
      "contrast": jax.random.uniform(keys[3], (_B,), minval=0.5,
                                     maxval=1.5),
      "noise": 0.05 * jax.random.normal(keys[4], x.shape, jnp.float32)}
  got = imt.photometric(torch.from_numpy(x), **{
      k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
  want = jimt.apply_photometric_image_distortions(key, jnp.asarray(x),
                                                  noise_stddev=0.05)
  _close(got, want)
  # The port's own draws: within their ranges, from the generator alone.
  g = torch.Generator().manual_seed(0)
  out = imt.random_crop_image_and_resize(g, torch.from_numpy(x), 8, 6, 4, 3)
  assert out.shape == (_B, 4, 3, 3)
  a = imt.apply_photometric_image_distortions(
      torch.Generator().manual_seed(1), torch.from_numpy(x))
  b = imt.apply_photometric_image_distortions(
      torch.Generator().manual_seed(1), torch.from_numpy(x))
  assert torch.equal(a, b) and float(a.min()) >= 0 and float(a.max()) <= 1
  assert imt.ApplyPhotometricImageDistortions is (
      imt.apply_photometric_image_distortions)


@pytest.mark.parametrize("size", [(24, 20), (5, 4), (12, 7)])
def test_resize_is_jax_bilinear(size):
  """Up, down (antialiased) and mixed scales."""
  x = _images(2)
  _close(imt.resize(torch.from_numpy(x), *size),
         jimt.resize(jnp.asarray(x), *size), tol=1e-5)


def _specs(struct, spec, dtype):
  st = struct()
  st.image = spec(shape=(8, 6, 3), dtype=dtype, name="image")
  st.depth = spec(shape=(8, 6, 1), dtype=dtype, name="depth")
  st.pose = spec(shape=(2,), dtype=dtype, name="pose")
  return st


def _preprocessors():
  port = ImagePreprocessor(
      lambda mode: _specs(TensorSpecStruct, ExtendedTensorSpec, np.float32),
      lambda mode: None, src_height=_H, src_width=_W)
  ref = JaxImagePreprocessor(
      lambda mode: _specs(JaxStruct, JaxSpec, np.float32), lambda mode: None,
      src_height=_H, src_width=_W)
  return port, ref


def _wire(seed=3):
  rng = np.random.default_rng(seed)
  return {"image": rng.integers(0, 256, (_B, _H, _W, 3), dtype=np.uint8),
          "depth": rng.integers(0, 256, (_B, _H, _W, 1), dtype=np.uint8),
          "pose": rng.standard_normal((_B, 2)).astype(np.float64)}


def test_image_preprocessor_specs_are_jax():
  port, ref = _preprocessors()
  for mode, jax_mode in ((Mode.TRAIN, JaxMode.TRAIN),
                         (Mode.EVAL, JaxMode.EVAL)):
    got = port.get_in_feature_specification(mode).to_flat_dict()
    want = ref.get_in_feature_specification(jax_mode).to_flat_dict()
    assert set(got) == set(want)
    for key in want:
      assert got[key].shape == want[key].shape, key
      assert np.dtype(got[key].dtype) == np.dtype(want[key].dtype), key
    out = port.get_out_feature_specification(mode).to_flat_dict()
    assert out["image"].shape == (8, 6, 3)


def test_image_preprocessor_eval_equals_jax():
  port, ref = _preprocessors()
  wire = _wire()
  got, _ = port.preprocess({k: torch.from_numpy(v) for k, v in wire.items()},
                           None, Mode.EVAL)
  want, _ = ref.preprocess(JaxStruct.from_flat_dict(
      {k: jnp.asarray(v) for k, v in wire.items()}), None, JaxMode.EVAL)
  want = want.to_flat_dict()
  for key in want:
    assert got[key].dtype == torch.float32
    _close(got[key], want[key])


def test_image_preprocessor_train_equals_jax_with_its_draws(monkeypatch):
  """JAX's draws for `PRNGKey(5)` (per image key: split into the next
  key, a crop key and a distortion key) fed to the port's deterministic
  halves; the grey `depth` key keeps brightness and contrast only."""
  port, ref = _preprocessors()
  wire = _wire(4)
  rng = jax.random.PRNGKey(5)
  crops, distortions = [], []
  for key in ("image", "depth"):
    rng, crop_key, distort_key = jax.random.split(rng, 3)
    key_t, key_l = jax.random.split(crop_key)
    crops.append((np.array(jax.random.randint(key_t, (_B,), 0, _H - 8 + 1)),
                  np.array(jax.random.randint(key_l, (_B,), 0,
                                                _W - 6 + 1))))
    keys = jax.random.split(distort_key, 5)
    draws = {"delta": jax.random.uniform(keys[0], (_B,), minval=-0.125,
                                         maxval=0.125),
             "contrast": jax.random.uniform(keys[3], (_B,), minval=0.5,
                                            maxval=1.5)}
    if key == "image":
      draws["saturation"] = jax.random.uniform(keys[1], (_B,), minval=0.5,
                                               maxval=1.5)
      draws["hue"] = jax.random.uniform(keys[2], (_B,), minval=-0.2,
                                        maxval=0.2)
    distortions.append({k: torch.from_numpy(np.array(v))
                        for k, v in draws.items()})
  monkeypatch.setattr(imt, "random_crop", lambda g, images, h, w: (
      imt.crop_at(images, *(torch.from_numpy(c) for c in crops.pop(0)), h,
                  w)))
  monkeypatch.setattr(imt, "apply_photometric_image_distortions",
                      lambda g, images, **kw: imt.photometric(
                          images, **distortions.pop(0)))
  got, _ = port.preprocess({k: torch.from_numpy(v) for k, v in wire.items()},
                           None, Mode.TRAIN, torch.Generator())
  want, _ = ref.preprocess(JaxStruct.from_flat_dict(
      {k: jnp.asarray(v) for k, v in wire.items()}), None, JaxMode.TRAIN,
      jax.random.PRNGKey(5))
  assert not crops and not distortions
  want = want.to_flat_dict()
  for key in want:
    _close(got[key], want[key], tol=2e-6)


def test_tpu_compat_wrapper_casts_as_jax():
  port_base = ImagePreprocessor(
      lambda mode: _specs(TensorSpecStruct, ExtendedTensorSpec, np.uint8),
      lambda mode: None, src_height=8, src_width=6, distort=False)
  ref_base = JaxImagePreprocessor(
      lambda mode: _specs(JaxStruct, JaxSpec, np.uint8), lambda mode: None,
      src_height=8, src_width=6, distort=False)
  port = TPUCompatPreprocessorWrapper(port_base, model_dtype=torch.bfloat16)
  ref = JaxWrapper(ref_base, model_dtype=jnp.bfloat16)
  spec = port.get_out_feature_specification(Mode.EVAL).to_flat_dict()
  assert spec["image"].dtype is torch.bfloat16
  rng = np.random.default_rng(6)
  wire = {"image": rng.integers(0, 256, (_B, 8, 6, 3), dtype=np.uint8),
          "depth": rng.integers(0, 256, (_B, 8, 6, 1), dtype=np.uint8),
          "pose": rng.integers(0, 256, (_B, 2), dtype=np.uint8)}
  got, _ = port.preprocess({k: torch.from_numpy(v) for k, v in wire.items()},
                           None, Mode.EVAL)
  want, _ = ref.preprocess(JaxStruct.from_flat_dict(
      {k: jnp.asarray(v) for k, v in wire.items()}), None, JaxMode.EVAL)
  for key, value in want.to_flat_dict().items():
    assert got[key].dtype is torch.bfloat16
    _close(got[key].float(), np.asarray(value, np.float32))


@pytest.mark.parametrize("alpha", [False, True])
def test_colour_png_to_grey_is_tensorflow(alpha):
  rng = np.random.default_rng(int(alpha))
  image = rng.integers(0, 256, (40, 30, 4 if alpha else 3), dtype=np.uint8)
  image[0, :8, :3] = image[0, :8, :1]  # grey pixels keep their value
  data = tf.io.encode_png(image).numpy()
  want = tf.io.decode_png(data, channels=1).numpy()
  got = png.decode(data, channels=1)
  assert got.dtype == np.uint8 and got.shape == want.shape
  np.testing.assert_array_equal(got, want)
