"""The port's tf.Example / SequenceExample parsers against the JAX
package's (`data/tfexample.py`), which parse through TensorFlow.

Records written by either package (the JAX encoder through `tf.train`
and `tf.io.encode_png`, the port's through its own wire codec and PNG
encoder) parse to exactly equal arrays in both packages, for both
parsers (the eager `parse_*_batch` and the generator's `graph_parse_*`),
over the VRGripper transformer's specs and a mixed set: float, float16,
bfloat16, int32, uint8, bool, varlen, raw (f32, uint8, bf16), PNG
(RGB and grey), optional and named keys, context and sequence. Records
that break their specs raise in both.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
tf = pytest.importorskip("tensorflow")

import torch  # noqa: E402

from tensor2robot_tpu.data import tfexample as jax_tfexample  # noqa: E402
from tensor2robot_tpu.specs import serialization as jax_serial  # noqa: E402
from tensor2robot_tpu_torch.data import tfexample  # noqa: E402
from tensor2robot_tpu_torch.specs import (  # noqa: E402
    ExtendedTensorSpec as Spec,
    TensorSpecStruct,
    serialization,
)

T = 5  # the parsers' sequence_length


def _flat_specs(sequence):
  """The mixed spec set; `sequence` lifts every key but the context
  ones to per-step specs."""
  specs = {
      "pose": Spec((2, 3), np.float32, name="robot_pose"),
      "half": Spec((2,), np.float16),
      "brain": Spec((3,), "bfloat16"),
      "count": Spec((4,), np.int32),
      "small": Spec((2,), np.uint8),
      "flags": Spec((3,), np.bool_),
      "raw_f32": Spec((2, 2), np.float32, data_format="raw"),
      "raw_u8": Spec((3, 4, 2), np.uint8, data_format="raw", name="depth"),
      "raw_bf16": Spec((3,), "bfloat16", data_format="raw"),
      "image": Spec((6, 7, 3), np.uint8, data_format="png", name="rgb"),
      "grey": Spec((5, 4, 1), np.uint8, data_format="png"),
      "nested/opt": Spec((2,), np.float32, is_optional=True),
  }
  if not sequence:
    specs["ragged"] = Spec((5,), np.float32, varlen=True)
    specs["ragged_int"] = Spec((2, 2), np.int64, varlen=True)
    return specs
  out = {k: s.replace(is_sequence=True) for k, s in specs.items()}
  out["task"] = Spec((2,), np.int64, name="task_id")
  out["goal"] = Spec((4, 4, 3), np.uint8, data_format="png")
  out["ctx_ragged"] = Spec((3,), np.float32, varlen=True)
  return out


def _value(spec, rng, steps=None):
  shape = tuple(spec.shape) if steps is None else (steps,) + tuple(spec.shape)
  if spec.varlen:
    return rng.standard_normal(int(rng.integers(0, 8))).astype(np.float32) \
        if spec.dtype == np.float32 else rng.integers(-5, 5, int(
            rng.integers(0, 8)))
  if spec.dtype is torch.bfloat16 or spec.dtype.kind == "f":
    return (rng.standard_normal(shape) * 3).astype(np.float32)
  if spec.dtype == np.bool_:
    return rng.random(shape) > 0.5
  if spec.dtype == np.uint8:
    if spec.is_image and rng.random() < 0.5:  # smooth: Sub/Up/Paeth rows
      grid = np.add.outer(np.arange(shape[-3]), np.arange(shape[-2]))
      return np.broadcast_to((grid * 9)[..., None] % 251, shape).astype(
          np.uint8)
    return rng.integers(0, 256, shape, dtype=np.uint8)
  return rng.integers(-(2 ** 40), 2 ** 40, shape)  # int32 wraps, as tf.cast


def _records(sequence, n, seed, drop_optional=True):
  rng = np.random.default_rng(seed)
  out = []
  for i in range(n):
    steps = int(rng.integers(1, T + 3)) if sequence else None
    record = {}
    for key, spec in _flat_specs(sequence).items():
      if spec.is_optional and drop_optional and i % 2:
        continue
      record[key] = _value(spec, rng, steps if spec.is_sequence else None)
    out.append(record)
  return out


def _port_struct(sequence, drop_optional=True):
  flat = _flat_specs(sequence)
  if drop_optional:
    flat = {k: s for k, s in flat.items() if not s.is_optional}
  return TensorSpecStruct.from_flat_dict(flat)


def _jax_struct(port_struct):
  """The same specs in the JAX package, through the two packages' spec
  serialization (pinned equal in test_torch_specs_packing.py)."""
  return jax_serial.struct_from_dict(serialization.struct_to_dict(port_struct))


def _encode(writer, records, struct, sequence):
  if writer == "port":
    fn = (tfexample.encode_sequence_example if sequence
          else tfexample.encode_example)
  else:
    struct = _jax_struct(struct)
    fn = (jax_tfexample.encode_sequence_example if sequence
          else jax_tfexample.encode_example)
  return [fn(r, struct) for r in records]


def _bits(x):
  """An array to compare exactly: bfloat16 as its uint16 bits."""
  if isinstance(x, torch.Tensor):
    assert x.dtype == torch.bfloat16
    return ("bfloat16", x.view(torch.int16).numpy().view(np.uint16))
  if hasattr(x, "numpy"):
    x = x.numpy()
  x = np.asarray(x)
  if x.dtype.name == "bfloat16":
    return ("bfloat16", x.view(np.uint16))
  return (x.dtype.name, x)


def _assert_equal(port, jax):
  port = dict(port.to_flat_dict() if hasattr(port, "to_flat_dict") else port)
  jax = dict(jax.to_flat_dict() if hasattr(jax, "to_flat_dict") else jax)
  assert list(port) == list(jax)
  for key in port:
    (pd, pa), (jd, ja) = _bits(port[key]), _bits(jax[key])
    assert pd == jd, (key, pd, jd)
    assert pa.shape == ja.shape, (key, pa.shape, ja.shape)
    assert np.array_equal(pa, ja), key


def _parse(package, kind, serialized, struct, sequence):
  if package == "port":
    if kind == "eager":
      return (tfexample.parse_sequence_example_batch(serialized, struct, T)
              if sequence else tfexample.parse_example_batch(serialized,
                                                             struct))
    return (tfexample.graph_parse_sequence_example(serialized, struct, T)
            if sequence else tfexample.graph_parse_example(serialized, struct))
  struct = _jax_struct(struct)
  if kind == "eager":
    # An object array: numpy's bytes dtype would strip each record's
    # trailing NUL bytes.
    serialized = np.array(serialized, object)
    return (jax_tfexample.parse_sequence_example_batch(serialized, struct, T)
            if sequence else jax_tfexample.parse_example_batch(serialized,
                                                               struct))
  tensor = tf.constant(serialized)
  return (jax_tfexample.graph_parse_sequence_example(tensor, struct, T)
          if sequence else jax_tfexample.graph_parse_example(tensor, struct))


@pytest.mark.parametrize("sequence", [False, True])
@pytest.mark.parametrize("kind", ["eager", "graph"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parse_equals_jax(writer, kind, sequence):
  struct = _port_struct(sequence, drop_optional=False)
  records = _records(sequence, 6, seed=7, drop_optional=False)
  serialized = _encode(writer, records, struct, sequence)
  _assert_equal(_parse("port", kind, serialized, struct, sequence),
                _parse("jax", kind, serialized, struct, sequence))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_records_without_the_optional_key_parse_without_it(writer):
  struct = _port_struct(True)
  records = _records(True, 4, seed=3)
  serialized = _encode(writer, records, _port_struct(True, False), True)
  for kind in ("eager", "graph"):
    _assert_equal(_parse("port", kind, serialized, struct, True),
                  _parse("jax", kind, serialized, struct, True))


def _transformer_specs():
  image = Spec((48, 48, 3), np.uint8, name="image", data_format="png",
               is_sequence=True)
  return TensorSpecStruct.from_flat_dict({
      "image": image,
      "gripper_pose": Spec((3,), np.float32, name="gripper_pose",
                           is_sequence=True),
      "action": Spec((3,), np.float32, name="action", is_sequence=True)})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_the_transformer_episodes_parse_as_in_jax(writer):
  from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env import (
      VRGripperEnv,
      collect_expert_episode,
  )
  env = VRGripperEnv(seed=3, max_steps=40)
  rng = np.random.default_rng(3)
  episodes = [collect_expert_episode(env, action_noise=0.1, min_steps=m,
                                     rng=rng) for m in (3, 31, 33, 40)]
  struct = _transformer_specs()
  serialized = _encode(writer, episodes, struct, True)
  for kind in ("eager", "graph"):
    port = _parse("port", kind, serialized, struct, True)
    _assert_equal(port, _parse("jax", kind, serialized, struct, True))
  lengths = port[tfexample.SEQUENCE_LENGTH_KEY]
  assert lengths.tolist() == [min(len(e["action"]), T) for e in episodes]


def _tf_sequence_example(mutate):
  se = tf.train.SequenceExample()
  se.context.feature["task_id"].int64_list.value.extend([1, 2])
  for t in range(3):
    se.feature_lists.feature_list["pose"].feature.add().float_list.value \
        .extend([t, t + 1.0])
    frame = tf.io.encode_png(np.full((4, 4, 3), t, np.uint8)).numpy()
    se.feature_lists.feature_list["rgb"].feature.add().bytes_list.value \
        .append(frame)
  mutate(se)
  return se.SerializeToString()


_SEQ_STRUCT = {
    "task": Spec((2,), np.int64, name="task_id"),
    "pose": Spec((2,), np.float32, is_sequence=True),
    "rgb": Spec((4, 4, 3), np.uint8, data_format="png", is_sequence=True),
}


def _drop_list(se, key):
  del se.feature_lists.feature_list[key]


def _pad_frame(se):
  se.feature_lists.feature_list["rgb"].feature[1].bytes_list.value[0] = b""


_BAD_SEQUENCE = {
    "missing feature list": lambda se: _drop_list(se, "pose"),
    "missing context key": lambda se: se.context.feature.pop("task_id"),
    "short step": lambda se: se.feature_lists.feature_list["pose"]
    .feature[2].float_list.value.pop(),
    "wrong kind": lambda se: se.feature_lists.feature_list["pose"]
    .feature[0].int64_list.value.append(1),
    "wrong image size": lambda se: se.feature_lists.feature_list["rgb"]
    .feature[0].bytes_list.value.__setitem__(
        0, tf.io.encode_png(np.zeros((4, 5, 3), np.uint8)).numpy()),
    "not an image": lambda se: se.feature_lists.feature_list["rgb"]
    .feature[2].bytes_list.value.__setitem__(0, b"\x89PNG junk"),
}


@pytest.mark.parametrize("kind", ["eager", "graph"])
@pytest.mark.parametrize("case", sorted(_BAD_SEQUENCE))
def test_bad_sequence_records_raise_in_both(case, kind):
  serialized = [_tf_sequence_example(lambda se: None),
                _tf_sequence_example(_BAD_SEQUENCE[case])]
  struct = TensorSpecStruct.from_flat_dict(_SEQ_STRUCT)
  with pytest.raises(Exception):
    _parse("jax", kind, serialized, struct, True)
  with pytest.raises(ValueError):
    _parse("port", kind, serialized, struct, True)


def test_an_empty_frame_is_zero_in_the_graph_parse_and_an_error_eagerly():
  serialized = [_tf_sequence_example(_pad_frame)]
  struct = TensorSpecStruct.from_flat_dict(_SEQ_STRUCT)
  port = _parse("port", "graph", serialized, struct, True)
  _assert_equal(port, _parse("jax", "graph", serialized, struct, True))
  assert not port["rgb"][0, 1].any() and port["rgb"][0, 2].all()
  for package in ("jax", "port"):
    with pytest.raises(Exception):
      _parse(package, "eager", serialized, struct, True)


def test_the_graph_parse_decodes_to_the_specs_channels():
  """Trap 13: grey frames under an RGB spec replicate in the generator's
  parse and raise in the eager one, in both packages."""
  struct = {"image": Spec((3, 4, 3), np.uint8, data_format="png")}
  grey = tf.io.encode_png(np.arange(12, dtype=np.uint8).reshape(3, 4, 1))
  serialized = [tf.train.Example(features=tf.train.Features(feature={
      "image": tf.train.Feature(bytes_list=tf.train.BytesList(
          value=[grey.numpy()]))})).SerializeToString()]
  port = _parse("port", "graph", serialized, struct, False)
  _assert_equal(port, _parse("jax", "graph", serialized, struct, False))
  assert (port["image"][0, :, :, 0] == port["image"][0, :, :, 2]).all()
  for package in ("jax", "port"):
    with pytest.raises(ValueError):
      _parse(package, "eager", serialized, struct, False)


@pytest.mark.parametrize("bad", ["missing", "short", "long_raw", "kind"])
def test_bad_examples_raise_in_both(bad):
  struct = {"x": Spec((3,), np.float32),
            "r": Spec((2,), np.int16, data_format="raw")}
  feature = {"x": tf.train.Feature(float_list=tf.train.FloatList(
      value=[1, 2, 3])), "r": tf.train.Feature(bytes_list=tf.train.BytesList(
          value=[b"\x01\x00\x02\x00"]))}
  if bad == "missing":
    del feature["x"]
  elif bad == "short":
    feature["x"].float_list.value.pop()
  elif bad == "long_raw":
    feature["r"].bytes_list.value[0] = b"\x01\x00\x02\x00\x03"
  else:
    feature["x"] = tf.train.Feature(int64_list=tf.train.Int64List(
        value=[1, 2, 3]))
  serialized = [tf.train.Example(features=tf.train.Features(
      feature=feature)).SerializeToString()]
  for kind in ("eager", "graph"):
    with pytest.raises(Exception):
      _parse("jax", kind, serialized, struct, False)
    with pytest.raises(ValueError):
      _parse("port", kind, serialized, struct, False)


def test_the_wire_maps_equal_jax():
  """Trap 17: the wire key is `spec.name or key`; kinds and counts are
  those of the JAX feature maps."""
  for sequence in (False, True):
    struct = _port_struct(sequence, drop_optional=False)
    if sequence:
      port_ctx, port_seq = tfexample.build_sequence_feature_maps(struct)
      jax_ctx, jax_seq = jax_tfexample.build_sequence_feature_maps(
          _jax_struct(struct))
      pairs = [(port_ctx, jax_ctx), (port_seq, jax_seq)]
    else:
      pairs = [(tfexample.build_feature_map(struct),
                jax_tfexample.build_feature_map(_jax_struct(struct)))]
    kinds = {tf.string: "bytes", tf.float32: "float", tf.int64: "int64"}
    for port, jax in pairs:
      assert list(port) == list(jax)
      for name, desc in port.items():
        want = jax[name]
        assert desc.kind == kinds[want.dtype], name
        if isinstance(want, tf.io.VarLenFeature):
          assert desc.length is None
        elif desc.kind != "bytes":
          assert desc.length == int(np.prod(want.shape)), name
  with pytest.raises(ValueError, match="SequenceExample"):
    tfexample.build_feature_map({"x": Spec((1,), np.float32,
                                           is_sequence=True)})


def test_the_sequence_length_key_is_reserved():
  struct = {"sequence_length": Spec((1,), np.float32, is_sequence=True)}
  with pytest.raises(ValueError, match="reserved"):
    tfexample.graph_parse_sequence_example([], struct, T)


def test_encoders_refuse_missing_keys_and_ragged_episodes():
  struct = {"a": Spec((1,), np.float32, is_sequence=True),
            "b": Spec((1,), np.float32, is_sequence=True)}
  with pytest.raises(ValueError, match="share a length"):
    tfexample.encode_sequence_example(
        {"a": np.zeros((2, 1)), "b": np.zeros((3, 1))}, struct)
  with pytest.raises(ValueError, match="Missing required"):
    tfexample.encode_sequence_example({"a": np.zeros((2, 1))}, struct)
  with pytest.raises(ValueError, match="is_sequence"):
    tfexample.encode_sequence_example({}, {"c": Spec((1,), np.float32)})


def test_jpeg_raises_naming_the_roadmap_item():
  """JPEG is ported (ROADMAP A9): a JPEG spec encodes as
  `tf.io.encode_jpeg` does and parses to `tf.io.decode_image`'s pixels;
  only the kinds the codec refuses (here progressive) still raise
  NotImplementedError, naming what they are."""
  struct = {"image": Spec((4, 4, 3), np.uint8, data_format="jpeg")}
  image = np.random.default_rng(3).integers(0, 256, (4, 4, 3), np.uint8)
  serialized = [tfexample.encode_example({"image": image}, struct)]
  want = tf.io.encode_jpeg(image).numpy()
  assert tf.train.Example.FromString(serialized[0]).features.feature[
      "image"].bytes_list.value[0] == want
  got = tfexample.graph_parse_example(serialized, struct)["image"][0]
  np.testing.assert_array_equal(got, tf.io.decode_image(want).numpy())
  progressive = tf.io.encode_jpeg(image, progressive=True).numpy()
  serialized = [tfexample.encode_example({"image": progressive}, struct)]
  with pytest.raises(NotImplementedError, match="progressive"):
    tfexample.graph_parse_example(serialized, struct)


def test_bfloat16_rounds_to_nearest_even_as_tf_cast():
  """Trap 16: floats travel as f32; a bf16 spec rounds to nearest even."""
  values = np.array([1.00390625, 1.01171875, -3.0078125, 65504.0, 1e-40,
                     3.3895314e38], np.float32)
  struct = {"x": Spec((len(values),), "bfloat16")}
  serialized = [tfexample.encode_example({"x": values}, struct)]
  got = tfexample.graph_parse_example(serialized, struct)["x"]
  want = tf.cast(tf.constant(values), tf.bfloat16).numpy()
  assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16)[0],
                        want.view(np.uint16))


def test_the_records_are_tf_records():
  """Port-encoded records parse with protobuf's own `FromString`."""
  struct = _port_struct(True, drop_optional=False)
  record = _encode("port", _records(True, 1, 1, drop_optional=False), struct, True)[0]
  parsed = tf.train.SequenceExample.FromString(record)
  assert set(parsed.feature_lists.feature_list) == {
      tfexample.wire_key(k, s) for k, s in struct.to_flat_dict().items()
      if s.is_sequence}
