"""The data plane's wire codecs against TensorFlow and protobuf: the
TFRecord framing and its CRC-32C, the Example / SequenceExample
protobuf codec, and PNG.

  * framing: port-written files read back by `tf.data.TFRecordDataset`,
    TF-written files read by the port; the native CRC-32C (hardware and
    table paths) equal to the plain version at lengths 0, 1, 7, 8, 9 and
    4099, and not zlib's CRC-32 (trap 11); a flipped byte or a cut file
    raises, naming the file and the offset;
  * protos: random messages built with `tf.train.*` decode equal in the
    port, and the port's encodings parse with `FromString` to the same
    message; packed and unpacked scalars, negative int64, unknown fields,
    a repeated map key (the last wins);
  * PNG: `tf.io.encode_png` output over a corpus asserted to use filter
    types 1–4 decodes bit for bit (trap 12); rows filtered by hand with
    each type decode equal under TF and the port; the port's PNGs decode
    exactly under `tf.io.decode_png`; grey, grey + alpha, palette and
    RGBA convert as `decode_image(channels=c)` does; 16-bit and
    interlaced PNGs raise; the native unfilter equals the plain one.
"""

import io
import struct
import zlib
from collections import Counter

import numpy as np
import pytest

pytest.importorskip("torch")
tf = pytest.importorskip("tensorflow")

from tensor2robot_tpu_torch.data import example_proto as proto  # noqa: E402
from tensor2robot_tpu_torch.data import png  # noqa: E402
from tensor2robot_tpu_torch.data import tfrecord_io  # noqa: E402
from tensor2robot_tpu_torch.utils import native  # noqa: E402

# ---- framing ----


@pytest.mark.parametrize("length", [0, 1, 7, 8, 9, 4099])
def test_crc32c_native_equals_plain(length):
  data = np.random.default_rng(length).bytes(length)
  want = native.crc32c_plain(data)
  assert native.crc32c(data) == want
  assert native.crc32c(data, hardware=False) == want
  head = data[:length // 2]
  assert native.crc32c(data[length // 2:], crc=native.crc32c(head)) == want


def test_crc32c_is_castagnoli_not_zlib():
  assert native.crc32c(b"123456789") == 0xE3069283  # the standard check
  assert zlib.crc32(b"123456789") != 0xE3069283


def test_port_records_read_back_in_tensorflow(tmp_path):
  rng = np.random.default_rng(0)
  records = [rng.bytes(int(n)) for n in rng.integers(0, 5000, 20)] + [b""]
  path = str(tmp_path / "port.tfrecord")
  with tfrecord_io.TFRecordWriter(path) as writer:
    for record in records:
      writer.write(record)
  assert list(tf.data.TFRecordDataset(path).as_numpy_iterator()) == records
  assert list(tfrecord_io.iterate_records(path)) == records


def test_tensorflow_records_read_in_the_port(tmp_path):
  rng = np.random.default_rng(1)
  records = [rng.bytes(int(n)) for n in rng.integers(0, 3000, 15)]
  path = str(tmp_path / "tf.tfrecord")
  with tf.io.TFRecordWriter(path) as writer:
    for record in records:
      writer.write(record)
  assert list(tfrecord_io.iterate_records(path)) == records


def _file(tmp_path, records):
  path = str(tmp_path / "f.tfrecord")
  with tfrecord_io.TFRecordWriter(path) as writer:
    for record in records:
      writer.write(record)
  with open(path, "rb") as f:
    return path, bytearray(f.read())


@pytest.mark.parametrize("where,match", [
    (3, "corrupt record length at byte 0"),      # the length
    (9, "corrupt record length at byte 0"),      # the length's CRC
    (14, "corrupt record data at byte 0"),       # the data
    (28 + 12 + 3, "corrupt record data at byte 28"),  # the second's data
    (28 + 12 + 16, "corrupt record data at byte 28"),  # its data CRC
])
def test_a_flipped_byte_raises_naming_the_offset(tmp_path, where, match):
  path, raw = _file(tmp_path, [b"x" * 12, b"y" * 16])
  raw[where] ^= 0x01
  with open(path, "wb") as f:
    f.write(raw)
  with pytest.raises(tfrecord_io.TFRecordError, match=match) as e:
    list(tfrecord_io.iterate_records(path))
  assert path in str(e.value)


@pytest.mark.parametrize("cut", [1, 4, 10, 20])
def test_a_truncated_file_raises(tmp_path, cut):
  path, raw = _file(tmp_path, [b"x" * 12, b"y" * 16])
  with open(path, "wb") as f:
    f.write(raw[:-cut])
  with pytest.raises(tfrecord_io.TFRecordError, match="truncated"):
    list(tfrecord_io.iterate_records(path))


def test_a_failed_codec_build_raises_on_every_call(tmp_path, monkeypatch):
  bad = tmp_path / "codec.cc"
  bad.write_text("this is not C++\n")
  monkeypatch.setattr(native, "CODEC_SOURCE", bad)
  monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
  monkeypatch.setattr(native, "_CODEC_LIB", None)
  monkeypatch.setattr(native, "_CODEC_ERROR", None)
  for _ in range(2):
    with pytest.raises(native.NativeBuildError, match="codec.cc"):
      native.crc32c(b"abc")
    with pytest.raises(native.NativeBuildError):
      png.decode(png.encode(np.zeros((2, 2, 3), np.uint8)))
  assert "error" in native.codec_load_error()


# ---- protos ----


def _rand_feature(rng):
  feature = tf.train.Feature()
  kind = rng.integers(0, 4)
  n = int(rng.integers(0, 5))
  if kind == 0:
    feature.bytes_list.value.extend([rng.bytes(int(rng.integers(0, 20)))
                                     for _ in range(n)])
  elif kind == 1:
    feature.float_list.value.extend(rng.standard_normal(n).astype(np.float32))
  elif kind == 2:
    feature.int64_list.value.extend(
        rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64).tolist())
  return feature  # kind 3: no kind set


def _same(want, got):
  kind = want.WhichOneof("kind")
  assert got.kind == {"bytes_list": "bytes", "float_list": "float",
                      "int64_list": "int64", None: None}[kind]
  if kind:
    assert list(getattr(want, kind).value) == list(got.values)


@pytest.mark.parametrize("seed", range(4))
def test_random_examples_round_trip(seed):
  rng = np.random.default_rng(seed)
  for _ in range(50):
    example = tf.train.Example()
    for j in range(int(rng.integers(0, 5))):
      example.features.feature[f"k{j}"].CopyFrom(_rand_feature(rng))
    got = proto.decode_example(example.SerializeToString())
    assert set(got) == set(example.features.feature)
    for key, feature in got.items():
      _same(example.features.feature[key], feature)
    assert tf.train.Example.FromString(proto.encode_example(got)) == example


@pytest.mark.parametrize("seed", range(4))
def test_random_sequence_examples_round_trip(seed):
  rng = np.random.default_rng(100 + seed)
  for _ in range(50):
    se = tf.train.SequenceExample()
    for j in range(int(rng.integers(0, 3))):
      se.context.feature[f"c{j}"].CopyFrom(_rand_feature(rng))
    for j in range(int(rng.integers(0, 3))):
      steps = se.feature_lists.feature_list[f"s{j}"]
      for _ in range(int(rng.integers(0, 4))):
        steps.feature.add().CopyFrom(_rand_feature(rng))
    context, lists = proto.decode_sequence_example(se.SerializeToString())
    assert set(context) == set(se.context.feature)
    assert set(lists) == set(se.feature_lists.feature_list)
    for key, steps in lists.items():
      want = se.feature_lists.feature_list[key].feature
      assert len(steps) == len(want)
      for w, g in zip(want, steps):
        _same(w, g)
    again = proto.encode_sequence_example(context, lists)
    assert tf.train.SequenceExample.FromString(again) == se


def _varint(value):
  out = bytearray()
  proto._put_varint(out, value)
  return bytes(out)


def _field(number, wire, payload):
  if wire == 2:
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload
  return _varint(number << 3 | wire) + payload


def test_unpacked_scalars_negative_ints_unknown_fields_and_repeated_keys():
  ints = b"".join(_field(1, 0, _varint(v)) for v in (-1, 5, -2 ** 63))
  floats = _field(1, 5, struct.pack("<f", 1.5)) + _field(
      1, 2, struct.pack("<2f", -2.0, 3.25))
  unknown = _field(9, 0, _varint(7)) + _field(10, 2, b"junk") + _field(
      11, 5, b"\0\0\0\0") + _field(12, 1, b"\0" * 8)
  feature_int = _field(3, 2, ints + unknown)
  feature_float = _field(2, 2, floats)

  def entry(key, value):
    return _field(1, 2, _field(1, 2, key) + _field(2, 2, value))

  # (Unknown fields inside a map entry itself are left out: protobuf's
  # own parser then drops the entry's value.)
  features = (entry(b"i", feature_int + unknown) + unknown
              + entry(b"f", feature_float)
              + entry(b"f", _field(1, 2, _field(1, 2, b"last"))))
  raw = _field(1, 2, features) + unknown
  got = proto.decode_example(raw)
  want = tf.train.Example.FromString(raw)
  assert list(got["i"].values) == [-1, 5, -2 ** 63] == list(
      want.features.feature["i"].int64_list.value)
  assert got["f"].kind == "bytes" and got["f"].values == [b"last"]
  assert want.features.feature["f"].bytes_list.value == [b"last"]
  assert got["f"].values == list(want.features.feature["f"].bytes_list.value)
  got = proto.decode_example(_field(1, 2, entry(b"f", feature_float)))
  np.testing.assert_array_equal(got["f"].values, [1.5, -2.0, 3.25])


@pytest.mark.parametrize("raw", [b"\x0a\x05\x0a\x03", b"\x0a", b"\x0b\x00",
                                 b"\x0a\x02\x0a\x09"])
def test_malformed_messages_raise(raw):
  with pytest.raises(proto.ProtoDecodeError):
    proto.decode_example(raw)


# ---- PNG ----


def _filters(data):
  """The filter type of every scanline of a PNG."""
  pos, idat = 8, b""
  while pos < len(data):
    (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
    if kind == b"IHDR":
      width, height, _, colour = struct.unpack(">IIBB", data[pos + 8:pos + 18])
    if kind == b"IDAT":
      idat += data[pos + 8:pos + 8 + n]
    pos += 12 + n
  raw = zlib.decompress(idat)
  row = width * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
  return Counter(raw[i * (row + 1)] for i in range(height))


def _corpus(n=24, seed=0):
  rng = np.random.default_rng(seed)
  x = np.linspace(0, 1, 48)
  out = []
  for i in range(n):
    kind = i % 4
    if kind == 0:
      img = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
    elif kind == 1:
      img = np.tile(np.arange(48, dtype=np.uint8)[:, None, None] * 5,
                    (1, 48, 3))
    elif kind == 2:
      img = (np.stack([np.outer(x, x), np.outer(1 - x, x),
                       np.outer(x, 1 - x)], -1) * 255).astype(np.uint8)
      img[10:20, 5:30] = rng.integers(0, 255, (10, 25, 3))
    else:
      img = (np.stack([np.outer(x, x)] * 3, -1) * 255
             + rng.integers(0, 8, (48, 48, 3))).astype(np.uint8)
    out.append(img)
  return out


def test_tensorflow_pngs_with_adaptive_filters_decode_exactly():
  images = _corpus()
  encoded = [tf.io.encode_png(img).numpy() for img in images]
  seen = sum((_filters(e) for e in encoded), Counter())
  assert {1, 2, 3, 4} <= set(seen), seen
  for img, got in zip(images, png.decode_many(encoded)):
    np.testing.assert_array_equal(got, img)


def _hand_filtered(image, kinds):
  """A PNG whose row y uses filter kinds[y % len(kinds)], written here
  straight from the PNG specification."""
  h, w, c = image.shape
  rows = image.reshape(h, w * c).astype(np.int32)
  lines = []
  for y in range(h):
    kind = kinds[y % len(kinds)]
    cur = rows[y]
    prev = rows[y - 1] if y else np.zeros_like(cur)
    left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
    up_left = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
    if kind == 0:
      pred = np.zeros_like(cur)
    elif kind == 1:
      pred = left
    elif kind == 2:
      pred = prev
    elif kind == 3:
      pred = (left + prev) // 2
    else:
      p = left + prev - up_left
      pa, pb, pc = abs(p - left), abs(p - prev), abs(p - up_left)
      pred = np.where((pa <= pb) & (pa <= pc), left,
                      np.where(pb <= pc, prev, up_left))
    lines.append(bytes([kind]) + ((cur - pred) % 256).astype(
        np.uint8).tobytes())

  def chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))

  header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
  return (png.SIGNATURE + chunk(b"IHDR", header)
          + chunk(b"IDAT", zlib.compress(b"".join(lines)))
          + chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,),
                                   (4, 3, 2, 1, 0)])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_each_filter_type_decodes_as_tensorflow_does(kinds, channels):
  rng = np.random.default_rng(len(kinds) * 10 + channels)
  image = rng.integers(0, 256, (9, 13, channels), dtype=np.uint8)
  image[:, :6] = np.arange(6, dtype=np.uint8)[None, :, None] * 40  # ties
  data = _hand_filtered(image, kinds)
  assert set(_filters(data)) == set(kinds)
  np.testing.assert_array_equal(tf.io.decode_png(data).numpy(), image)
  np.testing.assert_array_equal(png.decode(data), image)
  plain = png.decode_many([data], unfilter=native.png_unfilter_plain)[0]
  np.testing.assert_array_equal(plain, image)


def test_native_unfilter_equals_plain_over_many_frames():
  encoded = [tf.io.encode_png(img).numpy() for img in _corpus(8, seed=2)]
  encoded.append(_hand_filtered(_corpus(1)[0], (3, 4, 1)))
  native_out = png.decode_many(encoded)
  plain_out = png.decode_many(encoded, unfilter=native.png_unfilter_plain)
  for a, b in zip(native_out, plain_out):
    np.testing.assert_array_equal(a, b)
  bad = np.zeros(2 * (1 + 3), np.uint8)
  bad[0] = 7
  for fn in (native.png_unfilter, native.png_unfilter_plain):
    with pytest.raises(ValueError, match="frame 0"):
      fn(bad, [[0, 0, 2, 3, 1]], np.zeros(6, np.uint8))
    with pytest.raises(ValueError, match="outside"):
      fn(bad, [[0, 0, 3, 3, 1]], np.zeros(9, np.uint8))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_port_pngs_decode_exactly_in_tensorflow(channels):
  rng = np.random.default_rng(channels)
  image = rng.integers(0, 256, (11, 17, channels), dtype=np.uint8)
  data = png.encode(image)
  assert set(_filters(data)) == {1}
  np.testing.assert_array_equal(tf.io.decode_png(data).numpy(), image)
  np.testing.assert_array_equal(png.decode(data), image)


def _pil_png(mode, rng):
  Image = pytest.importorskip("PIL.Image")
  image = Image.fromarray(rng.integers(0, 256, (9, 14, 3), dtype=np.uint8))
  options = {}
  if mode == "P":
    image = image.quantize(37)
  elif mode == "PA":
    image = image.quantize(37)
    options["transparency"] = bytes(range(0, 37 * 6, 6))
  else:
    image = image.convert(mode)
  buffer = io.BytesIO()
  image.save(buffer, format="PNG", **options)
  return buffer.getvalue()


@pytest.mark.parametrize("mode", ["L", "LA", "P", "PA", "RGBA"])
@pytest.mark.parametrize("channels", [0, 1, 3, 4])
def test_channel_conversion_is_decode_images(mode, channels):
  """Every mode to every channel count, colour to grey (libpng's
  truncated weighted sum) included, equal to TF's pixels."""
  data = _pil_png(mode, np.random.default_rng(len(mode)))
  want = tf.io.decode_image(data, channels=channels).numpy()
  np.testing.assert_array_equal(png.decode(data, channels), want)


def _ihdr_png(depth=8, colour=2, interlace=0):
  header = struct.pack(">IIBBBBB", 2, 2, depth, colour, 0, 0, interlace)

  def chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))

  return (png.SIGNATURE + chunk(b"IHDR", header)
          + chunk(b"IDAT", zlib.compress(b"\0" * 64)) + chunk(b"IEND", b""))


def test_unsupported_pngs_raise_with_the_reason():
  with pytest.raises(ValueError, match="bit depth 16"):
    png.decode(_ihdr_png(depth=16))
  with pytest.raises(ValueError, match="interlaced"):
    png.decode(_ihdr_png(interlace=1))
  with pytest.raises(ValueError, match="CRC"):
    data = bytearray(png.encode(np.zeros((2, 2, 3), np.uint8)))
    data[-20] ^= 1
    png.decode(bytes(data))
  with pytest.raises(ValueError, match="signature"):
    png.decode(b"GIF89a")
  with pytest.raises(ValueError, match="channels"):
    png.decode(png.encode(np.zeros((2, 2, 3), np.uint8)), channels=2)
  # JPEG dispatches to the JPEG codec, which refuses progressive files.
  with pytest.raises(NotImplementedError, match="progressive"):
    png.decode(tf.io.encode_jpeg(np.zeros((4, 4, 3), np.uint8),
                                 progressive=True).numpy())
  assert png.encode_jpeg(np.zeros((4, 4, 3), np.uint8)) == (
      tf.io.encode_jpeg(np.zeros((4, 4, 3), np.uint8)).numpy())
