"""The port's JPEG codec (`data/jpeg.py`, `native/codec.cc`) against
TensorFlow's (libjpeg-turbo, which TF runs without this port on the card's
host), bit for bit.

Encode: the port's bytes equal `tf.io.encode_jpeg`'s (its defaults:
quality 95, 4:2:0, JFIF at 300 dpi) at 64×64×3, 48×48×3, 37×53×3 (partial
MCUs on both axes), 64×64×1, a constant image and a 0/255 checkerboard.
Decode: the port's pixels equal
`tf.io.decode_image`'s for TF-written files of those images at quality
50, 75, 95 and 100, with and without chroma downsampling. Tolerance: none
(exact bytes, exact pixels). Files written by PIL (4:2:2, restart
intervals, grey) decode to TF's pixels too; progressive files raise
NotImplementedError naming what they are.

Pinned traps (ROADMAP): 19, TF decodes with the IFAST integer IDCT
(`dct_method=""` is `INTEGER_FAST`), not ISLOW; 20, `encode_jpeg`'s exact
defaults and marker order.
"""

import hashlib
import io

import numpy as np
import pytest

pytest.importorskip("torch")
tf = pytest.importorskip("tensorflow")

import chip_smoke  # noqa: E402
from tensor2robot_tpu_torch.data import jpeg  # noqa: E402
from tensor2robot_tpu_torch.data import png  # noqa: E402


def _images():
  rng = np.random.default_rng(0)
  checker = (np.indices((32, 32)).sum(0) % 2 * 255).astype(np.uint8)
  return {
      "64x64x3": rng.integers(0, 256, (64, 64, 3), np.uint8),
      "48x48x3": rng.integers(0, 256, (48, 48, 3), np.uint8),
      "37x53x3": rng.integers(0, 256, (37, 53, 3), np.uint8),
      "64x64x1": rng.integers(0, 256, (64, 64, 1), np.uint8),
      "constant": np.full((40, 40, 3), 77, np.uint8),
      "checkerboard": np.repeat(checker[..., None], 3, axis=-1),
  }


IMAGES = _images()


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_encode_equals_tf_bytes(name):
  image = IMAGES[name]
  assert jpeg.encode(image) == tf.io.encode_jpeg(image).numpy()


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("chroma", [True, False])
def test_decode_equals_tf_pixels(quality, chroma):
  """All sizes of one (quality, sampling) in one `decode_many` call."""
  files = [tf.io.encode_jpeg(image, quality=quality,
                             chroma_downsampling=chroma).numpy()
           for image in IMAGES.values()]
  got = jpeg.decode_many(files)
  for name, data, image in zip(IMAGES, files, got):
    want = tf.io.decode_image(data).numpy()
    assert image.dtype == np.uint8 and image.shape == want.shape, name
    np.testing.assert_array_equal(image, want, err_msg=name)


def test_tf_decodes_with_ifast_not_islow():
  """Trap 19: `decode_image`'s pixels are `INTEGER_FAST`'s; an ISLOW
  decoder would be off by a few levels on this file."""
  data = tf.io.encode_jpeg(IMAGES["64x64x3"], quality=75).numpy()
  ifast = tf.io.decode_jpeg(data, dct_method="INTEGER_FAST").numpy()
  islow = tf.io.decode_jpeg(data, dct_method="INTEGER_ACCURATE").numpy()
  np.testing.assert_array_equal(tf.io.decode_image(data).numpy(), ifast)
  assert not np.array_equal(ifast, islow)
  np.testing.assert_array_equal(jpeg.decode(data), ifast)


def _segments(data):
  """(marker, body) of each segment up to the scan."""
  out, at = [], 2
  while True:
    marker = data[at + 1]
    length = int.from_bytes(data[at + 2:at + 4], "big")
    out.append((marker, data[at + 4:at + 2 + length]))
    if marker == 0xDA:
      return out
    at += 2 + length


def test_encode_defaults_and_marker_order():
  """Trap 20: JFIF APP0 1.01 at 300 × 300 dpi, two DQT (quality 95),
  baseline SOF0 with Y at 2×2 and Cb, Cr at 1×1, the four standard DHT,
  one SOS, no DRI; a grey image has one component, one DQT, two DHT."""
  data = jpeg.encode(IMAGES["37x53x3"])
  segs = _segments(data)
  assert [m for m, _ in segs] == [0xE0, 0xDB, 0xDB, 0xC0, 0xC4, 0xC4, 0xC4,
                                  0xC4, 0xDA]
  assert segs[0][1] == b"JFIF\x00\x01\x01\x01\x01\x2c\x01\x2c\x00\x00"
  assert segs[1][1][:4] == bytes([0, 2, 1, 1])  # 16 × 10 / 100 → 2, ...
  assert segs[3][1] == bytes([8, 0, 37, 0, 53, 3, 1, 0x22, 0, 2, 0x11, 1,
                              3, 0x11, 1])
  assert [b[0] for m, b in segs if m == 0xC4] == [0x00, 0x10, 0x01, 0x11]
  assert data.endswith(b"\xff\xd9") and b"\xff\xdd" not in data[:200]
  grey = _segments(jpeg.encode(IMAGES["64x64x1"]))
  assert [m for m, _ in grey] == [0xE0, 0xDB, 0xC0, 0xC4, 0xC4, 0xDA]
  assert grey[2][1][5:] == bytes([1, 1, 0x11, 0])


def test_chip_smoke_digests_are_tf_output():
  """The constants chip_smoke checks on the card (no TF there) are the
  SHA-256 of TF's bytes and pixels, and the port's."""
  for shape, image in chip_smoke.jpeg_digest_images().items():
    want_bytes, want_pixels = chip_smoke.JPEG_DIGESTS[shape]
    tf_bytes = tf.io.encode_jpeg(image).numpy()
    assert hashlib.sha256(tf_bytes).hexdigest() == want_bytes
    assert hashlib.sha256(tf.io.decode_image(tf_bytes).numpy().tobytes()
                          ).hexdigest() == want_pixels
    ours = jpeg.encode(image)
    assert hashlib.sha256(ours).hexdigest() == want_bytes
    assert hashlib.sha256(jpeg.decode(ours).tobytes()
                          ).hexdigest() == want_pixels


def _pil(image, **kwargs):
  pil = pytest.importorskip("PIL.Image")
  out = io.BytesIO()
  pil.fromarray(image).save(out, "JPEG", **kwargs)
  return out.getvalue()


@pytest.mark.parametrize("kind", ["422", "restart_blocks", "restart_rows",
                                  "grey"])
@pytest.mark.parametrize("channels", [0, 1, 3])
def test_other_writers_decode_to_tf_pixels(kind, channels):
  """Sampling 4:2:2 (h2v1 fancy upsampling), restart intervals (DRI and
  RSTn), a grey file; each to the file's channels, to grey (the luma) and
  to RGB (grey replicated), as `decode_image(channels=c)`."""
  rng = np.random.default_rng(1)
  y, x = np.mgrid[0:45, 0:67]
  image = (np.stack([x * 3, y * 4, (x + y) * 2], -1)
           + rng.integers(0, 40, (45, 67, 3))).clip(0, 255).astype(np.uint8)
  data = {
      "422": lambda: _pil(image, subsampling=1, quality=80),
      "restart_blocks": lambda: _pil(image, subsampling=2,
                                     restart_marker_blocks=3),
      "restart_rows": lambda: _pil(image, subsampling=1,
                                   restart_marker_rows=1),
      "grey": lambda: _pil(image[..., 0]),
  }[kind]()
  if kind.startswith("restart"):
    assert b"\xff\xdd" in data
  want = tf.io.decode_image(data, channels=channels).numpy()
  np.testing.assert_array_equal(jpeg.decode(data, channels), want)


def test_refusals_and_malformed_files():
  image = IMAGES["48x48x3"]
  progressive = tf.io.encode_jpeg(image, progressive=True).numpy()
  with pytest.raises(NotImplementedError, match="progressive"):
    jpeg.decode(progressive)
  with pytest.raises(NotImplementedError, match="progressive"):
    png.decode_many([png.encode(image), progressive])
  data = bytearray(jpeg.encode(image))
  sof = data.index(b"\xff\xc0")
  twelve = bytes(data[:sof + 4]) + b"\x0c" + bytes(data[sof + 5:])
  with pytest.raises(NotImplementedError, match="12-bit"):
    jpeg.decode(twelve)
  arithmetic = bytes(data[:sof + 1]) + b"\xc9" + bytes(data[sof + 2:])
  with pytest.raises(NotImplementedError, match="arithmetic"):
    jpeg.decode(arithmetic)
  lossless = bytes(data[:sof + 1]) + b"\xc3" + bytes(data[sof + 2:])
  with pytest.raises(NotImplementedError, match="lossless"):
    jpeg.decode(lossless)
  with pytest.raises(jpeg.JPEGError, match="truncated"):
    jpeg.decode(bytes(data[:sof + 6]))
  with pytest.raises(ValueError, match="0, 1 or 3"):
    jpeg.decode(bytes(data), channels=4)
  with pytest.raises(ValueError, match="1 or 3"):
    jpeg.encode(np.zeros((4, 4, 4), np.uint8))


def test_png_dispatch_keeps_order_across_formats():
  image = IMAGES["37x53x3"]
  files = [png.encode(image), jpeg.encode(image), png.encode(image[..., :1])]
  got = png.decode_many(files)
  np.testing.assert_array_equal(got[0], image)
  np.testing.assert_array_equal(
      got[1], tf.io.decode_image(files[1]).numpy())
  np.testing.assert_array_equal(got[2], image[..., :1])


def test_threaded_decode_equals_one_thread_and_names_the_first_bad_frame():
  """`decode_many` splits 30 frames over threads (8 frames a thread at
  least): each frame's pixels are those of its own one-frame call, which
  runs on one thread, and a failure names the first bad frame."""
  files = [tf.io.encode_jpeg(image).numpy() for image in IMAGES.values()] * 5
  got = jpeg.decode_many(files)
  for data, image in zip(files, got):
    np.testing.assert_array_equal(image, jpeg.decode(data))
  broken = list(files)
  sof = broken[7].index(b"\xff\xc0")
  for i in (7, 20):
    broken[i] = broken[i][:sof + 1] + b"\xc2" + broken[i][sof + 2:]
  with pytest.raises(NotImplementedError, match="frame 7: progressive"):
    jpeg.decode_many(broken)
  # A fault found only in the scan (a Huffman table it names is not
  # defined), in two threads' runs: the first frame is named.
  broken = list(files)
  for i in (17, 26):
    sos = broken[i].index(b"\xff\xda")
    broken[i] = broken[i][:sos + 6] + b"\x33" + broken[i][sos + 7:]
  with pytest.raises(ValueError, match="frame 17: JPEG scan uses a Huffman"):
    jpeg.decode_many(broken)
