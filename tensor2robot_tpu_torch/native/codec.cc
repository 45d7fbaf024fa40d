// Host codec for the data plane: CRC-32C for the TFRecord framing, PNG
// row unfiltering and a baseline JPEG codec for image decode and encode.
//
// The port reads TFRecord files and PNG frames without TensorFlow. Two
// loops in that path are sequential per byte and too slow in Python:
//   * CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) over every
//     record's length and data. With SSE4.2 the `crc32` instruction
//     does 8 bytes a step; otherwise slice-by-8 tables.
//   * PNG row unfiltering. Each row of a PNG starts with a filter type
//     (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth); Sub, Average and Paeth
//     depend on the byte `bpp` to the left in the same row, so a row is
//     a serial chain. One call unfilters many frames.
//   * JPEG (baseline sequential, Huffman, 8-bit) as TensorFlow's
//     libjpeg-turbo gives it: decode with the IFAST integer IDCT and
//     fancy upsampling (`tf.io.decode_image`'s defaults), encode with
//     the ISLOW forward DCT, 4:2:0 and quality 95 (`tf.io.encode_jpeg`'s
//     defaults). Entropy coding, (I)DCT, resampling and colour
//     conversion all live here; one call decodes many frames.
//
// Exposed as a tiny C ABI consumed through ctypes;
// `tensor2robot_tpu_torch.utils.native` compiles it with g++ on first
// use, beside the row gather.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <nmmintrin.h>
#endif

namespace {

uint32_t g_table[8][256];

bool init_table() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
    g_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    for (int t = 1; t < 8; ++t) {
      g_table[t][i] =
          (g_table[t - 1][i] >> 8) ^ g_table[0][g_table[t - 1][i] & 0xFF];
    }
  }
  return true;
}

uint32_t crc_slice8(uint32_t crc, const uint8_t* p, int64_t n) {
  static const bool ready = init_table();  // once, thread-safe
  (void)ready;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = g_table[7][lo & 0xFF] ^ g_table[6][(lo >> 8) & 0xFF] ^
          g_table[5][(lo >> 16) & 0xFF] ^ g_table[4][lo >> 24] ^
          g_table[3][hi & 0xFF] ^ g_table[2][(hi >> 8) & 0xFF] ^
          g_table[1][(hi >> 16) & 0xFF] ^ g_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) crc = (crc >> 8) ^ g_table[0][(crc ^ *p++) & 0xFF];
  return crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2"))) uint32_t crc_hw(uint32_t crc,
                                                   const uint8_t* p,
                                                   int64_t n) {
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    c = _mm_crc32_u64(c, v);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (n-- > 0) c32 = _mm_crc32_u8(c32, *p++);
  return c32;
}

bool has_hw() {
  static const bool hw = __builtin_cpu_supports("sse4.2");
  return hw;
}
#endif

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

// One frame: `src` holds `height` rows of (1 + row_bytes) bytes, `dst`
// receives height * row_bytes bytes. Returns 0, or 1 + the row index
// whose filter type is not 0..4.
int64_t unfilter_frame(const uint8_t* src, uint8_t* dst, int64_t height,
                       int64_t row_bytes, int64_t bpp) {
  const uint8_t* prev = nullptr;
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t type = src[0];
    const uint8_t* in = src + 1;
    uint8_t* out = dst;
    switch (type) {
      case 0:
        std::memcpy(out, in, static_cast<size_t>(row_bytes));
        break;
      case 1:
        for (int64_t x = 0; x < row_bytes; ++x)
          out[x] = static_cast<uint8_t>(in[x] + (x >= bpp ? out[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < row_bytes; ++x)
          out[x] = static_cast<uint8_t>(in[x] + (prev ? prev[x] : 0));
        break;
      case 3:
        for (int64_t x = 0; x < row_bytes; ++x) {
          int a = x >= bpp ? out[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          out[x] = static_cast<uint8_t>(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < row_bytes; ++x) {
          int a = x >= bpp ? out[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
          out[x] = static_cast<uint8_t>(in[x] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
    prev = out;
    src += 1 + row_bytes;
    dst += row_bytes;
  }
  return 0;
}

}  // namespace

extern "C" {

// CRC-32C of `n` bytes at `data`, continuing from `crc` (0 to start);
// pre- and post-inverted as the standard defines it.
uint32_t t2r_crc32c(uint32_t crc, const uint8_t* data, int64_t n) {
  crc = ~crc;
#if defined(__x86_64__)
  if (has_hw()) return ~crc_hw(crc, data, n);
#endif
  return ~crc_slice8(crc, data, n);
}

// CRC-32C without the hardware path (for tests of the table path).
uint32_t t2r_crc32c_sw(uint32_t crc, const uint8_t* data, int64_t n) {
  return ~crc_slice8(~crc, data, n);
}

// Whether t2r_crc32c uses the SSE4.2 instruction on this CPU.
int32_t t2r_crc32c_hw() {
#if defined(__x86_64__)
  return has_hw() ? 1 : 0;
#else
  return 0;
#endif
}

// Unfilters `n` frames. Frame i's filtered rows start at
// src + src_off[i], its pixels go to dst + dst_off[i]; it has height[i]
// rows of row_bytes[i] bytes at bpp[i] bytes per pixel. Returns 0, or
// -(1 + i) for the first frame i with an invalid filter type.
int64_t t2r_png_unfilter(const uint8_t* src, const int64_t* src_off,
                         uint8_t* dst, const int64_t* dst_off,
                         const int64_t* height, const int64_t* row_bytes,
                         const int64_t* bpp, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    if (unfilter_frame(src + src_off[i], dst + dst_off[i], height[i],
                       row_bytes[i], bpp[i]) != 0) {
      return -(1 + i);
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------
// JPEG. The arithmetic follows libjpeg-turbo's C paths, which its SIMD
// paths equal bit for bit (DCTELEM is 16-bit in its SIMD builds, so the
// IFAST IDCT's intermediates wrap as int16 here too):
//   decode: jdhuff.c, jidctfst.c (IFAST), jdsample.c (fancy h2v1, h1v2,
//           h2v2; box otherwise), jdcolor.c (fixed-point YCbCr -> RGB);
//   encode: jccolor.c, jcsample.c (h2v2 with biases 1, 2), jfdctint.c
//           (ISLOW), jcdctmgr.c (the reciprocal quantizer), jccoefct.c
//           (dummy blocks of partial MCUs), jchuff.c, jcmarker.c.
// ---------------------------------------------------------------------

namespace {

// Zigzag position -> natural (row-major) position.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a corrupt run past 63 lands here, harmlessly
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct JpegError {
  int kind;  // 1: not supported (a kind of JPEG this codec refuses); 2: malformed
  std::string message;
};

[[noreturn]] void unsupported(const std::string& m) { throw JpegError{1, m}; }
[[noreturn]] void malformed(const std::string& m) { throw JpegError{2, m}; }

// ---- Huffman decoding (canonical codes, ITU T.81 F.2.2.3) ----

constexpr int kLookBits = 9;

struct HuffDec {
  bool present = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valptr[17] = {};
  int32_t mincode[17] = {};
  // Codes of up to kLookBits bits by their next kLookBits bits:
  // (length << 8) | value, 0 where the code is longer.
  uint16_t look[1 << kLookBits] = {};
};

void build_huff_dec(HuffDec* t, const uint8_t bits[17], const uint8_t* vals,
                    int count) {
  std::memcpy(t->vals, vals, static_cast<size_t>(count));
  int32_t code = 0, k = 0;
  std::memset(t->look, 0, sizeof(t->look));
  for (int l = 1; l <= 16; ++l) {
    t->valptr[l] = k;
    t->mincode[l] = code;
    for (int i = 0; i < bits[l]; ++i) {
      if (l <= kLookBits) {
        const int first = (code + i) << (kLookBits - l);
        for (int j = 0; j < (1 << (kLookBits - l)); ++j)
          t->look[first + j] = static_cast<uint16_t>((l << 8) | vals[k + i]);
      }
    }
    code += bits[l];
    k += bits[l];
    t->maxcode[l] = bits[l] ? code - 1 : -1;
    code <<= 1;
  }
  t->maxcode[17] = 0x7FFFFFFF;
  t->present = true;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!at_marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          const uint32_t next = p + 1 < end ? p[1] : 0xD9;
          if (next == 0x00) {
            p += 2;
          } else {
            at_marker = true;  // past the data: zeros, as libjpeg feeds
            b = 0;
          }
        } else {
          ++p;
        }
      }
      buf |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }
  int get(int n) {  // n in 0..16
    if (n == 0) return 0;
    if (cnt < n) fill();
    const int v = static_cast<int>(buf >> (64 - n));
    buf <<= n;
    cnt -= n;
    return v;
  }
  int decode(const HuffDec& t) {
    if (cnt < 16) fill();
    const int32_t peek = static_cast<int32_t>(buf >> 48);
    const int hit = t.look[peek >> (16 - kLookBits)];
    if (hit) {
      buf <<= hit >> 8;
      cnt -= hit >> 8;
      return hit & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      const int32_t code = peek >> (16 - l);
      if (code <= t.maxcode[l]) {
        buf <<= l;
        cnt -= l;
        return t.vals[(t.valptr[l] + code - t.mincode[l]) & 0xFF];
      }
    }
    malformed("corrupt JPEG data: bad Huffman code");
  }
  // At a restart marker: drop the padding bits, step over RSTn.
  void restart(int expect) {
    buf = 0;
    cnt = 0;
    at_marker = false;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7)) ++p;
    if (p + 1 >= end || p[1] != 0xD0 + expect)
      malformed("corrupt JPEG data: restart marker missing or out of order");
    p += 2;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ---- the IFAST inverse DCT (jidctfst.c, 8-bit: CONST_BITS 8) ----

const int16_t kAanScales[64] = {
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,
    22725, 31521, 29692, 26722, 22725, 17855, 12299, 6270,
    21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,
    19266, 26722, 25172, 22654, 19266, 15137, 10426, 5315,
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,
    12873, 17855, 16819, 15137, 12873, 10114, 6967,  3552,
    8867,  12299, 11585, 10426, 8867,  6967,  4799,  2446,
    4520,  6270,  5906,  5315,  4520,  3552,  2446,  1247};

// The IFAST dequantization table: DESCALE(q * aanscale, 14 - 2), rounded.
void ifast_table(const uint16_t quant[64], int16_t out[64]) {
  for (int i = 0; i < 64; ++i) {
    const int64_t v = static_cast<int64_t>(quant[i]) * kAanScales[i];
    out[i] = static_cast<int16_t>((v + (1 << 11)) >> 12);
  }
}

typedef int16_t DCTELEM;  // 16-bit, as libjpeg-turbo's SIMD builds have it

inline DCTELEM mul8(int64_t var, int64_t c) {  // MULTIPLY, no rounding
  return static_cast<DCTELEM>((var * c) >> 8);
}

// libjpeg's post-IDCT range limit: index (x & 1023) of a table that
// maps -128..127 -> 0..255, 128..511 -> 255, 512..895 -> 0 (wrapping).
inline uint8_t range_limit(int x) {
  const int i = x & 1023;
  if (i < 128) return static_cast<uint8_t>(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return static_cast<uint8_t>(i - 896);
}

void idct_ifast(const int16_t* coef, const int16_t* q, uint8_t* out,
                int64_t stride) {
  const int64_t F1_082 = 277, F1_414 = 362, F1_847 = 473, F2_613 = 669;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int16_t* qq = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      const int dc = static_cast<int>(in[0]) * qq[0];
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    DCTELEM tmp0 = static_cast<DCTELEM>(in[0] * qq[0]);
    DCTELEM tmp1 = static_cast<DCTELEM>(in[16] * qq[16]);
    DCTELEM tmp2 = static_cast<DCTELEM>(in[32] * qq[32]);
    DCTELEM tmp3 = static_cast<DCTELEM>(in[48] * qq[48]);
    DCTELEM tmp10 = static_cast<DCTELEM>(tmp0 + tmp2);
    DCTELEM tmp11 = static_cast<DCTELEM>(tmp0 - tmp2);
    DCTELEM tmp13 = static_cast<DCTELEM>(tmp1 + tmp3);
    DCTELEM tmp12 = static_cast<DCTELEM>(mul8(tmp1 - tmp3, F1_414) - tmp13);
    tmp0 = static_cast<DCTELEM>(tmp10 + tmp13);
    tmp3 = static_cast<DCTELEM>(tmp10 - tmp13);
    tmp1 = static_cast<DCTELEM>(tmp11 + tmp12);
    tmp2 = static_cast<DCTELEM>(tmp11 - tmp12);
    DCTELEM tmp4 = static_cast<DCTELEM>(in[8] * qq[8]);
    DCTELEM tmp5 = static_cast<DCTELEM>(in[24] * qq[24]);
    DCTELEM tmp6 = static_cast<DCTELEM>(in[40] * qq[40]);
    DCTELEM tmp7 = static_cast<DCTELEM>(in[56] * qq[56]);
    const DCTELEM z13 = static_cast<DCTELEM>(tmp6 + tmp5);
    const DCTELEM z10 = static_cast<DCTELEM>(tmp6 - tmp5);
    const DCTELEM z11 = static_cast<DCTELEM>(tmp4 + tmp7);
    const DCTELEM z12 = static_cast<DCTELEM>(tmp4 - tmp7);
    tmp7 = static_cast<DCTELEM>(z11 + z13);
    tmp11 = mul8(z11 - z13, F1_414);
    const DCTELEM z5 = mul8(z10 + z12, F1_847);
    tmp10 = static_cast<DCTELEM>(mul8(z12, F1_082) - z5);
    tmp12 = static_cast<DCTELEM>(mul8(z10, -F2_613) + z5);
    tmp6 = static_cast<DCTELEM>(tmp12 - tmp7);
    tmp5 = static_cast<DCTELEM>(tmp11 - tmp6);
    tmp4 = static_cast<DCTELEM>(tmp10 + tmp5);
    w[0] = tmp0 + tmp7;
    w[56] = tmp0 - tmp7;
    w[8] = tmp1 + tmp6;
    w[48] = tmp1 - tmp6;
    w[16] = tmp2 + tmp5;
    w[40] = tmp2 - tmp5;
    w[32] = tmp3 + tmp4;
    w[24] = tmp3 - tmp4;
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      const uint8_t dc = range_limit(w[0] >> 5);
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    const DCTELEM w0 = static_cast<DCTELEM>(w[0]), w1 = static_cast<DCTELEM>(w[1]),
                  w2 = static_cast<DCTELEM>(w[2]), w3 = static_cast<DCTELEM>(w[3]),
                  w4 = static_cast<DCTELEM>(w[4]), w5 = static_cast<DCTELEM>(w[5]),
                  w6 = static_cast<DCTELEM>(w[6]), w7 = static_cast<DCTELEM>(w[7]);
    DCTELEM tmp10 = static_cast<DCTELEM>(w0 + w4);
    DCTELEM tmp11 = static_cast<DCTELEM>(w0 - w4);
    DCTELEM tmp13 = static_cast<DCTELEM>(w2 + w6);
    DCTELEM tmp12 = static_cast<DCTELEM>(mul8(w2 - w6, F1_414) - tmp13);
    const DCTELEM tmp0 = static_cast<DCTELEM>(tmp10 + tmp13);
    const DCTELEM tmp3 = static_cast<DCTELEM>(tmp10 - tmp13);
    const DCTELEM tmp1 = static_cast<DCTELEM>(tmp11 + tmp12);
    const DCTELEM tmp2 = static_cast<DCTELEM>(tmp11 - tmp12);
    const DCTELEM z13 = static_cast<DCTELEM>(w5 + w3);
    const DCTELEM z10 = static_cast<DCTELEM>(w5 - w3);
    const DCTELEM z11 = static_cast<DCTELEM>(w1 + w7);
    const DCTELEM z12 = static_cast<DCTELEM>(w1 - w7);
    const DCTELEM tmp7 = static_cast<DCTELEM>(z11 + z13);
    tmp11 = mul8(z11 - z13, F1_414);
    const DCTELEM z5 = mul8(z10 + z12, F1_847);
    tmp10 = static_cast<DCTELEM>(mul8(z12, F1_082) - z5);
    tmp12 = static_cast<DCTELEM>(mul8(z10, -F2_613) + z5);
    const DCTELEM tmp6 = static_cast<DCTELEM>(tmp12 - tmp7);
    const DCTELEM tmp5 = static_cast<DCTELEM>(tmp11 - tmp6);
    const DCTELEM tmp4 = static_cast<DCTELEM>(tmp10 + tmp5);
    o[0] = range_limit((tmp0 + tmp7) >> 5);
    o[7] = range_limit((tmp0 - tmp7) >> 5);
    o[1] = range_limit((tmp1 + tmp6) >> 5);
    o[6] = range_limit((tmp1 - tmp6) >> 5);
    o[2] = range_limit((tmp2 + tmp5) >> 5);
    o[5] = range_limit((tmp2 - tmp5) >> 5);
    o[4] = range_limit((tmp3 + tmp4) >> 5);
    o[3] = range_limit((tmp3 - tmp4) >> 5);
  }
}

// ---- the parsed file ----

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;      // Huffman tables of the current scan
  int width = 0, height = 0;    // downsampled size
  int bw = 0, bh = 0;      // blocks stored (padded to whole MCUs)
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples after the IDCT
};

struct Frame {
  int width = 0, height = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool frame_seen = false;
  std::vector<Component> comps;
  uint16_t quant[4][64] = {};
  bool quant_present[4] = {};
  HuffDec dc[4], ac[4];
  bool rgb() const {  // jdapimin.c default_decompress_parms, 3 components
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  }
};

inline int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

void read_sof(Frame* f, const uint8_t* s, int len, int marker) {
  if (marker == 0xC2 || marker == 0xC6)
    unsupported("progressive JPEG (SOF" + std::to_string(marker - 0xC0) +
                ") is not supported; baseline sequential only");
  if (marker == 0xC3 || marker == 0xC7)
    unsupported("lossless JPEG (SOF" + std::to_string(marker - 0xC0) +
                ") is not supported; baseline sequential only");
  if (marker == 0xC5)
    unsupported("hierarchical JPEG (SOF5) is not supported");
  if (marker >= 0xC9)
    unsupported("arithmetic-coded JPEG (SOF" + std::to_string(marker - 0xC0) +
                ") is not supported; Huffman coding only");
  if (f->frame_seen) malformed("JPEG with two frame headers");
  if (len < 6) malformed("JPEG frame header too short");
  const int precision = s[0];
  if (precision != 8)
    unsupported(std::to_string(precision) +
                "-bit JPEG is not supported; 8-bit samples only");
  f->height = u16(s + 1);
  f->width = u16(s + 3);
  const int n = s[5];
  if (f->height == 0 || f->width == 0)
    malformed("JPEG with an empty image (or a DNL height)");
  if (n == 4)
    unsupported("4-component (CMYK / YCCK) JPEG is not supported");
  if (n != 1 && n != 3)
    unsupported(std::to_string(n) + "-component JPEG is not supported");
  if (len < 6 + 3 * n) malformed("JPEG frame header too short");
  f->comps.resize(static_cast<size_t>(n));
  for (int i = 0; i < n; ++i) {
    Component& c = f->comps[static_cast<size_t>(i)];
    c.id = s[6 + 3 * i];
    c.h = s[7 + 3 * i] >> 4;
    c.v = s[7 + 3 * i] & 15;
    c.tq = s[8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      malformed("JPEG component with bad sampling factors or table");
    if (c.h > 2 || c.v > 2)
      unsupported("JPEG sampling factors above 2 are not supported");
    f->hmax = std::max(f->hmax, c.h);
    f->vmax = std::max(f->vmax, c.v);
  }
  f->mcux = (f->width + 8 * f->hmax - 1) / (8 * f->hmax);
  f->mcuy = (f->height + 8 * f->vmax - 1) / (8 * f->vmax);
  for (Component& c : f->comps) {
    c.width = (f->width * c.h + f->hmax - 1) / f->hmax;
    c.height = (f->height * c.v + f->vmax - 1) / f->vmax;
    c.bw = f->mcux * c.h;
    c.bh = f->mcuy * c.v;
  }
  f->frame_seen = true;
}

void read_dqt(Frame* f, const uint8_t* s, int len) {
  int at = 0;
  while (at < len) {
    const int pq = s[at] >> 4, tq = s[at] & 15;
    if (tq > 3) malformed("JPEG quantization table index above 3");
    if (pq != 0) unsupported("16-bit JPEG quantization tables are not supported");
    if (at + 65 > len) malformed("JPEG quantization table too short");
    for (int k = 0; k < 64; ++k) f->quant[tq][kNatural[k]] = s[at + 1 + k];
    f->quant_present[tq] = true;
    at += 65;
  }
}

void read_dht(Frame* f, const uint8_t* s, int len) {
  int at = 0;
  while (at < len) {
    if (at + 17 > len) malformed("JPEG Huffman table too short");
    const int tc = s[at] >> 4, th = s[at] & 15;
    if (tc > 1 || th > 3) malformed("JPEG Huffman table class or index");
    uint8_t bits[17] = {};
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += bits[l] = s[at + l];
    if (count > 256 || at + 17 + count > len)
      malformed("JPEG Huffman table too long");
    build_huff_dec(tc ? &f->ac[th] : &f->dc[th], bits, s + at + 17, count);
    at += 17 + count;
  }
}

void decode_block(BitReader* br, const HuffDec& dc, const HuffDec& ac,
                  int* pred, int16_t* blk) {
  const int t = br->decode(dc);
  if (t > 16) malformed("corrupt JPEG data: bad DC magnitude");
  const int diff = t ? extend(br->get(t), t) : 0;
  *pred += diff;
  blk[0] = static_cast<int16_t>(*pred);
  for (int k = 1; k < 64; ++k) {
    const int rs = br->decode(ac);
    const int r = rs >> 4, sz = rs & 15;
    if (sz) {
      k += r;
      blk[kNatural[k]] = static_cast<int16_t>(extend(br->get(sz), sz));
    } else if (r == 15) {
      k += 15;
    } else {
      break;
    }
  }
}

// One scan: returns the position after its entropy-coded data.
const uint8_t* read_scan(Frame* f, const uint8_t* s, int len,
                         const uint8_t* data, const uint8_t* end) {
  if (!f->frame_seen) malformed("JPEG scan before the frame header");
  const int ns = s[0];
  if (ns < 1 || ns > 4 || len < 4 + 2 * ns) malformed("JPEG scan header");
  std::vector<Component*> sc;
  for (int i = 0; i < ns; ++i) {
    Component* c = nullptr;
    for (Component& cc : f->comps)
      if (cc.id == s[1 + 2 * i]) c = &cc;
    if (c == nullptr) malformed("JPEG scan names an unknown component");
    c->td = s[2 + 2 * i] >> 4;
    c->ta = s[2 + 2 * i] & 15;
    if (c->td > 3 || c->ta > 3 || !f->dc[c->td].present ||
        !f->ac[c->ta].present)
      malformed("JPEG scan uses a Huffman table that is not defined");
    if (c->coef.empty())
      c->coef.assign(static_cast<size_t>(c->bw) * c->bh * 64, 0);
    sc.push_back(c);
  }
  const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahal = s[3 + 2 * ns];
  if (ss != 0 || se != 63 || ahal != 0)
    unsupported("progressive JPEG scan (spectral selection or successive "
                "approximation) is not supported");
  BitReader br{data, end};
  int pred[4] = {0, 0, 0, 0};
  int mcus_x, mcus_y;
  if (ns == 1) {  // non-interleaved: one block per MCU, the component's own
    mcus_x = (sc[0]->width + 7) / 8;
    mcus_y = (sc[0]->height + 7) / 8;
  } else {
    mcus_x = f->mcux;
    mcus_y = f->mcuy;
  }
  const int64_t total = static_cast<int64_t>(mcus_x) * mcus_y;
  int next_rst = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (f->restart && m > 0 && m % f->restart == 0) {
      br.restart(next_rst);
      next_rst = (next_rst + 1) & 7;
      for (int& p : pred) p = 0;
    }
    const int mx = static_cast<int>(m % mcus_x), my = static_cast<int>(m / mcus_x);
    for (int i = 0; i < ns; ++i) {
      Component* c = sc[static_cast<size_t>(i)];
      if (ns == 1) {
        int16_t* blk = &c->coef[(static_cast<size_t>(my) * c->bw + mx) * 64];
        decode_block(&br, f->dc[c->td], f->ac[c->ta], &pred[i], blk);
        continue;
      }
      for (int yy = 0; yy < c->v; ++yy)
        for (int xx = 0; xx < c->h; ++xx) {
          const size_t b = static_cast<size_t>(my * c->v + yy) * c->bw +
                           static_cast<size_t>(mx * c->h + xx);
          decode_block(&br, f->dc[c->td], f->ac[c->ta], &pred[i],
                       &c->coef[b * 64]);
        }
    }
  }
  // The position of the next marker (libjpeg skips anything before it).
  const uint8_t* p = br.p;
  while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 &&
                          !(p[1] >= 0xD0 && p[1] <= 0xD7)))
    ++p;
  return p;
}

// Parses the whole file; with `decode_data` also entropy-decodes it.
void parse(Frame* f, const uint8_t* src, int64_t n, bool decode_data) {
  if (n < 4 || src[0] != 0xFF || src[1] != 0xD8)
    malformed("not a JPEG (no SOI marker)");
  const uint8_t* p = src + 2;
  const uint8_t* end = src + n;
  bool scanned = false;
  while (true) {
    while (p < end && *p != 0xFF) ++p;  // libjpeg skips junk, warning
    while (p < end && *p == 0xFF) ++p;  // fill bytes
    if (p >= end) {
      if (scanned) return;  // a missing EOI is tolerated, as libjpeg does
      malformed("truncated JPEG: no image data");
    }
    const int marker = *p++;
    if (marker == 0xD9) return;
    if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7) || marker == 0x01)
      continue;
    if (p + 2 > end) malformed("truncated JPEG marker segment");
    const int len = u16(p);
    if (len < 2 || p + len > end) malformed("truncated JPEG marker segment");
    const uint8_t* s = p + 2;
    const int slen = len - 2;
    p += len;
    if (marker == 0xC0 || marker == 0xC1) {
      read_sof(f, s, slen, marker);
    } else if ((marker >= 0xC2 && marker <= 0xCF) && marker != 0xC4 &&
               marker != 0xC8 && marker != 0xCC) {
      read_sof(f, s, slen, marker);
    } else if (marker == 0xCC) {
      unsupported("arithmetic-coded JPEG (DAC marker) is not supported");
    } else if (marker == 0xC4) {
      read_dht(f, s, slen);
    } else if (marker == 0xDB) {
      read_dqt(f, s, slen);
    } else if (marker == 0xDD) {
      if (slen < 2) malformed("JPEG restart interval segment too short");
      f->restart = u16(s);
    } else if (marker == 0xE0) {
      if (slen >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) f->jfif = true;
    } else if (marker == 0xEE) {
      if (slen >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
        f->adobe = true;
        f->adobe_transform = s[11];
      }
    } else if (marker == 0xDA) {
      if (!decode_data) {
        if (!f->frame_seen) malformed("JPEG scan before the frame header");
        return;
      }
      p = read_scan(f, s, slen, p, end);
      scanned = true;
    }
  }
}

void check_decodable(const Frame& f) {
  if (!f.frame_seen) malformed("JPEG without a frame header");
  for (const Component& c : f.comps) {
    if (!f.quant_present[c.tq])
      malformed("JPEG component uses an undefined quantization table");
    if (c.coef.empty()) malformed("JPEG component has no scan");
  }
}

void idct_component(const Frame& f, Component* c) {
  int16_t q[64];
  ifast_table(f.quant[c->tq], q);
  const int64_t stride = static_cast<int64_t>(c->bw) * 8;
  c->plane.assign(static_cast<size_t>(stride) * c->bh * 8, 0);
  const int need_bw = (c->width + 7) / 8, need_bh = (c->height + 7) / 8;
  for (int by = 0; by < need_bh; ++by)
    for (int bx = 0; bx < need_bw; ++bx)
      idct_ifast(&c->coef[(static_cast<size_t>(by) * c->bw + bx) * 64], q,
                 &c->plane[static_cast<size_t>(by) * 8 * stride + bx * 8],
                 stride);
}

// Upsamples a component to the image size (jdsample.c): fancy (triangle)
// for 2:1 ratios where libjpeg-turbo takes it, box otherwise.
void upsample(const Frame& f, const Component& c, uint8_t* out) {
  const int W = f.width, H = f.height;
  const int hf = f.hmax / c.h, vf = f.vmax / c.v;
  const int64_t stride = static_cast<int64_t>(c.bw) * 8;
  const int cw = c.width, ch = c.height;
  auto row = [&](int y) {
    y = y < 0 ? 0 : (y >= ch ? ch - 1 : y);
    return &c.plane[static_cast<size_t>(y) * stride];
  };
  if (hf == 1 && vf == 1) {
    for (int y = 0; y < H; ++y) std::memcpy(out + static_cast<size_t>(y) * W, row(y), W);
    return;
  }
  if (f.hmax % c.h || f.vmax % c.v)
    unsupported("JPEG sampling factors that do not divide the maximum");
  std::vector<int> cs(static_cast<size_t>(cw) + 1);
  std::vector<uint8_t> line(static_cast<size_t>(cw) * 2 + 2);
  for (int y = 0; y < H; ++y) {
    const int k = y / vf;
    const uint8_t* in0 = row(k);
    uint8_t* o = line.data();
    if (hf == 2 && vf == 2 && cw > 2) {  // h2v2_fancy_upsample
      const uint8_t* in1 = row((y & 1) ? k + 1 : k - 1);
      for (int j = 0; j < cw; ++j) cs[j] = in0[j] * 3 + in1[j];
      for (int j = 0; j < cw; ++j) {
        o[2 * j] = static_cast<uint8_t>(
            j == 0 ? (cs[0] * 4 + 8) >> 4 : (cs[j] * 3 + cs[j - 1] + 8) >> 4);
        o[2 * j + 1] = static_cast<uint8_t>(
            j == cw - 1 ? (cs[j] * 4 + 7) >> 4
                        : (cs[j] * 3 + cs[j + 1] + 7) >> 4);
      }
    } else if (hf == 2 && vf == 1 && cw > 2) {  // h2v1_fancy_upsample
      for (int j = 0; j < cw; ++j) {
        o[2 * j] = static_cast<uint8_t>(
            j == 0 ? in0[0] : (in0[j] * 3 + in0[j - 1] + 1) >> 2);
        o[2 * j + 1] = static_cast<uint8_t>(
            j == cw - 1 ? in0[j] : (in0[j] * 3 + in0[j + 1] + 2) >> 2);
      }
    } else if (hf == 1 && vf == 2) {  // h1v2_fancy_upsample
      const bool below = (y & 1) != 0;
      const uint8_t* in1 = row(below ? k + 1 : k - 1);
      const int bias = below ? 2 : 1;
      for (int j = 0; j < cw; ++j)
        o[j] = static_cast<uint8_t>((in0[j] * 3 + in1[j] + bias) >> 2);
    } else {  // box: h2v1 / h2v2 at widths <= 2
      for (int j = 0; j < cw; ++j)
        for (int r = 0; r < hf; ++r) o[j * hf + r] = in0[j];
    }
    std::memcpy(out + static_cast<size_t>(y) * W, o, W);
  }
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {  // jdcolor.c build_ycc_rgb_table (SCALEBITS 16)
    const int64_t one_half = 1 << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Decodes one file into `out` (height x width x channels); channels 0
// keeps the file's count.
void decode_one(const uint8_t* src, int64_t n, int channels, uint8_t* out) {
  Frame f;
  parse(&f, src, n, true);
  check_decodable(f);
  const int nc = static_cast<int>(f.comps.size());
  const int oc = channels == 0 ? nc : channels;
  const size_t npix = static_cast<size_t>(f.width) * f.height;
  if (nc == 1 || oc == 1) {
    if (nc == 3 && f.rgb())
      unsupported("an RGB (untransformed) JPEG to 1 channel is not supported");
    Component& y = f.comps[0];
    idct_component(f, &y);
    std::vector<uint8_t> grey(npix);
    upsample(f, y, grey.data());
    for (size_t i = 0; i < npix; ++i)
      for (int k = 0; k < oc; ++k) out[i * oc + k] = grey[i];
    return;
  }
  std::vector<uint8_t> full[3];
  for (int i = 0; i < 3; ++i) {
    idct_component(f, &f.comps[static_cast<size_t>(i)]);
    full[i].resize(npix);
    upsample(f, f.comps[static_cast<size_t>(i)], full[i].data());
  }
  if (f.rgb()) {
    for (size_t i = 0; i < npix; ++i)
      for (int k = 0; k < 3; ++k) out[i * 3 + k] = full[k][i];
    return;
  }
  static const YccTables t;
  for (size_t i = 0; i < npix; ++i) {
    const int y = full[0][i], cb = full[1][i], cr = full[2][i];
    out[i * 3 + 0] = clamp255(y + t.cr_r[cr]);
    out[i * 3 + 1] = clamp255(y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
    out[i * 3 + 2] = clamp255(y + t.cb_b[cb]);
  }
}

// ---- encoding ----

const uint8_t kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// The standard Huffman tables (ITU T.81 K.3), as DHT bodies: class and
// index, 16 code-length counts, values.
const uint8_t kDcLuma[] = {0x00, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0,
                           0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChroma[] = {0x01, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0,
                             0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLuma[] = {
    0x10, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d,
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChroma[] = {
    0x11, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77,
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffEnc {
  uint32_t code[256] = {};
  uint8_t size[256] = {};
};

void build_huff_enc(HuffEnc* t, const uint8_t* body) {  // body: a DHT body
  const uint8_t* bits = body;  // bits[1..16]
  const uint8_t* vals = body + 17;
  uint32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++k) {
      t->code[vals[k]] = code++;
      t->size[vals[k]] = static_cast<uint8_t>(l);
    }
    code <<= 1;
  }
}

struct BitWriter {
  std::vector<uint8_t>* out;
  uint32_t acc = 0;
  int cnt = 0;
  void put(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) {
      acc = (acc << 1) | ((v >> i) & 1);
      if (++cnt == 8) {
        out->push_back(static_cast<uint8_t>(acc));
        if (acc == 0xFF) out->push_back(0);
        acc = 0;
        cnt = 0;
      }
    }
  }
  void flush() {  // pad with 1-bits to a whole byte
    if (cnt) put(0x7F, 8 - cnt);
  }
};

inline int bit_length(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(BitWriter* bw, const HuffEnc& dc, const HuffEnc& ac,
                  const int16_t* blk, int* last_dc) {
  int temp = blk[0] - *last_dc, temp2 = temp;
  *last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nbits = bit_length(temp);
  bw->put(dc.code[nbits], dc.size[nbits]);
  if (nbits) bw->put(static_cast<uint32_t>(temp2) & ((1u << nbits) - 1), nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = blk[kNatural[k]];
    if (temp == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw->put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nbits = bit_length(temp);
    const int sym = (r << 4) + nbits;
    bw->put(ac.code[sym], ac.size[sym]);
    bw->put(static_cast<uint32_t>(temp2) & ((1u << nbits) - 1), nbits);
    r = 0;
  }
  if (r > 0) bw->put(ac.code[0], ac.size[0]);
}

// jfdctint.c, 8-bit: CONST_BITS 13, PASS1_BITS 2, with rounding.
void fdct_islow(DCTELEM* data) {
  const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
                F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
  auto descale = [](int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; };
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8;    // element step within a line
    const int line = pass == 0 ? 8 : 1;    // step between lines
    const int odd_shift = pass == 0 ? 13 - 2 : 13 + 2;
    for (int i = 0; i < 8; ++i) {
      DCTELEM* d = data + i * line;
      const int64_t tmp0 = d[0] + d[7 * step], tmp7 = d[0] - d[7 * step];
      const int64_t tmp1 = d[step] + d[6 * step], tmp6 = d[step] - d[6 * step];
      const int64_t tmp2 = d[2 * step] + d[5 * step], tmp5 = d[2 * step] - d[5 * step];
      const int64_t tmp3 = d[3 * step] + d[4 * step], tmp4 = d[3 * step] - d[4 * step];
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        d[0] = static_cast<DCTELEM>((tmp10 + tmp11) * 4);
        d[4 * step] = static_cast<DCTELEM>((tmp10 - tmp11) * 4);
      } else {
        d[0] = static_cast<DCTELEM>(descale(tmp10 + tmp11, 2));
        d[4 * step] = static_cast<DCTELEM>(descale(tmp10 - tmp11, 2));
      }
      int64_t z1 = (tmp12 + tmp13) * F0_541;
      d[2 * step] = static_cast<DCTELEM>(descale(z1 + tmp13 * F0_765, odd_shift));
      d[6 * step] = static_cast<DCTELEM>(descale(z1 + tmp12 * -F1_847, odd_shift));
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      const int64_t z5 = (z3 + z4) * F1_175;
      const int64_t t4 = tmp4 * F0_298, t5 = tmp5 * F2_053;
      const int64_t t6 = tmp6 * F3_072, t7 = tmp7 * F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 = z3 * -F1_961 + z5;
      z4 = z4 * -F0_390 + z5;
      d[7 * step] = static_cast<DCTELEM>(descale(t4 + z1 + z3, odd_shift));
      d[5 * step] = static_cast<DCTELEM>(descale(t5 + z2 + z4, odd_shift));
      d[3 * step] = static_cast<DCTELEM>(descale(t6 + z2 + z3, odd_shift));
      d[1 * step] = static_cast<DCTELEM>(descale(t7 + z1 + z4, odd_shift));
    }
  }
}

int flss(uint16_t val) {
  int bit = 16;
  if (!val) return 0;
  if (!(val & 0xff00)) { bit -= 8; val = static_cast<uint16_t>(val << 8); }
  if (!(val & 0xf000)) { bit -= 4; val = static_cast<uint16_t>(val << 4); }
  if (!(val & 0xc000)) { bit -= 2; val = static_cast<uint16_t>(val << 2); }
  if (!(val & 0x8000)) { bit -= 1; }
  return bit;
}

// jcdctmgr.c compute_reciprocal (16-bit DCTELEM).
struct Divisor {
  uint16_t recip, corr;
  int shift;
};

Divisor reciprocal(uint16_t divisor) {
  const int b = flss(divisor) - 1;
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor;
  const uint32_t fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return Divisor{static_cast<uint16_t>(fq), static_cast<uint16_t>(c), r - 16};
}

void quantize(const DCTELEM* ws, const Divisor* div, int16_t* out) {
  for (int i = 0; i < 64; ++i) {
    DCTELEM temp = ws[i];
    const bool neg = temp < 0;
    if (neg) temp = static_cast<DCTELEM>(-temp);
    uint32_t product = static_cast<uint32_t>(static_cast<uint16_t>(temp + div[i].corr)) *
                       div[i].recip;
    product >>= div[i].shift + 16;
    temp = static_cast<DCTELEM>(product);
    out[i] = static_cast<int16_t>(neg ? -temp : temp);
  }
}

void put16(std::vector<uint8_t>* o, int v) {
  o->push_back(static_cast<uint8_t>(v >> 8));
  o->push_back(static_cast<uint8_t>(v & 0xFF));
}

void put_segment(std::vector<uint8_t>* o, int marker, const uint8_t* body,
                 size_t n) {
  o->push_back(0xFF);
  o->push_back(static_cast<uint8_t>(marker));
  put16(o, static_cast<int>(n + 2));
  o->insert(o->end(), body, body + n);
}

// Encodes height x width x channels (1 or 3) uint8 pixels at
// tf.io.encode_jpeg's quality 95, colour at 4:2:0.
std::vector<uint8_t> encode(const uint8_t* px, int H, int W, int channels) {
  const int quality = 95;
  const int scale = 200 - quality * 2;  // jpeg_quality_scaling, q >= 50
  uint16_t qt[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) {
      const uint8_t* base = t ? kStdChroma : kStdLuma;
      int64_t temp = (static_cast<int64_t>(base[i]) * scale + 50) / 100;
      if (temp <= 0) temp = 1;
      if (temp > 255) temp = 255;  // force_baseline
      qt[t][i] = static_cast<uint16_t>(temp);
    }
  const int nc = channels;
  const int hs0 = nc == 3 ? 2 : 1;
  const int hmax = hs0, vmax = hs0;
  const int mcux = (W + 8 * hmax - 1) / (8 * hmax);
  const int mcuy = (H + 8 * vmax - 1) / (8 * vmax);

  // Colour conversion (jccolor.c rgb_ycc_convert), full resolution.
  const size_t npix = static_cast<size_t>(W) * H;
  std::vector<uint8_t> full[3];
  for (int k = 0; k < nc; ++k) full[k].resize(npix);
  if (nc == 1) {
    std::memcpy(full[0].data(), px, npix);
  } else {
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536 + 0.5); };
    const int64_t one_half = 1 << 15, cbcr_off = int64_t{128} << 16;
    for (size_t i = 0; i < npix; ++i) {
      const int64_t r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
      full[0][i] = static_cast<uint8_t>(
          (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + one_half) >> 16);
      full[1][i] = static_cast<uint8_t>(
          (-fix(0.16874) * r - fix(0.33126) * g + fix(0.50000) * b + cbcr_off +
           one_half - 1) >> 16);
      full[2][i] = static_cast<uint8_t>(
          (fix(0.50000) * r - fix(0.41869) * g - fix(0.08131) * b + cbcr_off +
           one_half - 1) >> 16);
    }
  }

  struct EncComp {
    int h, v, wib, hib, bw, bh, tq;
    std::vector<int16_t> coef;  // quantized, natural order, bw x bh blocks
  };
  std::vector<EncComp> comps(static_cast<size_t>(nc));
  for (int k = 0; k < nc; ++k) {
    EncComp& c = comps[static_cast<size_t>(k)];
    c.h = c.v = k == 0 ? hs0 : 1;
    c.tq = k == 0 ? 0 : 1;
    const int cw = (W * c.h + hmax - 1) / hmax, chh = (H * c.v + vmax - 1) / vmax;
    c.wib = (cw + 7) / 8;
    c.hib = (chh + 7) / 8;
    c.bw = mcux * c.h;
    c.bh = mcuy * c.v;
    // The component's samples over its whole blocks (jcprepct.c,
    // jcsample.c): edges replicated, chroma averaged over 2x2 with the
    // alternating bias 1, 2; the last downsampled row repeats.
    const int pw = c.wib * 8, ph = c.hib * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(pw) * ph);
    const uint8_t* src = full[k].data();
    auto at = [&](int x, int y) {
      x = x < W ? x : W - 1;
      y = y < H ? y : H - 1;
      return static_cast<int>(src[static_cast<size_t>(y) * W + x]);
    };
    if (c.h == hmax && c.v == vmax) {
      for (int y = 0; y < ph; ++y)
        for (int x = 0; x < pw; ++x) plane[static_cast<size_t>(y) * pw + x] = static_cast<uint8_t>(at(x, y));
    } else {  // h2v2_downsample
      const int rows = (H + vmax - 1) / vmax;
      for (int y = 0; y < ph; ++y) {
        const int yy = y < rows ? y : rows - 1;
        int bias = 1;
        for (int x = 0; x < pw; ++x) {
          plane[static_cast<size_t>(y) * pw + x] = static_cast<uint8_t>(
              (at(2 * x, 2 * yy) + at(2 * x + 1, 2 * yy) + at(2 * x, 2 * yy + 1) +
               at(2 * x + 1, 2 * yy + 1) + bias) >> 2);
          bias ^= 3;
        }
      }
    }
    Divisor div[64];
    for (int i = 0; i < 64; ++i)
      div[i] = reciprocal(static_cast<uint16_t>(qt[c.tq][i] << 3));
    c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    for (int by = 0; by < c.hib; ++by)
      for (int bx = 0; bx < c.wib; ++bx) {
        DCTELEM ws[64];
        for (int r = 0; r < 8; ++r)
          for (int q = 0; q < 8; ++q)
            ws[r * 8 + q] = static_cast<DCTELEM>(
                plane[static_cast<size_t>(by * 8 + r) * pw + bx * 8 + q] - 128);
        fdct_islow(ws);
        quantize(ws, div, &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64]);
      }
  }

  std::vector<uint8_t> o;
  o.reserve(1024 + npix);
  o.push_back(0xFF);
  o.push_back(0xD8);
  const uint8_t jfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 1, 0x01, 0x2C, 0x01, 0x2C, 0, 0};
  put_segment(&o, 0xE0, jfif, sizeof(jfif));
  const int ntables = nc == 1 ? 1 : 2;
  for (int t = 0; t < ntables; ++t) {
    uint8_t body[65];
    body[0] = static_cast<uint8_t>(t);
    for (int k = 0; k < 64; ++k) body[1 + k] = static_cast<uint8_t>(qt[t][kNatural[k]]);
    put_segment(&o, 0xDB, body, sizeof(body));
  }
  std::vector<uint8_t> sof = {8, static_cast<uint8_t>(H >> 8), static_cast<uint8_t>(H & 0xFF),
                              static_cast<uint8_t>(W >> 8), static_cast<uint8_t>(W & 0xFF),
                              static_cast<uint8_t>(nc)};
  for (int k = 0; k < nc; ++k) {
    sof.push_back(static_cast<uint8_t>(k + 1));
    sof.push_back(static_cast<uint8_t>((comps[static_cast<size_t>(k)].h << 4) |
                                       comps[static_cast<size_t>(k)].v));
    sof.push_back(static_cast<uint8_t>(comps[static_cast<size_t>(k)].tq));
  }
  put_segment(&o, 0xC0, sof.data(), sof.size());
  put_segment(&o, 0xC4, kDcLuma, sizeof(kDcLuma));
  put_segment(&o, 0xC4, kAcLuma, sizeof(kAcLuma));
  if (nc == 3) {
    put_segment(&o, 0xC4, kDcChroma, sizeof(kDcChroma));
    put_segment(&o, 0xC4, kAcChroma, sizeof(kAcChroma));
  }
  std::vector<uint8_t> sos = {static_cast<uint8_t>(nc)};
  for (int k = 0; k < nc; ++k) {
    sos.push_back(static_cast<uint8_t>(k + 1));
    sos.push_back(k == 0 ? 0x00 : 0x11);
  }
  sos.push_back(0);
  sos.push_back(63);
  sos.push_back(0);
  put_segment(&o, 0xDA, sos.data(), sos.size());

  HuffEnc dc[2], ac[2];
  build_huff_enc(&dc[0], kDcLuma);
  build_huff_enc(&ac[0], kAcLuma);
  build_huff_enc(&dc[1], kDcChroma);
  build_huff_enc(&ac[1], kAcChroma);
  BitWriter bw{&o};
  int last_dc[3] = {0, 0, 0};
  // A single-component scan is non-interleaved: its MCU is one block.
  const int mx_n = nc == 1 ? comps[0].wib : mcux;
  const int my_n = nc == 1 ? comps[0].hib : mcuy;
  int16_t buffer[4][64];
  for (int my = 0; my < my_n; ++my)
    for (int mx = 0; mx < mx_n; ++mx)
      for (int k = 0; k < nc; ++k) {
        const EncComp& c = comps[static_cast<size_t>(k)];
        const int t = c.tq;
        int n = 0;
        for (int yy = 0; yy < c.v; ++yy)
          for (int xx = 0; xx < c.h; ++xx, ++n) {
            const int bx = mx * c.h + xx, by = my * c.v + yy;
            if (by >= c.hib) {  // a row of dummy blocks (jccoefct.c)
              std::memset(buffer[n], 0, sizeof(buffer[n]));
              buffer[n][0] = buffer[yy * c.h - 1][0];
            } else if (bx >= c.wib) {  // dummy blocks at the right edge
              std::memset(buffer[n], 0, sizeof(buffer[n]));
              buffer[n][0] = buffer[n - 1][0];
            } else {
              std::memcpy(buffer[n], &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64],
                          sizeof(buffer[n]));
            }
            encode_block(&bw, dc[t], ac[t], buffer[n], &last_dc[k]);
          }
      }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

void set_error(char* err, int64_t cap, const std::string& m) {
  if (err == nullptr || cap <= 0) return;
  const size_t n = std::min(static_cast<size_t>(cap - 1), m.size());
  std::memcpy(err, m.data(), n);
  err[n] = 0;
}

}  // namespace

extern "C" {

// Reads a JPEG's header: info = {height, width, components}. Returns 0,
// 1 for a kind of JPEG the codec refuses, 2 for a malformed file (with a
// message in `err`).
int32_t t2r_jpeg_info(const uint8_t* src, int64_t n, int64_t* info,
                      char* err, int64_t err_cap) {
  try {
    Frame f;
    parse(&f, src, n, false);
    if (!f.frame_seen) malformed("JPEG without a frame header");
    info[0] = f.height;
    info[1] = f.width;
    info[2] = static_cast<int64_t>(f.comps.size());
    return 0;
  } catch (const JpegError& e) {
    set_error(err, err_cap, e.message);
    return e.kind;
  }
}

// Decodes `n` JPEG files: file i is src[src_off[i], src_off[i] + len[i])
// and its height x width x channels[i] pixels land at dst + dst_off[i]
// (the caller sized them from t2r_jpeg_info; channels 0 keeps the
// file's). Frames are split into contiguous runs over up to 8 threads
// (one per core, at least 8 frames a thread); each frame's pixels are the
// same whatever the split.
// Returns 0, or -(1 + i) for the first file i that fails, with its kind
// (1 refused, 2 malformed) in *kind and the message in `err`.
int64_t t2r_jpeg_decode_many(const uint8_t* src, const int64_t* src_off,
                             const int64_t* len, uint8_t* dst,
                             const int64_t* dst_off, const int64_t* channels,
                             int64_t n, int32_t* kind, char* err,
                             int64_t err_cap) {
  const int64_t cores = std::min(8u, std::max(1u, std::thread::hardware_concurrency()));
  const int64_t threads = std::max<int64_t>(1, std::min<int64_t>(cores, n / 8));
  std::vector<int64_t> failed(static_cast<size_t>(threads), -1);
  std::vector<JpegError> errors(static_cast<size_t>(threads));
  auto run = [&](int64_t t) {
    const int64_t lo = n * t / threads, hi = n * (t + 1) / threads;
    for (int64_t i = lo; i < hi; ++i) {
      try {
        decode_one(src + src_off[i], len[i], static_cast<int>(channels[i]),
                   dst + dst_off[i]);
      } catch (const JpegError& e) {
        failed[static_cast<size_t>(t)] = i;
        errors[static_cast<size_t>(t)] = e;
        return;
      }
    }
  };
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < threads; ++t) pool.emplace_back(run, t);
  run(0);
  for (std::thread& th : pool) th.join();
  for (int64_t t = 0; t < threads; ++t) {  // runs are in frame order
    if (failed[static_cast<size_t>(t)] >= 0) {
      *kind = errors[static_cast<size_t>(t)].kind;
      set_error(err, err_cap, errors[static_cast<size_t>(t)].message);
      return -(1 + failed[static_cast<size_t>(t)]);
    }
  }
  return 0;
}

// Encodes height x width x channels (1 or 3) pixels as tf.io.encode_jpeg
// does with its defaults (quality 95, 4:2:0). Writes at most `cap` bytes
// to `out`; returns the encoded size (which may exceed `cap`: then call
// again with room for it).
int64_t t2r_jpeg_encode(const uint8_t* px, int64_t height, int64_t width,
                        int64_t channels, uint8_t* out, int64_t cap) {
  const std::vector<uint8_t> o =
      encode(px, static_cast<int>(height), static_cast<int>(width),
             static_cast<int>(channels));
  const int64_t size = static_cast<int64_t>(o.size());
  if (size <= cap) std::memcpy(out, o.data(), o.size());
  return size;
}

}  // extern "C"
