// Host codec for the data plane: CRC-32C for the TFRecord framing and
// PNG row unfiltering for image decode.
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
//
// Exposed as a tiny C ABI consumed through ctypes;
// `tensor2robot_tpu_torch.utils.native` compiles it with g++ on first
// use, beside the row gather.

#include <cstdint>
#include <cstdlib>
#include <cstring>

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
