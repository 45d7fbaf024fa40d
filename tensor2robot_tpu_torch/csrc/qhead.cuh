// The QT-Opt q-head MLP on Hopper tensor cores, shared by the two CEM
// kernels (cem_select.cu over a population's pooled features, cem_head.cu
// over each member's pooled conv output): one warpgroup scores a 64-row
// bf16 tile of features in shared memory.
//
// Numerics, as the TPU kernels' `_mlp_f32`: every product is bf16 × bf16
// summed in f32; the hidden layers add the f32 bias, apply relu and round
// to bf16; the last layer (width 1) sums in f32 and adds its f32 bias.
//
// Design. Layer 0 is `wgmma` m64n64k16 with A (the features, a K-major
// `hopper::Tile<K0>`) and B (the weights) from shared memory. Its f32
// accumulators get bias, relu and the bf16 rounding in registers, and the
// rounded pairs are the register A operand of the next layer's `wgmma`
// (the layout rule at the head of hopper.cuh), so hidden activations never
// touch shared memory. The width-1 layer is a dot product on the last
// hidden layer's registers, summed over the row's quad of lanes by
// shuffles. Hidden widths are padded to a multiple of 64 with zero weights
// and biases (their relu is 0 and adds nothing downstream), so every
// product is an n64 slice.
//
// Weights live in shared memory MN-major ([K, N], N contiguous, as they are
// stored): boxes of 64 columns (128-B rows, 128-B swizzle) of K rows each,
// the layout wgmma's transposed-B descriptor reads; staged by 16-byte
// cp.async, all in flight at once (they are the same for every CTA, so
// they come from L2).

#pragma once

#include "hopper.cuh"

namespace qhead {

constexpr int kMaxLayers = 8;

__host__ __device__ inline int pad64(int n) { return (n + 63) / 64 * 64; }

struct Params {
  int n_layers;               // dense layers, the last of width 1
  int dims[kMaxLayers + 1];   // dims[0] = K0, dims[n_layers] = 1
  const __nv_bfloat16* w[kMaxLayers];
  const __nv_bfloat16* b[kMaxLayers];
  uint32_t w_off[kMaxLayers];  // hidden layer l's weight tile (bytes)
  uint32_t b_off[kMaxLayers];  // its f32 bias; [n_layers-1]: f32 w_last
                               // (pad64 entries), then the f32 last bias
};

// Rows of layer l's weight tile: K0 for layer 0, else the padded width.
__host__ __device__ inline int k_rows(const Params& p, int l) {
  return l == 0 ? p.dims[0] : pad64(p.dims[l]);
}

__host__ __device__ inline size_t align_to(size_t n, size_t a) {
  return (n + a - 1) / a * a;
}

// Fills p's shared-memory offsets from byte `off` (of a 1024-B aligned
// base); returns the end.
__host__ __device__ inline size_t layout(Params* p, size_t off) {
  const int n = p->n_layers;
  for (int l = 0; l < n - 1; ++l) {
    off = align_to(off, 1024);
    p->w_off[l] = uint32_t(off);
    off += size_t(k_rows(*p, l)) * pad64(p->dims[l + 1]) * 2;
  }
  for (int l = 0; l < n - 1; ++l) {
    p->b_off[l] = uint32_t(off);
    off += size_t(pad64(p->dims[l + 1])) * 4;
  }
  p->b_off[n - 1] = uint32_t(off);
  return align_to(off + (size_t(pad64(p->dims[n - 1])) + 4) * 4, 16);
}

// Byte offset of weight (k, n) in a K-row MN-major tile.
__device__ __forceinline__ uint32_t mn_offset(int k_rows, int k, int n) {
  const uint32_t o = (n / 64) * k_rows * 128 + k * 128 + (n % 64) * 2;
  return o ^ (((o >> 7) & 7) << 4);
}

// Descriptor of such a tile as wgmma's MN-major B at k16 step kk.
__device__ __forceinline__ uint64_t mn_desc(uint32_t base, int k_rows,
                                            int kk) {
  return hopper::make_desc(base + kk * 16 * 128, k_rows * 128, 1024, 1);
}

// The bf16 source of entry i of the f32 run of biases and last column
// (see `layout`), or null for padding and past the end.
__device__ inline const __nv_bfloat16* bias_source(const Params& p, int i) {
  const int n = p.n_layers;
  for (int l = 0; l < n - 1; ++l) {
    const int N = p.dims[l + 1];
    if (i < pad64(N)) return i < N ? p.b[l] + i : nullptr;
    i -= pad64(N);
  }
  const int K = p.dims[n - 1];
  if (i < pad64(K)) return i < K ? p.w[n - 1] + i : nullptr;
  return i == pad64(K) ? p.b[n - 1] : nullptr;
}

// Stages every weight and bias into shared memory (threads tid of n):
// the weights by 16-byte cp.async, all in flight at once and committed
// as one group, the zero padding and the f32 biases by plain stores. The
// caller then waits for the group (hopper::cp_async_wait), runs
// hopper::fence_proxy_async() and a barrier.
__device__ inline void stage(const Params& p, uint8_t* smem, int tid,
                             int nthreads) {
  const int n = p.n_layers;
  const uint32_t base = hopper::smem_addr(smem);
  for (int l = 0; l < n - 1; ++l) {
    const int K = p.dims[l], N = p.dims[l + 1];
    const int rows = k_rows(p, l), chunks = pad64(N) / 8;
    for (int i = tid; i < rows * chunks; i += nthreads) {
      const int k = i / chunks, c = (i - k * chunks) * 8;
      const uint32_t dst = p.w_off[l] + mn_offset(rows, k, c);
      if (k < K && c < N) {
        hopper::cp_async16(base + dst, p.w[l] + size_t(k) * N + c);
      } else {
        *reinterpret_cast<uint4*>(smem + dst) = make_uint4(0, 0, 0, 0);
      }
    }
  }
  hopper::cp_async_commit();
  // The f32 biases and last column lie end to end from b_off[0]: entry i
  // of that run, four per thread at a time, every load issued before any
  // value is stored (one round trip to L2, not one per layer).
  int total = pad64(p.dims[n - 1]) + 1;  // the last column and its bias
  for (int l = 0; l < n - 1; ++l) total += pad64(p.dims[l + 1]);
  for (int i0 = tid; i0 < total; i0 += 4 * nthreads) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const __nv_bfloat16* src = bias_source(p, i0 + u * nthreads);
      v[u] = src ? __bfloat162float(*src) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * nthreads;
      if (i < total) reinterpret_cast<float*>(smem + p.b_off[0])[i] = v[u];
    }
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Scores of a 64-row bf16 feature tile (`a_tile`, a K-major Tile<K0> at
// shared address a_tile) by one warpgroup (threads 0 .. 127 of the
// caller's numbering, `tid`): returns the scores of rows r0 = 16·warp +
// lane/4 and r0 + 8, in every lane of the row's quad. kH is the largest
// padded hidden width (64 or 256); smem / smem_s are the weights' base as
// a pointer and as a shared address.
template <int K0, int kH>
__device__ inline float2 rows(const Params& p, const uint8_t* smem,
                              uint32_t smem_s, uint32_t a_tile, int tid) {
  using hopper::pin;
  constexpr int kChunks = kH / 64, kSteps = kH / 16;
  const int t = tid % 4;
  uint32_t a[kSteps][4], an[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = 0u;
  float part[2] = {0.f, 0.f};
  const int nl = p.n_layers;
  const float* w_last = reinterpret_cast<const float*>(smem + p.b_off[nl - 1]);
  for (int l = 0; l < nl - 1; ++l) {
    const int npad = pad64(p.dims[l + 1]);
    const int krows = k_rows(p, l);
    const int ksteps = krows / 16;
    const uint32_t w_s = smem_s + p.w_off[l];
    const float* bias = reinterpret_cast<const float*>(smem + p.b_off[l]);
    const bool last_hidden = l == nl - 2;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c * 64 >= npad) break;
      const uint32_t wc = w_s + c * krows * 128;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      pin(acc);
      pin(a);
      hopper::wgmma_fence();
      if (l == 0) {
#pragma unroll
        for (int kk = 0; kk < K0 / 16; ++kk)
          hopper::wgmma_ss_n64_mn(acc, hopper::Tile<K0>::k_major(a_tile, kk),
                                  mn_desc(wc, krows, kk), 1);
      } else {
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          if (kk < ksteps)
            hopper::wgmma_rs_n64(acc, a[kk], mn_desc(wc, krows, kk), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      pin(acc);
      pin(a);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = c * 64 + 8 * (i / 4) + 2 * t;
        const float h0 = round_bf16(fmaxf(acc[i] + bias[col], 0.f));
        const float h1 = round_bf16(fmaxf(acc[i + 1] + bias[col + 1], 0.f));
        if (last_hidden) {
          part[(i / 2) % 2] += h0 * w_last[col] + h1 * w_last[col + 1];
        } else {
          hopper::a_reg(an, 32 * c + i) = hopper::pack_bf16(h0, h1);
        }
      }
    }
    if (!last_hidden) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[kk][e] = an[kk][e];
    }
  }
  const float b_last = w_last[pad64(p.dims[nl - 1])];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    part[r] += __shfl_xor_sync(0xffffffffu, part[r], 1);
    part[r] += __shfl_xor_sync(0xffffffffu, part[r], 2);
  }
  return make_float2(part[0] + b_last, part[1] + b_last);
}

}  // namespace qhead
