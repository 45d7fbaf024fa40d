// Fused CEM population-head tail for Hopper (sm_90a): everything after
// the QT-Opt Q-network's merge GEMM, for a whole CEM population, with
// only the [B, P] Q values written back.
//
// Replaces the Pallas TPU kernel `_cem_head_kernel` of
// tensor2robot_tpu/ops/cem_head.py (`fused_cem_head_tail`). Same
// contract as that kernel and as its plain version
// `fused_cem_head_tail_reference` in tensor2robot_tpu_torch/ops/cem_head.py:
//
//   act        [B, P, h1, w1, C1]  compute dtype T (bf16 or f32), any strides
//   enc0       [B, h1, w1, C1]     T, contiguous
//   taps       [3, 3, C1, C2]      T, contiguous (HWIO)
//   bn_scale, bn_shift [C2]        f32
//   dense      ((W0 [C2, H0], b0 [H0]), ..., (Wn [Hn-1, 1], bn [1])) in T
//   → q [B, P] f32
//
// Numerics, in the TPU kernel's order: x = relu(f32(act) + f32(enc0)),
// rounded to T; a 3×3 stride-2 SAME conv (XLA pads an even input by 0
// low and 1 high, so output (i, j) reads input (2i + di, 2j + dj), zero
// past the edge) with exact products of T values summed in f32; the
// eval-BN affine on the f32 accumulator (a multiply, then an add, each
// rounded); relu; the f32 spatial mean (sum / count), rounded to T; the
// dense head with f32 sums, + the f32 bias, relu and rounding to T
// between layers.
//
// Bound: at the Bellman shape (B=256, P=64, 8×8×64 → 64, bf16) the
// kernel must read the 134 MB population activation once (~40 µs at
// 3.35 TB/s) and do 19.3 GFLOP of conv (~20 µs on bf16 tensor cores), so
// bytes bound it: 0.0407 ms. PR 4's kernel took 0.548 ms there, 13.5×
// its bound: staging through five strides with plain 16-byte loads, the
// conv on `mma.sync` (Hopper's older tensor-core path), and a dense head
// per member out of shared memory.
//
// Three paths, chosen by ops/cem_head.py's `launch_plan`:
//  - wgmma (bf16, h1·w1 = 64, C1 and C2 in {32, 64}: the Q-network's
//    shape). One CTA per (run of ≤ 64 members, state b); runs are sized
//    so the batch gives about one CTA per SM (the taps leave room for
//    one). Two warpgroups take alternate groups of 4 members, so 8 warps
//    hide each other's gather and product latency. Members arrive by TMA
//    through a rank-5 map over act's own strides (the Q-network's
//    transposed P-major view as it is), four to a stage, two stages per
//    warpgroup behind mbarriers, so a warpgroup's next group lands while
//    it computes this one. The taps [9·C1, C2] and enc0 come once per
//    CTA, by TMA; the q-head's weights are staged over them at the end.
//    The conv is an implicit GEMM, M = 64 (4 members × 16 positions),
//    N = C2, K = 9·C1 (36 k16 steps at 64 → 64), on wgmma with A from
//    registers: ldmatrix gathers each stride-2 tap's rows (the high-side
//    padding a zero row) from the member's tile and from enc0's, and
//    relu(act + enc0) rounded to bf16 is made in registers. The BN
//    affine and relu run on the accumulators; warp w holds member w, so
//    its 16-position mean is an in-warp shuffle sum in a fixed order.
//    The run's pooled rows go to a [64, C2] tile and the dense head runs
//    once over it (first warpgroup) with qhead.cuh's wgmma routine
//    (shared with cem_select.cu).
//  - mma.sync (other bf16 whose taps fit whole): PR 4's kernel. Chunks
//    of `rows` members are staged with the enc0 add, relu and rounding on
//    the way in (16-byte loads where the layout allows, act read through
//    its five strides); the conv is an implicit GEMM on `mma.sync`
//    m16n8k16, each warp a 16-position × 32-channel tile; a dense head
//    per member from shared memory.
//  - CUDA cores (f32, and bf16 convs too wide to stage whole: C1 = C2 =
//    128): the same chunks staged as f32, the taps per channel chunk,
//    each thread 4 positions × 4 channels in f32.
// No path uses atomics; a member's positions are summed in a fixed
// order, so a rerun gives the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "qhead.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 8;
constexpr int kMaxSmem = 232448;  // 227 KB per block on sm_90
constexpr int kTM = 4;            // CUDA cores: output positions per item
constexpr int kTN = 4;            // CUDA cores: output channels per item
constexpr int kCtasPerSm = 2;     // grid target: CTAs per SM, over B
constexpr int kStage = 4;         // loads in flight per thread when staging

struct DenseParams {
  int n_layers;
  int dims[kMaxLayers + 1];  // dims[0] = C2, dims[n_layers] = 1
  const void* w[kMaxLayers];
  const void* b[kMaxLayers];
};

struct Shape {
  int B, P, H1, W1, C1, C2;
  long long act_stride[5];  // elements, for (b, p, i, j, c)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}
// Component i of a float4; i is a constant after unrolling.
__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// One 16-byte vector of T: 8 bf16 or 4 f32 values.
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};
template <> struct Vec<float> {
  static constexpr int n = 4;
};

// ---- shared-memory layouts (the host computes the same totals) ----

// Common tail of both layouts: per-member spatial sums and the dense
// head's two activation buffers.
struct Tail {
  size_t pool_off, h0_off, h1_off;
};

__host__ __device__ inline size_t tail_layout(size_t off, int rows, int C2,
                                              int max_width, Tail* t) {
  const size_t f = sizeof(float);
  t->pool_off = off;
  off = align16(off + size_t(rows) * C2 * f);
  t->h0_off = off;
  off = align16(off + size_t(rows) * max_width * f);
  t->h1_off = off;
  return align16(off + size_t(rows) * max_width * f);
}

// CUDA-core path: members and a channel chunk of taps staged as f32.
struct CoreLayout {
  size_t x_off, zero_off, w_off, part_off, total;
  Tail tail;
  int c1p;     // C1 rounded up to 4 (zero channels past C1)
  int xrow;    // floats per staged pixel: c1p + 4, so pixels shift banks
  int ncp;     // channel chunk rounded up to kTN
  int groups;  // position groups of kTM per population member
};

__host__ __device__ inline CoreLayout core_layout(const Shape& s,
                                                  int max_width, int rows,
                                                  int nc) {
  CoreLayout L;
  const int npos = (s.H1 / 2) * (s.W1 / 2);
  L.groups = (npos + kTM - 1) / kTM;
  L.c1p = round_up(s.C1, 4);
  L.xrow = L.c1p + 4;
  L.ncp = round_up(nc, kTN);
  const size_t f = sizeof(float);
  size_t off = 0;
  L.x_off = off;
  off = align16(off + size_t(rows) * s.H1 * s.W1 * L.xrow * f);
  L.zero_off = off;
  off = align16(off + size_t(L.c1p) * f);
  L.w_off = off;
  off = align16(off + size_t(9) * L.c1p * L.ncp * f);
  L.part_off = off;
  off = align16(off + size_t(rows) * L.groups * L.ncp * f);
  L.total = tail_layout(off, rows, s.C2, max_width, &L.tail);
  return L;
}

// Tensor-core path: members staged as bf16 [pixel][c1p + 8], all taps as
// bf16 [tap][c2p][c1p + 8] (8 elements of padding move neighbouring rows
// to other banks), and the conv's f32 outputs [Mp][c2p].
struct MmaLayout {
  size_t x_off, zero_off, w_off, y_off, total;
  Tail tail;
  int c1p;  // C1 rounded up to 16 (one mma's depth)
  int c2p;  // C2 rounded up to 8 (one mma's width)
  int row;  // bf16 elements per staged pixel and per tap row: c1p + 8
  int mp;   // the chunk's output positions rounded up to 16
};

__host__ __device__ inline MmaLayout mma_layout(const Shape& s,
                                                int max_width, int rows) {
  MmaLayout L;
  const int npos = (s.H1 / 2) * (s.W1 / 2);
  L.c1p = round_up(s.C1, 16);
  L.c2p = round_up(s.C2, 8);
  L.row = L.c1p + 8;
  L.mp = round_up(rows * npos, 16);
  const size_t h = 2;  // sizeof(bf16)
  size_t off = 0;
  L.x_off = off;
  off = align16(off + size_t(rows) * s.H1 * s.W1 * L.row * h);
  L.zero_off = off;
  off = align16(off + size_t(L.row) * h);
  L.w_off = off;
  off = align16(off + size_t(9) * L.c2p * L.row * h);
  L.y_off = off;
  off = align16(off + size_t(L.mp) * L.c2p * sizeof(float));
  L.total = tail_layout(off, rows, s.C2, max_width, &L.tail);
  return L;
}

// ---- device pieces shared by both paths ----

template <typename S> __device__ __forceinline__ S store_as(float x);
template <> __device__ __forceinline__ float store_as<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
store_as<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // x is already a bf16 value: exact
}

// Stages members p0 .. p0 + rows - 1 of state b as S [rows·h1·w1][xrow]:
// relu(f32(act) + f32(enc0)) rounded to T, zero for members past P and
// for the channels C1 .. c1p - 1.
template <typename T, typename S>
__device__ void stage_members(const T* __restrict__ act_b,
                              const T* __restrict__ enc_b,
                              const long long* st, S* xs, int xrow,
                              int c1p, int rows, int p0, const Shape& s,
                              int vec) {
  const int tid = threadIdx.x;
  const int W1 = s.W1, C1 = s.C1, HW = s.H1 * s.W1;
  if (vec) {
    // kStage vectors per thread per pass, all loads issued before any
    // is used, so several device-memory round trips overlap.
    constexpr int V = Vec<T>::n;
    const int per_pix = C1 / V;
    const int total = rows * HW * per_pix;
    for (int base = tid; base < total; base += kThreads * kStage) {
      uint4 av[kStage], ev[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = base + u * kThreads;
        const int rp = i / per_pix, c = (i - rp * per_pix) * V;
        const int r = rp / HW, pix = rp - r * HW;
        const int ii = pix / W1, jj = pix - ii * W1;
        av[u] = ev[u] = make_uint4(0, 0, 0, 0);
        if (i < total && p0 + r < s.P) {
          av[u] = *reinterpret_cast<const uint4*>(
              act_b + (p0 + r) * st[1] + ii * st[2] + jj * st[3] + c);
          ev[u] = *reinterpret_cast<const uint4*>(enc_b + size_t(pix) * C1 +
                                                  c);
        }
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = base + u * kThreads;
        if (i >= total) break;
        const int rp = i / per_pix, c = (i - rp * per_pix) * V;
        const bool live = p0 + rp / HW < s.P;
        const T* a = reinterpret_cast<const T*>(&av[u]);
        const T* e = reinterpret_cast<const T*>(&ev[u]);
        S* dst = xs + size_t(rp) * xrow + c;
#pragma unroll
        for (int v = 0; v < V; ++v)
          dst[v] = store_as<S>(
              live ? round_to<T>(fmaxf(to_f32(a[v]) + to_f32(e[v]), 0.f))
                   : 0.f);
      }
    }
    for (int i = tid; i < rows * HW * (c1p - C1); i += kThreads) {
      const int rp = i / (c1p - C1), c = C1 + i - rp * (c1p - C1);
      xs[size_t(rp) * xrow + c] = store_as<S>(0.f);
    }
  } else {
    for (int i = tid; i < rows * HW * c1p; i += kThreads) {
      const int rp = i / c1p, c = i - rp * c1p;
      const int r = rp / HW, pix = rp - r * HW;
      const int ii = pix / W1, jj = pix - ii * W1;
      float v = 0.f;
      if (p0 + r < s.P && c < C1) {
        const float a = to_f32(act_b[(p0 + r) * st[1] + ii * st[2] +
                                     jj * st[3] + c * st[4]]);
        v = round_to<T>(fmaxf(a + to_f32(enc_b[size_t(pix) * C1 + c]), 0.f));
      }
      xs[size_t(rp) * xrow + c] = store_as<S>(v);
    }
  }
}

// Member r's spatial sums pool[r·C2 + n] → mean, rounded to T → the
// dense head → q[b, p0 + r]. Starts and ends with a barrier.
template <typename T>
__device__ void dense_head(const DenseParams& dp, const float* pool,
                           float* h0, float* h1, float* __restrict__ q,
                           const Shape& s, int b, int rows, int p0,
                           int max_width) {
  const int tid = threadIdx.x, C2 = s.C2;
  const float npos = float((s.H1 / 2) * (s.W1 / 2));
  __syncthreads();
  float* h = h0;
  for (int i = tid; i < rows * C2; i += kThreads) {
    const int r = i / C2, c = i - r * C2;
    h[r * max_width + c] = round_to<T>(pool[i] / npos);
  }
  for (int l = 0; l < dp.n_layers; ++l) {
    __syncthreads();
    const int K = dp.dims[l], N = dp.dims[l + 1];
    const T* w = static_cast<const T*>(dp.w[l]);
    const T* bias = static_cast<const T*>(dp.b[l]);
    float* out = (l & 1) ? h0 : h1;
    for (int i = tid; i < rows * N; i += kThreads) {
      const int r = i / N, j = i - r * N;
      const float* hr = h + r * max_width;
      float acc = 0.f;
      for (int k = 0; k < K; ++k) acc = fmaf(hr[k], to_f32(w[k * N + j]), acc);
      acc += to_f32(bias[j]);
      if (l < dp.n_layers - 1) acc = round_to<T>(fmaxf(acc, 0.f));
      out[r * max_width + j] = acc;
    }
    h = out;
  }
  __syncthreads();
  for (int r = tid; r < rows; r += kThreads) {
    const int p = p0 + r;
    if (p < s.P) q[size_t(b) * s.P + p] = h[r * max_width];
  }
}

// The BN affine on one f32 accumulator, then relu.
__device__ __forceinline__ float bn_relu(float acc, float sc, float sh) {
  return fmaxf(__fadd_rn(__fmul_rn(acc, sc), sh), 0.f);
}

// ---- the tensor-core path (bf16) ----

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a · b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 2)
cem_head_mma_kernel(const __nv_bfloat16* __restrict__ act,
                    const __nv_bfloat16* __restrict__ enc0,
                    const __nv_bfloat16* __restrict__ taps,
                    const float* __restrict__ bn_scale,
                    const float* __restrict__ bn_shift, DenseParams dp,
                    float* __restrict__ q, Shape s, int rows, int max_width,
                    int vec) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaLayout L = mma_layout(s, max_width, rows);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int b = blockIdx.y;
  const int H1 = s.H1, W1 = s.W1, C1 = s.C1, C2 = s.C2, HW = H1 * W1;
  const int w2 = W1 / 2, npos = (H1 / 2) * w2;
  const int c1p = L.c1p, c2p = L.c2p, xrow = L.row;
  T* xs = reinterpret_cast<T*>(smem + L.x_off);
  T* zero = reinterpret_cast<T*>(smem + L.zero_off);
  T* ws = reinterpret_cast<T*>(smem + L.w_off);
  float* ys = reinterpret_cast<float*>(smem + L.y_off);
  float* pool = reinterpret_cast<float*>(smem + L.tail.pool_off);
  float* h0 = reinterpret_cast<float*>(smem + L.tail.h0_off);
  float* h1 = reinterpret_cast<float*>(smem + L.tail.h1_off);
  const T* act_b = act + b * s.act_stride[0];
  const T* enc_b = enc0 + size_t(b) * HW * C1;

  // The taps once per CTA as [tap][n][k] (k contiguous: an mma's B
  // fragment is two 32-bit loads), zero past C1 and C2; kStage loads in
  // flight per thread, consecutive threads on consecutive n.
  for (int c = tid; c < c1p; c += kThreads) zero[c] = __float2bfloat16_rn(0.f);
  const int wtotal = 9 * c1p * c2p;
  for (int base = tid; base < wtotal; base += kThreads * kStage) {
    T v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = base + u * kThreads;
      const int row = i / c2p, n = i - row * c2p;  // row = tap·c1p + k
      const int tap = row / c1p, k = row - tap * c1p;
      v[u] = (i < wtotal && k < C1 && n < C2)
                 ? taps[(size_t(tap) * C1 + k) * C2 + n]
                 : __float2bfloat16_rn(0.f);
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = base + u * kThreads;
      if (i >= wtotal) break;
      const int row = i / c2p, n = i - row * c2p;
      const int tap = row / c1p, k = row - tap * c1p;
      ws[(size_t(tap) * c2p + n) * xrow + k] = v[u];
    }
  }

  const int m_live = rows * npos;
  const int n_quads = (c2p + 31) / 32;  // 4 n8 tiles per warp unit
  const int units = (L.mp / 16) * n_quads;
  const int chunks = (s.P + rows - 1) / rows;
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const int p0 = chunk * rows;
    // The previous chunk's readers of xs and ys are done.
    __syncthreads();
    stage_members<T, T>(act_b, enc_b, s.act_stride, xs, xrow, c1p, rows, p0,
                        s, vec);
    __syncthreads();
    // The conv as 16-position × 32-channel warp tiles, then BN + relu
    // into ys [position][channel].
    for (int unit = warp; unit < units; unit += kWarps) {
      const int mt = unit / n_quads, nq = unit - mt * n_quads;
      int mrow[2], r_of[2], oi[2], oj[2];
      bool live[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mrow[h] = mt * 16 + g + 8 * h;
        live[h] = mrow[h] < m_live;
        r_of[h] = mrow[h] / npos;
        const int pos = mrow[h] - r_of[h] * npos;
        oi[h] = pos / w2;
        oj[h] = pos - oi[h] * w2;
      }
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int tap = 0; tap < 9; ++tap) {
        const int di = tap / 3, dj = tap - di * 3;
        const T* xp[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ii = 2 * oi[h] + di, jj = 2 * oj[h] + dj;
          xp[h] = (live[h] && ii < H1 && jj < W1)
                      ? xs + (size_t(r_of[h]) * HW + ii * W1 + jj) * xrow
                      : zero;
        }
        const T* wt = ws + size_t(tap) * c2p * xrow;
        for (int k0 = 0; k0 < c1p; k0 += 16) {
          const uint32_t a[4] = {ld32(xp[0] + k0 + 2 * t),
                                 ld32(xp[1] + k0 + 2 * t),
                                 ld32(xp[0] + k0 + 8 + 2 * t),
                                 ld32(xp[1] + k0 + 8 + 2 * t)};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n8 = nq * 4 + j;
            if (n8 * 8 >= c2p) break;
            const T* wp = wt + size_t(n8 * 8 + g) * xrow + k0 + 2 * t;
            mma_bf16(acc[j], a, ld32(wp), ld32(wp + 8));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n8 = nq * 4 + j;
        if (n8 * 8 >= c2p) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, n = n8 * 8 + 2 * t + (e & 1);
          if (live[h] && n < C2)
            ys[size_t(mrow[h]) * c2p + n] =
                bn_relu(acc[j][e], bn_scale[n], bn_shift[n]);
        }
      }
    }
    __syncthreads();
    // Each member's spatial sum, its positions added in order.
    for (int i = tid; i < rows * C2; i += kThreads) {
      const int r = i / C2, n = i - r * C2;
      const float* y = ys + size_t(r) * npos * c2p + n;
      float sum = 0.f;
      for (int pos = 0; pos < npos; ++pos) sum += y[size_t(pos) * c2p];
      pool[i] = sum;
    }
    dense_head<T>(dp, pool, h0, h1, q, s, b, rows, p0, max_width);
  }
}

// ---- the CUDA-core path (f32, and bf16 convs too wide for the other) ----

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
cem_head_core_kernel(const T* __restrict__ act, const T* __restrict__ enc0,
                     const T* __restrict__ taps,
                     const float* __restrict__ bn_scale,
                     const float* __restrict__ bn_shift, DenseParams dp,
                     float* __restrict__ q, Shape s, int rows, int nc,
                     int max_width, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const CoreLayout L = core_layout(s, max_width, rows, nc);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int H1 = s.H1, W1 = s.W1, C1 = s.C1, C2 = s.C2;
  const int HW = H1 * W1;
  const int w2 = W1 / 2, npos = (H1 / 2) * w2;
  const int c1p = L.c1p, xrow = L.xrow, ncp = L.ncp;
  float* xs = reinterpret_cast<float*>(smem + L.x_off);
  float* zero = reinterpret_cast<float*>(smem + L.zero_off);
  float* ws = reinterpret_cast<float*>(smem + L.w_off);
  float* part = reinterpret_cast<float*>(smem + L.part_off);
  float* pool = reinterpret_cast<float*>(smem + L.tail.pool_off);
  float* h0 = reinterpret_cast<float*>(smem + L.tail.h0_off);
  float* h1 = reinterpret_cast<float*>(smem + L.tail.h1_off);
  const T* act_b = act + b * s.act_stride[0];
  const T* enc_b = enc0 + size_t(b) * HW * C1;

  for (int c = tid; c < c1p; c += kThreads) zero[c] = 0.f;
  const int nblk = ncp / kTN;
  const int items = rows * L.groups * nblk;
  const int chunks = (s.P + rows - 1) / rows;
  int staged_n0 = -1;

  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const int p0 = chunk * rows;
    // The previous chunk's readers of xs and part are done.
    __syncthreads();
    stage_members<T, float>(act_b, enc_b, s.act_stride, xs, xrow, c1p, rows,
                            p0, s, vec);
    for (int n0 = 0; n0 < C2; n0 += nc) {
      const int ncur = min(nc, C2 - n0);
      // The taps of this channel chunk as f32 [9][c1p][ncp], zero past
      // C1 and past the chunk; staged once when one chunk holds every
      // channel. No thread reads ws between a chunk's conv and here, so
      // the writes race with nothing.
      if (n0 != staged_n0) {
        const int wtotal = 9 * c1p * ncp;
        for (int base = tid; base < wtotal; base += kThreads * kStage) {
          float v[kStage];
#pragma unroll
          for (int u = 0; u < kStage; ++u) {
            const int i = base + u * kThreads;
            const int row = i / ncp, n = i - row * ncp;  // tap·c1p + k
            const int tap = row / c1p, k = row - tap * c1p;
            v[u] = (i < wtotal && k < C1 && n < ncur)
                       ? to_f32(taps[(size_t(tap) * C1 + k) * C2 + n0 + n])
                       : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kStage; ++u) {
            const int i = base + u * kThreads;
            if (i < wtotal) ws[i] = v[u];
          }
        }
        staged_n0 = n0;
      }
      __syncthreads();
      // Conv + BN affine + relu + a partial sum over kTM positions.
      for (int it = tid; it < items; it += kThreads) {
        const int nb = it % nblk;
        const int rg = it / nblk;
        const int g = rg % L.groups, r = rg / L.groups;
        const float* rowx = xs + size_t(r) * HW * xrow;
        int oi[kTM], oj[kTM];
        bool live[kTM];
#pragma unroll
        for (int m = 0; m < kTM; ++m) {
          const int pos = g * kTM + m;
          live[m] = pos < npos;
          oi[m] = pos / w2;
          oj[m] = pos - oi[m] * w2;
        }
        float acc[kTM][kTN];
#pragma unroll
        for (int m = 0; m < kTM; ++m)
#pragma unroll
          for (int n = 0; n < kTN; ++n) acc[m][n] = 0.f;
        for (int tap = 0; tap < 9; ++tap) {
          const int di = tap / 3, dj = tap - di * 3;
          const float* xp[kTM];
#pragma unroll
          for (int m = 0; m < kTM; ++m) {
            const int ii = 2 * oi[m] + di, jj = 2 * oj[m] + dj;
            xp[m] = (live[m] && ii < H1 && jj < W1)
                        ? rowx + size_t(ii * W1 + jj) * xrow
                        : zero;
          }
          const float* wp = ws + size_t(tap) * c1p * ncp + nb * kTN;
#pragma unroll 2
          for (int k = 0; k < c1p; k += 4) {
            float4 xv[kTM];
#pragma unroll
            for (int m = 0; m < kTM; ++m)
              xv[m] = *reinterpret_cast<const float4*>(xp[m] + k);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float4 w4 = *reinterpret_cast<const float4*>(
                  wp + size_t(k + kk) * ncp);
#pragma unroll
              for (int m = 0; m < kTM; ++m) {
                const float xk = lane_of(xv[m], kk);
                acc[m][0] = fmaf(xk, w4.x, acc[m][0]);
                acc[m][1] = fmaf(xk, w4.y, acc[m][1]);
                acc[m][2] = fmaf(xk, w4.z, acc[m][2]);
                acc[m][3] = fmaf(xk, w4.w, acc[m][3]);
              }
            }
          }
        }
#pragma unroll
        for (int n = 0; n < kTN; ++n) {
          const int col = nb * kTN + n;
          if (col >= ncur) continue;
          const float sc = bn_scale[n0 + col], sh = bn_shift[n0 + col];
          float sum = 0.f;
#pragma unroll
          for (int m = 0; m < kTM; ++m)
            if (live[m]) sum += bn_relu(acc[m][n], sc, sh);
          part[(size_t(r) * L.groups + g) * ncp + col] = sum;
        }
      }
      __syncthreads();
      // Each member's spatial sum, its groups added in order.
      for (int i = tid; i < rows * ncur; i += kThreads) {
        const int r = i / ncur, col = i - r * ncur;
        float sum = 0.f;
        for (int g = 0; g < L.groups; ++g)
          sum += part[(size_t(r) * L.groups + g) * ncp + col];
        pool[r * C2 + n0 + col] = sum;
      }
    }
    dense_head<T>(dp, pool, h0, h1, q, s, b, rows, p0, max_width);
  }
}

// ---- bf16 on wgmma, members by TMA (hopper.cuh, qhead.cuh) ----

constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kConsumers = 2;    // warpgroups per CTA, alternate groups
constexpr int kCtaThreads = kConsumers * kWgThreads;
constexpr int kMembers = 4;      // members per product: 4 × 16 positions
constexpr int kPixels = 64;      // h1·w1 on this path (16 output positions)
constexpr int kMaxRun = 64;      // members per CTA: one q-head tile

struct WgLayout {
  uint32_t taps_off, enc_off, stage_off, pool_off, bn_off, zero_off,
      bar_off;
  int stages;
  size_t total;  // with the 1 KB of alignment slack
};

// Bytes from the 1024-B aligned base (ops/cem_head.py computes the same
// total): the taps [9·C1, C2], enc0's 64 pixels and `stages` groups of 4
// members, with the q-head laid over them (it is staged once the conv is
// done); then the pooled tile [64, C2], BN, a zero row, the mbarriers.
template <int C1, int C2>
WgLayout wg_layout(qhead::Params* qp, int stages) {
  WgLayout L;
  L.stages = stages;
  L.taps_off = 0;
  size_t off = size_t(9) * C1 * C2 * 2;
  L.enc_off = uint32_t(qhead::align_to(off, 1024));
  off = L.enc_off + size_t(kPixels) * C1 * 2;
  L.stage_off = uint32_t(qhead::align_to(off, 1024));
  off = L.stage_off + size_t(stages) * kMembers * kPixels * C1 * 2;
  const size_t head_end = qhead::layout(qp, 0);
  const size_t overlay_end = off > head_end ? off : head_end;
  L.pool_off = uint32_t(qhead::align_to(overlay_end, 1024));
  off = L.pool_off + size_t(hopper::kRows) * C2 * 2;
  L.bn_off = uint32_t(off);
  off += 2 * C2 * 4;
  L.zero_off = uint32_t(qhead::align_to(off, 16));
  off = L.zero_off + 16;
  L.bar_off = uint32_t(qhead::align_to(off, 8));
  off = L.bar_off + 8 * (stages + 1);
  L.total = qhead::align_to(off, 16) + 1024;
  return L;
}

// relu(f32(a) + f32(e)) rounded to bf16, for two bf16 pairs at once. One
// correctly rounded bf16 add gives the same bits: the f32 sum of two
// bf16 values is exact unless their exponents lie more than 16 apart,
// and then both roundings return the larger; relu commutes with the
// rounding. So two instructions instead of nine.
__device__ __forceinline__ uint32_t merge_relu(uint32_t a, uint32_t e) {
  uint32_t out;
  asm("{\n.reg .b32 s;\n"
      "add.rn.bf16x2 s, %1, %2;\n"
      "max.bf16x2 %0, s, %3;\n}\n"
      : "=r"(out) : "r"(a), "r"(e), "r"(0u));
  return out;
}

// One CTA per (run of ≤ 64 members, state b), two warpgroups taking
// alternate groups of 4 members: group g lands in stage g % S (S even),
// so each warpgroup waits on and refills only its own stages, in order.
// Warp w of a product owns member w of the group: rows 16w .. 16w+15
// are its 16 output positions. The conv is an implicit GEMM, M = 64,
// N = C2, K = 9·C1, on wgmma with A from registers: each lane's
// ldmatrix row address is the stride-2 tap's input pixel (XLA's
// high-side padding: a zero row), the same address in enc0's tile gives
// the enc0 add, and relu and the bf16 rounding happen in registers. Two
// fragment buffers let one tap's products run while the next tap's
// fragments are built.
template <int C1, int C2, int kH>
__global__ void __launch_bounds__(kCtaThreads, 1)
cem_head_wgmma(const __grid_constant__ CUtensorMap tact,
               const __grid_constant__ CUtensorMap tenc,
               const __grid_constant__ CUtensorMap ttaps,
               const float* __restrict__ bn_scale,
               const float* __restrict__ bn_shift, qhead::Params qp,
               WgLayout lay, float* __restrict__ q, int P, int W1, int run,
               int p_outer) {
  using TA = hopper::Tile<C1>;  // act / enc0 rows: pixels
  using TB = hopper::Tile<C2>;  // taps rows: (tap, c1); pooled rows
  constexpr int kMemberBytes = kPixels * C1 * 2;
  constexpr int kGroupBytes = kMembers * kMemberBytes;
  constexpr int kTapRows = 3 * C1;  // rows of one taps box
  constexpr int kKSteps = C1 / 16;  // k16 steps of one tap
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t bar_w = base + lay.bar_off;  // taps and enc0
  const int S = lay.stages;
  const int b = blockIdx.y;
  const int p_begin = blockIdx.x * run;
  const int members = min(run, P - p_begin);
  const int groups = (members + kMembers - 1) / kMembers;
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / kWgThreads, wtid = tid % kWgThreads;
  const int warp = wtid / 32;

  const CUtensorMap* act_map = &tact;
  auto issue = [=](int g) {  // group g's members into stage g % S
    const int st = g % S;
    const uint32_t bar = bar_w + 8 * (1 + st);
    const uint32_t dst = base + lay.stage_off + st * kGroupBytes;
    const int p = p_begin + kMembers * g;
    hopper::mbar_expect_tx(bar, kGroupBytes);
    if (p_outer) {
      hopper::tma_load_5d(dst, act_map, bar, 0, 0, 0, b, p);
    } else {
      hopper::tma_load_5d(dst, act_map, bar, 0, 0, 0, p, b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= S; ++i) hopper::mbar_init(bar_w + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar_w, 9 * C1 * C2 * 2 + kMemberBytes);
    for (int i = 0; i < 3; ++i)
      hopper::tma_load_2d(base + lay.taps_off + i * kTapRows * C2 * 2,
                          &ttaps, bar_w, 0, i * kTapRows);
    hopper::tma_load_2d(base + lay.enc_off, &tenc, bar_w, 0, b * kPixels);
    for (int g = 0; g < S && g < groups; ++g) issue(g);
  }
  const float* bn = reinterpret_cast<const float*>(smem + lay.bn_off);
  for (int i = tid; i < C2; i += kCtaThreads) {
    hopper::cp_async4(base + lay.bn_off + 4 * i, bn_scale + i);
    hopper::cp_async4(base + lay.bn_off + 4 * (C2 + i), bn_shift + i);
  }
  if (tid < 4) reinterpret_cast<uint32_t*>(smem + lay.zero_off)[tid] = 0u;
  for (int i = tid; i < hopper::kRows * C2 / 8; i += kCtaThreads)
    reinterpret_cast<uint4*>(smem + lay.pool_off)[i] = make_uint4(0, 0, 0, 0);
  hopper::cp_async_wait_all();
  __syncthreads();
  hopper::mbar_wait(bar_w, 0);

  // ldmatrix rows: lane i addresses row (i%8) + 8·((i/8)%2), columns
  // 8·(i/16) .. +7 of a k16 step; the row is an output position.
  const int pos = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int cofs = 8 * (lane >> 4);
  const int w2 = W1 / 2, H1 = kPixels / W1;
  const int oi = pos / w2, oj = pos % w2;
  const uint32_t zero_s = base + lay.zero_off;
  const uint32_t enc_s = base + lay.enc_off;
  const uint32_t taps_s = base + lay.taps_off;
  const int t = lane % 4;

  for (int g = wg; g < groups; g += kConsumers) {
    const int st = g % S;
    hopper::mbar_wait(bar_w + 8 * (1 + st), (g / S) & 1);
    const uint32_t mem_s =
        base + lay.stage_off + st * kGroupBytes + warp * kMemberBytes;
    float acc[C2 / 2];
#pragma unroll
    for (int i = 0; i < C2 / 2; ++i) acc[i] = 0.f;
    uint32_t fa[2][kKSteps][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ii = 2 * oi + tap / 3, jj = 2 * oj + tap % 3;
      const bool live = ii < H1 && jj < W1;
      if (tap >= 2) hopper::wgmma_wait<1>();  // tap − 2's products are done
      uint32_t (&f)[kKSteps][4] = fa[tap & 1];
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const uint32_t off = TA::offset(ii * W1 + jj, ks * 16 + cofs);
        uint32_t ra[4], re[4];
        hopper::ldmatrix_x4(ra, live ? mem_s + off : zero_s);
        hopper::ldmatrix_x4(re, live ? enc_s + off : zero_s);
#pragma unroll
        for (int r = 0; r < 4; ++r) f[ks][r] = merge_relu(ra[r], re[r]);
      }
      if (tap == 8) {  // the warpgroup has read the stage: refill it
        asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(kWgThreads)
                     : "memory");
        if (wtid == 0 && g + S < groups) issue(g + S);
      }
      hopper::pin(acc);
      hopper::pin(f);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        hopper::wgmma_rs<C2>(acc, f[ks], TB::mn_major(taps_s,
                                                      tap * kKSteps + ks));
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait_all();
    hopper::pin(acc);
    hopper::pin(fa[0]);
    hopper::pin(fa[1]);

    // BN affine and relu per element; the member's 16 positions summed
    // in a fixed order (its two rows, then lanes 4 and 8 and 16 apart).
    const int m = kMembers * g + warp;
#pragma unroll
    for (int n = 0; n < C2 / 8; ++n) {
      float mean[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        const float sc = bn[col], sh = bn[C2 + col];
        float v = bn_relu(acc[4 * n + e], sc, sh) +
                  bn_relu(acc[4 * n + 2 + e], sc, sh);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        mean[e] = v / 16.f;
      }
      if (lane < 4)
        *reinterpret_cast<uint32_t*>(smem + lay.pool_off +
                                     TB::offset(m, 8 * n + 2 * t)) =
            hopper::pack_bf16(mean[0], mean[1]);
    }
  }

  // The dense head over the run's pooled rows (zero rows past it), its
  // weights staged over the taps and stages the conv no longer reads.
  __syncthreads();
  qhead::stage(qp, smem, tid, kCtaThreads);
  hopper::cp_async_wait_all();
  hopper::fence_proxy_async();
  __syncthreads();
  if (wg != 0) return;
  const float2 sc = qhead::rows<C2, kH>(qp, smem, base, base + lay.pool_off,
                                        tid);
  const int r0 = 16 * warp + lane / 4;
  if (lane % 4 == 0) {
    float* qb = q + size_t(b) * P + p_begin;
    if (r0 < members) qb[r0] = sc.x;
    if (r0 + 8 < members) qb[r0 + 8] = sc.y;
  }
}

// ---- host side ----

int max_width_of(const DenseParams& dp) {
  int m = 0;
  for (int l = 0; l <= dp.n_layers; ++l) m = dp.dims[l] > m ? dp.dims[l] : m;
  return m;
}

// Whether act and enc0 can be staged with 16-byte loads: channels
// contiguous and a whole number of vectors, every other stride and both
// base addresses on 16-byte boundaries.
template <typename T>
int can_vectorize(const void* act, const void* enc0, const Shape& s) {
  constexpr int V = Vec<T>::n;
  if (s.C1 % V || s.act_stride[4] != 1) return 0;
  for (int i = 0; i < 4; ++i)
    if (s.act_stride[i] % V) return 0;
  return (reinterpret_cast<uintptr_t>(act) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(enc0) % 16 == 0);
}

// Raises the kernel's dynamic shared-memory limit when a launch needs
// more than 48 KB (once per kernel and size).
template <typename K>
cudaError_t opt_in(K kernel, size_t smem, size_t* opted_in) {
  if (smem <= 48 * 1024 || smem <= *opted_in) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess) *opted_in = smem;
  return err;
}

cudaError_t sm_count(int* sms) {
  static int count = 0;
  if (count == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
  }
  *sms = count;
  return cudaSuccess;
}

// The mma.sync (tensor_cores) and CUDA-core paths with the plan's
// members per chunk (`rows`) and channels per tap chunk (`nc`).
template <typename T>
int launch_chunks(bool mma, int rows, int nc, size_t planned_smem,
                  const void* act, const void* enc0, const void* taps,
                  const float* bn_scale, const float* bn_shift,
                  const DenseParams& dp, float* q, const Shape& s, int sms,
                  cudaStream_t stream) {
  const int max_width = max_width_of(dp);
  const size_t smem = mma ? mma_layout(s, max_width, rows).total
                          : core_layout(s, max_width, rows, nc).total;
  if (rows < 1 || nc < 1 || smem != planned_smem || smem > size_t(kMaxSmem))
    return int(cudaErrorInvalidValue);
  // CTAs per state: enough for kCtasPerSm CTAs per SM over the batch,
  // at most one per population chunk.
  const int chunks = (s.P + rows - 1) / rows;
  int per_state = (kCtasPerSm * sms + s.B - 1) / s.B;
  per_state = per_state < chunks ? per_state : chunks;
  const dim3 grid(per_state, s.B);
  const int vec = can_vectorize<T>(act, enc0, s);
  cudaError_t err;
  if (mma) {
    static size_t opted_in = 0;
    err = opt_in(cem_head_mma_kernel, smem, &opted_in);
    if (err != cudaSuccess) return int(err);
    cem_head_mma_kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(act),
        static_cast<const __nv_bfloat16*>(enc0),
        static_cast<const __nv_bfloat16*>(taps), bn_scale, bn_shift, dp, q,
        s, rows, max_width, vec);
  } else {
    static size_t opted_in = 0;  // per T
    err = opt_in(cem_head_core_kernel<T>, smem, &opted_in);
    if (err != cudaSuccess) return int(err);
    cem_head_core_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(act), static_cast<const T*>(enc0),
        static_cast<const T*>(taps), bn_scale, bn_shift, dp, q, s, rows, nc,
        max_width, vec);
  }
  return int(cudaGetLastError());
}

template <int C1, int C2, int kH>
int launch_wgmma_t(const void* act, const long long* st, const void* enc0,
                   const void* taps, const float* bn_scale,
                   const float* bn_shift, qhead::Params qp, float* q,
                   const Shape& s, int stages, size_t planned_smem, int sms,
                   cudaStream_t stream) {
  using TA = hopper::Tile<C1>;
  using TB = hopper::Tile<C2>;
  const WgLayout lay = wg_layout<C1, C2>(&qp, stages);
  if (lay.total != planned_smem || lay.total > size_t(kMaxSmem))
    return int(cudaErrorInvalidValue);
  // act [B, P, h1, w1, C1] as a rank-5 map, dims innermost first: C1,
  // w1, h1, then P and B in the order of their strides.
  const int p_outer = st[1] > st[0];
  CUtensorMap tact, tenc, ttaps;
  const cuuint64_t adims[5] = {
      cuuint64_t(C1), cuuint64_t(s.W1), cuuint64_t(s.H1),
      cuuint64_t(p_outer ? s.B : s.P), cuuint64_t(p_outer ? s.P : s.B)};
  const cuuint64_t astrides[4] = {
      cuuint64_t(st[3]) * 2, cuuint64_t(st[2]) * 2,
      cuuint64_t(p_outer ? st[0] : st[1]) * 2,
      cuuint64_t(p_outer ? st[1] : st[0]) * 2};
  const cuuint32_t abox[5] = {cuuint32_t(C1), cuuint32_t(s.W1),
                              cuuint32_t(s.H1),
                              cuuint32_t(p_outer ? 1 : kMembers),
                              cuuint32_t(p_outer ? kMembers : 1)};
  cudaError_t err = hopper::encode_bf16(&tact, act, 5, adims, astrides,
                                        abox, TA::kTmaSwizzle);
  const cuuint64_t edims[2] = {cuuint64_t(C1), cuuint64_t(s.B) * kPixels};
  const cuuint64_t estrides[1] = {cuuint64_t(C1) * 2};
  const cuuint32_t ebox[2] = {cuuint32_t(C1), cuuint32_t(kPixels)};
  if (err == cudaSuccess)
    err = hopper::encode_bf16(&tenc, enc0, 2, edims, estrides, ebox,
                              TA::kTmaSwizzle);
  const cuuint64_t tdims[2] = {cuuint64_t(C2), cuuint64_t(9) * C1};
  const cuuint64_t tstrides[1] = {cuuint64_t(C2) * 2};
  const cuuint32_t tbox[2] = {cuuint32_t(C2), cuuint32_t(3 * C1)};
  if (err == cudaSuccess)
    err = hopper::encode_bf16(&ttaps, taps, 2, tdims, tstrides, tbox,
                              TB::kTmaSwizzle);
  if (err != cudaSuccess) return int(err);
  static size_t opted_in = 0;  // per instantiation
  err = opt_in(cem_head_wgmma<C1, C2, kH>, lay.total, &opted_in);
  if (err != cudaSuccess) return int(err);
  // Members per CTA: a multiple of 4, enough CTAs for one per SM over
  // the batch, at most one q-head tile.
  int run = (s.P * s.B + sms - 1) / sms;
  run = (run + kMembers - 1) / kMembers * kMembers;
  run = run < kMembers ? kMembers : run > kMaxRun ? kMaxRun : run;
  const dim3 grid((s.P + run - 1) / run, s.B);
  cem_head_wgmma<C1, C2, kH><<<grid, kCtaThreads, lay.total, stream>>>(
      tact, tenc, ttaps, bn_scale, bn_shift, qp, lay, q, s.P, s.W1, run,
      p_outer);
  return int(cudaGetLastError());
}

// The wgmma path's rule (ops/cem_head.py `launch_plan` states the same):
// bf16, h1·w1 = 64, C1 and C2 in {32, 64}, at least one hidden dense
// layer, hidden widths multiples of 16 up to 256.
int launch_wgmma(const void* act, const long long* st, const void* enc0,
                 const void* taps, const float* bn_scale,
                 const float* bn_shift, const DenseParams& dp, float* q,
                 const Shape& s, int stages, size_t planned_smem, int sms,
                 cudaStream_t stream) {
  if (s.H1 * s.W1 != kPixels || dp.n_layers < 2 || stages < 2 ||
      stages % kConsumers)
    return int(cudaErrorInvalidValue);
  qhead::Params qp = {};
  qp.n_layers = dp.n_layers;
  int widest = 0;
  for (int l = 0; l <= dp.n_layers; ++l) qp.dims[l] = dp.dims[l];
  for (int l = 0; l < dp.n_layers; ++l) {
    qp.w[l] = static_cast<const __nv_bfloat16*>(dp.w[l]);
    qp.b[l] = static_cast<const __nv_bfloat16*>(dp.b[l]);
    if (l < dp.n_layers - 1) {
      const int h = dp.dims[l + 1];
      if (h % 16 || h > 256) return int(cudaErrorInvalidValue);
      widest = h > widest ? h : widest;
    }
  }
#define T2R_HEAD_CASE(c1, c2)                                               \
  if (s.C1 == c1 && s.C2 == c2)                                             \
    return widest <= 64                                                     \
               ? launch_wgmma_t<c1, c2, 64>(act, st, enc0, taps, bn_scale,  \
                                            bn_shift, qp, q, s, stages,     \
                                            planned_smem, sms, stream)      \
               : launch_wgmma_t<c1, c2, 256>(act, st, enc0, taps, bn_scale, \
                                             bn_shift, qp, q, s, stages,    \
                                             planned_smem, sms, stream);
  T2R_HEAD_CASE(64, 64)
  T2R_HEAD_CASE(32, 32)
  T2R_HEAD_CASE(64, 32)
  T2R_HEAD_CASE(32, 64)
#undef T2R_HEAD_CASE
  return int(cudaErrorInvalidValue);
}

bool make_params(int n_layers, const void* const* w, const void* const* b,
                 const int* dims, DenseParams* dp) {
  if (n_layers < 1 || n_layers > kMaxLayers || dims[n_layers] != 1)
    return false;
  *dp = DenseParams{};
  dp->n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    dp->w[l] = w[l];
    dp->b[l] = b[l];
  }
  for (int l = 0; l <= n_layers; ++l) dp->dims[l] = dims[l];
  return true;
}

}  // namespace

extern "C" {

// Launches one head tail on `stream`; returns cudaGetLastError() (0 ok).
// act_strides: 5 element strides of act for (b, p, i, j, c). w / b are
// host arrays of n_layers device pointers; dims has n_layers + 1
// entries (dims[0] = C2, dims[n_layers] = 1). The plan is
// ops/cem_head.py's `launch_plan`: `path` 0 CUDA cores, 1 mma.sync
// (bf16), 2 wgmma (bf16; act, enc0 and taps read by TMA); `rows` and
// `nc` the chunking of paths 0 and 1, `stages` the act ring of path 2,
// and `smem` the shared-memory bytes, which the layout here must
// reproduce (a launch whose layouts disagree is refused).
int t2r_cem_head_tail(const void* act, const long long* act_strides,
                      const void* enc0, const void* taps,
                      const void* bn_scale, const void* bn_shift,
                      int n_layers, const void* const* w,
                      const void* const* b, const int* dims, void* q, int B,
                      int P, int H1, int W1, int C1, int C2, int is_bf16,
                      int path, int rows, int nc, int stages, size_t smem,
                      void* stream) {
  DenseParams dp;
  if (!make_params(n_layers, w, b, dims, &dp) || dims[0] != C2 || B < 1 ||
      B > 65535 || P < 1 || H1 < 2 || W1 < 2 || (H1 & 1) || (W1 & 1) ||
      C1 < 1 || C2 < 1 || path < 0 || path > 2 || (path && !is_bf16))
    return int(cudaErrorInvalidValue);
  Shape s = {B, P, H1, W1, C1, C2, {0, 0, 0, 0, 0}};
  for (int i = 0; i < 5; ++i) s.act_stride[i] = act_strides[i];
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return int(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(bn_scale);
  const float* sh = static_cast<const float*>(bn_shift);
  float* out = static_cast<float*>(q);
  if (path == 2)
    return launch_wgmma(act, act_strides, enc0, taps, sc, sh, dp, out, s,
                        stages, smem, sms, st);
  return is_bf16 ? launch_chunks<__nv_bfloat16>(path == 1, rows, nc, smem,
                                                act, enc0, taps, sc, sh, dp,
                                                out, s, sms, st)
                 : launch_chunks<float>(false, rows, nc, smem, act, enc0,
                                        taps, sc, sh, dp, out, s, sms, st);
}

}  // extern "C"
