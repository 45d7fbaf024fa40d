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
// Design. A CTA owns one state b and walks a run of its population in
// chunks of `rows` members; the grid is (CTAs per state, B), sized so
// the card has a couple of CTAs per SM even at B=4, where one CTA per
// state would leave most of the 132 SMs idle. Each chunk is staged into
// shared memory with the enc0 add, relu and rounding to T on the way in
// (16-byte loads, several in flight, where the layout allows; act is read
// through its five strides, so the Q-network's P-major tensor comes in
// as a transposed view, not a copy). The conv is an implicit GEMM: M =
// the chunk's output positions, N = C2, K = 9·C1 (the nine taps read
// the staged members in place, the stride-2 padding as a zero row).
//   - bf16 (the Bellman path): on tensor cores, `mma.sync` m16n8k16 with
//     f32 accumulators. The taps are staged once per CTA as bf16 [tap][n]
//     [k]; each warp owns a 16-position × 32-channel tile. Chunks are as
//     large as lets two CTAs share an SM (2 members at 8×8×64 → 64), so
//     one CTA's staging and epilogue overlap the other's conv.
//   - f32, and bf16 convs too wide to stage whole (C1 = C2 = 128): on
//     CUDA cores in f32, the taps staged per channel chunk as f32; each
//     thread owns 4 positions × 4 channels, 4 input channels per step
//     from float4 loads.
// The BN affine and relu follow in registers; a member's positions are
// summed in a fixed order (no atomics: the result is the same on every
// run), and the dense head runs per member from shared memory with its
// weights read from device memory (L2-resident).
//
// Bound: at the Bellman shape (B=256, P=64, 8×8×64 → 64, bf16) the
// kernel must read the 134 MB population activation once (~40 µs at
// 3.35 TB/s) and do 19.3 GFLOP of conv (~20 µs on bf16 tensor cores), so
// bytes bound it. `mma.sync` is Hopper's older tensor-core path; wgmma
// and TMA staging are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 8;
constexpr int kMaxSmem = 232448;  // 227 KB per block on sm_90
// Two blocks on one SM: 228 KB per SM, less 1 KB reserved per block.
constexpr int kHalfSmem = 233472 / 2 - 1024;
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

struct Plan {
  bool mma;
  int rows, nc;
  size_t smem;
};

// bf16 on tensor cores when the taps fit whole: the most members per
// chunk (at most 4) that let two CTAs share an SM, else that fit at all;
// otherwise CUDA cores with 4 members and all channels where they fit,
// else fewer channels, then fewer members.
bool make_plan(const Shape& s, int max_width, bool bf16, Plan* plan) {
  if (bf16) {
    const int limits[2] = {kHalfSmem, kMaxSmem};
    for (const int limit : limits) {
      for (int r = 4; r >= 1; r /= 2) {
        const MmaLayout L = mma_layout(s, max_width, r);
        if (L.total <= size_t(limit)) {
          *plan = Plan{true, r, s.C2, L.total};
          return true;
        }
      }
    }
  }
  for (int r = 4; r >= 1; r /= 2) {
    int n = s.C2;
    while (true) {
      const CoreLayout L = core_layout(s, max_width, r, n);
      if (L.total <= size_t(kMaxSmem)) {
        *plan = Plan{false, r, n, L.total};
        return true;
      }
      if (n <= kTN) break;
      n = round_up((n + 1) / 2, kTN);
    }
  }
  return false;
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

template <typename T>
int launch(const void* act, const void* enc0, const void* taps,
           const float* bn_scale, const float* bn_shift,
           const DenseParams& dp, float* q, const Shape& s,
           cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int max_width = max_width_of(dp);
  Plan plan;
  if (!make_plan(s, max_width, kBf16, &plan))
    return int(cudaErrorInvalidValue);
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return int(err);
  }
  // CTAs per state: enough for kCtasPerSm CTAs per SM over the batch,
  // at most one per population chunk.
  const int chunks = (s.P + plan.rows - 1) / plan.rows;
  int per_state = (kCtasPerSm * sms + s.B - 1) / s.B;
  per_state = per_state < chunks ? per_state : chunks;
  const dim3 grid(per_state, s.B);
  const int vec = can_vectorize<T>(act, enc0, s);
  cudaError_t err;
  if (plan.mma) {
    static size_t opted_in = 0;
    err = opt_in(cem_head_mma_kernel, plan.smem, &opted_in);
    if (err != cudaSuccess) return int(err);
    cem_head_mma_kernel<<<grid, kThreads, plan.smem, stream>>>(
        static_cast<const __nv_bfloat16*>(act),
        static_cast<const __nv_bfloat16*>(enc0),
        static_cast<const __nv_bfloat16*>(taps), bn_scale, bn_shift, dp, q,
        s, plan.rows, max_width, vec);
  } else {
    static size_t opted_in = 0;  // per T
    err = opt_in(cem_head_core_kernel<T>, plan.smem, &opted_in);
    if (err != cudaSuccess) return int(err);
    cem_head_core_kernel<T><<<grid, kThreads, plan.smem, stream>>>(
        static_cast<const T*>(act), static_cast<const T*>(enc0),
        static_cast<const T*>(taps), bn_scale, bn_shift, dp, q, s,
        plan.rows, plan.nc, max_width, vec);
  }
  return int(cudaGetLastError());
}

bool make_params(int n_layers, const void* const* w, const void* const* b,
                 const int* dims, DenseParams* dp) {
  if (n_layers < 1 || n_layers > kMaxLayers || dims[n_layers] != 1)
    return false;
  *dp = DenseParams{};
  dp->n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    dp->w[l] = w ? w[l] : nullptr;
    dp->b[l] = b ? b[l] : nullptr;
  }
  for (int l = 0; l <= n_layers; ++l) dp->dims[l] = dims[l];
  return true;
}

}  // namespace

extern "C" {

// The launch plan for a shape: whether the conv runs on tensor cores,
// population members per chunk, output channels per chunk and
// shared-memory bytes. Returns 0, or a CUDA error code when no plan fits
// in 227 KB.
int t2r_cem_head_plan(int B, int P, int H1, int W1, int C1, int C2,
                      int n_layers, const int* dims, int is_bf16,
                      int* tensor_cores, int* rows, int* nc, size_t* smem) {
  DenseParams dp;
  if (!make_params(n_layers, nullptr, nullptr, dims, &dp))
    return int(cudaErrorInvalidValue);
  const Shape s = {B, P, H1, W1, C1, C2, {0, 0, 0, 0, 0}};
  Plan plan;
  if (!make_plan(s, max_width_of(dp), is_bf16 != 0, &plan))
    return int(cudaErrorInvalidValue);
  *tensor_cores = plan.mma;
  *rows = plan.rows;
  *nc = plan.nc;
  *smem = plan.smem;
  return 0;
}

// Launches one head tail on `stream`; returns cudaGetLastError() (0 ok).
// act_strides: 5 element strides of act for (b, p, i, j, c). w / b are
// host arrays of n_layers device pointers; dims has n_layers + 1
// entries (dims[0] = C2, dims[n_layers] = 1).
int t2r_cem_head_tail(const void* act, const long long* act_strides,
                      const void* enc0, const void* taps,
                      const void* bn_scale, const void* bn_shift,
                      int n_layers, const void* const* w,
                      const void* const* b, const int* dims, void* q, int B,
                      int P, int H1, int W1, int C1, int C2, int is_bf16,
                      void* stream) {
  DenseParams dp;
  if (!make_params(n_layers, w, b, dims, &dp) || dims[0] != C2 || B < 1 ||
      B > 65535 || P < 1 || H1 < 2 || W1 < 2 || (H1 & 1) || (W1 & 1) ||
      C1 < 1 || C2 < 1)
    return int(cudaErrorInvalidValue);
  Shape s = {B, P, H1, W1, C1, C2, {0, 0, 0, 0, 0}};
  for (int i = 0; i < 5; ++i) s.act_stride[i] = act_strides[i];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(bn_scale);
  const float* sh = static_cast<const float*>(bn_shift);
  float* out = static_cast<float*>(q);
  return is_bf16 ? launch<__nv_bfloat16>(act, enc0, taps, sc, sh, dp, out, s,
                                         st)
                 : launch<float>(act, enc0, taps, sc, sh, dp, out, s, st);
}

}  // extern "C"
