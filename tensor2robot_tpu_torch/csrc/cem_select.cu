// Fused CEM iteration tail for Hopper (sm_90a): q-head MLP scoring,
// top-E elite selection, elite mean / std / best action / best score.
//
// Replaces the Pallas TPU kernel `_cem_select_kernel` of
// tensor2robot_tpu/ops/cem_select.py (`fused_cem_select`). Same
// contract as that kernel and as its plain version
// `cem_select_reference` in tensor2robot_tpu_torch/ops/cem_select.py:
//
//   pooled  [P, B, C]  compute dtype T (bf16 or f32), P-major
//   samples [B, P, A]  f32
//   dense   ((W0 [C, H0], b0 [H0]), ..., (Wn [Hn-1, 1], bn [1])) in T
//   → mean, std, best_action [B, A] f32; best_score [B] f32
//
// Numerics: every MLP product accumulates in f32 from T operands; the
// bias is cast to f32 and added after the dot; hidden activations are
// relu'd and rounded to T (the TPU kernel's `_mlp_f32`). The optional
// sigmoid is applied before selection, so saturated sigmoids tie and
// the tie goes to the lower sample index (lax.top_k's order).
// Selection and statistics are f32; std uses ddof 0 and is floored at
// min_std; the elites are summed in rank order, so a rerun gives the
// same bits.
//
// Bound: at the serving and Bellman shapes (P=64, C=H=64, A=4, E=6) the
// work is 2·P·B·(C·H + H·H + H) flops against ~(P·C·sizeof(T) + P·A·4)
// bytes per state, about 8 flops per byte, so device-memory traffic
// bounds it: 2.7e-5 ms at B=8, 7.1e-4 ms at B=256 on an H100, both far
// under one launch. What a call costs is one CTA's chain of dependent
// steps.
//
// Version 1 (PR 1, kept below as the CUDA-core kernel) was a 256-thread
// CTA per state whose chain was: every weight and pooled row staged two
// bytes at a time (the rows at stride B·C), the MLP on CUDA cores out of
// shared memory with a barrier per layer, E argmax passes with two
// barriers and a serial 8-warp merge each, and statistics through
// dependent global loads.
//
// Version 2, the bf16 path (C a power of two 16 .. 256, hidden widths
// multiples of 16 up to 256, E ≤ 64): one warpgroup (128 threads) per
// state b. At P=64 a state's population is one wgmma M=64 tile, so a
// state is never split over CTAs.
//  - State b's pooled rows arrive by TMA, a rank-3 map over [P, B, C]
//    (box C × 1 × 64 rows, zero fill past P), two stages when P > 64 so
//    tile t+1 lands while tile t is scored. The q-head weights come with
//    16-byte cp.async (L2 hits: every CTA reads the same), all in flight
//    at once, and the state's [P, A] samples with cp.async, issued before
//    the MLP and waited for after it.
//  - The MLP is qhead.cuh's routine: layer 0 as wgmma from shared memory,
//    later layers with the rounded activations as the register A operand,
//    the width-1 layer as a quad-shuffled dot product. No barrier per
//    layer.
//  - Selection: each 64-row tile's scores join the E elites kept so far
//    as 128 candidates, one per thread; each thread counts the
//    candidates that rank before its own on (score desc, index asc) and,
//    after one barrier, keeps its candidate in that slot if it is below
//    E. Kept elites have lower indices than the tile's rows, so ties
//    still go to the lower index; rows past P are empty slots. No
//    shuffle chains and two barriers per tile, none per elite.
//  - Statistics from the staged samples, in rank order.
// f32 and other widths keep version 1: tensor cores would compute f32
// products in TF32 and break the f32 contract.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "qhead.cuh"

namespace {

// ---- f32 and other widths: version 1, on CUDA cores ----

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
// 227 KB per block on sm_90, less the kernel's static argmax scratch.
constexpr int kMaxSmem = 232448 - 2 * (kThreads / 32) * 4;

struct MlpParams {
  int n_layers;
  int dims[kMaxLayers + 1];  // dims[0] = C, dims[n_layers] = 1
  const void* w[kMaxLayers];
  const void* b[kMaxLayers];
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

// Rows of a hidden-layer output each thread computes: the weight it
// loads is reused kRows times and the kRows sums are independent, so
// shared-memory latency overlaps instead of serializing one FMA chain.
constexpr int kRows = 4;

__host__ __device__ inline int padded_rows(int P) {
  return (P + kRows - 1) / kRows * kRows;
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

struct SmemLayout {
  size_t w_off[kMaxLayers], b_off[kMaxLayers];
  size_t x_off, h0_off, h1_off, score_off, taken_off, elite_off, total;
};

// Shared-memory layout; the host side computes the same total to
// refuse shapes that do not fit.
__host__ __device__ inline SmemLayout smem_layout(const MlpParams& prm,
                                                  int P, size_t elt) {
  SmemLayout s;
  size_t off = 0;
  int max_hidden = 0;
  for (int l = 0; l < prm.n_layers; ++l) {
    s.w_off[l] = off;
    off = align16(off + size_t(prm.dims[l]) * prm.dims[l + 1] * elt);
    s.b_off[l] = off;
    off = align16(off + size_t(prm.dims[l + 1]) * elt);
    if (l < prm.n_layers - 1 && prm.dims[l + 1] > max_hidden)
      max_hidden = prm.dims[l + 1];
  }
  // Activation buffers hold P rounded up to kRows rows; the extra rows
  // are zero inputs whose outputs no score reads (rows are independent).
  const size_t rows = size_t(padded_rows(P));
  s.x_off = off;
  off = align16(off + rows * prm.dims[0] * elt);
  s.h0_off = off;
  off = align16(off + rows * max_hidden * elt);
  s.h1_off = off;
  off = align16(off + rows * max_hidden * elt);
  s.score_off = off;
  off = align16(off + size_t(P) * sizeof(float));
  s.taken_off = off;
  off = align16(off + size_t(P) * sizeof(int));
  s.elite_off = off;
  off = align16(off + size_t(P) * sizeof(int));
  s.total = off;
  return s;
}

// (s, i) ranks before (bs, bi): higher score, then lower index.
// i < 0 marks an empty slot.
__device__ __forceinline__ bool ranks_before(float s, int i, float bs,
                                             int bi) {
  if (i < 0) return false;
  if (bi < 0) return true;
  return s > bs || (s == bs && i < bi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cem_select_kernel(const T* __restrict__ pooled,
                  const float* __restrict__ samples, MlpParams prm,
                  float* __restrict__ mean_out, float* __restrict__ std_out,
                  float* __restrict__ best_action_out,
                  float* __restrict__ best_score_out, int P, int B, int A,
                  int E, float min_std, int sigmoid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SmemLayout lay = smem_layout(prm, P, sizeof(T));
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int C = prm.dims[0];

  // Stage the q-head weights and state b's P pooled rows (zero rows pad
  // P up to a multiple of kRows).
  for (int l = 0; l < prm.n_layers; ++l) {
    const int nw = prm.dims[l] * prm.dims[l + 1];
    const T* wg = static_cast<const T*>(prm.w[l]);
    const T* bg = static_cast<const T*>(prm.b[l]);
    T* ws = reinterpret_cast<T*>(smem + lay.w_off[l]);
    T* bs = reinterpret_cast<T*>(smem + lay.b_off[l]);
    for (int i = tid; i < nw; i += kThreads) ws[i] = wg[i];
    for (int i = tid; i < prm.dims[l + 1]; i += kThreads) bs[i] = bg[i];
  }
  T* x = reinterpret_cast<T*>(smem + lay.x_off);
  const int P_pad = padded_rows(P);
  for (int i = tid; i < P_pad * C; i += kThreads) {
    const int p = i / C, k = i - p * C;
    x[i] = p < P ? pooled[(size_t(p) * B + b) * C + k] : from_f32<T>(0.f);
  }
  float* scores = reinterpret_cast<float*>(smem + lay.score_off);
  int* taken = reinterpret_cast<int*>(smem + lay.taken_off);
  int* elite = reinterpret_cast<int*>(smem + lay.elite_off);
  for (int p = tid; p < P; p += kThreads) taken[p] = 0;
  __syncthreads();

  // The MLP: hidden layers into ping-pong buffers, the last into scores.
  const T* in = x;
  T* bufs[2] = {reinterpret_cast<T*>(smem + lay.h0_off),
                reinterpret_cast<T*>(smem + lay.h1_off)};
  for (int l = 0; l < prm.n_layers; ++l) {
    const int K = prm.dims[l], N = prm.dims[l + 1];
    const T* w = reinterpret_cast<const T*>(smem + lay.w_off[l]);
    const T* bias = reinterpret_cast<const T*>(smem + lay.b_off[l]);
    if (l < prm.n_layers - 1) {
      // Thread item (g, j): output column j of rows g*kRows .. +kRows-1,
      // each summed over k in ascending order, then + bias, relu, round.
      T* out = bufs[l & 1];
      for (int i = tid; i < (P_pad / kRows) * N; i += kThreads) {
        const int g = i / N, j = i - g * N;
        const T* rows = in + size_t(g) * kRows * K;
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const float wv = to_f32(w[k * N + j]);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r] += to_f32(rows[r * K + k]) * wv;
        }
        const float bj = to_f32(bias[j]);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          out[(size_t(g) * kRows + r) * N + j] =
              from_f32<T>(fmaxf(acc[r] + bj, 0.f));
      }
      in = out;
    } else {
      for (int p = tid; p < P; p += kThreads) {
        const T* row = in + size_t(p) * K;
        float acc = 0.f;
        for (int k = 0; k < K; ++k) acc += to_f32(row[k]) * to_f32(w[k]);
        acc += to_f32(bias[0]);
        if (sigmoid) acc = 1.f / (1.f + expf(-acc));
        scores[p] = acc;
      }
    }
    __syncthreads();
  }

  // E argmax passes over the untaken scores.
  __shared__ float red_s[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  const int lane = tid & 31, warp = tid >> 5;
  for (int e = 0; e < E; ++e) {
    float bs = -INFINITY;
    int bi = -1;
    for (int p = tid; p < P; p += kThreads) {
      if (!taken[p] && ranks_before(scores[p], p, bs, bi)) {
        bs = scores[p];
        bi = p;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (ranks_before(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_s[warp] = bs;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      float s = red_s[0];
      int i = red_i[0];
      for (int w = 1; w < kThreads / 32; ++w) {
        if (ranks_before(red_s[w], red_i[w], s, i)) {
          s = red_s[w];
          i = red_i[w];
        }
      }
      elite[e] = i;
      taken[i] = 1;
    }
    __syncthreads();
  }

  // Elite statistics, summed in rank order.
  const float* acts = samples + size_t(b) * P * A;
  for (int a = tid; a < A; a += kThreads) {
    float m = 0.f;
    for (int e = 0; e < E; ++e) m += acts[size_t(elite[e]) * A + a];
    m /= float(E);
    float var = 0.f;
    for (int e = 0; e < E; ++e) {
      const float d = acts[size_t(elite[e]) * A + a] - m;
      var += d * d;
    }
    var /= float(E);
    mean_out[size_t(b) * A + a] = m;
    std_out[size_t(b) * A + a] = fmaxf(sqrtf(var), min_std);
    best_action_out[size_t(b) * A + a] = acts[size_t(elite[0]) * A + a];
  }
  if (tid == 0) best_score_out[b] = scores[elite[0]];
}

template <typename T>
int launch_core(const void* pooled, const float* samples,
                const MlpParams& prm, float* mean, float* stdv,
                float* best_action, float* best_score, int P, int B, int A,
                int E, float min_std, int sigmoid, size_t planned_smem,
                cudaStream_t stream) {
  const size_t smem = smem_layout(prm, P, sizeof(T)).total;
  if (smem != planned_smem || smem > size_t(kMaxSmem))
    return int(cudaErrorInvalidValue);
  static size_t opted_in = 0;  // per T; raised only when a launch needs it
  if (smem > 48 * 1024 && smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        cem_select_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
    opted_in = smem;
  }
  cem_select_kernel<T><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(pooled), samples, prm, mean, stdv, best_action,
      best_score, P, B, A, E, min_std, sigmoid);
  return int(cudaGetLastError());
}

// ---- bf16: version 2, on wgmma (hopper.cuh, qhead.cuh) ----

constexpr int kWgThreads = 128;  // one warpgroup

// The running top-E over candidate slots: 0 .. 63 hold the elites kept
// so far in rank order (slots at E and past unused), 64 .. 127 the rows
// of the tile just scored; an empty slot is (−inf, kEmpty), which ranks
// after every real candidate. Ranks run on (score desc, index asc);
// kept elites have lower indices than the tile's rows, so ties still go
// to the lower index.
constexpr int kCands = 2 * hopper::kRows;
constexpr int kEmpty = 0x7fffffff;

// Shared-memory layout of version 2, in bytes from the 1024-B aligned
// base; the host side computes the same total (ops/cem_select.py).
struct WgLayout {
  uint32_t pool_off, cand_off, bar_off, smp_off;
  int stages;
  size_t total;  // with the 1 KB of alignment slack
};

template <int C>
WgLayout wg_layout(qhead::Params* qp, int P, int A) {
  WgLayout L;
  L.stages = P > hopper::kRows ? 2 : 1;
  L.pool_off = 0;
  size_t off = size_t(L.stages) * hopper::Tile<C>::kBytes;
  off = qhead::layout(qp, off);
  L.cand_off = uint32_t(off);  // kCands scores, then their indices
  off += 2 * kCands * 4;
  L.bar_off = uint32_t(off);
  off += 16;
  L.smp_off = uint32_t(off);
  off = align16(off + size_t(P) * A * 4);
  L.total = off + 1024;
  return L;
}

__device__ __forceinline__ bool before(float sj, int ij, float s, int i) {
  return sj > s || (sj == s && ij < i);
}

// How many candidates rank before (s, i): the E kept, then the tile's
// rows four at a time.
__device__ __forceinline__ int rank_of(const float* cs, const int* ci,
                                       float s, int i, int E) {
  int r = 0;
  for (int j = 0; j < E; ++j) r += before(cs[j], ci[j], s, i);
#pragma unroll 4
  for (int j = hopper::kRows; j < kCands; j += 4) {
    const float4 s4 = *reinterpret_cast<const float4*>(cs + j);
    const int4 i4 = *reinterpret_cast<const int4*>(ci + j);
    r += before(s4.x, i4.x, s, i) + before(s4.y, i4.y, s, i) +
         before(s4.z, i4.z, s, i) + before(s4.w, i4.w, s, i);
  }
  return r;
}

template <int C, int kH>
__global__ void __launch_bounds__(kWgThreads, 1)
cem_select_wgmma(const __grid_constant__ CUtensorMap tpool,
                 const float* __restrict__ samples, qhead::Params qp,
                 WgLayout lay, float* __restrict__ mean_out,
                 float* __restrict__ std_out,
                 float* __restrict__ best_action_out,
                 float* __restrict__ best_score_out, int P, int A, int E,
                 float min_std, int sigmoid) {
  using L = hopper::Tile<C>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t bars = base + lay.bar_off;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tiles = (P + hopper::kRows - 1) / hopper::kRows;
  float* cs = reinterpret_cast<float*>(smem + lay.cand_off);
  int* ci = reinterpret_cast<int*>(cs + kCands);
  const float* smp = reinterpret_cast<const float*>(smem + lay.smp_off);

  if (tid == 0) {
    for (int s = 0; s < lay.stages; ++s) hopper::mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int t = 0; t < lay.stages && t < tiles; ++t) {
      hopper::mbar_expect_tx(bars + 8 * t, L::kBytes);
      for (int i = 0; i < L::kBoxes; ++i)
        hopper::tma_load_3d(base + lay.pool_off + t * L::kBytes +
                                i * L::kBoxBytes,
                            &tpool, bars + 8 * t, i * L::kBoxCols, b,
                            t * hopper::kRows);
    }
  }
  if (tid < hopper::kRows) {  // no elites kept yet
    cs[tid] = -INFINITY;
    ci[tid] = kEmpty;
  }
  qhead::stage(qp, smem, tid, kWgThreads);  // cp.async group 1
  const float* src = samples + size_t(b) * P * A;
  for (int i = tid; i < P * A; i += kWgThreads)
    hopper::cp_async4(base + lay.smp_off + 4 * i, src + i);
  hopper::cp_async_commit();                // group 2: waited after tile 0
  hopper::cp_async_wait<1>();
  hopper::fence_proxy_async();
  __syncthreads();

  // One candidate per thread: rank it against all, then (after a
  // barrier) keep it in slot `rank` if that is below E.
  const int r0 = warp * 16 + lane / 4;
  for (int t = 0; t < tiles; ++t) {
    const int s = t % lay.stages;
    const int p0 = t * hopper::kRows;
    const uint32_t tile = base + lay.pool_off + s * L::kBytes;
    hopper::mbar_wait(bars + 8 * s, (t / lay.stages) & 1);
    float2 sc = qhead::rows<C, kH>(qp, smem, base, tile, tid);
    if (sigmoid) {
      sc.x = 1.f / (1.f + expf(-sc.x));
      sc.y = 1.f / (1.f + expf(-sc.y));
    }
    if (lane % 4 == 0) {
      const float v[2] = {sc.x, sc.y};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, p = p0 + r;
        cs[hopper::kRows + r] = p < P ? v[h] : -INFINITY;
        ci[hopper::kRows + r] = p < P ? p : kEmpty;
      }
    }
    if (t == 0) hopper::cp_async_wait_all();
    __syncthreads();  // the tile's scores are out; its stage is free
    if (tid == 0 && t + lay.stages < tiles) {
      hopper::mbar_expect_tx(bars + 8 * s, L::kBytes);
      for (int i = 0; i < L::kBoxes; ++i)
        hopper::tma_load_3d(tile + i * L::kBoxBytes, &tpool, bars + 8 * s,
                            i * L::kBoxCols, b,
                            (t + lay.stages) * hopper::kRows);
    }
    const float my_s = cs[tid];
    const int my_i = ci[tid];
    const bool live = my_i != kEmpty && (tid >= hopper::kRows || tid < E);
    const int rank = live ? rank_of(cs, ci, my_s, my_i, E) : kCands;
    __syncthreads();  // every rank is read before any slot is rewritten
    if (rank < E) {
      cs[rank] = my_s;
      ci[rank] = my_i;
    }
  }
  __syncthreads();

  // Elite statistics from the staged samples, summed in rank order.
  for (int a = tid; a < A; a += kWgThreads) {
    float m = 0.f;
#pragma unroll 8
    for (int e = 0; e < E; ++e) m += smp[ci[e] * A + a];
    m /= float(E);
    float var = 0.f;
#pragma unroll 8
    for (int e = 0; e < E; ++e) {
      const float d = smp[ci[e] * A + a] - m;
      var += d * d;
    }
    var /= float(E);
    mean_out[size_t(b) * A + a] = m;
    std_out[size_t(b) * A + a] = fmaxf(sqrtf(var), min_std);
    best_action_out[size_t(b) * A + a] = smp[ci[0] * A + a];
  }
  if (tid == 0) best_score_out[b] = cs[0];
}

template <int C, int kH>
int launch_wgmma_t(const void* pooled, const float* samples,
                   qhead::Params qp, float* mean, float* stdv,
                   float* best_action, float* best_score, int P, int B,
                   int A, int E, float min_std, int sigmoid,
                   size_t planned_smem, cudaStream_t stream) {
  using L = hopper::Tile<C>;
  const WgLayout lay = wg_layout<C>(&qp, P, A);
  if (lay.total != planned_smem || lay.total > size_t(kMaxSmem))
    return int(cudaErrorInvalidValue);
  CUtensorMap map;
  const cuuint64_t dims[3] = {cuuint64_t(C), cuuint64_t(B), cuuint64_t(P)};
  const cuuint64_t strides[2] = {cuuint64_t(C) * 2, cuuint64_t(B) * C * 2};
  const cuuint32_t box[3] = {cuuint32_t(L::kBoxCols), 1,
                             cuuint32_t(hopper::kRows)};
  cudaError_t err = hopper::encode_bf16(&map, pooled, 3, dims, strides, box,
                                        L::kTmaSwizzle);
  if (err != cudaSuccess) return int(err);
  static size_t opted_in = 0;  // per instantiation
  if (lay.total > 48 * 1024 && lay.total > opted_in) {
    err = cudaFuncSetAttribute(cem_select_wgmma<C, kH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(lay.total));
    if (err != cudaSuccess) return int(err);
    opted_in = lay.total;
  }
  cem_select_wgmma<C, kH><<<B, kWgThreads, lay.total, stream>>>(
      map, samples, qp, lay, mean, stdv, best_action, best_score, P, A, E,
      min_std, sigmoid);
  return int(cudaGetLastError());
}

template <int kH>
int launch_wgmma_h(int C, const void* pooled, const float* samples,
                   const qhead::Params& qp, float* mean, float* stdv,
                   float* best_action, float* best_score, int P, int B,
                   int A, int E, float min_std, int sigmoid,
                   size_t planned_smem, cudaStream_t s) {
  switch (C) {
    case 16:
      return launch_wgmma_t<16, kH>(pooled, samples, qp, mean, stdv,
                                    best_action, best_score, P, B, A, E,
                                    min_std, sigmoid, planned_smem, s);
    case 32:
      return launch_wgmma_t<32, kH>(pooled, samples, qp, mean, stdv,
                                    best_action, best_score, P, B, A, E,
                                    min_std, sigmoid, planned_smem, s);
    case 64:
      return launch_wgmma_t<64, kH>(pooled, samples, qp, mean, stdv,
                                    best_action, best_score, P, B, A, E,
                                    min_std, sigmoid, planned_smem, s);
    case 128:
      return launch_wgmma_t<128, kH>(pooled, samples, qp, mean, stdv,
                                     best_action, best_score, P, B, A, E,
                                     min_std, sigmoid, planned_smem, s);
    case 256:
      return launch_wgmma_t<256, kH>(pooled, samples, qp, mean, stdv,
                                     best_action, best_score, P, B, A, E,
                                     min_std, sigmoid, planned_smem, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// Version 2's rule (ops/cem_select.py `_plan` states the same): C a
// power of two 16 .. 256, at least one hidden layer, hidden widths
// multiples of 16 up to 256, E ≤ 64.
int launch_wgmma(const void* pooled, const float* samples,
                 const MlpParams& prm, float* mean, float* stdv,
                 float* best_action, float* best_score, int P, int B, int A,
                 int E, float min_std, int sigmoid, size_t planned_smem,
                 cudaStream_t stream) {
  const int C = prm.dims[0];
  if (prm.n_layers < 2 || E > 64 || (C & (C - 1)) || C < 16 || C > 256)
    return int(cudaErrorInvalidValue);
  qhead::Params qp = {};
  qp.n_layers = prm.n_layers;
  int widest = 0;
  for (int l = 0; l <= prm.n_layers; ++l) qp.dims[l] = prm.dims[l];
  for (int l = 0; l < prm.n_layers; ++l) {
    qp.w[l] = static_cast<const __nv_bfloat16*>(prm.w[l]);
    qp.b[l] = static_cast<const __nv_bfloat16*>(prm.b[l]);
    const int h = prm.dims[l + 1];
    if (l < prm.n_layers - 1) {
      if (h % 16 || h > 256) return int(cudaErrorInvalidValue);
      widest = h > widest ? h : widest;
    }
  }
  return widest <= 64
             ? launch_wgmma_h<64>(C, pooled, samples, qp, mean, stdv,
                                  best_action, best_score, P, B, A, E,
                                  min_std, sigmoid, planned_smem, stream)
             : launch_wgmma_h<256>(C, pooled, samples, qp, mean, stdv,
                                   best_action, best_score, P, B, A, E,
                                   min_std, sigmoid, planned_smem, stream);
}

}  // namespace

extern "C" {

// Launches one CEM select on `stream`; returns cudaGetLastError() (0 ok).
// w / b are host arrays of n_layers device pointers; dims has
// n_layers + 1 entries (dims[0] = C, dims[n_layers] = 1). `path` is
// ops/cem_select.py's choice (1: version 2 on wgmma, bf16 only; 0:
// version 1) and `smem` its shared-memory bytes, which the layout here
// must reproduce (a launch whose layouts disagree is refused).
int t2r_cem_select(const void* pooled, const void* samples, int n_layers,
                   const void* const* w, const void* const* b,
                   const int* dims, void* mean, void* stdv,
                   void* best_action, void* best_score, int P, int B, int A,
                   int E, float min_std, int sigmoid, int is_bf16, int path,
                   size_t smem, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || dims[n_layers] != 1 ||
      E < 1 || E > P || B < 1 || A < 1 || (path && !is_bf16))
    return int(cudaErrorInvalidValue);
  MlpParams prm = {};
  prm.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    prm.w[l] = w[l];
    prm.b[l] = b[l];
  }
  for (int l = 0; l <= n_layers; ++l) prm.dims[l] = dims[l];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* smp = static_cast<const float*>(samples);
  float* m = static_cast<float*>(mean);
  float* sd = static_cast<float*>(stdv);
  float* ba = static_cast<float*>(best_action);
  float* bsc = static_cast<float*>(best_score);
  if (path)
    return launch_wgmma(pooled, smp, prm, m, sd, ba, bsc, P, B, A, E,
                        min_std, sigmoid, smem, s);
  return is_bf16
             ? launch_core<__nv_bfloat16>(pooled, smp, prm, m, sd, ba, bsc,
                                          P, B, A, E, min_std, sigmoid, smem,
                                          s)
             : launch_core<float>(pooled, smp, prm, m, sd, ba, bsc, P, B, A,
                                  E, min_std, sigmoid, smem, s);
}

}  // extern "C"
