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
// min_std.
//
// Design. One CTA per state b. The TPU kernel runs a running top-k over
// sample blocks because its grid is sequential and it never holds all
// scores; here a CTA holds state b's whole population: the q-head
// weights, its P pooled rows (row p lives at (p*B + b)*C), the hidden
// activations and all P scores sit in shared memory, and selection is
// E block-wide argmax passes keyed on (score desc, index asc).
//
// Bound: at the serving and Bellman shapes (P=64, C=H=64, A=4, E=6) the
// work is 2·P·B·(C·H + H·H + H) flops against ~(P·C·sizeof(T) + P·A·4)
// bytes per state, about 8 flops per byte — far below the ~295 the card
// needs to be compute-bound, so device-memory traffic bounds it; at
// small B it is launch-bound. Each pooled byte is read once. The
// products run on CUDA cores in f32 (no tensor cores yet), each thread
// keeping kRows independent sums: simple and exact first, wgmma/TMA
// later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

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
int launch(const void* pooled, const float* samples, const MlpParams& prm,
           float* mean, float* stdv, float* best_action, float* best_score,
           int P, int B, int A, int E, float min_std, int sigmoid,
           cudaStream_t stream) {
  const size_t smem = smem_layout(prm, P, sizeof(T)).total;
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
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

}  // namespace

extern "C" {

// Shared-memory bytes a launch needs (the wrapper refuses > 227 KB).
size_t t2r_cem_select_smem_bytes(int n_layers, const int* dims, int P,
                                 int is_bf16) {
  MlpParams prm = {};
  prm.n_layers = n_layers;
  for (int l = 0; l <= n_layers && l <= kMaxLayers; ++l) prm.dims[l] = dims[l];
  return smem_layout(prm, P, is_bf16 ? 2 : 4).total;
}

// Launches one CEM select on `stream`; returns cudaGetLastError() (0 ok).
// w / b are host arrays of n_layers device pointers; dims has
// n_layers + 1 entries (dims[0] = C, dims[n_layers] = 1).
int t2r_cem_select(const void* pooled, const void* samples, int n_layers,
                   const void* const* w, const void* const* b,
                   const int* dims, void* mean, void* stdv,
                   void* best_action, void* best_score, int P, int B, int A,
                   int E, float min_std, int sigmoid, int is_bf16,
                   void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || dims[n_layers] != 1 ||
      E < 1 || E > P || B < 1 || A < 1)
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
  return is_bf16
             ? launch<__nv_bfloat16>(pooled, smp, prm, m, sd, ba, bsc, P, B,
                                     A, E, min_std, sigmoid, s)
             : launch<float>(pooled, smp, prm, m, sd, ba, bsc, P, B, A, E,
                             min_std, sigmoid, s);
}

}  // extern "C"
