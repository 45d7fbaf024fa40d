// Flash-attention forward for Hopper (sm_90a): exact softmax attention
// with an online softmax, optionally causal, returning out and lse.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// tensor2robot_tpu/ops/flash_attention.py (`_flash_forward_impl`).
// Same contract as that kernel and as its plain version
// `flash_attention_reference` in tensor2robot_tpu_torch/ops/flash_attention.py:
//
//   q, k, v [B, T, H, D]  T (bf16 or f32), read in place through their
//                         batch / time / head strides (last dim dense)
//   → out   [B, T, H, D]  T, dense
//     lse   [B, H, T]     f32
//
// Numerics: s = (q·k)·(1/√D) in f32 (bf16 products are exact in f32);
// causal scores past the diagonal are −1e30 and their p is 0; the
// running max m and normalizer l are f32; p = exp(s − m_new) is rounded
// to T before the PV product, which accumulates in f32 (l sums the
// unrounded p); acc is rescaled by exp(m_old − m_new) per tile; out =
// acc / max(l, 1e-30) in T; lse = m + log(max(l, 1e-30)).
//
// Design. One CTA of 256 threads per (batch·head, 64-row q block); four
// threads per q row. K and V tiles of 64 keys are staged in shared
// memory as f32 (rows padded to D+1 floats so the four lanes of a row
// group and the eight row groups of a warp hit distinct banks). A
// thread computes 16 of its row's 64 scores, the row max and sum go
// over its four lanes by shuffles, and the row's rounded p goes to
// shared memory for the PV product, where each thread owns D/4 output
// columns. Per-row state (m, l, acc) stays in registers. In causal mode
// tiles past the diagonal are never loaded and only the diagonal tile
// (and a ragged last tile) pays for the mask; q blocks are scheduled
// heaviest first. Any T: rows and keys past T are zero-filled, masked
// and not stored (the TPU kernel's power-of-two block rule is a Mosaic
// limit and is not carried over).
//
// Bound: at the serving shape (B=1, T=512, H=4, D=32, bf16, causal) the
// work is 2·B·H·T²·D ≈ 67 MFLOP against ≈ 0.53 MB moved, ~126 FLOP per
// byte — below the ~295 the card needs to be compute-bound, so the
// bound is the bytes (≈ 0.16 µs), far under the launch cost. The
// products run on CUDA cores in f32 from shared memory (no tensor
// cores yet), so this version is bound by shared-memory loads: simple
// and exact first, mma/wgmma and TMA later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;                     // q rows per CTA
constexpr int kBlockN = 64;                     // keys per K/V tile
constexpr int kLanes = 4;                       // threads per q row
constexpr int kThreads = kBlockM * kLanes;      // 256
constexpr int kKeysPerLane = kBlockN / kLanes;  // 16
constexpr int kPStride = kBlockN + 4;           // conflict-free p rows
constexpr float kNegInf = -1e30f;               // the TPU kernel's sentinel

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

struct Strides {
  long long b, t, h;  // element strides of the batch, time and head dims
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kBlockM) * (D + 1) + size_t(kBlockN) * (D + 1)
                          + size_t(kBlockN) * D + size_t(kBlockM) * kPStride);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int num_heads, int seq_len,
                 Strides qs, Strides ks, Strides vs, float scale,
                 int causal) {
  static_assert(D % 32 == 0, "bank mapping assumes D % 32 == 0");
  constexpr int kCols = D / kLanes;  // output columns per thread
  extern __shared__ float smem[];
  float* q_tile = smem;                             // [kBlockM][D + 1]
  float* k_tile = q_tile + kBlockM * (D + 1);       // [kBlockN][D + 1]
  float* v_tile = k_tile + kBlockN * (D + 1);       // [kBlockN][D]
  float* p_tile = v_tile + kBlockN * D;             // [kBlockM][kPStride]

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal blocks first
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int tid = threadIdx.x;
  const int r = tid / kLanes;  // this thread's q row in the block
  const int c = tid % kLanes;  // its lane in the row's group of four
  const int row = qb * kBlockM + r;

  const T* q_bh = q + b * qs.b + h * qs.h;
  const T* k_bh = k + b * ks.b + h * ks.h;
  const T* v_bh = v + b * vs.b + h * vs.h;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int t = qb * kBlockM + rr;
    q_tile[rr * (D + 1) + d] = t < seq_len ? to_f32(q_bh[t * qs.t + d]) : 0.f;
  }

  float m = kNegInf;
  float l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) acc[e] = 0.f;

  const int num_tiles = (seq_len + kBlockN - 1) / kBlockN;
  const int last_tile = causal ? min(num_tiles - 1, qb) : num_tiles - 1;
  const float* q_row = q_tile + r * (D + 1);
  float* p_row = p_tile + r * kPStride;

  for (int j = 0; j <= last_tile; ++j) {
    __syncthreads();  // the Q tile is staged; the last tile's reads are done
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int rr = i / D, d = i % D;
      const int t = j * kBlockN + rr;
      const bool in_range = t < seq_len;
      k_tile[rr * (D + 1) + d] = in_range ? to_f32(k_bh[t * ks.t + d]) : 0.f;
      v_tile[rr * D + d] = in_range ? to_f32(v_bh[t * vs.t + d]) : 0.f;
    }
    __syncthreads();

    // Scores of keys c, c+4, ..., c+60 of this tile for this row.
    float s[kKeysPerLane];
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = q_row[d];
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        s[i] = fmaf(qd, k_tile[(c + kLanes * i) * (D + 1) + d], s[i]);
      }
    }
    // Only the diagonal tile and a ragged last tile need the mask.
    const bool masked = (causal && j == qb) || (j + 1) * kBlockN > seq_len;
    float tile_max = kNegInf;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      s[i] *= scale;
      if (masked) {
        const int col = j * kBlockN + c + kLanes * i;
        if (col >= seq_len || (causal && col > row)) s[i] = kNegInf;
      }
      tile_max = fmaxf(tile_max, s[i]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);

    float row_sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      float p = expf(s[i] - m_new);
      if (masked) {
        const int col = j * kBlockN + c + kLanes * i;
        if (col >= seq_len || (causal && col > row)) p = 0.f;
      }
      row_sum += p;
      p_row[c + kLanes * i] = to_f32(from_f32<T>(p));  // p in v's dtype
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    const float alpha = expf(m - m_new);
    l = alpha * l + row_sum;
    m = m_new;
    __syncwarp();  // the row's four lanes share one warp

    float pv[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) pv[e] = 0.f;
#pragma unroll 4
    for (int jj = 0; jj < kBlockN; ++jj) {
      const float p = p_row[jj];
      const float* v_row = v_tile + jj * D + c;
#pragma unroll
      for (int e = 0; e < kCols; ++e) pv[e] = fmaf(p, v_row[kLanes * e], pv[e]);
    }
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[e] = alpha * acc[e] + pv[e];
  }

  if (row < seq_len) {
    const float l_final = fmaxf(l, 1e-30f);
    T* out_row = out + (((long long)b * seq_len + row) * num_heads + h) * D;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      out_row[c + kLanes * e] = from_f32<T>(acc[e] / l_final);
    }
    if (c == 0) lse[(long long)bh * seq_len + row] = m + logf(l_final);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int batch, int seq_len, int num_heads, Strides qs, Strides ks,
           Strides vs, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();  // 42 / 66 / 114 KB at D=32/64/128
  static bool opted_in = false;  // per <T, D>; only above the 48 KB default
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
    opted_in = true;
  }
  dim3 grid((seq_len + kBlockM - 1) / kBlockM, batch * num_heads);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), num_heads, seq_len, qs, ks, vs, scale,
      causal);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_d(int head_dim, const void* q, const void* k, const void* v,
               void* out, void* lse, int batch, int seq_len, int num_heads,
               Strides qs, Strides ks, Strides vs, int causal, float scale,
               cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, batch, seq_len, num_heads, qs,
                           ks, vs, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, batch, seq_len, num_heads, qs,
                           ks, vs, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, batch, seq_len, num_heads, qs,
                            ks, vs, causal, scale, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the forward on `stream`; returns the CUDA error code (0 = ok).
// Strides are in elements; out must be a dense [B, T, H, D] buffer and
// lse a dense [B, H, T] f32 buffer.
int t2r_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* out, void* lse, int batch, int seq_len,
                            int num_heads, int head_dim, long long q_sb,
                            long long q_st, long long q_sh, long long k_sb,
                            long long k_st, long long k_sh, long long v_sb,
                            long long v_st, long long v_sh, int causal,
                            int is_bf16, float scale, void* stream) {
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch_d<__nv_bfloat16>(head_dim, q, k, v, out, lse, batch,
                                     seq_len, num_heads, qs, ks, vs, causal,
                                     scale, s);
  }
  return dispatch_d<float>(head_dim, q, k, v, out, lse, batch, seq_len,
                           num_heads, qs, ks, vs, causal, scale, s);
}

}  // extern "C"
