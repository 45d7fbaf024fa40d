// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ of exact
// softmax attention, recomputing the probabilities from the forward's
// logsumexp; optionally causal.
//
// Replaces the Pallas TPU kernels `_dkdv_kernel` and `_dq_kernel` of
// tensor2robot_tpu/ops/flash_attention.py (`_flash_bwd_impl`). Same
// contract as those kernels and as their plain version
// `flash_attention_backward_reference` in
// tensor2robot_tpu_torch/ops/flash_attention.py:
//
//   q, k, v, dO [B, T, H, D]  T (bf16 or f32), read in place through
//                             their batch / time / head / dim strides
//   lse, delta  [B, H, T]     f32, dense; delta = rowsum(dO·O) − dlse
//   → dk, dv    [B, T, H, D]  T, dense   (t2r_flash_attention_bwd_dkdv)
//     dq        [B, T, H, D]  T, dense   (t2r_flash_attention_bwd_dq)
//
// Numerics, as the Pallas kernels: s = (q·k)·(1/√D) in f32; p = exp(s −
// lse), and 0 for causal scores past the diagonal (the Pallas kernels'
// −1e30 sentinel gives the same 0);
// dp = dO·v in f32; ds = p·(dp − delta)·(1/√D). p is rounded to dO's
// dtype before dv += pᵀ·dO, ds to q's dtype before dk += dsᵀ·q and to
// k's dtype before dq += ds·k; every product accumulates in f32, and the
// gradients are rounded to T once, when stored. No atomics: each output
// element is owned by one thread, so the result is deterministic.
//
// Design. Both kernels follow the forward's layout (flash_attention.cu):
// 256-thread CTAs over 64-row tiles, four threads per row, tiles staged
// in shared memory as f32 with rows padded to D+1 floats (the four lanes
// of a row group and the eight row groups of a warp hit distinct banks),
// and a row's 64 p / ds values exchanged through a padded shared row
// inside one warp (`__syncwarp`, no block barrier).
//   dK/dV: one CTA per (batch·head, 64-key block). Its K and V tiles are
//     staged once; it walks the q tiles (in causal mode from the
//     diagonal to the end), staging q, dO, lse and delta per tile. A
//     thread computes s and dp of its key row against 16 of the tile's
//     64 q rows, and accumulates D/4 columns of its key row's dk and dv
//     in registers over all 64 rows.
//   dQ: one CTA per (batch·head, 64-row q block), heaviest causal blocks
//     first. Its q, dO, lse and delta are staged once; it walks the key
//     tiles up to the diagonal. A thread computes 16 of its row's 64 ds
//     values per tile and accumulates D/4 columns of its row's dq.
// Only the causal diagonal tile and a ragged last tile pay for the mask.
// Any T: rows and keys past T are zero-filled, masked and not stored.
//
// Bound: at the training shape (B=16, T=32, H=4, D=32, bf16, causal) the
// work is ~8·B·H·T²·D/2 ≈ 8.4 MFLOP (dK/dV) against ≈ 0.8 MB moved, so
// both kernels are bound by bytes (≈ 0.2 µs), far under the launch
// cost: each (b·h) is one 32×32 tile, one CTA's whole problem. The
// products run on CUDA cores in f32 from shared memory (no tensor cores
// yet): simple and exact first, mma/wgmma and TMA later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;                      // rows (q or keys) per tile
constexpr int kLanes = 4;                       // threads per row
constexpr int kThreads = kBlock * kLanes;       // 256
constexpr int kPerLane = kBlock / kLanes;       // 16 partner rows per lane
constexpr int kPStride = kBlock + 4;            // conflict-free p/ds rows

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
// x rounded to T and back: the cast the Pallas kernels make before a product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

struct Strides {
  long long b, t, h, d;  // element strides of the batch, time, head, dim
};

// Stages rows [row0, row0 + kBlock) of one (b, h) slice of x into a
// [kBlock][D + 1] f32 tile; rows past seq_len are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* tile, const T* __restrict__ x,
                                      Strides s, int row0, int seq_len) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int t = row0 + rr;
    tile[rr * (D + 1) + d] = t < seq_len ? to_f32(x[t * s.t + d * s.d]) : 0.f;
  }
}

// Stages the f32 lse and delta of rows [row0, row0 + kBlock); zero past T.
__device__ __forceinline__ void stage_rows(float* lse_tile, float* delta_tile,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int row0, int seq_len) {
  for (int i = threadIdx.x; i < kBlock; i += kThreads) {
    const int t = row0 + i;
    lse_tile[i] = t < seq_len ? lse[t] : 0.f;
    delta_tile[i] = t < seq_len ? delta[t] : 0.f;
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (4 * size_t(kBlock) * (D + 1)
                          + 2 * size_t(kBlock) * kPStride + 2 * kBlock);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * size_t(kBlock) * (D + 1)
                          + size_t(kBlock) * kPStride + 2 * kBlock);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int num_heads, int seq_len,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      float scale, int causal) {
  static_assert(D % 32 == 0, "bank mapping assumes D % 32 == 0");
  constexpr int kCols = D / kLanes;  // dk / dv columns per thread
  extern __shared__ float smem[];
  float* k_tile = smem;                          // [kBlock][D + 1]
  float* v_tile = k_tile + kBlock * (D + 1);     // [kBlock][D + 1]
  float* q_tile = v_tile + kBlock * (D + 1);     // [kBlock][D + 1]
  float* o_tile = q_tile + kBlock * (D + 1);     // dO, [kBlock][D + 1]
  float* p_tile = o_tile + kBlock * (D + 1);     // [kBlock keys][kPStride]
  float* ds_tile = p_tile + kBlock * kPStride;   // [kBlock keys][kPStride]
  float* lse_tile = ds_tile + kBlock * kPStride; // [kBlock]
  float* delta_tile = lse_tile + kBlock;         // [kBlock]

  const int kb = blockIdx.x;  // key block; block 0 has the most causal work
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int tid = threadIdx.x;
  const int c = tid / kLanes;  // this thread's key row in the block
  const int lane = tid % kLanes;
  const int key = kb * kBlock + c;

  const T* q_bh = q + b * qs.b + h * qs.h;
  const T* o_bh = dout + b * os.b + h * os.h;
  const float* lse_bh = lse + (long long)bh * seq_len;
  const float* delta_bh = delta + (long long)bh * seq_len;

  stage<T, D>(k_tile, k + b * ks.b + h * ks.h, ks, kb * kBlock, seq_len);
  stage<T, D>(v_tile, v + b * vs.b + h * vs.h, vs, kb * kBlock, seq_len);

  float dk_acc[kCols], dv_acc[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  const float* k_row = k_tile + c * (D + 1);
  const float* v_row = v_tile + c * (D + 1);
  float* p_row = p_tile + c * kPStride;
  float* ds_row = ds_tile + c * kPStride;
  const int num_tiles = (seq_len + kBlock - 1) / kBlock;

  for (int i = causal ? kb : 0; i < num_tiles; ++i) {
    __syncthreads();  // K/V are staged; the last q tile's reads are done
    stage<T, D>(q_tile, q_bh, qs, i * kBlock, seq_len);
    stage<T, D>(o_tile, o_bh, os, i * kBlock, seq_len);
    stage_rows(lse_tile, delta_tile, lse_bh, delta_bh, i * kBlock, seq_len);
    __syncthreads();

    // s and dp of this key row against q rows lane, lane+4, ..., lane+60.
    float s[kPerLane], dp[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = k_row[d], vd = v_row[d];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int r = (lane + kLanes * j) * (D + 1) + d;
        s[j] = fmaf(q_tile[r], kd, s[j]);
        dp[j] = fmaf(o_tile[r], vd, dp[j]);
      }
    }
    const bool masked = (causal && i == kb) || (i + 1) * kBlock > seq_len;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int rr = lane + kLanes * j;
      float p = expf(s[j] * scale - lse_tile[rr]);
      if (masked) {
        const int row = i * kBlock + rr;
        if (row >= seq_len || key >= seq_len || (causal && key > row)) p = 0.f;
      }
      const float ds = p * (dp[j] - delta_tile[rr]) * scale;
      p_row[rr] = round_to<T>(p);    // p in dO's dtype
      ds_row[rr] = round_to<T>(ds);  // ds in q's dtype
    }
    __syncwarp();  // the key row's four lanes share one warp

#pragma unroll 4
    for (int rr = 0; rr < kBlock; ++rr) {
      const float p = p_row[rr], ds = ds_row[rr];
      const float* q_r = q_tile + rr * (D + 1) + lane;
      const float* o_r = o_tile + rr * (D + 1) + lane;
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        dv_acc[e] = fmaf(p, o_r[kLanes * e], dv_acc[e]);
        dk_acc[e] = fmaf(ds, q_r[kLanes * e], dk_acc[e]);
      }
    }
  }

  if (key < seq_len) {
    const long long off = (((long long)b * seq_len + key) * num_heads + h) * D;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      dk[off + lane + kLanes * e] = from_f32<T>(dk_acc[e]);
      dv[off + lane + kLanes * e] = from_f32<T>(dv_acc[e]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int num_heads, int seq_len, Strides qs, Strides ks,
                    Strides vs, Strides os, float scale, int causal) {
  static_assert(D % 32 == 0, "bank mapping assumes D % 32 == 0");
  constexpr int kCols = D / kLanes;  // dq columns per thread
  extern __shared__ float smem[];
  float* q_tile = smem;                          // [kBlock][D + 1]
  float* o_tile = q_tile + kBlock * (D + 1);     // dO, [kBlock][D + 1]
  float* k_tile = o_tile + kBlock * (D + 1);     // [kBlock][D + 1]
  float* v_tile = k_tile + kBlock * (D + 1);     // [kBlock][D + 1]
  float* ds_tile = v_tile + kBlock * (D + 1);    // [kBlock rows][kPStride]
  float* lse_tile = ds_tile + kBlock * kPStride; // [kBlock]
  float* delta_tile = lse_tile + kBlock;         // [kBlock]

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal blocks first
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int tid = threadIdx.x;
  const int r = tid / kLanes;  // this thread's q row in the block
  const int lane = tid % kLanes;
  const int row = qb * kBlock + r;

  const T* k_bh = k + b * ks.b + h * ks.h;
  const T* v_bh = v + b * vs.b + h * vs.h;

  stage<T, D>(q_tile, q + b * qs.b + h * qs.h, qs, qb * kBlock, seq_len);
  stage<T, D>(o_tile, dout + b * os.b + h * os.h, os, qb * kBlock, seq_len);
  stage_rows(lse_tile, delta_tile, lse + (long long)bh * seq_len,
             delta + (long long)bh * seq_len, qb * kBlock, seq_len);

  float dq_acc[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) dq_acc[e] = 0.f;

  const float* q_row = q_tile + r * (D + 1);
  const float* o_row = o_tile + r * (D + 1);
  float* ds_row = ds_tile + r * kPStride;
  const int num_tiles = (seq_len + kBlock - 1) / kBlock;
  const int last_tile = causal ? min(num_tiles - 1, qb) : num_tiles - 1;

  for (int j = 0; j <= last_tile; ++j) {
    __syncthreads();  // q/dO are staged; the last tile's reads are done
    stage<T, D>(k_tile, k_bh, ks, j * kBlock, seq_len);
    stage<T, D>(v_tile, v_bh, vs, j * kBlock, seq_len);
    __syncthreads();
    const float row_lse = lse_tile[r], row_delta = delta_tile[r];

    // s and dp of this row against keys lane, lane+4, ..., lane+60.
    float s[kPerLane], dp[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = q_row[d], od = o_row[d];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int kk = (lane + kLanes * i) * (D + 1) + d;
        s[i] = fmaf(qd, k_tile[kk], s[i]);
        dp[i] = fmaf(od, v_tile[kk], dp[i]);
      }
    }
    const bool masked = (causal && j == qb) || (j + 1) * kBlock > seq_len;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int col = j * kBlock + lane + kLanes * i;
      float p = expf(s[i] * scale - row_lse);
      if (masked && (col >= seq_len || row >= seq_len || (causal && col > row)))
        p = 0.f;
      ds_row[lane + kLanes * i] = round_to<T>(p * (dp[i] - row_delta) * scale);
    }
    __syncwarp();  // the row's four lanes share one warp

#pragma unroll 4
    for (int kk = 0; kk < kBlock; ++kk) {
      const float ds = ds_row[kk];  // in k's dtype
      const float* k_r = k_tile + kk * (D + 1) + lane;
#pragma unroll
      for (int e = 0; e < kCols; ++e) dq_acc[e] = fmaf(ds, k_r[kLanes * e], dq_acc[e]);
    }
  }

  if (row < seq_len) {
    T* dq_row = dq + (((long long)b * seq_len + row) * num_heads + h) * D;
#pragma unroll
    for (int e = 0; e < kCols; ++e) dq_row[lane + kLanes * e] = from_f32<T>(dq_acc[e]);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dk, *dv, *dq;
  int batch, seq_len, num_heads;
  Strides qs, ks, vs, os;
  float scale;
  int causal;
};

// Opts a kernel in to more than the default 48 KB of dynamic shared
// memory, once per instantiation.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, bool* done) {
  if (smem <= 48 * 1024 || *done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess) *done = true;
  return err;
}

template <typename T, int D>
int launch_dkdv(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<D>();  // 68 / 100 / 164 KB
  static bool opted_in = false;
  const cudaError_t err = opt_in(flash_bwd_dkdv_kernel<T, D>, smem, &opted_in);
  if (err != cudaSuccess) return int(err);
  dim3 grid((a.seq_len + kBlock - 1) / kBlock, a.batch * a.num_heads);
  flash_bwd_dkdv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.num_heads,
      a.seq_len, a.qs, a.ks, a.vs, a.os, a.scale, a.causal);
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();  // 51 / 84 / 147 KB
  static bool opted_in = false;
  const cudaError_t err = opt_in(flash_bwd_dq_kernel<T, D>, smem, &opted_in);
  if (err != cudaSuccess) return int(err);
  dim3 grid((a.seq_len + kBlock - 1) / kBlock, a.batch * a.num_heads);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.num_heads, a.seq_len, a.qs, a.ks,
      a.vs, a.os, a.scale, a.causal);
  return int(cudaGetLastError());
}

template <typename T, bool kDkDv>
int dispatch_d(int head_dim, const Args& a, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return kDkDv ? launch_dkdv<T, 32>(a, stream) : launch_dq<T, 32>(a, stream);
    case 64:
      return kDkDv ? launch_dkdv<T, 64>(a, stream) : launch_dq<T, 64>(a, stream);
    case 128:
      return kDkDv ? launch_dkdv<T, 128>(a, stream)
                   : launch_dq<T, 128>(a, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               void* dq, int batch, int seq_len, int num_heads,
               const long long* strides, int causal, float scale) {
  const long long* s = strides;  // q, k, v, dO: (b, t, h, d) each
  return Args{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), dk, dv, dq, batch, seq_len,
              num_heads, Strides{s[0], s[1], s[2], s[3]},
              Strides{s[4], s[5], s[6], s[7]},
              Strides{s[8], s[9], s[10], s[11]},
              Strides{s[12], s[13], s[14], s[15]}, scale, causal};
}

}  // namespace

extern "C" {

// Both entries launch on `stream` and return the CUDA error code (0 =
// ok). `strides` holds 16 element strides: (batch, time, head, dim) of
// q, k, v and dO in that order. lse and delta are dense [B, H, T] f32;
// the outputs are dense [B, T, H, D] buffers in the inputs' dtype.

int t2r_flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int batch, int seq_len, int num_heads,
                                 int head_dim, const long long* strides,
                                 int causal, int is_bf16, float scale,
                                 void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dk, dv, nullptr, batch,
                           seq_len, num_heads, strides, causal, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<__nv_bfloat16, true>(head_dim, a, s)
                 : dispatch_d<float, true>(head_dim, a, s);
}

int t2r_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int batch,
                               int seq_len, int num_heads, int head_dim,
                               const long long* strides, int causal,
                               int is_bf16, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, nullptr, nullptr, dq,
                           batch, seq_len, num_heads, strides, causal, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<__nv_bfloat16, false>(head_dim, a, s)
                 : dispatch_d<float, false>(head_dim, a, s);
}

}  // extern "C"
