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
//                             their strides (bf16: the last dim dense)
//   lse, delta  [B, H, T]     f32, dense; delta = rowsum(dO·O) − dlse
//   → dk, dv    [B, T, H, D]  T, dense   (t2r_flash_attention_bwd_dkdv)
//     dq        [B, T, H, D]  T, dense   (t2r_flash_attention_bwd_dq)
//
// D ∈ {16, 32, 64, 128}, any T. Numerics, as the Pallas kernels: s =
// (q·k)·(1/√D) in f32; p = exp(s − lse), and 0 for causal scores past the
// diagonal (the Pallas kernels' −1e30 sentinel gives the same 0); dp =
// dO·v in f32; ds = p·(dp − delta)·(1/√D). p is rounded to dO's dtype
// before dv += pᵀ·dO, ds to q's dtype before dk += dsᵀ·q and to k's dtype
// before dq += ds·k; every product accumulates in f32, and the gradients
// are rounded to T once, when stored. No atomics: each output element
// has one owner, so the result is deterministic.
//
// Bound: at the training shape (B=16, T=32, H=4, D=32, bf16, causal) the
// work is ~8·B·H·T²·D/2 ≈ 8.4 MFLOP (dK/dV) against ≈ 0.8 MB moved, so
// both kernels are bound by bytes (≈ 0.2 µs), far under a launch: each
// (b·h) is one 32-row tile, one CTA's whole problem. What a call costs is
// the latency chain of one CTA: loads, two products, the elementwise
// step, two products, the stores.
//
// The bf16 kernels, one warpgroup (128 threads) per CTA, on hopper.cuh,
// shorten that chain: products on tensor cores, loads by TMA ahead of use,
// p and ds kept in registers:
//  - dK/dV: one CTA per (b·h, 64-key block), block 0 (the most causal
//    work) first. K and V come in once by TMA; the CTA walks the q tiles
//    (in causal mode from the diagonal) through a ring of (Q, dO) stages,
//    one mbarrier each, loaded ahead by TMA; the tile's lse·log2(e) and δ
//    rows are fetched into registers one tile ahead and parked in shared
//    memory beside the stage. Per tile, Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are
//    `wgmma` from shared memory (M = 64 keys, N = the tile's q rows, K =
//    D); Pᵀ = exp2(Sᵀ·scale·log2(e) − lse·log2(e)) and dSᵀ = Pᵀ·(dPᵀ − δ)·
//    scale run on the accumulators (lse and δ indexed by column), are
//    rounded to bf16 in registers and become the register A operands of
//    dV += Pᵀ·dO and dK += dSᵀ·Q, whose dO and Q are read from the same
//    tiles through MN-major descriptors. At D=128 the q tile goes in two
//    halves of 32 rows, so Sᵀ, dPᵀ and the dK, dV accumulators fit in
//    registers without spilling.
//  - dQ: one CTA per (b·h, 64-row q block), heaviest causal blocks first.
//    Q and dO come in once, each thread's lse and δ rows into registers;
//    the CTA walks the key tiles up to the diagonal through a ring of
//    (K, V) stages. S = Q·Kᵀ and dP = dO·Vᵀ by `wgmma` from shared memory;
//    dS, rounded to bf16 in registers, is the A operand of dQ += dS·K with
//    K read MN-major.
//  - Only the causal diagonal tile and a ragged last tile pay for the
//    mask; rows past T come in as zeros and are not stored; the
//    gradients leave through shared memory as 16-byte rows.
// f32 keeps the CUDA-core kernels (tensor cores would compute its
// products in TF32 and break the f32 contract): 256-thread CTAs over
// 64-row tiles, four threads per row, tiles staged as f32 with rows
// padded to D+1 floats, and a row's 64 p / ds values exchanged through a
// padded shared row inside one warp.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

struct Strides {
  long long b, t, h, d;  // element strides of the batch, time, head, dim
};

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

// ---- f32: CUDA cores ----

constexpr int kBlock = 64;                      // rows (q or keys) per tile
constexpr int kLanes = 4;                       // threads per row
constexpr int kThreads = kBlock * kLanes;       // 256
constexpr int kPerLane = kBlock / kLanes;       // 16 partner rows per lane
constexpr int kPStride = kBlock + 4;            // conflict-free p/ds rows

// Stages rows [row0, row0 + kBlock) of one (b, h) slice of x into a
// [kBlock][D + 1] tile; rows past seq_len are zero.
template <int D>
__device__ __forceinline__ void stage(float* tile, const float* __restrict__ x,
                                      Strides s, int row0, int seq_len) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int t = row0 + rr;
    tile[rr * (D + 1) + d] = t < seq_len ? x[t * s.t + d * s.d] : 0.f;
  }
}

// Stages the lse and delta of rows [row0, row0 + kBlock); zero past T.
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

// Banks (both f32 kernels): a warp's eight row groups read their own rows
// at stride D+1, its four lanes their partner rows lane, lane+4, ... at
// stride D+1, and the p / ds rows at stride kPStride; D+1 is odd for every
// D taken (16, 32, 64, 128), so each set hits distinct banks.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int num_heads, int seq_len,
                   Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal) {
  static_assert(D % 2 == 0 && D % kLanes == 0, "lane and bank mapping");
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

  const float* q_bh = q + b * qs.b + h * qs.h;
  const float* o_bh = dout + b * os.b + h * os.h;
  const float* lse_bh = lse + (long long)bh * seq_len;
  const float* delta_bh = delta + (long long)bh * seq_len;

  stage<D>(k_tile, k + b * ks.b + h * ks.h, ks, kb * kBlock, seq_len);
  stage<D>(v_tile, v + b * vs.b + h * vs.h, vs, kb * kBlock, seq_len);

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
    stage<D>(q_tile, q_bh, qs, i * kBlock, seq_len);
    stage<D>(o_tile, o_bh, os, i * kBlock, seq_len);
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
      p_row[rr] = p;
      ds_row[rr] = p * (dp[j] - delta_tile[rr]) * scale;
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
      dk[off + lane + kLanes * e] = dk_acc[e];
      dv[off + lane + kLanes * e] = dv_acc[e];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int num_heads, int seq_len, Strides qs, Strides ks,
                 Strides vs, Strides os, float scale, int causal) {
  static_assert(D % 2 == 0 && D % kLanes == 0, "lane and bank mapping");
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

  const float* k_bh = k + b * ks.b + h * ks.h;
  const float* v_bh = v + b * vs.b + h * vs.h;

  stage<D>(q_tile, q + b * qs.b + h * qs.h, qs, qb * kBlock, seq_len);
  stage<D>(o_tile, dout + b * os.b + h * os.h, os, qb * kBlock, seq_len);
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
    stage<D>(k_tile, k_bh, ks, j * kBlock, seq_len);
    stage<D>(v_tile, v_bh, vs, j * kBlock, seq_len);
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
      ds_row[lane + kLanes * i] = p * (dp[i] - row_delta) * scale;
    }
    __syncwarp();  // the row's four lanes share one warp

#pragma unroll 4
    for (int kk = 0; kk < kBlock; ++kk) {
      const float ds = ds_row[kk];
      const float* k_r = k_tile + kk * (D + 1) + lane;
#pragma unroll
      for (int e = 0; e < kCols; ++e) dq_acc[e] = fmaf(ds, k_r[kLanes * e], dq_acc[e]);
    }
  }

  if (row < seq_len) {
    float* dq_row = dq + (((long long)b * seq_len + row) * num_heads + h) * D;
#pragma unroll
    for (int e = 0; e < kCols; ++e) dq_row[lane + kLanes * e] = dq_acc[e];
  }
}

template <int D>
int launch_dkdv_f32(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<D>();  // 52 / 68 / 100 / 164 KB
  static bool opted_in = false;
  const cudaError_t err = opt_in(flash_bwd_dkdv_f32<D>, smem, &opted_in);
  if (err != cudaSuccess) return int(err);
  dim3 grid((a.seq_len + kBlock - 1) / kBlock, a.batch * a.num_heads);
  flash_bwd_dkdv_f32<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.num_heads, a.seq_len, a.qs, a.ks, a.vs, a.os, a.scale, a.causal);
  return int(cudaGetLastError());
}

template <int D>
int launch_dq_f32(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();  // 35 / 51 / 84 / 147 KB
  static bool opted_in = false;
  const cudaError_t err = opt_in(flash_bwd_dq_f32<D>, smem, &opted_in);
  if (err != cudaSuccess) return int(err);
  dim3 grid((a.seq_len + kBlock - 1) / kBlock, a.batch * a.num_heads);
  flash_bwd_dq_f32<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.num_heads, a.seq_len,
      a.qs, a.ks, a.vs, a.os, a.scale, a.causal);
  return int(cudaGetLastError());
}

// ---- bf16: tensor cores (wgmma) fed by TMA (hopper.cuh) ----

using namespace hopper;

constexpr int kWgThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr int kStages = D > 64 ? 2 : 4;  // depth of the (Q, dO) or (K, V) ring
// dK/dV: q rows per pass over a q tile (two passes at D=128, for registers).
template <int D>
constexpr int kPassRows = D > 64 ? 32 : 64;

// Shared memory, 1 KB of alignment first. dK/dV: K, V, the ring of (Q, dO)
// stages, each stage's lse·log2(e) and δ rows ([2][64] f32), mbarriers
// ([0] K/V, [1 + s] stage s). dQ: Q, dO, the ring of (K, V) stages,
// mbarriers ([0] Q/dO, [1 + s] stage s).
template <int D>
constexpr size_t kDkdvSmem = 1024
                             + size_t(2 + 2 * kStages<D>) * Tile<D>::kBytes
                             + size_t(kStages<D>) * 2 * kRows * sizeof(float)
                             + 8 * (1 + kStages<D>);
template <int D>
constexpr size_t kDqSmem = 1024 + size_t(2 + 2 * kStages<D>) * Tile<D>::kBytes
                           + 8 * (1 + kStages<D>);

// Thread 0 sets up 1 + S mbarriers and makes them visible to the async
// proxy; the block waits for it.
__device__ __forceinline__ void init_barriers(uint32_t bars, int count) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < count; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Two rows' tiles (first then second) of rows t0 .. t0+63 on barrier `bar`.
template <int D>
__device__ __forceinline__ void load_pair(uint32_t dst, const CUtensorMap* first,
                                          const CUtensorMap* second,
                                          uint32_t bar, int h, int t0, int b) {
  mbar_expect_tx(bar, 2 * Tile<D>::kBytes);
  load_tile<D>(dst, first, bar, h, t0, b);
  load_tile<D>(dst + Tile<D>::kBytes, second, bar, h, t0, b);
}

// One CTA = one warpgroup per (batch·head, 64-key block). Thread 0 issues
// every TMA load. Warp w owns key rows 16w .. 16w+15; lane l holds key
// rows r0 = 16w + l/4 and r0 + 8 and, of each pass's Sᵀ / dPᵀ, q columns
// 2(l%4) and +1 of every group of 8.
template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int num_heads,
                    int seq_len, float scale, float scale_log2, int causal) {
  using L = Tile<D>;
  constexpr int S = kStages<D>;
  constexpr int N = kPassRows<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t k_s = smem_addr(smem);            // K, then dK
  const uint32_t v_s = k_s + L::kBytes;            // V, then dV
  const uint32_t ring = v_s + L::kBytes;           // stage s: Q, then dO
  float* terms = reinterpret_cast<float*>(smem + (2 + 2 * S) * L::kBytes);
  const uint32_t bars = smem_addr(terms + S * 2 * kRows);

  const int kb = blockIdx.x;  // key block; block 0 has the most causal work
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int tid = threadIdx.x;
  const int num_tiles = (seq_len + kRows - 1) / kRows;
  const int first = causal ? kb : 0;   // the first q tile with live scores
  const int count = num_tiles - first;
  const float* lse_bh = lse + (long long)bh * seq_len;
  const float* delta_bh = delta + (long long)bh * seq_len;
  // This thread's share of a q tile's row terms: lse·log2(e) of row tid
  // (threads 0 .. 63) or δ of row tid − 64; 0 past T. Stage s keeps them
  // at terms[128·s + tid].
  auto row_term = [&](int tile) {
    const int t = tile * kRows + tid % kRows;
    if (t >= seq_len) return 0.f;
    return tid < kRows ? lse_bh[t] * kLog2e : delta_bh[t];
  };

  init_barriers(bars, 1 + S);
  if (tid == 0) {
    load_pair<D>(k_s, &tk, &tv, bars, h, kb * kRows, b);
    for (int j = 0; j < S && j < count; ++j) {
      load_pair<D>(ring + 2 * j * L::kBytes, &tq, &tdo, bars + 8 * (1 + j), h,
                   (first + j) * kRows, b);
    }
  }
  for (int j = 0; j < S && j < count; ++j) {
    terms[2 * kRows * j + tid] = row_term(first + j);
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int key[2] = {kb * kRows + r0, kb * kRows + r0 + 8};
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(bars, 0);
  for (int j = 0; j < count; ++j) {
    const int it = first + j;  // the q tile
    const int s = j % S;
    const uint32_t q_s = ring + 2 * s * L::kBytes;
    const uint32_t do_s = q_s + L::kBytes;
    const float* lse_t = terms + 2 * kRows * s;  // lse·log2(e), then δ
    // The row terms of tile it + S, in flight through this tile's work.
    const float next_term = j + S < count ? row_term(it + S) : 0.f;
    const bool masked = (causal && it == kb) || (it + 1) * kRows > seq_len;
    mbar_wait(bars + 8 * (1 + s), (j / S) & 1);

#pragma unroll
    for (int pass = 0; pass < kRows / N; ++pass) {
      const int q0 = pass * N;  // the pass's first q row in the tile
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: M = 64 keys, N q rows, both K-major.
      float st[N / 2], dpt[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) st[i] = dpt[i] = 0.f;
      pin(st);
      pin(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<N>(st, L::k_major(k_s, kk),
                    L::k_major(q_s + q0 * L::kRowBytes, kk));
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<N>(dpt, L::k_major(v_s, kk),
                    L::k_major(do_s + q0 * L::kRowBytes, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(st);
      pin(dpt);

      // Pᵀ and dSᵀ on the accumulators, by column (q row); rounded to bf16
      // pairs they are the A operands of the next two products.
      uint32_t pa[N / 16][4], dsa[N / 16][4];
#pragma unroll
      for (int i = 0; i < N / 2; i += 2) {
        const int col = q0 + 8 * (i / 4) + c0;  // q row in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
        const float2 dl = *reinterpret_cast<const float2*>(lse_t + kRows + col);
        float p0 = exp2f(fmaf(st[i], scale_log2, -l2.x));
        float p1 = exp2f(fmaf(st[i + 1], scale_log2, -l2.y));
        if (masked) {
          const int t = it * kRows + col;
          const int kr = key[(i / 2) % 2];
          if (t >= seq_len || (causal && kr > t)) p0 = 0.f;
          if (t + 1 >= seq_len || (causal && kr > t + 1)) p1 = 0.f;
        }
        a_reg(pa, i) = pack_bf16(p0, p1);
        a_reg(dsa, i) = pack_bf16(p0 * (dpt[i] - dl.x) * scale,
                                  p1 * (dpt[i + 1] - dl.y) * scale);
      }

      // dV += Pᵀ·dO and dK += dSᵀ·Q: K = the pass's q rows, dO and Q read
      // MN-major from the stage's tiles.
      pin(dk_acc);
      pin(dv_acc);
      pin(pa);
      pin(dsa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        wgmma_rs<D>(dv_acc, pa[kk], L::mn_major(do_s, q0 / 16 + kk));
      }
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        wgmma_rs<D>(dk_acc, dsa[kk], L::mn_major(q_s, q0 / 16 + kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(dk_acc);
      pin(dv_acc);
      pin(pa);
      pin(dsa);
    }
    __syncthreads();  // every warp is done with stage s and its row terms
    if (j + S < count) {
      // Read again at tile j + S, after at least one more block barrier.
      terms[2 * kRows * s + tid] = next_term;
      if (tid == 0) {
        load_pair<D>(q_s, &tq, &tdo, bars + 8 * (1 + s), h, (it + S) * kRows,
                     b);
      }
    }
  }

  // dK and dV in bf16 into K's and V's tiles (every product reading them
  // has completed), then to device memory as 16-byte rows.
  store_acc<D>(smem, dk_acc, r0, c0);
  store_acc<D>(smem + L::kBytes, dv_acc, r0, c0);
  __syncthreads();
  copy_out<D>(dk, smem, b, h, kb * kRows, seq_len, num_heads, tid);
  copy_out<D>(dv, smem + L::kBytes, b, h, kb * kRows, seq_len, num_heads,
              tid);
}

// One CTA = one warpgroup per (batch·head, 64-row q block). Thread 0
// issues every TMA load. Lane l of warp w holds q rows r0 = 16w + l/4 and
// r0 + 8 and, of S and dP, key columns 2(l%4) and +1 of every group of 8.
template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int num_heads, int seq_len,
                  float scale, float scale_log2, int causal) {
  using L = Tile<D>;
  constexpr int S = kStages<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t q_s = smem_addr(smem);           // Q, then dQ
  const uint32_t do_s = q_s + L::kBytes;
  const uint32_t ring = do_s + L::kBytes;         // stage s: K, then V
  const uint32_t bars = ring + 2 * S * L::kBytes;

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal blocks first
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int tid = threadIdx.x;
  const int num_tiles = (seq_len + kRows - 1) / kRows;
  const int last_tile = causal ? min(num_tiles - 1, qb) : num_tiles - 1;

  init_barriers(bars, 1 + S);
  if (tid == 0) {
    load_pair<D>(q_s, &tq, &tdo, bars, h, qb * kRows, b);
    for (int j = 0; j < S && j <= last_tile; ++j) {
      load_pair<D>(ring + 2 * j * L::kBytes, &tk, &tv, bars + 8 * (1 + j), h,
                   j * kRows, b);
    }
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int row[2] = {qb * kRows + r0, qb * kRows + r0 + 8};
  float lse2[2], dl[2];  // lse·log2(e) and δ of the thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = row[r] < seq_len;
    lse2[r] = live ? lse[(long long)bh * seq_len + row[r]] * kLog2e : 0.f;
    dl[r] = live ? delta[(long long)bh * seq_len + row[r]] : 0.f;
  }
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  mbar_wait(bars, 0);
  for (int j = 0; j <= last_tile; ++j) {
    const int s = j % S;
    const uint32_t k_s = ring + 2 * s * L::kBytes;
    const uint32_t v_s = k_s + L::kBytes;
    mbar_wait(bars + 8 * (1 + s), (j / S) & 1);

    // S = Q·Kᵀ and dP = dO·Vᵀ: M = 64 q rows, N = 64 keys, both K-major.
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    pin(sc);
    pin(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n64(sc, L::k_major(q_s, kk), L::k_major(k_s, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n64(dp, L::k_major(do_s, kk), L::k_major(v_s, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);
    pin(dp);

    // dS on the accumulators, rounded to bf16 pairs: dQ's A operand.
    const bool masked = (causal && j == qb) || (j + 1) * kRows > seq_len;
    uint32_t dsa[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i / 2) % 2;
      const int col = j * kRows + 8 * (i / 4) + c0;  // key
      float p0 = exp2f(fmaf(sc[i], scale_log2, -lse2[r]));
      float p1 = exp2f(fmaf(sc[i + 1], scale_log2, -lse2[r]));
      if (masked) {
        if (col >= seq_len || (causal && col > row[r])) p0 = 0.f;
        if (col + 1 >= seq_len || (causal && col + 1 > row[r])) p1 = 0.f;
      }
      a_reg(dsa, i) = pack_bf16(p0 * (dp[i] - dl[r]) * scale,
                                p1 * (dp[i + 1] - dl[r]) * scale);
    }

    // dQ += dS·K: K = the tile's 64 keys, K read MN-major.
    pin(dq_acc);
    pin(dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D>(dq_acc, dsa[kk], L::mn_major(k_s, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(dq_acc);
    pin(dsa);
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && j + S <= last_tile) {
      load_pair<D>(k_s, &tk, &tv, bars + 8 * (1 + s), h, (j + S) * kRows, b);
    }
  }

  // dQ in bf16 into Q's tile (every product reading it has completed),
  // then to device memory as 16-byte rows.
  store_acc<D>(smem, dq_acc, r0, c0);
  __syncthreads();
  copy_out<D>(dq, smem, b, h, qb * kRows, seq_len, num_heads, tid);
}

// The tensor maps are encoded on every call and passed by value as
// __grid_constant__ parameters, which CUDA-graph capture keeps.
template <int D>
int launch_bf16(bool dkdv, const Args& a, cudaStream_t stream) {
  CUtensorMap maps[4];  // q, k, v, dO
  const void* bases[4] = {a.q, a.k, a.v, a.dout};
  const Strides strides[4] = {a.qs, a.ks, a.vs, a.os};
  for (int i = 0; i < 4; ++i) {
    if (strides[i].d != 1) return int(cudaErrorInvalidValue);
    const cudaError_t err =
        encode<D>(&maps[i], bases[i], a.batch, a.seq_len, a.num_heads,
                  strides[i].b, strides[i].t, strides[i].h);
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid((a.seq_len + kRows - 1) / kRows, a.batch * a.num_heads);
  const float scale_log2 = a.scale * kLog2e;
  cudaError_t err;
  if (dkdv) {
    constexpr size_t smem = kDkdvSmem<D>;  // 23 / 43 / 83 / 98 KB, D=16..128
    static bool opted_in = false;
    err = opt_in(flash_bwd_dkdv_bf16<D>, smem, &opted_in);
    if (err != cudaSuccess) return int(err);
    flash_bwd_dkdv_bf16<D><<<grid, kWgThreads, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], a.lse, a.delta,
        static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
        a.num_heads, a.seq_len, a.scale, scale_log2, a.causal);
  } else {
    constexpr size_t smem = kDqSmem<D>;  // 21 / 41 / 81 / 97 KB, D=16..128
    static bool opted_in = false;
    err = opt_in(flash_bwd_dq_bf16<D>, smem, &opted_in);
    if (err != cudaSuccess) return int(err);
    flash_bwd_dq_bf16<D><<<grid, kWgThreads, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], a.lse, a.delta,
        static_cast<__nv_bfloat16*>(a.dq), a.num_heads, a.seq_len, a.scale,
        scale_log2, a.causal);
  }
  return int(cudaGetLastError());
}

template <int D>
int launch(bool dkdv, int is_bf16, const Args& a, cudaStream_t stream) {
  if (is_bf16) return launch_bf16<D>(dkdv, a, stream);
  return dkdv ? launch_dkdv_f32<D>(a, stream) : launch_dq_f32<D>(a, stream);
}

int dispatch_d(bool dkdv, int is_bf16, int head_dim, const Args& a,
               cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<16>(dkdv, is_bf16, a, stream);
    case 32:
      return launch<32>(dkdv, is_bf16, a, stream);
    case 64:
      return launch<64>(dkdv, is_bf16, a, stream);
    case 128:
      return launch<128>(dkdv, is_bf16, a, stream);
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
// the outputs are dense [B, T, H, D] buffers in the inputs' dtype. bf16
// also needs a dense last dim, 16-byte aligned q, k, v and dO, and batch /
// time / head strides of a multiple of 16 bytes (TMA).

int t2r_flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int batch, int seq_len, int num_heads,
                                 int head_dim, const long long* strides,
                                 int causal, int is_bf16, float scale,
                                 void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dk, dv, nullptr, batch,
                           seq_len, num_heads, strides, causal, scale);
  return dispatch_d(true, is_bf16, head_dim, a,
                    static_cast<cudaStream_t>(stream));
}

int t2r_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int batch,
                               int seq_len, int num_heads, int head_dim,
                               const long long* strides, int causal,
                               int is_bf16, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, nullptr, nullptr, dq,
                           batch, seq_len, num_heads, strides, causal, scale);
  return dispatch_d(false, is_bf16, head_dim, a,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
