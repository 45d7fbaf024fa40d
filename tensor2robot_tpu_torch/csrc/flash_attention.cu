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
// running max m is taken per 64-key tile and m and the normalizer l
// are f32; p = exp(s − m_new) is rounded to T before the PV product,
// which accumulates in f32 (l sums the unrounded p); acc is rescaled by
// exp(m_old − m_new) per tile; out = acc / max(l, 1e-30) in T; lse = m +
// log(max(l, 1e-30)). One launch per call, no atomics: deterministic.
//
// Bound. At the policy's shape (B=1, T=512, H=4, D=32, bf16, causal) a
// call does 34 MFLOP on ≈ 0.53 MB; the bytes bound it, 1.59e-4 ms on an
// H100 (2.54e-3 ms at B=16), far under a launch. So the kernel is bound
// by latency: the chain of dependent steps of its longest CTA.
//
// Version 0 (kept below as the f32 kernel) held bf16 back four ways:
//  - QKᵀ and PV as f32 FMAs on CUDA cores, ~one shared-memory load each;
//  - K/V staged synchronously, one 2-byte element per thread at a time
//    with an integer divide each, kept as f32, two block barriers per
//    tile, the next tile's loads never overlapping this tile's math;
//  - each p written to shared memory and read back for PV;
//  - 32 CTAs at B=1 on 132 SMs, the last causal q block walking its 8
//    tiles in series.
// The bf16 kernel, one warpgroup (128 threads) per (b·h, 64-row q block):
//  - S = Q·Kᵀ is `wgmma` m64n64k16 from shared memory, bf16 in and f32
//    accumulators in registers; the online softmax runs on those
//    registers, each row's max over its quad of threads by shuffles, its
//    sum kept per thread until the end;
//  - p is rounded to bf16 in registers: the S accumulator layout is the
//    register A fragment of `wgmma` m64nDk16 for PV, whose V operand is
//    read from shared memory through a transposed (MN-major) descriptor;
//  - Q once and the K/V tiles as bf16 by TMA: rank-4 tensor maps over the
//    strided [B, T, H, D] views, boxes of 64 rows × ≤ 128 B (two boxes at
//    D=128), zero fill past T, the swizzle the descriptors read (32 B,
//    64 B or 128 B by row width: D = 16, 32, 64 and up). Tiles go into a
//    ring of stages with one mbarrier each, issued ahead, so later tiles
//    are in flight while this one computes. Tiles past the diagonal are
//    never loaded; only the diagonal tile and a ragged last tile pay for
//    the mask;
//  - out goes through shared memory (Q's tile, same swizzle: no bank
//    conflicts) and leaves with 16-byte stores;
//  - the grid stays (T/64, B·H), heaviest causal blocks first. At B=1 the
//    last q block still walks its 8 tiles in series, each now ~0.6 µs on
//    an H100. Two warpgroups splitting a block's tiles and merging their
//    (m, l, acc) measured ~1.55× slower at B=1, so one is kept (PERF.md).
// f32 keeps version 0: tensor cores would compute its products in TF32
// and break the f32 contract.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;               // the TPU kernel's sentinel

struct Strides {
  long long b, t, h;  // element strides of the batch, time and head dims
};

// ---- f32: version 0, on CUDA cores ----

constexpr int kBlockM = 64;                     // q rows per CTA
constexpr int kBlockN = 64;                     // keys per K/V tile
constexpr int kLanes = 4;                       // threads per q row
constexpr int kThreads = kBlockM * kLanes;      // 256
constexpr int kKeysPerLane = kBlockN / kLanes;  // 16
constexpr int kPStride = kBlockN + 4;           // conflict-free p rows

template <int D>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) * (size_t(kBlockM) * (D + 1) + size_t(kBlockN) * (D + 1)
                          + size_t(kBlockN) * D + size_t(kBlockM) * kPStride);
}

// Four threads per q row; K and V tiles of 64 keys staged in shared
// memory as f32 (rows padded to D+1 floats so the four lanes of a row
// group and the eight row groups of a warp hit distinct banks). A thread
// computes 16 of its row's 64 scores, the row max and sum go over its
// four lanes by shuffles, and the row's p goes to shared memory for the
// PV product, where each thread owns D/4 output columns.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int num_heads, int seq_len,
              Strides qs, Strides ks, Strides vs, float scale, int causal) {
  // Banks: a row group's four lanes read K rows c .. c+3 at stride D+1 and
  // a warp's eight row groups read Q rows at stride D+1; D+1 is odd for
  // every D taken (16, 32, 64, 128), so both hit distinct banks.
  static_assert(D % 2 == 0 && D % kLanes == 0, "lane and bank mapping");
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

  const float* q_bh = q + b * qs.b + h * qs.h;
  const float* k_bh = k + b * ks.b + h * ks.h;
  const float* v_bh = v + b * vs.b + h * vs.h;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int t = qb * kBlockM + rr;
    q_tile[rr * (D + 1) + d] = t < seq_len ? q_bh[t * qs.t + d] : 0.f;
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
      k_tile[rr * (D + 1) + d] = in_range ? k_bh[t * ks.t + d] : 0.f;
      v_tile[rr * D + d] = in_range ? v_bh[t * vs.t + d] : 0.f;
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
      p_row[c + kLanes * i] = p;
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
    float* out_row = out + (((long long)b * seq_len + row) * num_heads + h) * D;
#pragma unroll
    for (int e = 0; e < kCols; ++e) out_row[c + kLanes * e] = acc[e] / l_final;
    if (c == 0) lse[(long long)bh * seq_len + row] = m + logf(l_final);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int batch, int seq_len, int num_heads, Strides qs,
               Strides ks, Strides vs, int causal, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_f32<D>();  // 30 / 42 / 66 / 114 KB
  static bool opted_in = false;  // per D; only above the 48 KB default
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
    opted_in = true;
  }
  dim3 grid((seq_len + kBlockM - 1) / kBlockM, batch * num_heads);
  flash_fwd_f32<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), num_heads, seq_len, qs, ks, vs, scale,
      causal);
  return int(cudaGetLastError());
}

// ---- bf16: tensor cores (wgmma) fed by TMA (hopper.cuh) ----

using namespace hopper;

constexpr int kWgThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr int kStages = D > 64 ? 2 : 4;  // K/V ring depth
template <int D>                         // Q, the ring, the mbarriers
constexpr size_t kSmem = 1024 + size_t(1 + 2 * kStages<D>) * Tile<D>::kBytes
                         + 8 * (1 + kStages<D>);

// One CTA = one warpgroup per (batch·head, 64-row q block). Thread 0
// issues every TMA load; all 128 threads run the products and softmax.
// Warp w owns rows 16w .. 16w+15; in each, lane l holds rows r0 = 16w +
// l/4 and r0 + 8, columns 2(l%4) and +1 of every group of 8.
template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               int num_heads, int seq_len, float scale_log2, int causal) {
  using L = Tile<D>;
  constexpr int S = kStages<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t q_s = smem_addr(smem);           // Q, then out
  const uint32_t ring = q_s + L::kBytes;          // stage s: K, then V
  const uint32_t bars = ring + 2 * S * L::kBytes;  // [0] Q, [1 + s] stage s

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal blocks first
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int tid = threadIdx.x;
  const int num_tiles = (seq_len + kRows - 1) / kRows;
  const int last_tile = causal ? min(num_tiles - 1, qb) : num_tiles - 1;

  if (tid == 0) {
    for (int i = 0; i <= S; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, L::kBytes);
    load_tile<D>(q_s, &tq, bars, h, qb * kRows, b);
    for (int j = 0; j < S && j <= last_tile; ++j) {
      const uint32_t bar = bars + 8 * (1 + j);
      mbar_expect_tx(bar, 2 * L::kBytes);
      load_tile<D>(ring + 2 * j * L::kBytes, &tk, bar, h, j * kRows, b);
      load_tile<D>(ring + (2 * j + 1) * L::kBytes, &tv, bar, h, j * kRows, b);
    }
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int row[2] = {qb * kRows + r0, qb * kRows + r0 + 8};
  // Accumulator element i lies in row r0 + 8·half(i), column 8·(i/4) +
  // c0 + i%2 of its tile, half(i) = (i/2)%2.
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, in log2 units
  float l[2] = {0.f, 0.f};          // this thread's part of the normalizer

  mbar_wait(bars, 0);
  for (int j = 0; j <= last_tile; ++j) {
    const int s = j % S;
    const uint32_t k_s = ring + 2 * s * L::kBytes;
    const uint32_t v_s = k_s + L::kBytes;
    mbar_wait(bars + 8 * (1 + s), (j / S) & 1);

    // S = Q·Kᵀ: both K-major, one k16 step per 32 B of a row.
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    pin(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n64(sc, L::k_major(q_s, kk), L::k_major(k_s, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);

    // Online softmax on the accumulators (log2 units). Only the diagonal
    // tile and a ragged last tile need the mask.
    const bool masked = (causal && j == qb) || (j + 1) * kRows > seq_len;
    auto dead = [&](int i) {
      const int col = j * kRows + 8 * (i / 4) + c0 + i % 2;
      return col >= seq_len || (causal && col > row[i / 2 % 2]);
    };
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = masked && dead(i) ? kNegInf : sc[i] * scale_log2;
      mx[i / 2 % 2] = fmaxf(mx[i / 2 % 2], sc[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    // p, rounded to bf16 in registers, is PV's A operand: score pair i,
    // i+1 (8-column group n = i/4) is register 2·(n%2) + half(i) of k16
    // step n/2.
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = i / 2 % 2;
      const float p0 = masked && dead(i) ? 0.f : exp2f(sc[i] - m[r]);
      const float p1 = masked && dead(i + 1) ? 0.f : exp2f(sc[i + 1] - m[r]);
      l[r] += p0 + p1;
      a_reg(pa, i) = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[i / 2 % 2];

    // O += P·V: V is [key, d], MN-major for this product.
    pin(o);
    pin(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o, pa[kk], L::mn_major(v_s, kk));
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    pin(pa);
    __syncthreads();  // every warp is done with stage s and with Q
    if (tid == 0 && j + S <= last_tile) {
      const uint32_t bar = bars + 8 * (1 + s);
      mbar_expect_tx(bar, 2 * L::kBytes);
      load_tile<D>(k_s, &tk, bar, h, (j + S) * kRows, b);
      load_tile<D>(v_s, &tv, bar, h, (j + S) * kRows, b);
    }
  }

  // Epilogue: l over the row's quad; out in bf16 into Q's tile, then to
  // device memory as 16-byte rows; lse from the quad's first lane.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    if (lane % 4 == 0 && row[r] < seq_len) {
      lse[(long long)bh * seq_len + row[r]] = m[r] * kLn2 + logf(l[r]);
    }
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = i / 2 % 2;
    *reinterpret_cast<uint32_t*>(smem + L::offset(r0 + 8 * r,
                                                  8 * (i / 4) + c0)) =
        pack_bf16(o[i] / l[r], o[i + 1] / l[r]);
  }
  __syncthreads();
  copy_out<D>(out, smem, b, h, qb * kRows, seq_len, num_heads, tid);
}

// The tensor maps are encoded on every call and passed by value as
// __grid_constant__ parameters, which CUDA-graph capture keeps.
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int batch, int seq_len, int num_heads, Strides qs,
                Strides ks, Strides vs, int causal, float scale,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode<D>(&tq, q, batch, seq_len, num_heads, qs.b, qs.t,
                              qs.h);
  if (err == cudaSuccess) {
    err = encode<D>(&tk, k, batch, seq_len, num_heads, ks.b, ks.t, ks.h);
  }
  if (err == cudaSuccess) {
    err = encode<D>(&tv, v, batch, seq_len, num_heads, vs.b, vs.t, vs.h);
  }
  if (err != cudaSuccess) return int(err);
  constexpr size_t smem = kSmem<D>;  // 19 / 37 / 73 / 81 KB, D=16 .. 128
  static bool opted_in = false;  // per D; only above the 48 KB default
  if (smem > 48 * 1024 && !opted_in) {
    err = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
    opted_in = true;
  }
  dim3 grid((seq_len + kRows - 1) / kRows, batch * num_heads);
  flash_fwd_bf16<D><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      num_heads, seq_len, scale * kLog2e, causal);
  return int(cudaGetLastError());
}

template <int D>
int launch(int is_bf16, const void* q, const void* k, const void* v,
           void* out, void* lse, int batch, int seq_len, int num_heads,
           Strides qs, Strides ks, Strides vs, int causal, float scale,
           cudaStream_t stream) {
  if (is_bf16) {
    return launch_bf16<D>(q, k, v, out, lse, batch, seq_len, num_heads, qs,
                          ks, vs, causal, scale, stream);
  }
  return launch_f32<D>(q, k, v, out, lse, batch, seq_len, num_heads, qs, ks,
                       vs, causal, scale, stream);
}

}  // namespace

extern "C" {

// Launches the forward on `stream`; returns the CUDA error code (0 = ok).
// Strides are in elements; out must be a dense [B, T, H, D] buffer and
// lse a dense [B, H, T] f32 buffer. bf16 also needs 16-byte aligned q, k,
// v and batch / time / head strides of a multiple of 16 bytes (TMA).
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
  switch (head_dim) {
    case 16:
      return launch<16>(is_bf16, q, k, v, out, lse, batch, seq_len,
                        num_heads, qs, ks, vs, causal, scale, s);
    case 32:
      return launch<32>(is_bf16, q, k, v, out, lse, batch, seq_len,
                        num_heads, qs, ks, vs, causal, scale, s);
    case 64:
      return launch<64>(is_bf16, q, k, v, out, lse, batch, seq_len,
                        num_heads, qs, ks, vs, causal, scale, s);
    case 128:
      return launch<128>(is_bf16, q, k, v, out, lse, batch, seq_len,
                         num_heads, qs, ks, vs, causal, scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
