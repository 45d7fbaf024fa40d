// Hopper (sm_90a) building blocks of the port's attention and CEM
// kernels, and the layout they agree on: a [64, D] bf16 tile of a strided
// [B, T, H, D] view, loaded by TMA through a rank-4 tensor map into
// shared memory with the swizzle that wgmma's descriptors read (the CEM
// kernels encode maps of rank 2, 3 and 5 with `encode_bf16`); mbarrier,
// TMA, ldmatrix and cp.async primitives; wgmma descriptors and the
// m64nNk16 bf16 → f32 instructions (A from shared memory or from
// registers).
//
// Fragments: a warpgroup's m64nN f32 accumulator gives warp w rows 16w ..
// 16w+15, and lane l rows r0 = 16w + l/4 and r0 + 8, columns 2(l%4) and
// +1 of every group of 8: element i is row r0 + 8·((i/2)%2), column
// 8·(i/4) + 2(l%4) + i%2. Rounded to bf16 in pairs, the accumulator of
// an m64n16 slice is the register A operand of the next product's k16
// step: pair (i, i+1) of 8-column group n is register 2·(n%2) + (i/2)%2
// of step n/2.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

constexpr int kRows = 64;  // rows of a tile (TMA box, wgmma M)

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-B units), swizzle layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16)
         | (uint64_t(sbo >> 4) << 32) | (layout << 62);
}

// A [64, D] bf16 tile in shared memory as TMA writes it: boxes of 64
// rows × kBoxCols columns (rows of ≤ 128 B; two boxes at D=128), each
// swizzled with the pattern of its row width: 128 B, 64 B, or 32 B at
// D=16. The wgmma descriptors read the same layout (layout type 1, 2 or
// 3); both need 1024-B alignment.
template <int D>
struct Tile {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "tile width");
  static constexpr int kBoxCols = D > 64 ? 64 : D;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kRowBytes = kBoxCols * 2;          // 32, 64 or 128
  static constexpr int kBoxBytes = kRows * kRowBytes;     // 2, 4 or 8 KB
  static constexpr int kBytes = kBoxes * kBoxBytes;
  static constexpr int kKSteps = kRowBytes / 32;          // k16 steps a box
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1
                                      : kRowBytes == 64 ? 2 : 3;  // desc
  static constexpr uint32_t kSwizzle = kRowBytes / 16 - 1;  // 7, 3 or 1
  static constexpr CUtensorMapSwizzle kTmaSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;

  // Byte offset of element (r, c): 16-B chunks xor address bits 7 up.
  __device__ static uint32_t offset(int r, int c) {
    const uint32_t o = (c / kBoxCols) * kBoxBytes + r * kRowBytes
                       + (c % kBoxCols) * 2;
    return o ^ (((o >> 7) & kSwizzle) << 4);
  }

  // Descriptor of the tile as a K-major operand (rows along M or N, D
  // along K) at k16 step kk: the step's 32 B inside the swizzled row.
  __device__ static uint64_t k_major(uint32_t base, int kk) {
    return make_desc(base + (kk / kKSteps) * kBoxBytes + (kk % kKSteps) * 32,
                     16, 8 * kRowBytes, kLayout);
  }

  // Descriptor of the tile as an MN-major B operand (rows along K, D
  // along N) at k16 step kk: rows 16kk .. 16kk+15; the leading byte
  // offset steps to the next box of columns, the stride to 8 more rows.
  __device__ static uint64_t mn_major(uint32_t base, int kk) {
    return make_desc(base + kk * 16 * kRowBytes, kBoxBytes, 8 * kRowBytes,
                     kLayout);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed. A
// wait that never ends (a load that never lands) traps, failing the
// launch, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 22)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a rank-4 map at (column, head, time, batch) into `dst`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int h, int t,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c),
        "r"(h), "r"(t), "r"(b) : "memory");
}

// Rows t0 .. t0+63 of head h, batch b: the tile's boxes, on barrier `bar`.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int h, int t0, int b) {
#pragma unroll
  for (int i = 0; i < Tile<D>::kBoxes; ++i) {
    tma_load(dst + i * Tile<D>::kBoxBytes, map, bar, i * Tile<D>::kBoxCols,
             h, t0, b);
  }
}

// Generic-proxy writes to shared memory (st.shared) made visible to the
// async proxy (wgmma operands, TMA stores); a barrier must follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One box of a map of rank 2, 3 or 5 at coordinates c (innermost first).
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1) : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2) : "memory");
}
__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3), "r"(c4) : "memory");
}

// Four 8×8 bf16 matrices from shared memory: lane i gives the 16-byte row
// address of row i%8 of matrix i/8; register j of lane l holds row l/4,
// columns 2(l%4) and +1 of matrix j (an m64k16 A fragment's layout when
// the matrices are rows 0-7 / 8-15 × columns 0-7 / 8-15, in that order).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// 4-byte asynchronous copy global → shared (completes at cp_async_wait).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               ::"r"(dst), "l"(src) : "memory");
}
// 16-byte asynchronous copy global → shared (bypassing L1).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving register reads or writes across an
// asynchronous wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The register A operand that holds accumulator pair (i, i+1) rounded to
// bf16: register 2·(n%2) + (i/2)%2 of k16 step n/2, n = i/4 (see
// Fragments above). `i` must be a compile-time index (unrolled loops).
template <int K>
__device__ __forceinline__ uint32_t& a_reg(uint32_t (&a)[K][4], int i) {
  return a[i / 8][(i / 4) % 2 * 2 + (i / 2) % 2];
}

// A warpgroup's m64nD accumulator, rounded to bf16, into a [64, D] tile in
// shared memory at its swizzled offsets (4-byte stores of column pairs).
template <int D>
__device__ __forceinline__ void store_acc(uint8_t* tile,
                                          const float (&acc)[D / 2], int r0,
                                          int c0) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    *reinterpret_cast<uint32_t*>(
        tile + Tile<D>::offset(r0 + 8 * ((i / 2) % 2), 8 * (i / 4) + c0)) =
        pack_bf16(acc[i], acc[i + 1]);
  }
}

// Rows t0 .. t0+63 of a [64, D] bf16 tile in shared memory, those below
// seq_len, to head h of batch b of a dense [B, T, H, D] tensor: one
// 16-byte store per thread and chunk (D/8 chunks a row), 128 threads.
template <int D>
__device__ __forceinline__ void copy_out(__nv_bfloat16* out,
                                         const uint8_t* tile, int b, int h,
                                         int t0, int seq_len, int num_heads,
                                         int tid) {
  constexpr int kChunks = D / 8;
  for (int i = tid; i < kRows * kChunks; i += 128) {
    const int r = i / kChunks, c = i % kChunks;
    const int t = t0 + r;
    if (t < seq_len) {
      *reinterpret_cast<uint4*>(
          out + (((long long)b * seq_len + t) * num_heads + h) * D + 8 * c) =
          *reinterpret_cast<const uint4*>(tile + Tile<D>::offset(r, 8 * c));
    }
  }
}

// The first 1024-B aligned byte of dynamic shared memory (the kernels
// ask for 1 KB more than they use).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  return raw + (1024 - smem_addr(raw) % 1024) % 1024;
}

// d[64×64] (+)= A · B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64×32] (+)= A · B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64×64] (+)= A · B, A from shared memory K-major, B from shared memory
// MN-major (a [K, N] matrix with N contiguous, as weights are stored).
__device__ __forceinline__ void wgmma_ss_n64_mn(float (&d)[32], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64×N] += A · B for N ∈ {32, 64}, A and B from shared memory, K-major.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b) {
  if constexpr (N == 32) {
    wgmma_ss_n32(d, desc_a, desc_b, 1);
  } else {
    wgmma_ss_n64(d, desc_a, desc_b, 1);
  }
}

// d[64×16] (+)= A · B, A from registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d[64×32] (+)= A · B, A from registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d[64×64] (+)= A · B, A from registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d[64×128] (+)= A · B, A from registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d[64×N] += A · B for N = D ∈ {16, 32, 64, 128}: A (one k16 step) from
// registers, B from shared memory MN-major.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 16) {
    wgmma_rs_n16(d, a, desc_b, 1);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a, desc_b, 1);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, desc_b, 1);
  } else {
    wgmma_rs_n128(d, a, desc_b, 1);
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime's
// entry-point query so the library links no libcuda (CUDA 12.5 or later).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A rank-4 map over a strided [B, T, H, D] bf16 view (dims innermost
// first: D, H, T, B): boxes of 64 time rows × kBoxCols columns of one
// (b, h), zero-filled past T.
template <int D>
cudaError_t encode(CUtensorMap* map, const void* base, int batch,
                   int seq_len, int num_heads, long long stride_b,
                   long long stride_t, long long stride_h) {
  using L = Tile<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(num_heads),
                              cuuint64_t(seq_len), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(stride_h) * 2,
                                 cuuint64_t(stride_t) * 2,
                                 cuuint64_t(stride_b) * 2};
  const cuuint32_t box[4] = {cuuint32_t(L::kBoxCols), 1, cuuint32_t(kRows),
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::kTmaSwizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A tiled map over a bf16 tensor of rank 2 to 5: dims and boxes innermost
// first, strides in bytes for dims 1 .. rank-1 (multiples of 16), zero
// fill past the edges, the given swizzle.
inline cudaError_t encode_bf16(CUtensorMap* map, const void* base, int rank,
                               const cuuint64_t* dims,
                               const cuuint64_t* strides,
                               const cuuint32_t* box,
                               CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cuuint32_t(rank),
      const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
