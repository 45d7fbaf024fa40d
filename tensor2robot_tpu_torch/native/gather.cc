// Row gather and scatter for the replay store's host data path.
//
// The replay store's hot loop is `sample(batch)`: a random row gather
// out of a ring buffer of many GB into a contiguous batch for the
// host-to-device copy. numpy's fancy-index gather is single-threaded
// and holds the interpreter lock; the gather is memory-bound and
// parallelizes nearly linearly across row ranges on a many-core host.
// This module is that parallel gather: plain C++ threads, one
// contiguous memcpy per row, rows striped across workers.
//
// A copy of the JAX package's `native/gather.cc`, so that the PyTorch
// port builds from its own tree. Exposed as a tiny C ABI consumed via
// ctypes; `tensor2robot_tpu_torch.utils.native` compiles it with g++
// on first use.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Copies rows src[idx[i]] -> dst[i] for i in [row_begin, row_end).
void gather_range(const uint8_t* src, const int64_t* idx, uint8_t* dst,
                  int64_t row_bytes, int64_t row_begin,
                  int64_t row_end) {
  for (int64_t i = row_begin; i < row_end; ++i) {
    std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                static_cast<size_t>(row_bytes));
  }
}

}  // namespace

extern "C" {

// Gathers `num_rows` rows of `row_bytes` bytes each from `src` at
// `idx` into `dst`, using up to `num_threads` workers (<=0: hardware
// concurrency). Caller guarantees idx values are in range and dst has
// num_rows*row_bytes bytes.
void t2r_gather_rows(const uint8_t* src, const int64_t* idx,
                     uint8_t* dst, int64_t num_rows, int64_t row_bytes,
                     int32_t num_threads) {
  if (num_rows <= 0 || row_bytes <= 0) return;
  int64_t workers = num_threads > 0
                        ? num_threads
                        : static_cast<int64_t>(
                              std::thread::hardware_concurrency());
  if (workers < 1) workers = 1;
  // Below ~1 MB of traffic thread spawn costs more than it saves.
  const int64_t total = num_rows * row_bytes;
  if (workers > 1 && total < (1 << 20)) workers = 1;
  if (workers > num_rows) workers = num_rows;
  if (workers == 1) {
    gather_range(src, idx, dst, row_bytes, 0, num_rows);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(workers));
  const int64_t chunk = (num_rows + workers - 1) / workers;
  for (int64_t w = 0; w < workers; ++w) {
    const int64_t begin = w * chunk;
    const int64_t end = begin + chunk < num_rows ? begin + chunk
                                                 : num_rows;
    if (begin >= end) break;
    threads.emplace_back(gather_range, src, idx, dst, row_bytes, begin,
                         end);
  }
  for (auto& t : threads) t.join();
}

// Scatter counterpart for the ring-buffer writer: dst[idx[i]] = src[i].
// Used by batched `add` so multi-MB episode flushes don't serialize on
// one core either.
void t2r_scatter_rows(const uint8_t* src, const int64_t* idx,
                      uint8_t* dst, int64_t num_rows,
                      int64_t row_bytes, int32_t num_threads) {
  if (num_rows <= 0 || row_bytes <= 0) return;
  int64_t workers = num_threads > 0
                        ? num_threads
                        : static_cast<int64_t>(
                              std::thread::hardware_concurrency());
  if (workers < 1) workers = 1;
  const int64_t total = num_rows * row_bytes;
  if (workers > 1 && total < (1 << 20)) workers = 1;
  if (workers > num_rows) workers = num_rows;
  std::vector<std::thread> threads;
  const int64_t chunk = (num_rows + workers - 1) / workers;
  auto scatter_range = [](const uint8_t* s, const int64_t* ix,
                          uint8_t* d, int64_t rb, int64_t b,
                          int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      std::memcpy(d + ix[i] * rb, s + i * rb,
                  static_cast<size_t>(rb));
    }
  };
  if (workers == 1) {
    scatter_range(src, idx, dst, row_bytes, 0, num_rows);
    return;
  }
  threads.reserve(static_cast<size_t>(workers));
  for (int64_t w = 0; w < workers; ++w) {
    const int64_t begin = w * chunk;
    const int64_t end = begin + chunk < num_rows ? begin + chunk
                                                 : num_rows;
    if (begin >= end) break;
    threads.emplace_back(scatter_range, src, idx, dst, row_bytes,
                         begin, end);
  }
  for (auto& t : threads) t.join();
}

}  // extern "C"
