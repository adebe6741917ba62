// Native batch assembler — the C++ core of the DataLoader's collate
// (counterpart of paddle_tpu/native/batch_assemble.cc, the same code).
//
// Batch assembly off the Python interpreter (reference:
// paddle/fluid/framework/data_feed.cc). The DataLoader's collate calls
// this through ctypes, which drops the GIL for the call: N sample
// buffers are memcpy'd into one contiguous batch buffer by a small
// thread pool. Host code: nothing here runs on the GPU.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// srcs: n pointers, each `bytes_per_sample` long; dst: n*bytes contiguous
void pt_assemble_batch(const void** srcs, int64_t n,
                       int64_t bytes_per_sample, void* dst,
                       int n_threads) {
  if (n <= 0) return;
  char* out = static_cast<char*>(dst);
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = n_threads > 0 ? n_threads : std::max(1, hw / 2);
  nt = static_cast<int>(
      std::min<int64_t>(nt, n));
  // small batches: one thread beats spawn overhead
  if (n * bytes_per_sample < (1 << 20)) nt = 1;
  if (nt == 1) {
    for (int64_t i = 0; i < n; ++i)
      std::memcpy(out + i * bytes_per_sample, srcs[i], bytes_per_sample);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    pool.emplace_back([&]() {
      int64_t i;
      while ((i = next.fetch_add(1)) < n) {
        std::memcpy(out + i * bytes_per_sample, srcs[i],
                    bytes_per_sample);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
