// Threaded row gather for the host input pipeline.
//
// The per-epoch shuffle in recsys.data.loader.ShardSource is a random
// row permutation of each shard (dict of C-contiguous arrays). numpy's
// fancy indexing runs it single-threaded, which can cap the host pipeline
// below the device's training rate. This is the analog of the reference's
// tf.data shuffle threads (fm/fm.py:106-112): a memory-bound parallel
// gather,
//
//     dst[i*row] = src[idx[i]*row]  for i in [0, n)
//
// sliced across std::thread workers. Exposed via ctypes
// (recsys/data/native.py: gather_rows), numpy fallback when no g++.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

void gather_rows(const char* src, char* dst, const int64_t* idx, int64_t n,
                 int64_t row_bytes, int n_threads) {
  if (n <= 0) return;
  if (n_threads < 1) n_threads = 1;
  int64_t per = (n + n_threads - 1) / n_threads;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes, row_bytes);
    }
  };
  if (n_threads == 1 || n < (int64_t)1 << 14) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
