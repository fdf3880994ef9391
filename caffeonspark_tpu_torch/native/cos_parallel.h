// The port's native ingest library: one worker per hardware thread
// (or `num_threads`) pulling batch items off a shared counter, the
// transformer-thread-pool analog of CaffeProcessor.scala:54-55.

#pragma once

#include <algorithm>
#include <atomic>
#include <thread>
#include <vector>

namespace cos {

// Runs fn(i) for every i in [0, n) on min(n, threads) threads;
// num_threads <= 0 means one per hardware thread.
template <typename Fn>
void parallel_for(int n, int num_threads, Fn fn) {
  int nthreads = num_threads > 0
                     ? num_threads
                     : static_cast<int>(std::thread::hardware_concurrency());
  nthreads = std::max(1, std::min(nthreads, n));
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

}  // namespace cos
