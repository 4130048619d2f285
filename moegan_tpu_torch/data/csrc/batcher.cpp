// Native host-side batch assembly for the input pipeline (the port's copy
// of the JAX package's native/batcher.cpp; moegan_tpu_torch/data/native.py
// builds and binds it).
//
// Assembling a shuffled batch from a large host array is a strided gather
// that numpy executes single-threaded under the GIL. These functions do the
// same gather (plus a horizontal flip, or the CLIP normalisation) with a
// transient thread pool, called through ctypes, which releases the GIL.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libbatcher.so batcher.cpp -lpthread

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) over a transient thread pool.
template <typename F>
void parallel_for(int64_t n, int n_threads, F fn) {
  if (n_threads <= 1 || n < 2) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([&] {
      for (int64_t i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// dst[i] = src[idx[i]] for float32 rows of row_elems elements.
void gather_rows_f32(const float* src, const int64_t* idx, int64_t n_idx,
                     int64_t row_elems, float* dst, int n_threads) {
  parallel_for(n_idx, n_threads, [&](int64_t i) {
    std::memcpy(dst + i * row_elems, src + idx[i] * row_elems,
                sizeof(float) * static_cast<size_t>(row_elems));
  });
}

// Gather HWC images with optional per-row horizontal flip (flip[i] != 0).
void gather_images_f32(const float* src, const int64_t* idx, int64_t n_idx,
                       int64_t h, int64_t w, int64_t c, float* dst,
                       const uint8_t* flip, int n_threads) {
  const int64_t row_elems = h * w * c;
  parallel_for(n_idx, n_threads, [&](int64_t i) {
    const float* s = src + idx[i] * row_elems;
    float* d = dst + i * row_elems;
    if (flip == nullptr || !flip[i]) {
      std::memcpy(d, s, sizeof(float) * static_cast<size_t>(row_elems));
      return;
    }
    for (int64_t y = 0; y < h; ++y) {
      const float* srow = s + y * w * c;
      float* drow = d + y * w * c;
      for (int64_t x = 0; x < w; ++x) {
        std::memcpy(drow + x * c, srow + (w - 1 - x) * c,
                    sizeof(float) * static_cast<size_t>(c));
      }
    }
  });
}

// Fused gather + [-1,1] -> CLIP-style normalization:
// out = ((x+1)/2 - mean[c]) / std[c], used by the eval feature loop.
void gather_normalize_f32(const float* src, const int64_t* idx, int64_t n_idx,
                          int64_t hw, int64_t c, const float* mean,
                          const float* std_, float* dst, int n_threads) {
  const int64_t row_elems = hw * c;
  parallel_for(n_idx, n_threads, [&](int64_t i) {
    const float* s = src + idx[i] * row_elems;
    float* d = dst + i * row_elems;
    for (int64_t p = 0; p < hw; ++p) {
      for (int64_t ch = 0; ch < c; ++ch) {
        const float x01 = (s[p * c + ch] + 1.0f) * 0.5f;
        d[p * c + ch] = (x01 - mean[ch]) / std_[ch];
      }
    }
  });
}

}  // extern "C"
