// Native episode-assembly engine — the host-side data hot path in C++.
//
// The reference assembles episodes in Python inside 4 forked DataLoader
// workers (reference data.py:486-532,584-590): per image, a PIL/numpy load,
// an np.rot90, and a copy into the episode tensor. Here the whole meta-batch
// is assembled by one native call over the packed in-RAM image cache:
// gather + rotation-k augmentation + optional mean/std normalization + pack
// into the [B, n_way, n_samples, H, W, C] batch layout, parallelized over
// (episode, class) jobs with a std::thread pool.
//
// Episode *randomness* stays in Python (numpy RandomState, call-for-call
// parity with the reference's seed discipline); this engine is purely the
// data-movement half: it receives the drawn global image indices and
// per-class rotation counts.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread (see __init__.py).

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Copy one H x W x C image with np.rot90(arr, k, axes=(0,1)) semantics.
// Requires H == W when k is odd (both supported datasets are square).
inline void copy_rot90(const float* src, float* dst, int64_t H, int64_t W,
                       int64_t C, int k) {
  if (k == 0) {
    const int64_t n = H * W * C;
    for (int64_t i = 0; i < n; ++i) dst[i] = src[i];
    return;
  }
  for (int64_t i = 0; i < H; ++i) {
    for (int64_t j = 0; j < W; ++j) {
      // out[i, j] = in[si, sj]; np.rot90 rotates counter-clockwise k times:
      // k=1: out[i, j] = in[j, W-1-i]  (square H==W for odd k)
      // k=2: out[i, j] = in[H-1-i, W-1-j]
      // k=3: out[i, j] = in[H-1-j, i]
      int64_t si, sj;
      switch (k & 3) {
        case 1: si = j;          sj = W - 1 - i; break;
        case 2: si = H - 1 - i;  sj = W - 1 - j; break;
        case 3: si = H - 1 - j;  sj = i;         break;
        default: si = i;         sj = j;         break;
      }
      const float* s = src + (si * W + sj) * C;
      float* d = dst + (i * W + j) * C;
      for (int64_t c = 0; c < C; ++c) d[c] = s[c];
    }
  }
}

// Divides (not multiply-by-reciprocal) so results are bit-exact with the
// numpy fallback's (arr - mean) / std.
inline void normalize(float* img, int64_t HW, int64_t C, const float* mean,
                      const float* std_dev) {
  for (int64_t p = 0; p < HW; ++p) {
    float* px = img + p * C;
    for (int64_t c = 0; c < C; ++c) px[c] = (px[c] - mean[c]) / std_dev[c];
  }
}

}  // namespace

extern "C" {

// cache:     [total_images, H, W, C] float32, all images of one split packed
// image_idx: [B, n_way, n_samples] int64 global indices into cache
// rot_k:     [B, n_way] int32 rotation counts (0..3); pass zeros to disable
// out:       [B, n_way, n_samples, H, W, C] float32
// mean/std:  length-C channel statistics; has_norm=0 skips normalization
// Returns 0 on success, 1 on invalid arguments (odd rotation of non-square).
int assemble_episodes(const float* cache, const int64_t* image_idx,
                      const int32_t* rot_k, float* out, int64_t B,
                      int64_t n_way, int64_t n_samples, int64_t H, int64_t W,
                      int64_t C, const float* mean, const float* std_dev,
                      int has_norm, int num_threads) {
  if (H != W) {
    const int64_t n_jobs_check = B * n_way;
    for (int64_t i = 0; i < n_jobs_check; ++i)
      if (rot_k[i] & 1) return 1;  // odd rot90 of non-square image
  }
  const int64_t img_elems = H * W * C;
  const int64_t n_jobs = B * n_way;  // one job = one class slot of one episode
  std::atomic<int64_t> next{0};

  auto worker = [&]() {
    for (;;) {
      const int64_t job = next.fetch_add(1, std::memory_order_relaxed);
      if (job >= n_jobs) return;
      const int k = rot_k[job] & 3;
      const int64_t* idx = image_idx + job * n_samples;
      float* dst = out + job * n_samples * img_elems;
      for (int64_t s = 0; s < n_samples; ++s) {
        const float* src = cache + idx[s] * img_elems;
        copy_rot90(src, dst + s * img_elems, H, W, C, k);
        if (has_norm)
          normalize(dst + s * img_elems, H * W, C, mean, std_dev);
      }
    }
  };

  int n_threads = num_threads > 0 ? num_threads : 1;
  if (n_threads > n_jobs) n_threads = static_cast<int>(n_jobs);
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return 0;
}

}  // extern "C"
