// Host-side image tile pipeline of omchat_torch (processing/native.py).
//
// The per-tile rescale+normalize+CHW-transpose is the host hot path when
// feeding anyres tiles (up to 10 x 448x448x3 per image) to the device; in
// numpy/PIL it costs several allocations and passes per tile.  This library
// does it in one fused multithreaded pass over the uint8 source, plus the
// anyres geometry helpers (center-pad placement, raster tiling) so a batch of
// images becomes a ready [N, 3, T, T] float32 buffer with zero Python-side
// loops.  Exposed via a C ABI for ctypes (no pybind11).
//
// Behavioral contract matches omchat_torch.processing.clip_preprocess
// (rescale 1/255, ImageNet mean/std, CHW float32).  Built by
// omchat_torch/processing/native.py at first use; the JAX package keeps its
// own copy (native/tile_pipeline.cpp), which this file was copied from.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// Fused rescale+normalize+transpose for one tile:
//   src: HWC uint8 [t, t, 3]  →  dst: CHW float32 [3, t, t]
inline void normalize_tile(const uint8_t* src, float* dst, int t,
                           const float* scale, const float* shift) {
  const int hw = t * t;
  for (int i = 0; i < hw; ++i) {
    const uint8_t* p = src + i * 3;
    dst[i] = static_cast<float>(p[0]) * scale[0] + shift[0];
    dst[hw + i] = static_cast<float>(p[1]) * scale[1] + shift[1];
    dst[2 * hw + i] = static_cast<float>(p[2]) * scale[2] + shift[2];
  }
}

void parallel_for(int n, int num_threads, const std::function<void(int)>& fn) {
  if (n <= 1 || num_threads <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      fn(i);
    }
  };
  int t = std::min(n, num_threads);
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int i = 0; i < t; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Normalize a batch of tiles.
//   src:  [n, t, t, 3] uint8 (HWC, contiguous)
//   dst:  [n, 3, t, t] float32
//   mean/std: per-channel (normalized-space, e.g. ImageNet 0.485/0.229)
//   rescale: typically 1/255
void omchat_normalize_tiles(const uint8_t* src, float* dst, int n, int t,
                            const float* mean, const float* stddev,
                            float rescale, int num_threads) {
  float scale[3], shift[3];
  for (int c = 0; c < 3; ++c) {
    scale[c] = rescale / stddev[c];
    shift[c] = -mean[c] / stddev[c];
  }
  const int hw3 = t * t * 3;
  parallel_for(n, num_threads, [&](int i) {
    normalize_tile(src + static_cast<int64_t>(i) * hw3,
                   dst + static_cast<int64_t>(i) * hw3, t, scale, shift);
  });
}

// Center-pad a resized image into a black canvas, then cut raster tiles and
// normalize them — the anyres step after the (PIL-exact) resize.
//   resized: [rh, rw, 3] uint8
//   canvas (target): [th, tw] with th % tile == 0, tw % tile == 0
//   dst: [(th/tile)*(tw/tile), 3, tile, tile] float32
void omchat_pad_tile_normalize(const uint8_t* resized, int rh, int rw, int th,
                               int tw, int tile, float* dst, const float* mean,
                               const float* stddev, float rescale,
                               int num_threads) {
  const int paste_x = (tw - rw) / 2;
  const int paste_y = (th - rh) / 2;
  const int gx = tw / tile;
  const int gy = th / tile;
  float scale[3], shift[3];
  for (int c = 0; c < 3; ++c) {
    scale[c] = rescale / stddev[c];
    shift[c] = -mean[c] / stddev[c];
  }
  const float black[3] = {shift[0], shift[1], shift[2]};  // pixel 0 normalized
  const int hw = tile * tile;

  parallel_for(gx * gy, num_threads, [&](int g) {
    const int ty = g / gx;
    const int tx = g % gx;
    float* out = dst + static_cast<int64_t>(g) * 3 * hw;
    for (int y = 0; y < tile; ++y) {
      const int sy = ty * tile + y - paste_y;  // row in resized image
      for (int x = 0; x < tile; ++x) {
        const int sx = tx * tile + x - paste_x;
        const int o = y * tile + x;
        if (sy < 0 || sy >= rh || sx < 0 || sx >= rw) {
          out[o] = black[0];
          out[hw + o] = black[1];
          out[2 * hw + o] = black[2];
        } else {
          const uint8_t* p = resized + (static_cast<int64_t>(sy) * rw + sx) * 3;
          out[o] = static_cast<float>(p[0]) * scale[0] + shift[0];
          out[hw + o] = static_cast<float>(p[1]) * scale[1] + shift[1];
          out[2 * hw + o] = static_cast<float>(p[2]) * scale[2] + shift[2];
        }
      }
    }
  });
}

}  // extern "C"
