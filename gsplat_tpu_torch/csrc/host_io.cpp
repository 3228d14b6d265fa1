// Native host runtime of gsplat_tpu_torch: multithreaded PLY column
// extraction with fused activations (sigmoid opacity, exp scale, quaternion
// reorder and normalize), a multithreaded LSD radix argsort over float keys,
// and Morton-code spatial reordering (host-side preprocessing that improves
// the device's tile locality).
//
// The port's own copy of the JAX package's host helpers, with the same
// arithmetic: gsplat_tpu_torch/io/native.py builds it with
//   g++ -O3 -shared -fPIC -o libhost_io.so host_io.cpp -lpthread
// into build/ at first use and binds it with ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

template <typename F>
void parallel_for(int64_t n, F&& fn) {
  int nt = std::min<int64_t>(hw_threads(), std::max<int64_t>(n / 65536, 1));
  if (nt <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    ts.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// Extract `k` float32 columns from packed binary vertex records.
//   base:    pointer to the first record
//   n:       record count
//   stride:  record size in bytes
//   offsets: k byte-offsets of float32 fields within a record
//   out:     k destination arrays, each n floats (SoA)
void extract_columns_f32(const uint8_t* base, int64_t n, int64_t stride,
                         const int64_t* offsets, int k, float** out) {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int c = 0; c < k; ++c) {
      const uint8_t* src = base + offsets[c];
      float* dst = out[c];
      for (int64_t i = lo; i < hi; ++i) {
        std::memcpy(&dst[i], src + i * stride, sizeof(float));
      }
    }
  });
}

// Fused 3DGS activations:
//   opacity ← sigmoid(opacity); scale ← exp(scale);
//   (rot0..3 = w,x,y,z) → orient xyzw, normalized.
void activate_splats(float* opacity, float* sx, float* sy, float* sz,
                     const float* r0, const float* r1, const float* r2,
                     const float* r3, float* qx, float* qy, float* qz,
                     float* qw, int64_t n) {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      opacity[i] = 1.0f / (1.0f + std::exp(-opacity[i]));
      sx[i] = std::exp(sx[i]);
      sy[i] = std::exp(sy[i]);
      sz[i] = std::exp(sz[i]);
      float w = r0[i], x = r1[i], y = r2[i], z = r3[i];
      float inv = 1.0f / std::max(std::sqrt(w * w + x * x + y * y + z * z), 1e-12f);
      qx[i] = x * inv;
      qy[i] = y * inv;
      qz[i] = z * inv;
      qw[i] = w * inv;
    }
  });
}

// Multithreaded LSD radix argsort of float32 keys (ascending, NaN last;
// -0.0 before +0.0; stable among equal bit patterns), for host-side tooling.
void radix_argsort_f32(const float* keys, int64_t n, int32_t* out_idx) {
  // float → ordered uint32
  std::vector<uint32_t> k0(n), k1(n);
  std::vector<int32_t> i0(n), i1(n);
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      uint32_t u;
      std::memcpy(&u, &keys[i], 4);
      k0[i] = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
      i0[i] = static_cast<int32_t>(i);
    }
  });
  for (int pass = 0; pass < 4; ++pass) {
    int shift = pass * 8;
    int64_t hist[256] = {0};
    for (int64_t i = 0; i < n; ++i) ++hist[(k0[i] >> shift) & 0xFF];
    int64_t sum = 0;
    for (int b = 0; b < 256; ++b) {
      int64_t c = hist[b];
      hist[b] = sum;
      sum += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      int64_t d = hist[(k0[i] >> shift) & 0xFF]++;
      k1[d] = k0[i];
      i1[d] = i0[i];
    }
    k0.swap(k1);
    i0.swap(i1);
  }
  std::memcpy(out_idx, i0.data(), n * sizeof(int32_t));
}

// Morton (Z-order) codes from positions, for spatial reordering of splats
// (improves device-side tile/pair locality).  Positions are normalized to
// the bbox internally; 21 bits per axis → 63-bit codes.
static inline uint64_t expand_bits(uint64_t v) {
  v &= 0x1fffff;
  v = (v | v << 32) & 0x1f00000000ffffULL;
  v = (v | v << 16) & 0x1f0000ff0000ffULL;
  v = (v | v << 8) & 0x100f00f00f00f00fULL;
  v = (v | v << 4) & 0x10c30c30c30c30c3ULL;
  v = (v | v << 2) & 0x1249249249249249ULL;
  return v;
}

void morton_codes(const float* x, const float* y, const float* z, int64_t n,
                  uint64_t* out) {
  float mn[3] = {INFINITY, INFINITY, INFINITY};
  float mx[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int64_t i = 0; i < n; ++i) {
    mn[0] = std::min(mn[0], x[i]); mx[0] = std::max(mx[0], x[i]);
    mn[1] = std::min(mn[1], y[i]); mx[1] = std::max(mx[1], y[i]);
    mn[2] = std::min(mn[2], z[i]); mx[2] = std::max(mx[2], z[i]);
  }
  float inv[3];
  for (int a = 0; a < 3; ++a) {
    float d = mx[a] - mn[a];
    inv[a] = d > 0 ? 2097151.0f / d : 0.0f;
  }
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      uint64_t cx = expand_bits(static_cast<uint64_t>((x[i] - mn[0]) * inv[0]));
      uint64_t cy = expand_bits(static_cast<uint64_t>((y[i] - mn[1]) * inv[1]));
      uint64_t cz = expand_bits(static_cast<uint64_t>((z[i] - mn[2]) * inv[2]));
      out[i] = (cx << 2) | (cy << 1) | cz;
    }
  });
}

}  // extern "C"
