// What the compositing forward and backward kernels share: the tile and block
// shape, the payload read of one chunk into shared memory, and one pixel's
// alpha.  The backward has to land on the forward's side of the two hard
// thresholds (alpha >= 1/255, q^2 <= 4) at every pixel, so both kernels take
// alpha from the one function below, and both files are compiled with
// -fmad=false: the same separately rounded operations in the same order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gsplat {

constexpr int TILE = 32;
constexpr int TILE_PIXELS = TILE * TILE;
constexpr int THREADS = 256;
constexpr int PIX = 4;  // pixels per thread

// One pair's payload, read back from shared memory as a broadcast.
struct Pair {
    float cx, cy, ax, ay, bx, by, cr, cg, cb, op;
};

// Reads positions [lo, hi) of a tile's segment (counted from `base`) into
// shared memory at slots [lo - c0, hi - c0): first the payload column of each
// pair, then the ROWS words of that column.  Ends with a barrier.
template <bool PACKED>
__device__ __forceinline__ void load_chunk(const int* __restrict__ fields, long long n_cols,
                                           const int* __restrict__ pair_splat, int base, int c0,
                                           int lo, int hi, int chunk, int* s_idx, int* s_pay) {
    constexpr int ROWS = PACKED ? 8 : 10;
    const int tid = threadIdx.x;
    const int cnt = hi - lo;
    const int p0 = lo - c0;
    for (int i = tid; i < cnt; i += THREADS) s_idx[p0 + i] = pair_splat[(long long)base + lo + i];
    __syncthreads();
    for (int w = tid; w < cnt * ROWS; w += THREADS) {
        const int r = w / cnt;
        const int i = w - r * cnt;
        s_pay[r * chunk + p0 + i] = fields[(long long)r * n_cols + s_idx[p0 + i]];
    }
    __syncthreads();
}

template <bool PACKED>
__device__ __forceinline__ Pair read_pair(const int* s_pay, int chunk, int p) {
    Pair q;
    q.cx = __int_as_float(s_pay[0 * chunk + p]);
    q.cy = __int_as_float(s_pay[1 * chunk + p]);
    q.ax = __int_as_float(s_pay[2 * chunk + p]);
    q.ay = __int_as_float(s_pay[3 * chunk + p]);
    q.bx = __int_as_float(s_pay[4 * chunk + p]);
    q.by = __int_as_float(s_pay[5 * chunk + p]);
    if (PACKED) {
        const int w6 = s_pay[6 * chunk + p];
        const int w7 = s_pay[7 * chunk + p];
        q.cr = __int_as_float(w6 & (int)0xffff0000u);
        q.cg = __int_as_float(w6 << 16);
        q.cb = __int_as_float(w7 & (int)0xffff0000u);
        q.op = __int_as_float(w7 << 16);
    } else {
        q.cr = __int_as_float(s_pay[6 * chunk + p]);
        q.cg = __int_as_float(s_pay[7 * chunk + p]);
        q.cb = __int_as_float(s_pay[8 * chunk + p]);
        q.op = __int_as_float(s_pay[9 * chunk + p]);
    }
    return q;
}

// alpha of pair q at the pixel (dx, dy) away from its centre.  dxax = dx * ax
// and dxbx = dx * bx are shared by a thread's pixels (one column).
template <bool SOFT>
__device__ __forceinline__ float pixel_alpha(const Pair& q, float dxax, float dxbx, float dy,
                                             float max_alpha) {
    const float qx = dxax + dy * q.ay;
    const float qy = dxbx + dy * q.by;
    const float qx2 = qx * qx;
    const float qy2 = qy * qy;
    const float power = qx2 + qy2;
    const float a = expf(-power) * q.op;
    // NaN-preserving min, as the plain version's torch.minimum
    float alpha = (a > max_alpha) ? max_alpha : a;
    if (!SOFT) {
        const float alpha_cutoff = (float)(1.0 / 255.0);
        const bool keep = (qx2 <= 4.0f) && (qy2 <= 4.0f) && (alpha >= alpha_cutoff);
        alpha = keep ? alpha : 0.0f;
    }
    return alpha;
}

}  // namespace gsplat
