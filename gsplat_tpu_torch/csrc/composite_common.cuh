// What the compositing forward and backward kernels share: the tile and block
// shape, the payload read of one chunk into shared memory, and one pixel's
// alpha.  The backward has to land on the forward's side of every hard
// threshold (alpha >= 1/255, q^2 <= 4, the depth test) at every pixel, so both
// kernels take alpha from the functions below, and both files are compiled
// with -fmad=false: the same separately rounded operations in the same order.
// sqrtf stays correctly rounded (nvcc's default -prec-sqrt=true; never
// -use_fast_math): the wireframe band edge is a hard threshold too.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gsplat {

constexpr int TILE = 32;
constexpr int TILE_PIXELS = TILE * TILE;
constexpr int THREADS = 256;
constexpr int PIX = 4;  // pixels per thread

// Scene depth of a pixel beyond the image's edge: +inf never kills, so such a
// pixel's early-stop vote is the same as without the depth test.
__device__ __forceinline__ float far_depth() { return __int_as_float(0x7f800000); }

// Payload rows: packed (8 int32), float32 (10) and float32 with the view-z
// row of the depth test (11).
template <bool PACKED, bool DEPTH>
struct PayloadRows {
    static constexpr int value = PACKED ? 8 : (DEPTH ? 11 : 10);
};

// One pair's payload, read back from shared memory as a broadcast.  z is the
// splat centre's view depth (depth-test mode only).
struct Pair {
    float cx, cy, ax, ay, bx, by, cr, cg, cb, op, z;
};

// Reads positions [lo, hi) of a tile's segment (counted from `base`) into
// shared memory at slots [lo - c0, hi - c0): first the payload column of each
// pair, then the ROWS words of that column.  Ends with a barrier.
template <int ROWS>
__device__ __forceinline__ void load_chunk(const int* __restrict__ fields, long long n_cols,
                                           const int* __restrict__ pair_splat, int base, int c0,
                                           int lo, int hi, int chunk, int* s_idx, int* s_pay) {
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

template <bool PACKED, bool DEPTH>
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
    q.z = DEPTH ? __int_as_float(s_pay[10 * chunk + p]) : 0.0f;
    return q;
}

// alpha of pair q at the pixel (dx, dy) away from its centre.  dxax = dx * ax
// and dxbx = dx * bx are shared by a thread's pixels (one column).  With the
// depth test, applied after the hard cutoff as the JAX kernel applies it, a
// pixel whose scene depth bgd lies in front of the splat's view-z is killed;
// a NaN on either side kills it too (jnp.where of a false compare).
template <bool SOFT, bool DEPTH>
__device__ __forceinline__ float pixel_alpha(const Pair& q, float dxax, float dxbx, float dy,
                                             float max_alpha, float bgd) {
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
    if (DEPTH) alpha = (q.z <= bgd) ? alpha : 0.0f;
    return alpha;
}

// The reach test: can a pair's hard-cutoff alpha be non-zero at any pixel
// centre of a rectangle?  The rectangle's centres span [xc - hw, xc + hw] x
// [yc - hh, yc + hh] (global pixel coordinates).  alpha != 0 needs |qx| <= 2
// and |qy| <= 2, and qx = ax*dx + ay*dy is affine in the pixel, so over the
// rectangle it ranges over qx(centre) +- (|ax|*hw + |ay|*hh), and likewise
// qy: the test drops the rectangle only when one range misses [-2, 2].  It
// never divides, so a singular or rotated quad basis is handled like any
// other.  The margin covers rounding: the kernels compute qx at a pixel with
// an error below 3 ulp of s = |ax*dx| + |ay*dy| (dx, dy, the products and the
// sum each rounded once), this test computes qx(centre) with the same bound,
// and |qx| <= 2 + that error is all a live pixel can show (a float above 2
// squares to a float above 4).  So the limit is 2 + h + 1e-5*(s + h) +
// 1e-4, about 170 ulp of s beyond what any live pixel reaches.  A payload
// with an infinite or NaN entry keeps every rectangle (and so does any NaN
// the arithmetic meets: a comparison drops only when it is true).  A
// degenerate basis (A parallel to B, or zero) needs no special case: the
// ranges are exact for it too.  The depth test only kills, so it needs no
// term here; soft mode has no cutoff and never calls this.
// ops/kernels/composite.py reach_mask_plain is the same arithmetic in
// PyTorch.
__device__ __forceinline__ bool pair_reaches(const Pair& q, float xc, float yc, float hw, float hh) {
    if (!(isfinite(q.cx) && isfinite(q.cy) && isfinite(q.ax) && isfinite(q.ay) && isfinite(q.bx) &&
          isfinite(q.by)))
        return true;
    const float dxc = xc - q.cx;
    const float dyc = yc - q.cy;
    const float qx = dxc * q.ax + dyc * q.ay;
    const float qy = dxc * q.bx + dyc * q.by;
    const float aax = fabsf(q.ax), aay = fabsf(q.ay), abx = fabsf(q.bx), aby = fabsf(q.by);
    const float hx = aax * hw + aay * hh;
    const float hy = abx * hw + aby * hh;
    const float sx = aax * (fabsf(dxc) + hw) + aay * (fabsf(dyc) + hh);
    const float sy = abx * (fabsf(dxc) + hw) + aby * (fabsf(dyc) + hh);
    const float lx = 2.0001f + hx + 1e-5f * (sx + hx);
    const float ly = 2.0001f + hy + 1e-5f * (sy + hy);
    return !(fabsf(qx) > lx || fabsf(qy) > ly);
}

// Wireframe mode: an opaque band on the quad's +-2 edge replaces the Gaussian
// falloff (no max_alpha clamp, no depth test).  wq1 = line_px * |A| and
// wq2 = line_px * |B| are the band's half-widths in quad units, per pair.
__device__ __forceinline__ float wire_alpha(const Pair& q, float dxax, float dxbx, float dy,
                                            float wq1, float wq2) {
    const float qx = dxax + dy * q.ay;
    const float qy = dxbx + dy * q.by;
    const float aqx = fabsf(qx);
    const float aqy = fabsf(qy);
    // NaN-propagating max, as jnp.maximum / torch.maximum
    const float m = (aqx > aqy || aqx != aqx) ? aqx : aqy;
    const float wq = (aqx > aqy) ? wq1 : wq2;
    return (fabsf(m - 2.0f) <= wq && q.op > 0.0f) ? 1.0f : 0.0f;
}

}  // namespace gsplat
