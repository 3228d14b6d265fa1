// Compositing backward: one block per 32x32 tile walks the chunks its forward
// walked in reverse and writes, for every pair, nine sums over the tile's 1024
// pixels into the tile's own region of the gradient address space.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/composite.py:_bwd_kernel,
// with and without the depth test (a template flag).  What it computes is the
// same, by the same identities:
//
//   * the forward's strided/offset tile mapping (composite_fwd.cu): block
//     (ty, tx) is local tile (ty, tx) and global tile (row_off +
//     ty*row_stride, col_off + tx*col_stride); pixel centres, and so dx and
//     dy, from the global tile, the cotangent read and the guards local;
//   * chunks nused-1 .. 0 with nused = ceil(used / chunk); inside a chunk the
//     positions [max(c0, phi), min(c0 + chunk, used)) are the tile's own;
//   * alpha of every (pair, pixel) is recomputed by the forward's own
//     function (composite_common.cuh, both files built with -fmad=false), so
//     the hard thresholds fall on the same pixels; T is replayed forward from
//     the checkpoint the forward stored at the top of the chunk - never
//     rebuilt by dividing the tile's final T by (1 - alpha), which collapses
//     once T underflows;
//   * the suffix accumulator u starts at -d_a; per pair, back to front,
//       K = r*dc_r + g*dc_g + b*dc_b,   d_alpha = T_i * (K - u),
//       u <- u + alpha * (K - u);
//     the flow from d_alpha stops where alpha was clamped (alpha >= max_alpha)
//     and, in hard mode, where it was masked (alpha == 0);
//   * depth test: alpha is the forward's, killed pixels included (alpha = 0
//     there, so they add exact zeros to every sum and leave u as it was).
//     The scene depth is read from the caller's (height, width) float32
//     matrix, +inf beyond the image's edge, as in the forward.  The view-z
//     row and the scene depth get no gradient: the test is a hard mask;
//     dp2 = -2 * d_alpha * alpha;
//   * the nine sums, in this row order: dp2*dx, dp2*dy, dp2*dx^2, dp2*dx*dy,
//     dp2*dy^2, dc_r*w, dc_g*w, dc_b*w, dp2, with w = alpha * T_i and
//     dx = px - cx, dy = py - cy taken directly at every pixel.  Packed mode
//     writes eight int32 rows: the first six sums bit-cast, (dc_g*w, dc_b*w)
//     rounded to bf16 (nearest even) as the two halves of row 6, dp2 in row 7;
//   * written at column grad_base[t] + pos.  Pixels beyond the image edge
//     carry a zero cotangent and add exact zeros; the wrapper zero-fills the
//     whole space once, so positions outside [phi, used) and chunks the
//     forward never walked are never touched here.
//
// What is not carried over from the TPU design: the six-row sublane-factored
// emission with its chunk-end rebuild of the moments, the lane-vector copy of
// the centres, the 8-pair store groups and the (8, 128) pixel packing were all
// ways around the cost of moving rows on that machine.
//
// The replay memo.  The walk back needs alpha and T_i of every (pair, pixel)
// of a chunk in reverse order.  The TPU kernel keeps both for a whole chunk
// (2 x 512 KB at chunk 128); an SM has 227 KB of shared memory and 64K
// registers.  So a chunk is replayed on two levels, in sub-blocks of 8 pairs:
// pass 1 runs the chunk forward once and keeps only T at the top of every
// sub-block (chunk/8 x 4 pixels per thread, in shared memory, each thread
// reading back only what it wrote: 64 KB at chunk 128); pass 2 takes the
// sub-blocks in reverse, replays one forward from its stored T with alpha and
// T_i of its 8 pairs x 4 pixels kept in registers (64 of them), and walks it
// back.  Every alpha is thus computed twice here, both times bit-equal to the
// forward's; T is the forward's own product sequence.  About 80 KB of shared
// memory and under 128 registers a thread leave two blocks on an SM.
//
// The reductions.  Nine block-wide sums per pair are the cost.  A thread adds
// its 4 pixels, a warp reduces by xor-shuffles (16, 8, 4, 2, 1), lane 0 leaves
// the warp's nine partials in shared memory, and after one barrier per
// sub-block 72 threads add the 8 warps' partials in warp order: a fixed order
// throughout, no float atomics, so two runs give bit-equal sums.  A warp owns
// 4 whole pixel rows (not the forward's rows w, w+8, w+16, w+24), so a small
// splat touches few warps; a warp in which no lane has alpha != 0 adds exact
// zeros and skips the pair's arithmetic and shuffles.
//
// What bounds it: operations - two alpha evaluations and about 30 more float
// operations per pixel and pair, plus 45 shuffles per warp and pair, against
// 32 to 40 bytes of payload read and 32 to 36 bytes of sums written per pair.
//
// Plain C interface: nothing is allocated or synchronised here, and the entry
// returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>

#include "composite_common.cuh"

namespace {

using namespace gsplat;

constexpr int SUB = 8;              // pairs per sub-block of the replay
constexpr int WARPS = THREADS / 32;
constexpr int NSUMS = 9;

__device__ __forceinline__ int pack_bf16_pair(float hi, float lo) {
    const unsigned h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
    const unsigned l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
    return (int)((h << 16) | l);
}

template <bool PACKED, bool SOFT, bool DEPTH>
__global__ void __launch_bounds__(THREADS, 2)
composite_bwd_kernel(const int* __restrict__ fields,  // (ROWS, n_cols) 32-bit words
                     long long n_cols,
                     const float* __restrict__ bgd,   // (height, width) if DEPTH
                     const int* __restrict__ pair_splat,
                     const int* __restrict__ tile_base,
                     const int* __restrict__ tile_phi,
                     const int* __restrict__ used,
                     const int* __restrict__ grad_base,
                     const float* __restrict__ d_out,  // (height, width, 4)
                     const float* __restrict__ tchk,   // (num_tiles, max_chunks, 1024)
                     int* __restrict__ gout,           // (GROWS, g_pad) 32-bit words
                     long long g_pad,
                     int ntx, int height, int width, int chunk, int max_chunks,
                     float max_alpha, int row_stride, int col_stride, int row_off,
                     int col_off) {
    constexpr int ROWS = PayloadRows<PACKED, DEPTH>::value;
    constexpr int GROWS = PACKED ? 8 : NSUMS;
    extern __shared__ int smem[];
    int* s_idx = smem;                                              // [chunk]
    int* s_pay = s_idx + chunk;                                     // [ROWS][chunk]
    float* s_out = reinterpret_cast<float*>(s_pay + ROWS * chunk);  // [NSUMS][chunk]
    float* s_red = s_out + NSUMS * chunk;                           // [2][SUB][WARPS][NSUMS]
    float* s_tsub = s_red + 2 * SUB * WARPS * NSUMS;                // [chunk/SUB][PIX][THREADS]

    const int t = blockIdx.x;
    const int usedv = used[t];
    const int nused = (usedv + chunk - 1) / chunk;
    if (nused == 0) return;
    const int ty = t / ntx;
    const int tx = t - ty * ntx;
    const int base = tile_base[t];
    const int phi = tile_phi[t];
    const int gbase = grad_base[t];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    // This thread's pixels: column `lane`, rows 4*warp + k.  x, y local;
    // the centres from the global tile.
    const int gy0 = (row_off + ty * row_stride) * TILE;
    const int gx0 = (col_off + tx * col_stride) * TILE;
    const int x = tx * TILE + lane;
    const float px = (float)(gx0 + lane) + 0.5f;
    float py[PIX], dcr[PIX], dcg[PIX], dcb[PIX], u[PIX], zb[PIX];
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
        const int y = ty * TILE + 4 * warp + k;
        py[k] = (float)(gy0 + 4 * warp + k) + 0.5f;
        float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        zb[k] = far_depth();
        if (x < width && y < height) {
            d = *(reinterpret_cast<const float4*>(d_out) + ((long long)y * width + x));
            if (DEPTH) zb[k] = bgd[(long long)y * width + x];
        }
        dcr[k] = d.x;
        dcg[k] = d.y;
        dcb[k] = d.z;
        u[k] = -d.w;
    }
    const int pix0 = warp * (PIX * TILE) + lane;  // + k * TILE: row-major within the tile

    int buf = 0;
    for (int ci = nused - 1; ci >= 0; --ci) {
        const int c0 = ci * chunk;
        const int lo = max(c0, phi);
        const int hi = min(c0 + chunk, usedv);
        load_chunk<ROWS>(fields, n_cols, pair_splat, base, c0, lo, hi, chunk, s_idx, s_pay);
        const int p_lo = lo - c0;
        const int p_hi = hi - c0;
        const int sb0 = p_lo / SUB;
        const int sb1 = (p_hi - 1) / SUB;

        // Pass 1: the chunk forward from its checkpoint, keeping T at the top
        // of every sub-block.
        float T[PIX];
        {
            const float* chk = tchk + ((long long)t * max_chunks + ci) * TILE_PIXELS + pix0;
#pragma unroll
            for (int k = 0; k < PIX; ++k) T[k] = chk[k * TILE];
        }
        for (int s = sb0; s <= sb1; ++s) {
#pragma unroll
            for (int k = 0; k < PIX; ++k) s_tsub[(s * PIX + k) * THREADS + tid] = T[k];
            if (s == sb1) break;
            for (int j = 0; j < SUB; ++j) {
                const int p = s * SUB + j;
                if (p < p_lo || p >= p_hi) continue;
                const Pair q = read_pair<PACKED, DEPTH>(s_pay, chunk, p);
                const float dx = px - q.cx;
                const float dxax = dx * q.ax;
                const float dxbx = dx * q.bx;
#pragma unroll
                for (int k = 0; k < PIX; ++k) {
                    const float alpha =
                        pixel_alpha<SOFT, DEPTH>(q, dxax, dxbx, py[k] - q.cy, max_alpha, zb[k]);
                    T[k] = T[k] * (1.0f - alpha);
                }
            }
        }

        // Pass 2: sub-blocks in reverse; each replayed forward into registers,
        // then walked back.
        for (int s = sb1; s >= sb0; --s) {
            float a[SUB][PIX], Tm[SUB][PIX];
#pragma unroll
            for (int k = 0; k < PIX; ++k) T[k] = s_tsub[(s * PIX + k) * THREADS + tid];
#pragma unroll
            for (int j = 0; j < SUB; ++j) {
                const int p = s * SUB + j;
                const bool valid = (p >= p_lo) && (p < p_hi);
#pragma unroll
                for (int k = 0; k < PIX; ++k) {
                    a[j][k] = 0.0f;
                    Tm[j][k] = T[k];
                }
                if (valid) {
                    const Pair q = read_pair<PACKED, DEPTH>(s_pay, chunk, p);
                    const float dx = px - q.cx;
                    const float dxax = dx * q.ax;
                    const float dxbx = dx * q.bx;
#pragma unroll
                    for (int k = 0; k < PIX; ++k) {
                        const float alpha =
                            pixel_alpha<SOFT, DEPTH>(q, dxax, dxbx, py[k] - q.cy, max_alpha, zb[k]);
                        a[j][k] = alpha;
                        T[k] = T[k] * (1.0f - alpha);
                    }
                }
            }
#pragma unroll
            for (int j = SUB - 1; j >= 0; --j) {
                const int p = s * SUB + j;
                const bool valid = (p >= p_lo) && (p < p_hi);
                float sums[NSUMS];
#pragma unroll
                for (int r = 0; r < NSUMS; ++r) sums[r] = 0.0f;
                const bool mine = (a[j][0] != 0.0f) || (a[j][1] != 0.0f) || (a[j][2] != 0.0f) ||
                                  (a[j][3] != 0.0f);
                if (__any_sync(0xffffffffu, mine)) {
                    const Pair q = read_pair<PACKED, DEPTH>(s_pay, chunk, p);
                    const float dx = px - q.cx;
#pragma unroll
                    for (int k = 0; k < PIX; ++k) {
                        const float dy = py[k] - q.cy;
                        const float alpha = a[j][k];
                        const float t_i = Tm[j][k];
                        const float w_i = alpha * t_i;
                        const float k_i = q.cr * dcr[k] + q.cg * dcg[k] + q.cb * dcb[k];
                        const float ku = k_i - u[k];
                        const float d_alpha = t_i * ku;
                        const bool live = (alpha < max_alpha) && (SOFT || alpha > 0.0f);
                        const float ga = live ? d_alpha : 0.0f;
                        const float dp2 = -2.0f * ga * alpha;
                        const float dp2dx = dp2 * dx;
                        const float dp2dy = dp2 * dy;
                        sums[0] += dp2dx;
                        sums[1] += dp2dy;
                        sums[2] += dp2dx * dx;
                        sums[3] += dp2dx * dy;
                        sums[4] += dp2dy * dy;
                        sums[5] += dcr[k] * w_i;
                        sums[6] += dcg[k] * w_i;
                        sums[7] += dcb[k] * w_i;
                        sums[8] += dp2;
                        u[k] = u[k] + alpha * ku;
                    }
#pragma unroll
                    for (int off = 16; off >= 1; off >>= 1) {
#pragma unroll
                        for (int r = 0; r < NSUMS; ++r)
                            sums[r] += __shfl_xor_sync(0xffffffffu, sums[r], off);
                    }
                }
                if (lane == 0 && valid) {
                    float* dst = s_red + ((buf * SUB + j) * WARPS + warp) * NSUMS;
#pragma unroll
                    for (int r = 0; r < NSUMS; ++r) dst[r] = sums[r];
                }
            }
            __syncthreads();
            // The 8 warps' partials of this sub-block's pairs, added in warp
            // order.  The next sub-block writes the other half of s_red.
            if (tid < SUB * NSUMS) {
                const int j = tid / NSUMS;
                const int r = tid - j * NSUMS;
                const float* src = s_red + (buf * SUB + j) * WARPS * NSUMS + r;
                float acc = 0.0f;
#pragma unroll
                for (int w = 0; w < WARPS; ++w) acc += src[w * NSUMS];
                s_out[r * chunk + s * SUB + j] = acc;
            }
            buf ^= 1;
        }
        __syncthreads();

        // The chunk's own positions, row by row, to the gradient space.
        const int cnt = p_hi - p_lo;
        for (int w = tid; w < cnt * GROWS; w += THREADS) {
            const int r = w / cnt;
            const int p = p_lo + (w - r * cnt);
            int v;
            if (!PACKED) {
                v = __float_as_int(s_out[r * chunk + p]);
            } else if (r < 6) {
                v = __float_as_int(s_out[r * chunk + p]);
            } else if (r == 6) {
                v = pack_bf16_pair(s_out[6 * chunk + p], s_out[7 * chunk + p]);
            } else {
                v = __float_as_int(s_out[8 * chunk + p]);
            }
            gout[(long long)r * g_pad + gbase + c0 + p] = v;
        }
        // Frees s_idx, s_pay and s_out for the next chunk.
        __syncthreads();
    }
}

}  // namespace

// fields, pair_splat, tile_base, tile_phi: as gsplat_composite_fwd; with
// depth != 0 fields holds 11 float32 rows (row 10 the view-z) and bgd the
// (height, width) float32 scene depth (else null; never packed).
// used: (nty*ntx,) int32 and tchk: (nty*ntx, max_chunks, 1024) float32, as the
// checkpointed forward wrote them.  grad_base: (nty*ntx,) int32.
// d_out: (height, width, 4) float32, 16-byte aligned.
// gout: (9, g_pad) float32, or with packed != 0 (8, g_pad) int32; zero-filled
// by the caller.  row_stride, col_stride, row_off, col_off: the forward's tile
// mapping (1, 1, 0, 0 for a full frame; only that with depth != 0).
extern "C" int gsplat_composite_bwd(const void* fields, long long n_cols, int packed, int soft,
                                    int depth, const void* bgd, const void* pair_splat,
                                    const void* tile_base,
                                    const void* tile_phi, const void* tile_span,
                                    const void* used, const void* grad_base, const void* d_out,
                                    const void* tchk, void* gout, long long g_pad, int nty,
                                    int ntx, int height, int width, int chunk, int max_chunks,
                                    float max_alpha, int row_stride, int col_stride, int row_off,
                                    int col_off, void* stream) {
    (void)tile_span;  // used[t] <= span[t] already bounds every walk
    const int num_tiles = nty * ntx;
    if (num_tiles <= 0) return 0;
    if (chunk <= 0 || chunk % SUB != 0) return (int)cudaErrorInvalidValue;
    if (depth && (packed || bgd == nullptr)) return (int)cudaErrorInvalidValue;
    if (row_stride < 1 || col_stride < 1 || row_off < 0 || col_off < 0) return (int)cudaErrorInvalidValue;
    if (depth && (row_stride != 1 || col_stride != 1 || row_off != 0 || col_off != 0))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int rows = packed ? 8 : (depth ? 11 : 10);
    const size_t words = (size_t)chunk * (1 + rows + NSUMS) + 2 * SUB * WARPS * NSUMS +
                         (size_t)(chunk / SUB) * gsplat::PIX * gsplat::THREADS;
    const size_t shmem = words * sizeof(int);
    if (shmem > 227 * 1024) return (int)cudaErrorInvalidValue;
    const int* f = static_cast<const int*>(fields);
    const float* bd = static_cast<const float*>(bgd);
    const int* ps = static_cast<const int*>(pair_splat);
    const int* tb = static_cast<const int*>(tile_base);
    const int* tp = static_cast<const int*>(tile_phi);
    const int* us = static_cast<const int*>(used);
    const int* gb = static_cast<const int*>(grad_base);
    const float* dout = static_cast<const float*>(d_out);
    const float* tc = static_cast<const float*>(tchk);
    int* go = static_cast<int*>(gout);
#define GSPLAT_LAUNCH(P, S, D)                                                                 \
    do {                                                                                       \
        cudaError_t e = cudaFuncSetAttribute(composite_bwd_kernel<P, S, D>,                    \
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,      \
                                             (int)shmem);                                      \
        if (e != cudaSuccess) return (int)e;                                                   \
        composite_bwd_kernel<P, S, D><<<num_tiles, gsplat::THREADS, shmem, s>>>(               \
            f, n_cols, bd, ps, tb, tp, us, gb, dout, tc, go, g_pad, ntx, height, width, chunk, \
            max_chunks, max_alpha, row_stride, col_stride, row_off, col_off);                  \
    } while (0)
    if (depth) {
        if (soft) GSPLAT_LAUNCH(false, true, true); else GSPLAT_LAUNCH(false, false, true);
    } else if (packed) {
        if (soft) GSPLAT_LAUNCH(true, true, false); else GSPLAT_LAUNCH(true, false, false);
    } else {
        if (soft) GSPLAT_LAUNCH(false, true, false); else GSPLAT_LAUNCH(false, false, false);
    }
#undef GSPLAT_LAUNCH
    return (int)cudaGetLastError();
}
