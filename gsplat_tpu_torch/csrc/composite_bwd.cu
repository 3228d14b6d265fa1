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
//     writes eight int32 words: the first six sums bit-cast, (dc_g*w, dc_b*w)
//     rounded to bf16 (nearest even) as the two halves of word 6, dp2 in word 7;
//   * written pair-major, to row grad_base[t] + pos of the (g_pad, 9) float32
//     or (g_pad, 8) int32 gradient space, so that a pair's words are one
//     32-byte sector (packed) and its reader fetches them at once (a chunk's
//     positions are one contiguous run of words).  Pixels beyond the image edge
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
// back.  Every alpha is computed twice here, both times bit-equal to the
// forward's; T is the forward's own product sequence.
//
// The reach test.  A warp owns a rectangle of 128 pixels, 8 rows by 16
// columns, a thread 4 of them in one column (composite_common.cuh, shared
// with the forward).  When a chunk's payload is read, each
// pair gets a mask of the warps whose rectangle it can reach
// (composite_common.cuh reach_bits; all warps in soft mode).  A warp
// outside it skips the pair in pass 1 (T is
// left as it is, which is exact: T * (1 - 0) = T), in the replay (alpha =
// 0) and in the walk back: it adds exact zeros, so skipping changes no value.
// The test keeps every warp a live pixel lies in; the AUDIT instance, for
// the checks only, evaluates alpha in every skipped warp anyway and counts
// the pixels where it is not 0 into `audit`, which must stay 0.
//
// The reductions.  Nine sums over the tile's pixels per pair.  A thread adds
// its 4 pixels; a warp reduces the 9 x 8 sums of a sub-block across its 32
// lanes by halving exchanges, folded into the walk back: pairs (7, 6), (5,
// 4), ... meet at xor 16, where a lane keeps one pair's nine values and
// sends the other's; then xor 8 and xor 4 join those, and xor 2 and xor 1
// halve the nine values themselves.  71 shuffles a warp and sub-block
// (against 45 a pair and warp), after which lane L holds up to 3 of the
// sums of pair (L>>2 & 1)*4 + (L>>3 & 1)*2 + (L>>4 & 1).  The lanes leave
// them in shared memory for the whole chunk, and after one barrier a chunk
// all 256 threads add the 8 warps' partials in warp order and write the
// gradient space.  A fixed order throughout and no float atomics, so two
// runs give bit-equal sums.  A warp with no alpha != 0 in a sub-block skips
// the exchanges and leaves zeros.
//
// The arithmetic of the walk back (K, dalpha, dp2, the nine sums, u) is
// written with explicit __fmaf_rn; alpha and T are the forward's separately
// rounded operations (the file is built with -fmad=false for them).
//
// Tile order: block b takes tile order[b] (the wrapper passes the tiles
// longest walk first, so that the long tiles do not start in the last
// wave); each tile stays wholly in one block, so the output does not depend
// on the order.
//
// What bounds it: operations - two alpha evaluations and about 30 more float
// operations per live pixel and pair, against 32 to 40 bytes of payload read
// and 32 to 36 bytes of sums written per pair.
//
// Plain C interface: nothing is allocated or synchronised here, and the entry
// returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>

#include "composite_common.cuh"

namespace {

using namespace gsplat;

constexpr int SUB = 8;              // pairs per sub-block of the replay
constexpr int NSUMS = 9;
// s_red's rows (one a sum) are WARPS * chunk + RED_PAD words apart, so that
// the store loop's reads (8 or 9 sums of 4 neighbouring pairs a warp) fall
// in 32 distinct banks; at WARPS * chunk words apart, a multiple of 32, the
// lanes that share a pair would all hit one bank.
constexpr int RED_PAD = 4;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int pack_bf16_pair(float hi, float lo) {
    const unsigned h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
    const unsigned l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
    return (int)((h << 16) | l);
}

// One halving exchange: this lane keeps `a` (bit clear) or `b` (bit set) of
// two nine-value sets and adds its partner's copy of the same set.
__device__ __forceinline__ void halve(float (&out)[NSUMS], const float (&a)[NSUMS], const float (&b)[NSUMS],
                                      bool bit, int mask) {
#pragma unroll
    for (int r = 0; r < NSUMS; ++r) {
        const float keep = bit ? b[r] : a[r];
        const float send = bit ? a[r] : b[r];
        out[r] = keep + __shfl_xor_sync(FULL, send, mask);
    }
}

template <bool PACKED, bool SOFT, bool DEPTH, bool AUDIT>
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
                     int* __restrict__ gout,           // (g_pad, GROWS) 32-bit words
                     const int* __restrict__ order,    // (num_tiles,)
                     int* __restrict__ audit,          // AUDIT: skipped live pixels
                     int ntx, int height, int width, int chunk, int max_chunks,
                     float max_alpha, int row_stride, int col_stride, int row_off,
                     int col_off) {
    constexpr int ROWS = PayloadRows<PACKED, DEPTH>::value;
    constexpr int GROWS = PACKED ? 8 : NSUMS;
    extern __shared__ int smem[];
    int* s_idx = smem;                                              // [chunk]
    int* s_pay = s_idx + chunk;                                     // [ROWS][chunk]
    int* s_reach = s_pay + ROWS * chunk;                            // [chunk] warp bits
    const int red_stride = WARPS * chunk + RED_PAD;
    float* s_red = reinterpret_cast<float*>(s_reach + chunk);       // [NSUMS][red_stride]: [WARPS][chunk]
    float* s_tsub = s_red + NSUMS * red_stride;                     // [chunk/SUB][PIX][THREADS]

    const int t = order[blockIdx.x];
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

    // This thread's pixels: column warp_x0 + lane % WARP_W, rows warp_y0 +
    // PIX*(lane / WARP_W) + k of the tile.  x, y local; the centres from the
    // global tile.
    const int lx = warp_x0(warp) + lane % WARP_W;
    const int ly0 = warp_y0(warp) + PIX * (lane / WARP_W);
    const int gy0 = (row_off + ty * row_stride) * TILE;
    const int gx0 = (col_off + tx * col_stride) * TILE;
    const int x = tx * TILE + lx;
    const float px = (float)(gx0 + lx) + 0.5f;
    float py[PIX], dcr[PIX], dcg[PIX], dcb[PIX], u[PIX], zb[PIX];
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
        const int y = ty * TILE + ly0 + k;
        py[k] = (float)(gy0 + ly0 + k) + 0.5f;
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
    const int pix0 = ly0 * TILE + lx;  // + k * TILE: row-major within the tile
    const unsigned my_bit = 1u << warp;
    // the lane's place in the halving exchanges: the pair of the sub-block
    // its final sums belong to, and which of the nine
    const bool b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
    const bool b1 = (lane >> 1) & 1, b0 = lane & 1;
    const int my_pair = (int)b2 * 4 + (int)b3 * 2 + (int)b4;
    const int my_r0 = (int)b1 * 5 + (int)b0 * 3;
    const int my_cnt = b0 ? (b1 ? 1 : 2) : 3;

    for (int ci = nused - 1; ci >= 0; --ci) {
        const int c0 = ci * chunk;
        const int lo = max(c0, phi);
        const int hi = min(c0 + chunk, usedv);
        load_chunk<ROWS>(fields, n_cols, pair_splat, base, c0, lo, hi, chunk, s_idx, s_pay);
        const int p_lo = lo - c0;
        const int p_hi = hi - c0;
        // Every pair's warp mask.
        store_reach<PACKED, DEPTH>(s_pay, chunk, p_lo, p_hi, s_reach, [&](const Pair& q) {
            return SOFT ? ALL_WARPS : reach_bits(q, gx0, gy0, QUAD_REACH);
        });
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
                if (p < p_lo || p >= p_hi || !(s_reach[p] & my_bit)) continue;
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
            bool any_alpha = false;
#pragma unroll
            for (int j = 0; j < SUB; ++j) {
                const int p = s * SUB + j;
                const bool valid = (p >= p_lo) && (p < p_hi);
                const bool reach = valid && (s_reach[p] & my_bit);
#pragma unroll
                for (int k = 0; k < PIX; ++k) {
                    a[j][k] = 0.0f;
                    Tm[j][k] = T[k];
                }
                if (reach) {
                    const Pair q = read_pair<PACKED, DEPTH>(s_pay, chunk, p);
                    const float dx = px - q.cx;
                    const float dxax = dx * q.ax;
                    const float dxbx = dx * q.bx;
#pragma unroll
                    for (int k = 0; k < PIX; ++k) {
                        const float alpha =
                            pixel_alpha<SOFT, DEPTH>(q, dxax, dxbx, py[k] - q.cy, max_alpha, zb[k]);
                        a[j][k] = alpha;
                        any_alpha |= alpha != 0.0f;
                        T[k] = T[k] * (1.0f - alpha);
                    }
                } else if (AUDIT && valid) {
                    const Pair q = read_pair<PACKED, DEPTH>(s_pay, chunk, p);
                    const float dx = px - q.cx;
                    int live = 0;
#pragma unroll
                    for (int k = 0; k < PIX; ++k)
                        live += pixel_alpha<SOFT, DEPTH>(q, dx * q.ax, dx * q.bx, py[k] - q.cy, max_alpha,
                                                         zb[k]) != 0.0f;
                    if (live) atomicAdd(audit, live);
                }
            }
            // Where this sub-block's partials go: pair my_pair, sums my_r0 ...
            float* dst = s_red + my_r0 * red_stride + warp * chunk + s * SUB + my_pair;
            if (!__any_sync(FULL, any_alpha)) {
                // no alpha != 0 in the warp: zeros, and u stays as it is
                for (int i = 0; i < my_cnt; ++i) dst[i * red_stride] = 0.0f;
                continue;
            }
            float odd[NSUMS], l1_hi[NSUMS], l2_hi[NSUMS], l3[NSUMS];
#pragma unroll
            for (int j = SUB - 1; j >= 0; --j) {
                float sums[NSUMS];
#pragma unroll
                for (int r = 0; r < NSUMS; ++r) sums[r] = 0.0f;
                const bool mine = (a[j][0] != 0.0f) || (a[j][1] != 0.0f) || (a[j][2] != 0.0f) ||
                                  (a[j][3] != 0.0f);
                if (__any_sync(FULL, mine)) {
                    const int p = s * SUB + j;
                    const Pair q = read_pair<PACKED, DEPTH>(s_pay, chunk, p);
                    const float dx = px - q.cx;
#pragma unroll
                    for (int k = 0; k < PIX; ++k) {
                        const float dy = py[k] - q.cy;
                        const float alpha = a[j][k];
                        const float t_i = Tm[j][k];
                        const float w_i = alpha * t_i;
                        const float k_i = __fmaf_rn(q.cr, dcr[k], __fmaf_rn(q.cg, dcg[k], q.cb * dcb[k]));
                        const float ku = k_i - u[k];
                        const float d_alpha = t_i * ku;
                        const bool live = (alpha < max_alpha) && (SOFT || alpha > 0.0f);
                        const float ga = live ? d_alpha : 0.0f;
                        const float dp2 = (-2.0f * ga) * alpha;
                        const float dp2dx = dp2 * dx;
                        const float dp2dy = dp2 * dy;
                        sums[0] += dp2dx;
                        sums[1] += dp2dy;
                        sums[2] = __fmaf_rn(dp2dx, dx, sums[2]);
                        sums[3] = __fmaf_rn(dp2dx, dy, sums[3]);
                        sums[4] = __fmaf_rn(dp2dy, dy, sums[4]);
                        sums[5] = __fmaf_rn(dcr[k], w_i, sums[5]);
                        sums[6] = __fmaf_rn(dcg[k], w_i, sums[6]);
                        sums[7] = __fmaf_rn(dcb[k], w_i, sums[7]);
                        sums[8] += dp2;
                        u[k] = __fmaf_rn(alpha, ku, u[k]);
                    }
                }
                // Pair j's bits: j0 at lane bit 4, j1 at bit 3, j2 at bit 2.
                if (j & 1) {
#pragma unroll
                    for (int r = 0; r < NSUMS; ++r) odd[r] = sums[r];
                } else {
                    float l1[NSUMS];
                    halve(l1, sums, odd, b4, 16);
                    if (j & 2) {
#pragma unroll
                        for (int r = 0; r < NSUMS; ++r) l1_hi[r] = l1[r];
                    } else {
                        float l2[NSUMS];
                        halve(l2, l1, l1_hi, b3, 8);
                        if (j & 4) {
#pragma unroll
                            for (int r = 0; r < NSUMS; ++r) l2_hi[r] = l2[r];
                        } else {
                            halve(l3, l2, l2_hi, b2, 4);
                        }
                    }
                }
            }
            // The nine values of pair my_pair over the 8 lanes that share
            // bits 4..2; xor 2 and xor 1 halve them: 5 + 3 shuffles.
            float k5[5];
#pragma unroll
            for (int i = 0; i < 5; ++i) {
                const float lo5 = l3[i];
                const float hi5 = i < 4 ? l3[5 + i] : 0.0f;
                k5[i] = (b1 ? hi5 : lo5) + __shfl_xor_sync(FULL, b1 ? lo5 : hi5, 2);
            }
            float k3[3];
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                const float lo3 = k5[i];
                const float hi3 = i < 2 ? k5[3 + i] : 0.0f;
                k3[i] = (b0 ? hi3 : lo3) + __shfl_xor_sync(FULL, b0 ? lo3 : hi3, 1);
            }
#pragma unroll
            for (int i = 0; i < 3; ++i)
                if (i < my_cnt) dst[i * red_stride] = k3[i];
        }
        __syncthreads();

        // The chunk's own positions to the gradient space, pair-major: word w
        // of the run is word r of pair p, the 8 warps' partials added in warp
        // order.
        const int cnt = p_hi - p_lo;
        const long long row0 = (long long)gbase + c0 + p_lo;
        for (int w = tid; w < cnt * GROWS; w += THREADS) {
            const int pi = w / GROWS;
            const int r = w - pi * GROWS;
            const int p = p_lo + pi;
            auto total = [&](int row) {
                const float* src = s_red + row * red_stride + p;
                float acc = 0.0f;
#pragma unroll
                for (int wv = 0; wv < WARPS; ++wv) acc += src[wv * chunk];
                return acc;
            };
            int v;
            if (!PACKED || r < 6) {
                v = __float_as_int(total(r));
            } else if (r == 6) {
                v = pack_bf16_pair(total(6), total(7));
            } else {
                v = __float_as_int(total(8));
            }
            gout[row0 * GROWS + w] = v;
        }
        // load_chunk's first barrier keeps the next chunk's writes of s_red
        // and s_tsub behind these reads.
    }
}

}  // namespace

// fields, pair_splat, tile_base, tile_phi: as gsplat_composite_fwd; with
// depth != 0 fields holds 11 float32 rows (row 10 the view-z) and bgd the
// (height, width) float32 scene depth (else null; never packed).
// used: (nty*ntx,) int32 and tchk: (nty*ntx, max_chunks, 1024) float32, as the
// checkpointed forward wrote them.  grad_base: (nty*ntx,) int32.
// d_out: (height, width, 4) float32, 16-byte aligned.
// gout: (g_pad, 9) float32, or with packed != 0 (g_pad, 8) int32, pair-major;
// zero-filled by the caller.  row_stride, col_stride, row_off, col_off: the forward's tile
// mapping (1, 1, 0, 0 for a full frame; only that with depth != 0).
// order: a permutation of the nty*ntx tiles, the order blocks take them in.
// audit: null, or one int32 (hard cutoff only) to which the audit instance
// adds the pixels with alpha != 0 in the warps the reach test skipped.
extern "C" int gsplat_composite_bwd(const void* fields, long long n_cols, int packed, int soft,
                                    int depth, const void* bgd, const void* pair_splat,
                                    const void* tile_base,
                                    const void* tile_phi, const void* tile_span,
                                    const void* used, const void* grad_base, const void* d_out,
                                    const void* tchk, void* gout, int nty,
                                    int ntx, int height, int width, int chunk, int max_chunks,
                                    float max_alpha, int row_stride, int col_stride, int row_off,
                                    int col_off, const void* order, void* audit, void* stream) {
    (void)tile_span;  // used[t] <= span[t] already bounds every walk
    const int num_tiles = nty * ntx;
    if (num_tiles <= 0) return 0;
    if (chunk <= 0 || chunk % SUB != 0) return (int)cudaErrorInvalidValue;
    if (depth && (packed || bgd == nullptr)) return (int)cudaErrorInvalidValue;
    if (row_stride < 1 || col_stride < 1 || row_off < 0 || col_off < 0) return (int)cudaErrorInvalidValue;
    if (depth && (row_stride != 1 || col_stride != 1 || row_off != 0 || col_off != 0))
        return (int)cudaErrorInvalidValue;
    if (order == nullptr) return (int)cudaErrorInvalidValue;
    if (audit != nullptr && soft) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int rows = packed ? 8 : (depth ? 11 : 10);
    const size_t words = (size_t)chunk * (1 + rows + 1) + (size_t)NSUMS * (WARPS * chunk + RED_PAD) +
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
    const int* od = static_cast<const int*>(order);
    int* au = static_cast<int*>(audit);
    int* go = static_cast<int*>(gout);
#define GSPLAT_LAUNCH(P, S, D, A)                                                                \
    do {                                                                                         \
        cudaError_t e = cudaFuncSetAttribute(composite_bwd_kernel<P, S, D, A>,                   \
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                                             (int)shmem);                                        \
        if (e != cudaSuccess) return (int)e;                                                     \
        composite_bwd_kernel<P, S, D, A><<<num_tiles, gsplat::THREADS, shmem, s>>>(              \
            f, n_cols, bd, ps, tb, tp, us, gb, dout, tc, go, od, au, ntx, height, width,  \
            chunk, max_chunks, max_alpha, row_stride, col_stride, row_off, col_off);             \
    } while (0)
    const bool a = au != nullptr;
    if (depth) {
        if (soft) GSPLAT_LAUNCH(false, true, true, false);
        else if (a) GSPLAT_LAUNCH(false, false, true, true);
        else GSPLAT_LAUNCH(false, false, true, false);
    } else if (packed) {
        if (soft) GSPLAT_LAUNCH(true, true, false, false);
        else if (a) GSPLAT_LAUNCH(true, false, false, true);
        else GSPLAT_LAUNCH(true, false, false, false);
    } else {
        if (soft) GSPLAT_LAUNCH(false, true, false, false);
        else if (a) GSPLAT_LAUNCH(false, false, false, true);
        else GSPLAT_LAUNCH(false, false, false, false);
    }
#undef GSPLAT_LAUNCH
    return (int)cudaGetLastError();
}
