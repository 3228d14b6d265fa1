// Compositing forward: one block per 32x32 tile walks the tile's depth-ordered
// (tile, splat) pair segment front to back.
//
// Replaces the forward half of the TPU kernel
// gsplat_tpu/ops/pallas/composite.py:_fwd_kernel (with _splat_alpha and
// _pixel_coords), with and without transmittance checkpoints (a template
// flag), in three modes (a template parameter): the Gaussian beauty pass, the
// same with the depth test against a host scene's depth, and the wireframe
// band test.  What it computes is the same:
//
//   * the strided/offset tile mapping of the sharded renderer: block
//     (ty, tx) is local tile (ty, tx) of a (height, width) strip image and
//     global tile (row_off + ty*row_stride, col_off + tx*col_stride) of the
//     frame (the TPU kernel's off_ref, row_stride, col_stride).  Offsets are
//     in tiles, and runtime ints: no new template instances;
//   * pixel centres from the GLOBAL tile, an integer first and then a float
//     plus 0.5: (gtx*32 + col + 0.5, gty*32 + row + 0.5), so a strip is bit
//     for bit the matching pixels of a full-frame render.  The image write,
//     the x < width, y < height guards, used[] and tchk stay LOCAL;
//   * pair positions pos in [phi, span) counted from tile_base are the
//     tile's own; the lanes before phi and from span on belong to the
//     neighbouring tiles and are never read;
//   * alpha = min(exp(-(qx^2 + qy^2)) * op, max_alpha); in hard mode also
//     qx^2 <= 4, qy^2 <= 4 and alpha >= 1/255, else 0;
//   * depth test: then alpha = 0 where the splat's view-z (payload row 10)
//     is not <= the scene depth at the pixel.  The kernel reads the caller's
//     (height, width) float32 depth directly; pixels beyond the image's edge
//     count as +inf, so they never kill and vote in the early stop as they
//     would without the test;
//   * wireframe: alpha = 1 where |max(|qx|, |qy|) - 2| <= wq and op > 0, else
//     0, with wq = line_px * |A| or line_px * |B| by the larger of |qx|, |qy|
//     (composite_common.cuh:wire_alpha); no clamp, no depth test;
//   * acc += (alpha * T) * c;  T *= (1 - alpha), one multiply per pair in
//     pair order; the alpha channel is 1 - T;
//   * the early stop sits on the chunk grid counted from tile_base (NOT from
//     the segment's first pair): after each `chunk` positions the tile stops
//     iff every one of its 1024 pixels (those beyond the image edge
//     included) has T <= t_eps.  A pixel whose own T is already below t_eps
//     keeps accumulating until the whole tile stops;
//   * used[t] = min(span, chunks_walked * chunk);
//   * with checkpoints: at the top of every chunk ci it walks, each thread
//     stores its pixels' T into tchk[t][ci][pixel], pixels row-major within
//     the tile (the layout is this port's own; a warp stores 32 neighbouring
//     floats).  The tensor is sized for tile_capacity / chunk + 1 chunks a
//     tile, the most a capped span can reach, so nothing is read back to
//     size it.  Image and used[] do not depend on the flag.
//
// What differs from the TPU design, and why.  The TPU kernel needed a
// (rows, P_pad) pair payload materialised by a gather beforehand, because it
// cannot gather per pair; here each block reads pair_splat[j] and then
// column pair_splat[j] of the per-splat matrix itself, so the gather is part
// of this function and the pair payload never exists in device memory.  The
// (8, 128) register packing of a tile (and of the scene depth,
// pack_depth_packed), the zero rows that pad the payload to 16, and int32
// transport against denormal flushing have no counterpart: a packed word is
// bit-cast with __int_as_float, and the image is written as (H, W, 4) float
// with the ragged right and bottom tiles masked.
//
// Layout of a block: 256 threads; thread t owns column t % 32 and rows
// t / 32 + {0, 8, 16, 24}, so a warp writes 32 neighbouring float4 pixels.
// Per chunk the threads first read the chunk's pair indices, then the
// payload words of those splats, into shared memory; after a barrier every
// thread composites the chunk's pairs in order, reading each pair's words as
// a shared-memory broadcast; __syncthreads_or is the tile-wide vote.
//
// What bounds it: operations.  Every live pair costs 1024 pixel updates of
// about 30 float instructions plus one expf each, against 32 to 40 bytes of
// payload, so the float/exp issue rate and the per-pair shared-memory
// broadcast (8 to 10 words per pair per warp) bound it, not device memory.
// The payload read is a scattered 4-byte read per row (rows are N apart),
// which wastes most of each 32-byte sector; with all blocks of an SM
// overlapping each other's loads this stays behind the arithmetic.
//
// Floating point.  The result is held against a sequence of separately
// rounded PyTorch ops across hard thresholds (alpha >= 1/255, q^2 <= 4, the
// wireframe band's edge), where a one-ulp difference flips a pixel's
// contribution by up to about 4e-3 (a whole line pixel in wireframe mode).  So this file is compiled with -fmad=false (no a*b+c contraction),
// uses expf and not __expf, and never fast math.  That costs roughly the
// share of multiply-add pairs that could have been fused (about a third of
// the float instructions here); lifting it means accepting threshold flips
// against the plain version, and is a later decision.
//
// Plain C interface: nothing is allocated or synchronised here, and the
// entry returns cudaGetLastError() after its launch.

#include "composite_common.cuh"

namespace {

using namespace gsplat;  // PIX = 4 pixels per thread: rows r0, r0+8, r0+16, r0+24

constexpr int MODE_BEAUTY = 0;
constexpr int MODE_DEPTH = 1;
constexpr int MODE_WIRE = 2;

template <bool PACKED, bool SOFT, bool CHK, int MODE>
__global__ void __launch_bounds__(THREADS)
composite_fwd_kernel(const int* __restrict__ fields,  // (ROWS, n_cols) 32-bit words
                     long long n_cols,
                     const float* __restrict__ bgd,   // (height, width) if MODE_DEPTH
                     const int* __restrict__ pair_splat,
                     const int* __restrict__ tile_base,
                     const int* __restrict__ tile_phi,
                     const int* __restrict__ tile_span,
                     float* __restrict__ image,  // (height, width, 4)
                     int* __restrict__ used,     // (num_tiles,)
                     float* __restrict__ tchk,   // (num_tiles, max_chunks, 1024) if CHK
                     int ntx, int height, int width, int chunk, int max_chunks,
                     float max_alpha, float t_eps, float line_px,
                     int row_stride, int col_stride, int row_off, int col_off) {
    constexpr bool DEPTH = MODE == MODE_DEPTH;
    constexpr int ROWS = PayloadRows<PACKED, DEPTH>::value;
    extern __shared__ int smem[];
    int* s_idx = smem;          // [chunk]
    int* s_pay = smem + chunk;  // [ROWS][chunk]

    const int t = blockIdx.x;
    const int ty = t / ntx;
    const int tx = t - ty * ntx;
    const int base = tile_base[t];
    const int phi = tile_phi[t];
    const int span = tile_span[t];
    const int tid = threadIdx.x;
    const int col = tid & (TILE - 1);
    const int row0 = tid >> 5;

    // first global pixel row and column of this tile
    const int gy0 = (row_off + ty * row_stride) * TILE;
    const int gx0 = (col_off + tx * col_stride) * TILE;
    const float px = (float)(gx0 + col) + 0.5f;
    float py[PIX], T[PIX], acc_r[PIX], acc_g[PIX], acc_b[PIX], zb[PIX];
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
        const int y = ty * TILE + row0 + 8 * k;  // local
        const int x = tx * TILE + col;
        py[k] = (float)(gy0 + row0 + 8 * k) + 0.5f;
        T[k] = 1.0f;
        acc_r[k] = 0.0f;
        acc_g[k] = 0.0f;
        acc_b[k] = 0.0f;
        zb[k] = (DEPTH && x < width && y < height) ? bgd[(long long)y * width + x] : far_depth();
    }

    const int nchunks = (span + chunk - 1) / chunk;
    int ci = 0;
    while (ci < nchunks) {
        const int c0 = ci * chunk;
        const int lo = max(c0, phi);
        const int hi = min(c0 + chunk, span);
        // hi - lo >= 1: phi < chunk and span > phi

        if (CHK) {
#pragma unroll
            for (int k = 0; k < PIX; ++k)
                tchk[((long long)t * max_chunks + ci) * TILE_PIXELS + k * THREADS + tid] = T[k];
        }
        load_chunk<ROWS>(fields, n_cols, pair_splat, base, c0, lo, hi, chunk, s_idx, s_pay);

        for (int p = lo - c0; p < hi - c0; ++p) {
            const Pair q = read_pair<PACKED, DEPTH>(s_pay, chunk, p);
            const float dx = px - q.cx;
            const float dxax = dx * q.ax;
            const float dxbx = dx * q.bx;
            float wq1 = 0.0f, wq2 = 0.0f;
            if (MODE == MODE_WIRE) {
                wq1 = line_px * sqrtf(q.ax * q.ax + q.ay * q.ay);
                wq2 = line_px * sqrtf(q.bx * q.bx + q.by * q.by);
            }
#pragma unroll
            for (int k = 0; k < PIX; ++k) {
                const float dy = py[k] - q.cy;
                const float alpha = (MODE == MODE_WIRE)
                                        ? wire_alpha(q, dxax, dxbx, dy, wq1, wq2)
                                        : pixel_alpha<SOFT, DEPTH>(q, dxax, dxbx, dy, max_alpha, zb[k]);
                const float w = alpha * T[k];
                acc_r[k] = acc_r[k] + w * q.cr;
                acc_g[k] = acc_g[k] + w * q.cg;
                acc_b[k] = acc_b[k] + w * q.cb;
                T[k] = T[k] * (1.0f - alpha);
            }
        }
        ++ci;
        const float tmax = fmaxf(fmaxf(T[0], T[1]), fmaxf(T[2], T[3]));
        // Tile-wide vote; also the barrier that frees shared memory for the
        // next chunk.
        if (!__syncthreads_or(tmax > t_eps)) break;
    }

    const int x = tx * TILE + col;
    if (x < width) {
#pragma unroll
        for (int k = 0; k < PIX; ++k) {
            const int y = ty * TILE + row0 + 8 * k;
            if (y < height) {
                float4* dst = reinterpret_cast<float4*>(image) + ((long long)y * width + x);
                *dst = make_float4(acc_r[k], acc_g[k], acc_b[k], 1.0f - T[k]);
            }
        }
    }
    if (tid == 0) used[t] = min(span, ci * chunk);
}

}  // namespace

// fields: (10, n_cols) float32 rows [cx cy ax ay bx by r g b op], or with
// packed != 0 (8, n_cols) int32 rows [cx cy ax ay bx by (r,g) (b,op)], the
// first six bit-cast float32 and the last two holding two bf16 halves; with
// mode 1 (depth test) (11, n_cols) float32, row 10 the view-z.
// mode: 0 Gaussian, 1 Gaussian with the depth test against bgd ((height,
// width) float32, else null), 2 wireframe band of half-width line_px.
// image: (height, width, 4) float32, 16-byte aligned; used: (nty*ntx,) int32.
// tchk: (nty*ntx, max_chunks, 1024) float32 to take the checkpoints, or null.
// row_stride, col_stride (>= 1), row_off, col_off (>= 0): local tile (ty, tx)
// is global tile (row_off + ty*row_stride, col_off + tx*col_stride); 1, 1, 0, 0
// for a full frame.  Mode 1 takes only the full-frame mapping (its scene depth
// is the local image's).
// Combinations built: every mode with packed = 0; modes 0 and 2 packed;
// soft and checkpoints in modes 0 and 1.  Others return cudaErrorInvalidValue.
extern "C" int gsplat_composite_fwd(const void* fields, long long n_cols, int packed, int soft,
                                    int mode, const void* bgd, float line_px,
                                    const void* pair_splat, const void* tile_base,
                                    const void* tile_phi, const void* tile_span, void* image,
                                    void* used, void* tchk, int nty, int ntx, int height,
                                    int width, int chunk, int max_chunks, float max_alpha,
                                    float t_eps, int row_stride, int col_stride, int row_off,
                                    int col_off, void* stream) {
    const int num_tiles = nty * ntx;
    if (num_tiles <= 0) return 0;
    if (mode < MODE_BEAUTY || mode > MODE_WIRE) return (int)cudaErrorInvalidValue;
    if (row_stride < 1 || col_stride < 1 || row_off < 0 || col_off < 0) return (int)cudaErrorInvalidValue;
    if (mode == MODE_DEPTH && (row_stride != 1 || col_stride != 1 || row_off != 0 || col_off != 0))
        return (int)cudaErrorInvalidValue;
    if (mode == MODE_DEPTH && (packed || bgd == nullptr)) return (int)cudaErrorInvalidValue;
    if (mode == MODE_WIRE && (soft || tchk != nullptr)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int rows = packed ? 8 : (mode == MODE_DEPTH ? 11 : 10);
    const size_t shmem = (size_t)(rows + 1) * chunk * sizeof(int);
    if (shmem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const int* f = static_cast<const int*>(fields);
    const float* bd = static_cast<const float*>(bgd);
    const int* ps = static_cast<const int*>(pair_splat);
    const int* tb = static_cast<const int*>(tile_base);
    const int* tp = static_cast<const int*>(tile_phi);
    const int* ts = static_cast<const int*>(tile_span);
    float* im = static_cast<float*>(image);
    int* u = static_cast<int*>(used);
    float* tc = static_cast<float*>(tchk);
#define GSPLAT_LAUNCH(P, S, C, M)                                                        \
    composite_fwd_kernel<P, S, C, M><<<num_tiles, gsplat::THREADS, shmem, s>>>(          \
        f, n_cols, bd, ps, tb, tp, ts, im, u, tc, ntx, height, width, chunk, max_chunks, \
        max_alpha, t_eps, line_px, row_stride, col_stride, row_off, col_off)
#define GSPLAT_LAUNCH_C(P, S, M)                                                         \
    do {                                                                                 \
        if (tc) GSPLAT_LAUNCH(P, S, true, M); else GSPLAT_LAUNCH(P, S, false, M);        \
    } while (0)
    if (mode == MODE_WIRE) {
        if (packed) GSPLAT_LAUNCH(true, false, false, MODE_WIRE);
        else GSPLAT_LAUNCH(false, false, false, MODE_WIRE);
    } else if (mode == MODE_DEPTH) {
        if (soft) GSPLAT_LAUNCH_C(false, true, MODE_DEPTH); else GSPLAT_LAUNCH_C(false, false, MODE_DEPTH);
    } else if (packed) {
        if (soft) GSPLAT_LAUNCH_C(true, true, MODE_BEAUTY); else GSPLAT_LAUNCH_C(true, false, MODE_BEAUTY);
    } else {
        if (soft) GSPLAT_LAUNCH_C(false, true, MODE_BEAUTY); else GSPLAT_LAUNCH_C(false, false, MODE_BEAUTY);
    }
#undef GSPLAT_LAUNCH_C
#undef GSPLAT_LAUNCH
    return (int)cudaGetLastError();
}
