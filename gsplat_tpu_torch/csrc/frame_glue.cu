// The kernel path's glue between the port's kernels: the depth-order gather
// of the payload and the binning operands (gather_payload) and its gradient
// (scatter_payload), the marks of each rank's first pair slot (mark_owners),
// and the binning's per-pair expansion, exact-coverage cull and sort key
// (expand_pairs).
//
// Replaces no TPU kernel.  Under jax.jit XLA fuses the JAX package's
// element-wise and gather glue between its Pallas kernels into a few loops
// (gsplat_tpu/render.py:41-126: the payload permutation of sort_by_depth,
// ops/pallas/composite.py:976-984's packing, ops/binning.py:386-539's
// extents, expansion, SAT cull and key).  Run eagerly, PyTorch launches each
// of those operations as a kernel of its own, each a pass over (N,) or
// (pairs,) words.  These kernels are the port's counterpart:
//
//   * gather_payload: one thread a depth rank r reads order[r] and that
//     storage column of the sanitized, quantized (16, n) field matrix, which
//     projection.cu writes splat-major: the column is one 64-byte record,
//     two sectors at a random position.  It writes column r of the
//     compositor's payload -- (8, n) int32 packed [cx cy ax ay bx by (r,g)
//     (b,op)], or (10, n) float32 rows 0..9, or (11, n) with the view-z row --
//     and of the binning's operands: counts (tiles covered, 0 when culled),
//     nx (bbox width in tiles, at least 1), tile0 (first tile) and, when
//     thr is given, the 8-bit CEIL-quantized opacity radius thr_q;
//   * scatter_payload: the differentiable frame's gradient of the gather,
//     the inverse gather: rank r's cotangent of the payload's rows 0..9 goes
//     back to storage column order[r] of a (16, n) cotangent, written
//     splat-major (projection.cu's masked backward reads it so);
//   * mark_owners: after a kernel that zeroes the marks, one thread a rank
//     r writes its first pair slot, offset =
//     cum[r] - counts[r], and raises marks[min(offset, budget)] to r + 1
//     with atomicMax (the max is the same in any order), unless rank r + 1
//     marks the same slot; the prefix max of the marks (scan.cu) then gives
//     each slot its owner;
//   * expand_pairs: one thread a pair slot k < budget reads the prefix max
//     of the marks at k (rank + 1 of the slot's owner), the owner's offset,
//     nx, tile0, thr_q and, with the SAT cull, its six quad rows (the
//     payload's rows 0..5), and writes the slot's sort key (tile << bits_r)
//     | rank, or the tile and the rank apart when the key does not fit, and
//     with the gradient map the slot's depth rank (-1 past the pairs).
//
// Every operation repeats the plain PyTorch version
// (ops/kernels/frame_glue.py: gather_payload_plain, scatter_payload_plain,
// mark_owners_plain, expand_pairs_plain) one ATen rounding at a time, so the
// results are bit-equal: compiled with -fmad=false (no contraction); x / c
// for a Python float c is x * (float)(1 / c) with the reciprocal taken in
// double, passed in as a float; a Python float constant is the double
// literal cast to float; torch.clamp of a float keeps NaN; a float's
// conversion to int32 is a C cast (NaN -> 0 on the card, as ATen's own
// cast); torch.log and torch.sqrt are logf and the IEEE sqrtf;
// torch.div(rounding_mode="floor") of ints is a floor division; int32
// arithmetic wraps as ATen's does.
//
// What bounds them all: bytes.  gather_payload needs 60 B a splat read (the
// 8-byte order entry and 52 B of the column: rows 0..9, 11, 12, 13; 64 with
// the depth test's row 14) and 48 B written when packed (32 B of payload and
// the counts, nx, tile0 and thr_q words; 56 or 60 in float32): 108 B, 0.032
// ms at 1M splats at 3.35 TB/s.  scatter_payload reads 48 B a splat (the
// order entry, 10 cotangent words) and writes 64 (the 16-word record): 0.033
// ms at 1M.  expand_pairs moves 8 B a pair (the prefix max read, the key written)
// and 40 B a rank that owns a pair (offset, nx, tile0, thr_q, six quad
// words): ~0.018 ms at 2,359,296 pairs and 1M ranks.  Neighbouring slots
// share or neighbour their owner, so the per-rank reads are close to
// coalesced.  mark_owners moves 12 B a rank (cum and counts read, the offset
// written) and one 4-byte atomic a rank into the marks, beside the marks'
// zeroing (4 B a pair slot): ~0.0064 ms at 1M ranks and 2,359,297 slots.
//
// Plain C interface: nothing is allocated or synchronised here (all may be
// captured in a CUDA graph), and each entry returns cudaGetLastError() after
// its launch (nothing is launched for an empty grid).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// Field-matrix rows (ops/projection.py).
constexpr int ROW_OP = 9, ROW_VALID = 11, ROW_HX = 12, ROW_HY = 13, ROW_VIEWZ = 14;

// Python constants as ATen's float32 kernels see them.
constexpr float ALPHA_CUTOFF = (float)(1.0 / 255.0);
constexpr float ALPHA_CUTOFF_INV = (float)(1.0 / (1.0 / 255.0));  // x / ALPHA_CUTOFF
constexpr float QUAD_EXTENT = (float)2.0;
constexpr float RHO_SCALE = (float)(255.0 / 2.0);       // * (255.0 / QUAD_EXTENT)
constexpr float THR_SCALE = (float)(2.0 / 255.0);       // * (QUAD_EXTENT / 255.0)
constexpr float I32_SAFE = (float)(1 << 30);
constexpr float ERR_ABS = (float)1e-3;
constexpr float ERR_REL = (float)1e-6;

// The payload layouts (ops/kernels/frame_glue.py).
constexpr int LAYOUT_PACKED = 0, LAYOUT_F32 = 1, LAYOUT_F32_DEPTH = 2;

__device__ __forceinline__ float clamp_both(float v, float lo, float hi) {
    return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return isnan(v) ? v : fminf(v, hi); }
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// torch.div(a, b, rounding_mode="floor") of int32 (b != 0).
__device__ __forceinline__ int floordiv(int a, int b) {
    const int q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// int32 arithmetic that wraps, as ATen's does (signed overflow is undefined in C++).
__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wrap_mul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }

// round_bf16: float -> bf16 (round to nearest even) -> float.
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// pack2: hi's bf16 bits in the high half, lo's in the low half.
__device__ __forceinline__ int pack2(float hi, float lo) {
    const int hb = __float_as_int(round_bf16(hi));
    const int lb = __float_as_int(round_bf16(lo));
    return hb | ((lb >> 16) & 0xFFFF);
}

// _floor_i32(x / tile_px) - off, with x / tile_px as x * inv.
__device__ __forceinline__ int floor_tile(float x, float inv, int off) {
    const float f = clamp_both(floorf(x * inv), -I32_SAFE, I32_SAFE);
    return (int)f - off;
}

// _axis_tiles: the local tile range [l0, l1] (clamped) and the empty flag.
__device__ __forceinline__ bool axis_tiles(float lo, float hi, float inv, int off, int stride, int nt, int& l0,
                                           int& l1) {
    const int g0 = floor_tile(lo, inv, off);
    const int g1 = floor_tile(hi, inv, off);
    int a = g0, b = g1;
    if (stride != 1) {
        a = floordiv(g0 + (stride - 1), stride);
        b = floordiv(g1, stride);
    }
    const bool empty = (b < a) | (b < 0) | (a > nt - 1);
    l0 = clampi(a, 0, nt - 1);
    l1 = clampi(b, 0, nt - 1);
    return empty;
}

template <int LAYOUT>
__global__ void __launch_bounds__(THREADS)
gather_payload_kernel(const float* __restrict__ fields,     // (n, 16) splat-major: one 64-byte record a column
                      const long long* __restrict__ order,  // (n,) depth rank -> storage column
                      long long n,
                      int* __restrict__ payload,            // (8 | 10 | 11, n) 32-bit words
                      int* __restrict__ counts, int* __restrict__ nx_out, int* __restrict__ tile0_out,
                      int* __restrict__ thr_out,            // (n,) or null
                      int nty, int ntx, float inv_tw, float inv_th, int row_stride, int col_stride,
                      int row_off, int col_off) {
    const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (r >= n) return;
    const long long s = __ldg(order + r);
    float v[16];
    const float4* rec = reinterpret_cast<const float4*>(fields + s * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float4 t = __ldg(rec + q);
        v[4 * q] = t.x;
        v[4 * q + 1] = t.y;
        v[4 * q + 2] = t.z;
        v[4 * q + 3] = t.w;
    }
    const float valid = v[ROW_VALID], hx = v[ROW_HX], hy = v[ROW_HY];

    if (LAYOUT == LAYOUT_PACKED) {
#pragma unroll
        for (int i = 0; i < 6; ++i) payload[i * n + r] = __float_as_int(v[i]);
        payload[6 * n + r] = pack2(v[6], v[7]);
        payload[7 * n + r] = pack2(v[8], v[9]);
    } else {
        float* out = reinterpret_cast<float*>(payload);
#pragma unroll
        for (int i = 0; i < 10; ++i) out[i * n + r] = v[i];
        if (LAYOUT == LAYOUT_F32_DEPTH) out[10 * n + r] = v[ROW_VIEWZ];
    }

    // _tile_extents
    const float cx = v[0], cy = v[1], op = v[ROW_OP];
    const float x_lo = cx - hx, x_hi = cx + hx, y_lo = cy - hy, y_hi = cy + hy;
    bool cull = (valid < 0.5f) | (op < ALPHA_CUTOFF);
    int tx0, tx1, ty0, ty1;
    const bool ex = axis_tiles(x_lo, x_hi, inv_tw, col_off, col_stride, ntx, tx0, tx1);
    const bool ey = axis_tiles(y_lo, y_hi, inv_th, row_off, row_stride, nty, ty0, ty1);
    cull = cull | ex | ey;
    const int nx = cull ? 0 : tx1 - tx0 + 1;
    const int ny = cull ? 0 : ty1 - ty0 + 1;
    counts[r] = nx * ny;
    nx_out[r] = max(nx, 1);
    tile0_out[r] = ty0 * ntx + tx0;
    if (thr_out != nullptr) {
        const float rho = sqrtf(logf(clamp_min(op, ALPHA_CUTOFF) * ALPHA_CUTOFF_INV));
        const int q = (int)ceilf(clamp_max(rho, QUAD_EXTENT) * RHO_SCALE);
        thr_out[r] = min(q, 255);
    }
}

// gather_payload's gradient (the differentiable frame's): the permutation's
// VJP is the inverse gather.  Rank r's cotangent of the payload's rows 0..9
// goes back to storage column order[r]; no other row of the fields takes a
// gradient (the depth key, the validity, the footprint and the view-z row
// feed only the sort, the binning and the depth test), so rows 10..15 are
// zero.  The cotangent is written splat-major, column s one 64-byte record
// of four 16-byte stores: whole sectors at a random position, where ten
// rows n apart would be ten partial sectors (read, merged and written
// back); the rank-order reads are coalesced.  order is a permutation, so
// every record is written once.
__global__ void __launch_bounds__(THREADS)
scatter_payload_kernel(const float* __restrict__ d_payload,  // (>= 10, n) rows n apart, depth order
                       const long long* __restrict__ order, long long n,
                       float* __restrict__ d_fields) {       // (n, 16) splat-major, storage order
    const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (r >= n) return;
    const long long s = __ldg(order + r);
    float v[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) v[i] = __ldg(d_payload + i * n + r);
    float4* rec = reinterpret_cast<float4*>(d_fields + s * 16);
    rec[0] = make_float4(v[0], v[1], v[2], v[3]);
    rec[1] = make_float4(v[4], v[5], v[6], v[7]);
    rec[2] = make_float4(v[8], v[9], 0.0f, 0.0f);
    rec[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The marks' zeroing, four words a thread (marks 16-byte aligned).
__global__ void __launch_bounds__(THREADS)
zero_marks_kernel(int* __restrict__ marks, long long count) {
    const long long i = ((long long)blockIdx.x * THREADS + threadIdx.x) * 4;
    if (i + 3 < count) {
        *reinterpret_cast<int4*>(marks + i) = make_int4(0, 0, 0, 0);
    } else {
        for (long long j = i; j < count; ++j) marks[j] = 0;
    }
}

__global__ void __launch_bounds__(THREADS)
mark_owners_kernel(const int* __restrict__ cum, const int* __restrict__ counts, long long n, long long budget,
                   int* __restrict__ offsets, int* __restrict__ marks) {
    const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (r >= n) return;
    const int off = __ldg(cum + r) - __ldg(counts + r);
    offsets[r] = off;
    const int slot = min(off, (int)budget);
    // The next rank marks the same slot with a larger id: leave the slot to
    // it.  Ranks without pairs share their offset with the next rank (the
    // culled ones behind the camera all share the last), so without this a
    // run of them would queue their atomics on one address.
    if (r + 1 < n && min(__ldg(cum + r + 1) - __ldg(counts + r + 1), (int)budget) == slot) return;
    atomicMax(marks + slot, (int)r + 1);
}

__global__ void __launch_bounds__(THREADS)
expand_pairs_kernel(const int* __restrict__ smax,     // (budget,) prefix max of the marks
                    const int* __restrict__ cum,      // (n,) inclusive prefix sum of the counts
                    const int* __restrict__ offsets,  // (n,) cum - counts
                    const int* __restrict__ nx, const int* __restrict__ tile0,
                    const int* __restrict__ thr_q,    // (n,) or null (no opacity radius)
                    const float* __restrict__ quad,   // (6, n) rows n apart, or null (no SAT cull)
                    long long n, long long budget, int num_tiles, int ntx, int bits_r, int spread_mask,
                    bool key_ok, float tw, float th, int row_stride, int col_stride, int row_off, int col_off,
                    int* __restrict__ key, int* __restrict__ tile_out, int* __restrict__ rank_out,
                    int* __restrict__ exp_rank) {
    const long long k = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (k >= budget) return;
    const int pair = (int)k;
    const int last = (int)(n - 1);
    const int total = min(__ldg(cum + last), (int)budget);
    const int s = max(min(__ldg(smax + k) - 1, last), 0);
    const int nx_s = __ldg(nx + s);
    const int t0 = __ldg(tile0 + s);
    const int r = pair - __ldg(offsets + s);
    const int dty = floordiv(r, nx_s);
    const int dtx = r - dty * nx_s;
    int tile = wrap_add(wrap_add(t0, wrap_mul(dty, ntx)), dtx);
    const bool valid = pair < total;
    bool live = valid;
    if (quad != nullptr) {
        const float cx = __ldg(quad + s), cy = __ldg(quad + n + s);
        const float ax = __ldg(quad + 2 * n + s), ay = __ldg(quad + 3 * n + s);
        const float bx = __ldg(quad + 4 * n + s), by = __ldg(quad + 5 * n + s);
        const int ty0 = floordiv(t0, ntx);
        const float tx_t = (float)wrap_add(t0 - ty0 * ntx, dtx) * (float)col_stride + (float)col_off;
        const float ty_t = ((float)ty0 + (float)dty) * (float)row_stride + (float)row_off;
        const float pcx = (tx_t * tw + tw * 0.5f) - cx;
        const float pcy = (ty_t * th + th * 0.5f) - cy;
        const float hx_r = (tw - 1.0f) * 0.5f, hy_r = (th - 1.0f) * 0.5f;
        const float qxc = ax * pcx + ay * pcy;
        const float qyc = bx * pcx + by * pcy;
        const float e1 = hx_r * fabsf(ax) + hy_r * fabsf(ay);
        const float e2 = hx_r * fabsf(bx) + hy_r * fabsf(by);
        const float thr1 = thr_q != nullptr ? (float)__ldg(thr_q + s) * THR_SCALE : QUAD_EXTENT;
        const float err1 = ERR_ABS + ERR_REL * (fabsf(ax * pcx) + fabsf(ay * pcy));
        const float err2 = ERR_ABS + ERR_REL * (fabsf(bx * pcx) + fabsf(by * pcy));
        const bool separated = (fabsf(qxc) > (thr1 + err1) + e1) | (fabsf(qyc) > (thr1 + err2) + e2);
        live = live & !separated;
    }
    if (!live) tile = num_tiles;
    const int spread = min(pair & spread_mask, last);
    const int rank = valid ? s : spread;
    if (key_ok) {
        key[k] = (int)(((unsigned)tile << bits_r) | (unsigned)rank);
    } else {
        tile_out[k] = tile;
        rank_out[k] = rank;
    }
    if (exp_rank != nullptr) exp_rank[k] = valid ? s : -1;
}

}  // namespace

// fields: the (16, n) float32 matrix splat-major, i.e. (n, 16) row-major,
// 16-byte aligned; order (n,) int64; layout 0 packed ((8, n) int32
// payload), 1 float32 ((10, n)), 2 float32 with the view-z row ((11, n));
// counts, nx, tile0 (n,) int32; thr_q (n,) int32 or null; inv_tw, inv_th the
// tile sizes' reciprocals.  Every entry of the outputs is written.
extern "C" int gsplat_gather_payload(const void* fields, const void* order, long long n, int layout, void* payload,
                                     void* counts, void* nx, void* tile0, void* thr_q, int nty, int ntx,
                                     float inv_tw, float inv_th, int row_stride, int col_stride, int row_off,
                                     int col_off, void* stream) {
    if (n <= 0) return 0;
    if (layout < LAYOUT_PACKED || layout > LAYOUT_F32_DEPTH || row_stride < 1 || col_stride < 1 ||
        reinterpret_cast<uintptr_t>(fields) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const float* f = static_cast<const float*>(fields);
    const long long* o = static_cast<const long long*>(order);
    int* p = static_cast<int*>(payload);
    int *c = static_cast<int*>(counts), *x = static_cast<int*>(nx), *t = static_cast<int*>(tile0);
    int* q = static_cast<int*>(thr_q);
#define GATHER(L)                                                                                               \
    gather_payload_kernel<L><<<blocks, THREADS, 0, s>>>(f, o, n, p, c, x, t, q, nty, ntx, inv_tw, inv_th,         \
                                                        row_stride, col_stride, row_off, col_off)
    if (layout == LAYOUT_PACKED) GATHER(LAYOUT_PACKED);
    else if (layout == LAYOUT_F32) GATHER(LAYOUT_F32);
    else GATHER(LAYOUT_F32_DEPTH);
#undef GATHER
    return (int)cudaGetLastError();
}

// d_payload (>= 10, n) float32 rows n apart; order (n,) int64, a
// permutation; d_fields the (16, n) float32 cotangent splat-major, (n, 16)
// row-major, 16-byte aligned, every entry written.
extern "C" int gsplat_scatter_payload(const void* d_payload, const void* order, long long n, void* d_fields,
                                      void* stream) {
    if (n <= 0) return 0;
    if (reinterpret_cast<uintptr_t>(d_fields) % 16 != 0) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    scatter_payload_kernel<<<blocks, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(d_payload), static_cast<const long long*>(order), n,
        static_cast<float*>(d_fields));
    return (int)cudaGetLastError();
}

// smax (budget,), cum, offsets, nx, tile0 (n,) int32; thr_q (n,) int32 or
// null; quad (6, n) float32 rows n apart, or null for no SAT cull.  Outputs
// (budget,) int32: key when key_ok, else tile and rank; exp_rank or null.
extern "C" int gsplat_expand_pairs(const void* smax, const void* cum, const void* offsets, const void* nx,
                                   const void* tile0, const void* thr_q, const void* quad, long long n,
                                   long long budget, int num_tiles, int ntx, int bits_r, int spread_mask,
                                   int key_ok, float tw, float th, int row_stride, int col_stride, int row_off,
                                   int col_off, void* key, void* tile, void* rank, void* exp_rank, void* stream) {
    if (n <= 0 || budget <= 0) return 0;
    if (key_ok ? key == nullptr : (tile == nullptr || rank == nullptr)) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((budget + THREADS - 1) / THREADS);
    expand_pairs_kernel<<<blocks, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(smax), static_cast<const int*>(cum), static_cast<const int*>(offsets),
        static_cast<const int*>(nx), static_cast<const int*>(tile0), static_cast<const int*>(thr_q),
        static_cast<const float*>(quad), n, budget, num_tiles, ntx, bits_r, spread_mask, key_ok != 0, tw, th,
        row_stride, col_stride, row_off, col_off, static_cast<int*>(key), static_cast<int*>(tile),
        static_cast<int*>(rank), static_cast<int*>(exp_rank));
    return (int)cudaGetLastError();
}

// cum, counts (n,) int32; offsets (n,) int32 written; marks (budget + 1,)
// int32, 16-byte aligned: zeroed by the first kernel, then max-updated at
// min(offset, budget) by the second.
extern "C" int gsplat_mark_owners(const void* cum, const void* counts, long long n, long long budget, void* offsets,
                                  void* marks, void* stream) {
    if (n <= 0) return 0;
    if (budget <= 0 || reinterpret_cast<uintptr_t>(marks) % 16 != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const long long words = budget + 1;
    zero_marks_kernel<<<(unsigned)((words + 4 * THREADS - 1) / (4 * THREADS)), THREADS, 0, s>>>(
        static_cast<int*>(marks), words);
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    mark_owners_kernel<<<blocks, THREADS, 0, s>>>(
        static_cast<const int*>(cum), static_cast<const int*>(counts), n, budget, static_cast<int*>(offsets),
        static_cast<int*>(marks));
    return (int)cudaGetLastError();
}
