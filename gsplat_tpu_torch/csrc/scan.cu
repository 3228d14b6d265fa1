// Exact inclusive prefix sum / prefix max of a 1-D int32 array.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/scan.py:_scan_kernel (entries
// cumsum_i32 / cummax_i32), which walks the array in ONE sequential program,
// chaining (8, 512) blocks through a carried total with double-buffered
// copies.  On this card blocks run in parallel and nothing carries between
// them, so the scan is done as reduce-then-scan in three launches:
//
//   (a) reduce : every block reduces its tile of 4096 elements to one total;
//   (b) totals : ONE block scans the block totals in place (looping over
//                them in tiles of 4096 with a carry held in a register);
//   (c) scan   : every block scans its tile again, seeded with the total of
//                all tiles before it, and writes the result.
//
// What bounds it: bytes.  The function must move 8 bytes per element (read
// once, write once); this design moves 12 (the input is read twice), plus
// the small totals array.  A single-pass scan with decoupled look-back would
// reach 8; that is left for later.  Integer add and max are exact in any
// association order, so the result does not depend on the tile partition
// and equals a sequential scan bit for bit.  Inside a block the scan uses
// four consecutive elements per thread (one 16-byte load where the pointer
// allows), warp shuffles across the 32 threads of a warp, and shared memory
// across the 32 warps.  The ragged last tile is masked with the operator's
// neutral element (0 for add, INT32_MIN for max), never padded on the host.
//
// Plain C interface: pointers, sizes and the stream come in as arguments,
// nothing is allocated or synchronised here, and the entry returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

template <bool MAX>
struct Op {
    static __device__ __forceinline__ int neutral() { return MAX ? INT32_MIN : 0; }
    static __device__ __forceinline__ int combine(int a, int b) {
        if (MAX) return a > b ? a : b;
        // wrap-around add, as torch.cumsum(dtype=int32) does
        return (int)((unsigned)a + (unsigned)b);
    }
};

template <bool MAX>
__device__ __forceinline__ int warp_inclusive(int v, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        int up = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v = Op<MAX>::combine(up, v);
    }
    return v;
}

// One value per thread -> exclusive prefix of the thread within the block,
// and the block's total in `total`.  `smem` holds 32 ints.  Ends with a
// barrier, so `smem` may be reused at once.
template <bool MAX>
__device__ __forceinline__ int block_exclusive(int v, int* smem, int& total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int inc = warp_inclusive<MAX>(v, lane);
    if (lane == 31) smem[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int w = lane < WARPS ? smem[lane] : Op<MAX>::neutral();
        smem[lane] = warp_inclusive<MAX>(w, lane);
    }
    __syncthreads();
    const int warp_prefix = warp > 0 ? smem[warp - 1] : Op<MAX>::neutral();
    total = smem[WARPS - 1];
    int prev = __shfl_up_sync(FULL, inc, 1);
    if (lane == 0) prev = Op<MAX>::neutral();
    __syncthreads();
    return Op<MAX>::combine(warp_prefix, prev);
}

template <bool MAX>
__device__ __forceinline__ void load_items(const int* in, long long idx, long long n,
                                           bool vec_ok, int v[ITEMS]) {
    if (vec_ok && idx + ITEMS <= n) {
        const int4 q = *reinterpret_cast<const int4*>(in + idx);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
        for (int k = 0; k < ITEMS; ++k)
            v[k] = (idx + k < n) ? in[idx + k] : Op<MAX>::neutral();
    }
}

__device__ __forceinline__ void store_items(int* out, long long idx, long long n,
                                            bool vec_ok, const int v[ITEMS]) {
    if (vec_ok && idx + ITEMS <= n) {
        *reinterpret_cast<int4*>(out + idx) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
        for (int k = 0; k < ITEMS; ++k)
            if (idx + k < n) out[idx + k] = v[k];
    }
}

// Inclusive scan of the tile [base, base + TILE) ∩ [0, n), seeded with
// `carry`; returns carry ⊕ (tile total).  `in` and `out` may alias.
template <bool MAX>
__device__ __forceinline__ int scan_tile(const int* in, int* out, long long base, long long n,
                                         int carry, bool vec_in, bool vec_out, int* smem) {
    const long long idx = base + (long long)threadIdx.x * ITEMS;
    int v[ITEMS];
    load_items<MAX>(in, idx, n, vec_in, v);
#pragma unroll
    for (int k = 1; k < ITEMS; ++k) v[k] = Op<MAX>::combine(v[k - 1], v[k]);
    int total;
    const int excl = block_exclusive<MAX>(v[ITEMS - 1], smem, total);
    const int seed = Op<MAX>::combine(carry, excl);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) v[k] = Op<MAX>::combine(seed, v[k]);
    store_items(out, idx, n, vec_out, v);
    return Op<MAX>::combine(carry, total);
}

// (a) one total per tile
template <bool MAX>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const int* __restrict__ in, int* __restrict__ totals, long long n, bool vec_in) {
    __shared__ int smem[32];
    const long long idx = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
    int v[ITEMS];
    load_items<MAX>(in, idx, n, vec_in, v);
    int t = v[0];
#pragma unroll
    for (int k = 1; k < ITEMS; ++k) t = Op<MAX>::combine(t, v[k]);
    int total;
    block_exclusive<MAX>(t, smem, total);
    if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// (b) in-place inclusive scan of the totals, one block
template <bool MAX>
__global__ void __launch_bounds__(THREADS)
totals_kernel(int* totals, long long m) {
    __shared__ int smem[32];
    int carry = Op<MAX>::neutral();
    for (long long base = 0; base < m; base += TILE)
        carry = scan_tile<MAX>(totals, totals, base, m, carry, false, false, smem);
}

// (c) scan every tile, seeded with the scanned total of its predecessor
template <bool MAX>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const int* __restrict__ in, int* __restrict__ out, const int* __restrict__ totals,
            long long n, bool vec_in, bool vec_out) {
    __shared__ int smem[32];
    const int carry = blockIdx.x > 0 ? totals[blockIdx.x - 1] : Op<MAX>::neutral();
    scan_tile<MAX>(in, out, (long long)blockIdx.x * TILE, n, carry, vec_in, vec_out, smem);
}

template <bool MAX>
cudaError_t launch(const int* in, int* out, int* totals, long long n, cudaStream_t stream) {
    const long long nblocks = (n + TILE - 1) / TILE;
    const bool vec_in = (reinterpret_cast<uintptr_t>(in) & 15) == 0;
    const bool vec_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    if (nblocks > 1) {
        reduce_kernel<MAX><<<(unsigned)nblocks, THREADS, 0, stream>>>(in, totals, n, vec_in);
        totals_kernel<MAX><<<1, THREADS, 0, stream>>>(totals, nblocks);
    }
    scan_kernel<MAX><<<(unsigned)nblocks, THREADS, 0, stream>>>(in, out, totals, n, vec_in, vec_out);
    return cudaGetLastError();
}

}  // namespace

// Tile width, so the caller can size the `totals` scratch array.
extern "C" int gsplat_scan_tile() { return TILE; }

// Inclusive scan of in[0..n) into out[0..n).  `totals` is scratch of
// ceil(n / gsplat_scan_tile()) ints.  kind: 0 = add, 1 = max.
extern "C" int gsplat_scan_i32(const void* in, void* out, void* totals, long long n, int kind,
                               void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int* i = static_cast<const int*>(in);
    int* o = static_cast<int*>(out);
    int* t = static_cast<int*>(totals);
    cudaError_t err = kind == 1 ? launch<true>(i, o, t, n, s) : launch<false>(i, o, t, n, s);
    return (int)err;
}
