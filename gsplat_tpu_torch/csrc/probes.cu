// Calibration probes of the H100 speed-of-light model (utils/sol.py): the
// card's float32 issue rate and expf rate, and the rate of the scattered
// reads and writes the compositors and the segment sum make.
//
// alu_probe replaces the TPU probe scripts/sol_calibrate.py:vpu_rate (an
// unrolled FMA chain with 8-way independence on an (8, 512) block that stays
// in vector registers).  Here every thread keeps 8 independent chains in
// registers and runs `steps` links of each, with no memory traffic inside
// the loop; the grid fills every SM.  Three variants:
//   0  acc = fmaf(acc, a, b)                 one FFMA a link (contracted)
//   1  acc = __fadd_rn(__fmul_rn(acc, a), b) FMUL + FADD, separately rounded
//      (what the compositors compile to under -fmad=false; the intrinsics
//      are never contracted, whatever the flags)
//   2  acc = expf(1 - acc)                   CUDA's accurate expf (its range
//      reduction on the FP32 pipe and one MUFU.EX2) and one FADD.  The map
//      x -> e^(1-x) has its fixed point 1 at slope -1: a neutral point, so
//      the chain neither settles nor grows.  It swings about 1, odd links
//      above and even links below, closing in only as 1/sqrt(links), so
//      its value keeps depending on x and on the number of links (the
//      contracting e^-x would settle on 0.567... whatever ran).
// The chains start at x * (1 + 0.001 k) for k = 0..7 and the output is their
// sum (k in order), as vpu_rate's kernel body computes, so the plain version
// recomputes it and a wrong kernel is caught.  What bounds it: operations, by
// construction (one issue slot a link for variant 0, two for 1).
//
// gather_probe replaces the TPU probe scripts/profile_dma_gather.py:build and
// its chunk / per-column read / per-column write kernels.  For P queries over
// a float32 matrix of 16 rows and n_cols columns, four accesses:
//   0  contiguous: query q reads column q mod n_cols of the (16, n_cols)
//      matrix - a warp reads 32 neighbouring words of each row (the TPU
//      probe's contiguous 128-column chunks);
//   1  column gather: query q reads the 16 rows of column idx[q] of the
//      (16, n_cols) matrix, 4-byte words n_cols apart (the compositors'
//      payload read);
//   2  row gather: query q reads row idx[q] of the (n_cols, 16) transposed
//      matrix, 64 contiguous bytes as four 16-byte loads (the layout of the
//      pair-major gradient space);
//   3  column scatter: query q writes value(r, c) = 16 c + r into rows
//      0..15 of column c = idx[q] of the (16, n_cols) matrix (exact in float32
//      below 2^20 columns, and the same whichever duplicate query lands last).
// Accesses 0 and 2 give a thread one query (grid stride).  Accesses 1 and 3
// are scheduled around the 50 MB L2: a (16, 2^20) matrix is 64 MB, and a
// thread that touches all 16 rows of its column keeps every row in flight at
// once, so the reads miss L2 and the partial-sector writes leave it before
// their sectors fill (that schedule ran 2.1x and 2.9x faster on a (16, 2^18)
// matrix, 16 MB, which sits in L2).  Here block b takes the queries
// [b*span, (b+1)*span), span = ceil(P / blocks), stages them in shared memory
// 4096 at a time (idx is read once), and sweeps the 16 rows over each tile,
// one row at a time; the grid is one wave of resident blocks (the wrapper
// asks the kernel's occupancy), so the blocks move through the rows
// together and one or two 4 MB rows are in flight.  What keeps them
// together: reads stall their thread and hold it back, so the read's blocks
// meet at every row; stores never do, so the write also waits on the
// grid-wide counters below.  The other schedules measured against this one
// (more rows a staged column, 1024-query tiles, the largest shared-memory
// carveout, no barrier) ran slower (PERF.md, the probe's schedule).  The
// indices are not sorted: that would be work the library calls do not do.
// Reads are summed in double per thread, in a fixed order, then per block in
// a fixed order into partial[blockIdx.x]; the wrapper adds the partials.
// What bounds it: bytes (each query moves 64 bytes and, but for access 0,
// reads a 4-byte index); for accesses 1 and 3 the 16 scattered 4-byte
// accesses a query are L2 requests, one sector each, which bound them
// before the bytes do (on an NVIDIA H100 80GB HBM3, ~0.27 ms for the read
// and ~0.56 ms for the write of 2.36M queries when the whole matrix sits in
// L2, whatever the schedule).
//
// Plain C interface: nothing is allocated or synchronised here, and each
// entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int ILP = 8;
constexpr int ROWS = 16;
constexpr int THREADS = 256;

template <int VARIANT>
__global__ void __launch_bounds__(THREADS)
alu_probe_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int steps,
                 float a, float b) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const float x0 = x[i];
    float acc[ILP];
#pragma unroll
    for (int k = 0; k < ILP; ++k) acc[k] = x0 * (float)(1.0 + 0.001 * k);
#pragma unroll 16
    for (int s = 0; s < steps; ++s) {
#pragma unroll
        for (int k = 0; k < ILP; ++k) {
            if (VARIANT == 0) acc[k] = fmaf(acc[k], a, b);
            else if (VARIANT == 1) acc[k] = __fadd_rn(__fmul_rn(acc[k], a), b);
            else acc[k] = expf(1.0f - acc[k]);
        }
    }
    float sum = acc[0];
#pragma unroll
    for (int k = 1; k < ILP; ++k) sum = __fadd_rn(sum, acc[k]);
    out[i] = sum;
}

// The per-block sum of the thread's doubles, in a fixed order.
__device__ __forceinline__ void block_partial(double acc, double* s_sum, double* __restrict__ partial) {
    s_sum[threadIdx.x] = acc;
    __syncthreads();
    for (int h = THREADS / 2; h > 0; h >>= 1) {
        if (threadIdx.x < h) s_sum[threadIdx.x] += s_sum[threadIdx.x + h];
        __syncthreads();
    }
    if (threadIdx.x == 0) partial[blockIdx.x] = s_sum[0];
}

// Accesses 0 and 2: one thread a query, grid stride.
template <int ACCESS>
__global__ void __launch_bounds__(THREADS)
gather_probe_kernel(const float* __restrict__ mat, const int* __restrict__ idx, long long n_cols,
                    long long p, double* __restrict__ partial) {
    __shared__ double s_sum[THREADS];
    double acc = 0.0;
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long q = (long long)blockIdx.x * THREADS + threadIdx.x; q < p; q += stride) {
        if (ACCESS == 0) {
            const long long c = q % n_cols;
#pragma unroll
            for (int r = 0; r < ROWS; ++r) acc += (double)mat[r * n_cols + c];
        } else {
            const float4* row = reinterpret_cast<const float4*>(mat + (long long)idx[q] * ROWS);
#pragma unroll
            for (int v = 0; v < ROWS / 4; ++v) {
                const float4 w = row[v];
                acc += (double)w.x;
                acc += (double)w.y;
                acc += (double)w.z;
                acc += (double)w.w;
            }
        }
    }
    block_partial(acc, s_sum, partial);
}

// A performance hint, never a condition of the result: spin (bounded, about
// 8 ms) until *counter reaches target.
__device__ __forceinline__ void wait_for(const int* counter, int target) {
    const long long start = clock64();
    while (*(volatile const int*)counter < target && clock64() - start < (1ll << 24)) __nanosleep(256);
}

// Accesses 1 (WRITE false) and 3 (WRITE true): the block's queries staged
// TILE at a time, the 16 rows swept over each tile.  Every block takes the
// same number of steps (a step: one tile's row), with no queries left if
// need be.  The block meets at every step (a write first waits for its
// stores, which alone never stall a thread).  The write also waits, before
// step s, until every block has finished step s - 2 (steps_done[s - 2] ==
// gridDim.x), so that the grid works on at most two rows at a time;
// steps_done: zeroed, one int a step.
constexpr int TILE = 4096;

template <bool WRITE>
__global__ void __launch_bounds__(THREADS, 8)
column_sweep_kernel(float* __restrict__ mat, const int* __restrict__ idx, long long n_cols,
                    long long p, double* __restrict__ partial, int* __restrict__ steps_done) {
    __shared__ int s_idx[TILE];
    __shared__ double s_sum[THREADS];
    double acc = 0.0;
    const long long span = (p + gridDim.x - 1) / gridDim.x;
    const long long q0 = (long long)blockIdx.x * span;
    const long long q1 = q0 + span < p ? q0 + span : p;
    const long long tiles = (span + TILE - 1) / TILE;
    int step = 0;
    for (long long t = 0; t < tiles; ++t) {
        const long long t0 = q0 + t * TILE;
        const int cnt = t0 < q1 ? (int)(q1 - t0 < TILE ? q1 - t0 : TILE) : 0;
        for (int k = threadIdx.x; k < cnt; k += THREADS) s_idx[k] = idx[t0 + k];
        __syncthreads();
#pragma unroll 1
        for (int r = 0; r < ROWS; ++r, ++step) {
            if (WRITE && step >= 2) {
                if (threadIdx.x == 0) wait_for(steps_done + step - 2, (int)gridDim.x);
                __syncthreads();
            }
            float* row = mat + r * n_cols;
#pragma unroll 2
            for (int k = threadIdx.x; k < cnt; k += THREADS) {
                const int c = s_idx[k];
                if (WRITE) row[c] = (float)((long long)c * ROWS + r);
                else acc += (double)__ldg(row + c);
            }
            if (WRITE) __threadfence();
            __syncthreads();
            if (WRITE && threadIdx.x == 0) atomicAdd(steps_done + step, 1);
        }
        __syncthreads();  // the tile is read before the next one is staged
    }
    if (WRITE) return;
    block_partial(acc, s_sum, partial);
}

}  // namespace

// x, out: (n,) float32.  variant: 0 FMA, 1 separately rounded mul + add, 2 expf.
extern "C" int gsplat_alu_probe(const void* x, void* out, int n, int steps, int variant, float a,
                                float b, void* stream) {
    if (n <= 0) return 0;
    if (steps < 0 || variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int blocks = (n + THREADS - 1) / THREADS;
    const float* xi = static_cast<const float*>(x);
    float* o = static_cast<float*>(out);
    if (variant == 0) alu_probe_kernel<0><<<blocks, THREADS, 0, s>>>(xi, o, n, steps, a, b);
    else if (variant == 1) alu_probe_kernel<1><<<blocks, THREADS, 0, s>>>(xi, o, n, steps, a, b);
    else alu_probe_kernel<2><<<blocks, THREADS, 0, s>>>(xi, o, n, steps, a, b);
    return (int)cudaGetLastError();
}

// Blocks of the sweep (accesses 1 and 3, write = access == 3) that stay
// resident on one SM: the launch is one wave of them.  0 if the query fails.
extern "C" int gsplat_gather_sweep_blocks_per_sm(int write) {
    int blocks = 0;
    const cudaError_t e =
        write ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, column_sweep_kernel<true>, THREADS, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, column_sweep_kernel<false>, THREADS, 0);
    return e == cudaSuccess ? blocks : 0;
}

// mat: (16, n_cols) float32 for accesses 0, 1 and 3 (written by 3), (n_cols,
// 16) float32 and 16-byte aligned for access 2.  idx: (p,) int32 in
// [0, n_cols) (unused by access 0).  partial: (blocks,) float64 (unused by 3).
// steps_done: for access 3, ceil(ceil(p / blocks) / 4096) * 16 zeroed ints,
// else null.
extern "C" int gsplat_gather_probe(void* mat, const void* idx, long long n_cols, long long p,
                                   int access, void* steps_done, void* partial, int blocks, void* stream) {
    if (p <= 0) return 0;
    if (access < 0 || access > 3 || blocks <= 0 || n_cols <= 0) return (int)cudaErrorInvalidValue;
    int* done = static_cast<int*>(steps_done);
    if ((access == 3) != (done != nullptr)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    float* m = static_cast<float*>(mat);
    const int* ix = static_cast<const int*>(idx);
    double* part = static_cast<double*>(partial);
    if (access == 0) gather_probe_kernel<0><<<blocks, THREADS, 0, s>>>(m, ix, n_cols, p, part);
    else if (access == 1) column_sweep_kernel<false><<<blocks, THREADS, 0, s>>>(m, ix, n_cols, p, part, nullptr);
    else if (access == 2) gather_probe_kernel<2><<<blocks, THREADS, 0, s>>>(m, ix, n_cols, p, part);
    else column_sweep_kernel<true><<<blocks, THREADS, 0, s>>>(m, ix, n_cols, p, part, done);
    return (int)cudaGetLastError();
}
