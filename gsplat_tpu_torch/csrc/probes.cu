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
// a float32 matrix of 16 rows and n_cols columns, one thread a query (grid
// stride), four accesses:
//   0  contiguous: query q reads column q mod n_cols of the (16, n_cols)
//      matrix - a warp reads 32 neighbouring words of each row (the TPU
//      probe's contiguous 128-column chunks);
//   1  column gather: query q reads the 16 rows of column idx[q] of the
//      (16, n_cols) matrix, 4-byte words n_cols apart (the compositors'
//      payload read and the segment sum's gradient-space read today);
//   2  row gather: query q reads row idx[q] of the (n_cols, 16) transposed
//      matrix, 64 contiguous bytes as four 16-byte loads (the layout in
//      question);
//   3  column scatter: query q writes value(r, c) = 16 c + r into rows
//      0..15 of column c = idx[q] of the (16, n_cols) matrix (exact in float32
//      below 2^20 columns, and the same whichever duplicate query lands last).
// Reads are summed in double per thread, then per block in a fixed order into
// partial[blockIdx.x]; the wrapper adds the partials.  What bounds it: bytes
// (each query moves 64 bytes and, but for access 0, reads a 4-byte index).
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

template <int ACCESS>
__global__ void __launch_bounds__(THREADS)
gather_probe_kernel(float* __restrict__ mat, const int* __restrict__ idx, long long n_cols,
                    long long p, double* __restrict__ partial) {
    __shared__ double s_sum[THREADS];
    double acc = 0.0;
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long q = (long long)blockIdx.x * THREADS + threadIdx.x; q < p; q += stride) {
        if (ACCESS == 0) {
            const long long c = q % n_cols;
#pragma unroll
            for (int r = 0; r < ROWS; ++r) acc += (double)mat[r * n_cols + c];
        } else if (ACCESS == 1) {
            const long long c = idx[q];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) acc += (double)mat[r * n_cols + c];
        } else if (ACCESS == 2) {
            const float4* row = reinterpret_cast<const float4*>(mat + (long long)idx[q] * ROWS);
#pragma unroll
            for (int v = 0; v < ROWS / 4; ++v) {
                const float4 w = row[v];
                acc += (double)w.x;
                acc += (double)w.y;
                acc += (double)w.z;
                acc += (double)w.w;
            }
        } else {
            const long long c = idx[q];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) mat[r * n_cols + c] = (float)(c * ROWS + r);
        }
    }
    if (ACCESS == 3) return;
    s_sum[threadIdx.x] = acc;
    __syncthreads();
    for (int h = THREADS / 2; h > 0; h >>= 1) {
        if (threadIdx.x < h) s_sum[threadIdx.x] += s_sum[threadIdx.x + h];
        __syncthreads();
    }
    if (threadIdx.x == 0) partial[blockIdx.x] = s_sum[0];
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

// mat: (16, n_cols) float32 for accesses 0, 1 and 3 (written by 3), (n_cols,
// 16) float32 and 16-byte aligned for access 2.  idx: (p,) int32 in
// [0, n_cols) (unused by access 0).  partial: (blocks,) float64 (unused by 3).
extern "C" int gsplat_gather_probe(void* mat, const void* idx, long long n_cols, long long p,
                                   int access, void* partial, int blocks, void* stream) {
    if (p <= 0) return 0;
    if (access < 0 || access > 3 || blocks <= 0 || n_cols <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    float* m = static_cast<float*>(mat);
    const int* ix = static_cast<const int*>(idx);
    double* part = static_cast<double*>(partial);
    if (access == 0) gather_probe_kernel<0><<<blocks, THREADS, 0, s>>>(m, ix, n_cols, p, part);
    else if (access == 1) gather_probe_kernel<1><<<blocks, THREADS, 0, s>>>(m, ix, n_cols, p, part);
    else if (access == 2) gather_probe_kernel<2><<<blocks, THREADS, 0, s>>>(m, ix, n_cols, p, part);
    else gather_probe_kernel<3><<<blocks, THREADS, 0, s>>>(m, ix, n_cols, p, part);
    return (int)cudaGetLastError();
}
