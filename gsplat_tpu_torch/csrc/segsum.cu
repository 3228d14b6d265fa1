// Segmented row sum: the per-pair sums of the gradient address space, added
// up per splat.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/segsum.py:_segsum_kernel
// (entry segsum_by_splat) together with the two gathers that fed it
// (gsplat_tpu/ops/pallas/composite.py, _csp_bwd).  What it computes is the
// same: depth rank r owns the expansion pairs [exp_offsets[r],
// exp_offsets[r] + exp_counts[r]), cut at the pair budget; pair j's nine sums
// stand in row dest_of_exp[j] of the gradient space (a negative entry is a
// dropped pair and adds exact zero); out[:, r] (or out[:, order[r]]) is their
// sum.  Packed mode reads eight int32 words and unpacks word 6 into its two
// bf16 halves.
//
// What differs from the TPU design.  There the readback was two gathers that
// wrote (8, P) and (2, P) expansion-order matrices to device memory, and the
// reduction a one-hot matrix product (operand split in three bf16 terms, the
// rank carried as a float row), because that machine has no cheap ragged
// reduction.  Here a rank's window is walked directly: the kernel reads
// dest_of_exp[j], then that row, and the expansion-order matrices never
// exist.  The gradient space is pair-major, (g_pad, 8) int32 or (g_pad, 9)
// float32, so a pair's words are one 32-byte sector (packed: two 16-byte
// loads) or exactly two (float32: 36 bytes, read as nine 4-byte loads;
// loads split by the row's alignment ran slower, PERF.md).
//
// Layout: a group of LANES = 4 neighbouring lanes per rank (a splat has two
// to three pairs on average, so a whole warp per rank would idle), eight ranks
// a warp.  Lane l of a group adds pairs off + l, off + l + 4, ... in ascending
// order, then the group reduces by xor-shuffles (1, 2): a fixed order, so two
// runs give bit-equal sums whatever the launch shape.
//
// What bounds it: bytes.  A kept pair is one scattered 32-byte sector (two in
// float32 mode), read against nine adds; beside it dest_of_exp, the windows
// and the (9, n) output, whose columns are scattered too when `order` is
// given.
//
// Plain C interface: nothing is allocated or synchronised here, and the entry
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 4;
constexpr int NSUMS = 9;

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
segsum_kernel(const int* __restrict__ gspace,  // (g_pad, 8 or 9) 32-bit words
              const int* __restrict__ dest_of_exp, int budget,
              const int* __restrict__ exp_offsets,
              const int* __restrict__ exp_counts,
              const int* __restrict__ order,  // (n,) or null
              float* __restrict__ out,        // (9, n)
              int n) {
    const long long gid = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long r = gid / LANES;
    const int sub = (int)(gid % LANES);
    float acc[NSUMS];
#pragma unroll
    for (int i = 0; i < NSUMS; ++i) acc[i] = 0.0f;
    if (r < n) {
        const long long off = exp_offsets[r];
        long long end = off + exp_counts[r];
        if (end > budget) end = budget;
        for (long long j = off + sub; j < end; j += LANES) {
            const int d = dest_of_exp[j];
            if (d < 0) continue;
            if (PACKED) {
                const int4* row = reinterpret_cast<const int4*>(gspace) + 2 * (long long)d;
                const int4 lo = __ldg(row);
                const int4 hi = __ldg(row + 1);
                acc[0] += __int_as_float(lo.x);
                acc[1] += __int_as_float(lo.y);
                acc[2] += __int_as_float(lo.z);
                acc[3] += __int_as_float(lo.w);
                acc[4] += __int_as_float(hi.x);
                acc[5] += __int_as_float(hi.y);
                acc[6] += __int_as_float(hi.z & (int)0xffff0000u);
                acc[7] += __int_as_float(hi.z << 16);
                acc[8] += __int_as_float(hi.w);
            } else {
                const float* row = reinterpret_cast<const float*>(gspace) + (long long)d * NSUMS;
#pragma unroll
                for (int i = 0; i < NSUMS; ++i) acc[i] += __ldg(row + i);
            }
        }
    }
    // Every lane of the warp takes part, ranks past n with zeros.
#pragma unroll
    for (int m = 1; m < LANES; m <<= 1) {
#pragma unroll
        for (int i = 0; i < NSUMS; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], m);
    }
    if (r < n && sub == 0) {
        const long long c = order ? (long long)order[r] : r;
#pragma unroll
        for (int i = 0; i < NSUMS; ++i) out[(long long)i * n + c] = acc[i];
    }
}

}  // namespace

// gspace: (g_pad, 9) float32, or with packed != 0 (g_pad, 8) int32 and
// 16-byte aligned, as gsplat_composite_bwd wrote it.  dest_of_exp: (budget,)
// int32.  exp_offsets, exp_counts: (n,) int32 by depth rank.  order: (n,)
// int32 or null.  out: (9, n) float32; every column is written.
extern "C" int gsplat_segsum(const void* gspace, int packed, const void* dest_of_exp, int budget,
                             const void* exp_offsets, const void* exp_counts, const void* order,
                             void* out, int n, void* stream) {
    if (n <= 0) return 0;
    if (packed && (reinterpret_cast<uintptr_t>(gspace) & 15) != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const long long threads = (long long)n * LANES;
    const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
    const int* g = static_cast<const int*>(gspace);
    const int* de = static_cast<const int*>(dest_of_exp);
    const int* eo = static_cast<const int*>(exp_offsets);
    const int* ec = static_cast<const int*>(exp_counts);
    const int* od = static_cast<const int*>(order);
    float* o = static_cast<float*>(out);
    if (packed) segsum_kernel<true><<<blocks, THREADS, 0, s>>>(g, de, budget, eo, ec, od, o, n);
    else segsum_kernel<false><<<blocks, THREADS, 0, s>>>(g, de, budget, eo, ec, od, o, n);
    return (int)cudaGetLastError();
}
