// Segmented column sum: the per-pair sums of the gradient address space,
// added up per splat.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/segsum.py:_segsum_kernel
// (entry segsum_by_splat) together with the two gathers that fed it
// (gsplat_tpu/ops/pallas/composite.py, _csp_bwd).  What it computes is the
// same: depth rank r owns the expansion pairs [exp_offsets[r],
// exp_offsets[r] + exp_counts[r]), cut at the pair budget; pair j's nine sums
// stand in column dest_of_exp[j] of the gradient space (a negative entry is a
// dropped pair and adds exact zero); out[:, r] (or out[:, order[r]]) is their
// sum.  Packed mode reads eight int32 rows and unpacks row 6 into its two
// bf16 halves.
//
// What differs from the TPU design.  There the readback was two gathers that
// wrote (8, P) and (2, P) expansion-order matrices to device memory, and the
// reduction a one-hot matrix product (operand split in three bf16 terms, the
// rank carried as a float row), because that machine has no cheap ragged
// reduction.  Here a rank's window is walked directly: the kernel reads
// dest_of_exp[j], then that column, and the expansion-order matrices never
// exist.
//
// Layout: a group of LANES = 4 neighbouring lanes per rank (a splat has two
// to three pairs on average, so a whole warp per rank would idle), eight ranks
// a warp.  Lane l of a group adds pairs off + l, off + l + 4, ... in ascending
// order, then the group reduces by xor-shuffles (1, 2): a fixed order, so two
// runs give bit-equal sums whatever the launch shape.
//
// What bounds it: bytes.  Every pair costs nine scattered 4-byte reads, each
// its own 32-byte sector (rows are g_pad apart, a splat's pairs lie in
// different tiles' regions), against nine adds.
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
segsum_kernel(const int* __restrict__ gspace,  // (9 or 8, g_pad) 32-bit words
              long long g_pad,
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
            const int* col = gspace + d;
            if (PACKED) {
#pragma unroll
                for (int i = 0; i < 6; ++i) acc[i] += __int_as_float(col[i * g_pad]);
                const int w6 = col[6 * g_pad];
                acc[6] += __int_as_float(w6 & (int)0xffff0000u);
                acc[7] += __int_as_float(w6 << 16);
                acc[8] += __int_as_float(col[7 * g_pad]);
            } else {
#pragma unroll
                for (int i = 0; i < NSUMS; ++i) acc[i] += __int_as_float(col[i * g_pad]);
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

// gspace: (9, g_pad) float32, or with packed != 0 (8, g_pad) int32, as
// gsplat_composite_bwd wrote it.  dest_of_exp: (budget,) int32.  exp_offsets,
// exp_counts: (n,) int32 by depth rank.  order: (n,) int32 or null.
// out: (9, n) float32; every column is written.
extern "C" int gsplat_segsum(const void* gspace, long long g_pad, int packed,
                             const void* dest_of_exp, int budget, const void* exp_offsets,
                             const void* exp_counts, const void* order, void* out, int n,
                             void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const long long threads = (long long)n * LANES;
    const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
    const int* g = static_cast<const int*>(gspace);
    const int* de = static_cast<const int*>(dest_of_exp);
    const int* eo = static_cast<const int*>(exp_offsets);
    const int* ec = static_cast<const int*>(exp_counts);
    const int* od = static_cast<const int*>(order);
    float* o = static_cast<float*>(out);
    if (packed)
        segsum_kernel<true><<<blocks, THREADS, 0, s>>>(g, g_pad, de, budget, eo, ec, od, o, n);
    else
        segsum_kernel<false><<<blocks, THREADS, 0, s>>>(g, g_pad, de, budget, eo, ec, od, o, n);
    return (int)cudaGetLastError();
}
