// Adam's update of every leaf of a step in one pass: each element's
// parameter, gradient and two moments read once, the parameter and the two
// moments written once.
//
// Replaces no TPU kernel: the JAX package leaves optax.adam
// (gsplat_tpu/train/trainer.py, default_optimizer) to XLA's fusion under
// jax.jit.  It replaces torch.optim.Adam's capturable multi-tensor path on
// the card, which makes eight passes over the elements (lerp_, mul_,
// addcmul_, a sqrt into a temporary the size of the parameters, div_, add_,
// div_, addcdiv_): about 80 bytes an element against the 28 that the update
// needs (four float32 loads, three stores).
//
// What bounds it: bytes, 28 an element; the arithmetic is a dozen float
// operations.  So one launch covers every leaf of the step (a table passed
// by value: pointers, length, hyper-parameters), its grid is sized to the
// card (BLOCKS_PER_SM blocks an SM) and strides over the leaves' elements
// taken end to end, each thread loads 16 bytes at a time from each of the
// four streams with UNROLL units in flight (16 independent 16-byte loads),
// and every load and store carries the streaming hint (__ldcs/__stcs):
// each byte is touched once.  A leaf whose four pointers are not all 16-byte
// aligned, and the last n % 4 elements of every leaf, go through a scalar
// loop after the vector one.  Nothing is allocated and no temporary touches
// device memory.
//
// Arithmetic: float32 in the order of torch's capturable formula
// (torch/optim/adam.py, _multi_tensor_adam), with the two FMAs of ATen's
// lerp_ and addcmul_ written out (the file is compiled with -fmad=false, so
// no other product is contracted); it stays within a few ulp of torch's
// (tests/test_torch_adam_cuda.py):
//   m <- m + (1 - b1) (g - m)                  (lerp_, an FMA)
//   v <- fma(1 - b2, g g, b2 v)                (mul_, then addcmul_)
//   p <- p + m / ((sqrt(v) / sqrt(bc2) + eps) / step_size)
//   step_size = 1 / ((b1^t - 1) / lr),  bc2 = -(b2^t - 1)
// with t the leaf's step tensor on the device, which adam_count_kernel
// advances just before the update (two launches a step, in stream order: no
// race between blocks).  The step is read on the device at every launch, so
// a CUDA graph's replay follows a step tensor that was zeroed in between.
//
// Plain C interface: nothing is allocated or synchronised here, and the entry
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int BLOCKS_PER_SM = 4;
constexpr int MAX_LEAVES = 8;
constexpr int MAX_DEVICES = 64;

// Per-leaf hyper-parameters, in the order of the entry's `hyper` rows.
enum { H_LR, H_BETA1, H_BETA2, H_W1, H_W2, H_EPS, N_HYPER };

struct Leaf {
    float* p;
    const float* g;
    float* m;
    float* v;
    float* step;
    long long n;          // elements
    long long vec;        // float4 units of the vector loop: n / 4, or 0 when unaligned
    long long vec_off;    // units of the leaves before this one
    long long tail_off;   // scalar elements (n - 4 vec) of the leaves before this one
    float hyper[N_HYPER];
};

struct Table {
    Leaf leaf[MAX_LEAVES];
    int count;
    long long vec_total;
    long long tail_total;
};

__global__ void adam_count_kernel(const __grid_constant__ Table t) {
    if ((int)threadIdx.x < t.count) *t.leaf[threadIdx.x].step += 1.0f;
}

struct Scalars {
    float step_size, bc2_sqrt, w1, beta2, w2, eps;
};

__device__ __forceinline__ void adam_element(float& p, float g, float& m, float& v, const Scalars& s) {
    m = fmaf(s.w1, g - m, m);
    v = fmaf(s.w2, g * g, v * s.beta2);
    const float denom = (sqrtf(v) / s.bc2_sqrt + s.eps) / s.step_size;
    p = p + m / denom;
}

__device__ __forceinline__ void adam_vec(float4& p, float4 g, float4& m, float4& v, const Scalars& s) {
    adam_element(p.x, g.x, m.x, v.x, s);
    adam_element(p.y, g.y, m.y, v.y, s);
    adam_element(p.z, g.z, m.z, v.z, s);
    adam_element(p.w, g.w, m.w, v.w, s);
}

__global__ void __launch_bounds__(THREADS)
fused_adam_kernel(const __grid_constant__ Table t) {
    __shared__ Scalars sc[MAX_LEAVES];
    if ((int)threadIdx.x < t.count) {
        const Leaf& l = t.leaf[threadIdx.x];
        const float step = *l.step;
        Scalars s;
        s.step_size = 1.0f / ((powf(l.hyper[H_BETA1], step) - 1.0f) / l.hyper[H_LR]);
        s.bc2_sqrt = sqrtf(-(powf(l.hyper[H_BETA2], step) - 1.0f));
        s.w1 = l.hyper[H_W1];
        s.beta2 = l.hyper[H_BETA2];
        s.w2 = l.hyper[H_W2];
        s.eps = l.hyper[H_EPS];
        sc[threadIdx.x] = s;
    }
    __syncthreads();

    // Vector loop: unit u is float4 number u - vec_off of its leaf.  A thread
    // takes units base + k * THREADS, k < UNROLL: neighbouring lanes on
    // neighbouring 16 bytes, all loads issued before any arithmetic.
    const long long stride = (long long)gridDim.x * THREADS * UNROLL;
    for (long long base = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x; base < t.vec_total;
         base += stride) {
        int li[UNROLL];
        long long j[UNROLL];
        float4 p[UNROLL], g[UNROLL], m[UNROLL], v[UNROLL];
        int l = 0;
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
            const long long u = base + (long long)k * THREADS;
            while (l + 1 < t.count && u >= t.leaf[l + 1].vec_off) ++l;
            li[k] = l;
            j[k] = u - t.leaf[l].vec_off;
            if (u < t.vec_total) {
                const Leaf& lf = t.leaf[l];
                p[k] = __ldcs(reinterpret_cast<const float4*>(lf.p) + j[k]);
                g[k] = __ldcs(reinterpret_cast<const float4*>(lf.g) + j[k]);
                m[k] = __ldcs(reinterpret_cast<const float4*>(lf.m) + j[k]);
                v[k] = __ldcs(reinterpret_cast<const float4*>(lf.v) + j[k]);
            }
        }
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
            if (base + (long long)k * THREADS < t.vec_total) {
                const Leaf& lf = t.leaf[li[k]];
                adam_vec(p[k], g[k], m[k], v[k], sc[li[k]]);
                __stcs(reinterpret_cast<float4*>(lf.p) + j[k], p[k]);
                __stcs(reinterpret_cast<float4*>(lf.m) + j[k], m[k]);
                __stcs(reinterpret_cast<float4*>(lf.v) + j[k], v[k]);
            }
        }
    }

    // Scalar loop: the elements past each leaf's vector units (all of an
    // unaligned leaf).
    const long long threads = (long long)gridDim.x * THREADS;
    int l = 0;
    for (long long u = (long long)blockIdx.x * THREADS + threadIdx.x; u < t.tail_total; u += threads) {
        while (l + 1 < t.count && u >= t.leaf[l + 1].tail_off) ++l;
        const Leaf& lf = t.leaf[l];
        const long long e = 4 * lf.vec + (u - lf.tail_off);
        float p = __ldcs(lf.p + e), m = __ldcs(lf.m + e), v = __ldcs(lf.v + e);
        adam_element(p, __ldcs(lf.g + e), m, v, sc[l]);
        __stcs(lf.p + e, p);
        __stcs(lf.m + e, m);
        __stcs(lf.v + e, v);
    }
}

int sm_count() {
    static int cached[MAX_DEVICES] = {0};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (dev < 0 || dev >= MAX_DEVICES) return 0;
    if (cached[dev] == 0) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
    return cached[dev];
}

bool aligned16(const void* a) { return (reinterpret_cast<uintptr_t>(a) & 15) == 0; }

}  // namespace

// One Adam step of `count` <= 8 leaves.  Leaf i: params[i], grads[i],
// exp_avgs[i], exp_avg_sqs[i] float32 device arrays of numels[i] elements,
// steps[i] a float32 device scalar (advanced by one here), hyper[6 i ..]
// = lr, beta1, beta2, 1 - beta1, 1 - beta2, eps as float32.
extern "C" int gsplat_fused_adam(int count, void* const* params, const void* const* grads,
                                 void* const* exp_avgs, void* const* exp_avg_sqs, void* const* steps,
                                 const long long* numels, const float* hyper, void* stream) {
    if (count <= 0) return 0;
    if (count > MAX_LEAVES) return (int)cudaErrorInvalidValue;
    const int sms = sm_count();
    if (sms <= 0) return (int)cudaErrorInvalidDevice;
    Table t;
    t.count = count;
    t.vec_total = 0;
    t.tail_total = 0;
    for (int i = 0; i < count; ++i) {
        Leaf& l = t.leaf[i];
        l.p = static_cast<float*>(params[i]);
        l.g = static_cast<const float*>(grads[i]);
        l.m = static_cast<float*>(exp_avgs[i]);
        l.v = static_cast<float*>(exp_avg_sqs[i]);
        l.step = static_cast<float*>(steps[i]);
        l.n = numels[i];
        const bool vec = aligned16(l.p) && aligned16(l.g) && aligned16(l.m) && aligned16(l.v);
        l.vec = vec ? l.n / 4 : 0;
        l.vec_off = t.vec_total;
        l.tail_off = t.tail_total;
        t.vec_total += l.vec;
        t.tail_total += l.n - 4 * l.vec;
        for (int h = 0; h < N_HYPER; ++h) l.hyper[h] = hyper[N_HYPER * i + h];
    }
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    adam_count_kernel<<<1, 32, 0, s>>>(t);
    const long long per_block = (long long)THREADS * UNROLL;
    long long blocks = (t.vec_total + per_block - 1) / per_block;
    const long long tail_blocks = (t.tail_total + THREADS - 1) / THREADS;
    if (tail_blocks > blocks) blocks = tail_blocks;
    if (blocks > (long long)sms * BLOCKS_PER_SM) blocks = (long long)sms * BLOCKS_PER_SM;
    if (blocks < 1) blocks = 1;
    fused_adam_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(t);
    return (int)cudaGetLastError();
}
