// Projection: world splats -> the (16, N) screen-space field matrix, forward
// and backward, one thread a splat.
//
// Replaces no TPU kernel.  The JAX package writes project_splats
// (gsplat_tpu/ops/projection.py:142) as elementwise XLA ops, and jax.jit
// fuses them, and their VJP, into a few loops over the splats.  Run eagerly,
// PyTorch launches each of those ops as a kernel of its own (some 480
// forward, more backward), each a pass over N floats in device memory.  These
// two kernels are the port's counterpart of that fusion:
//
//   * project_fwd reads its splat's column of pos (3, N), orient (4, N),
//     scale (3, N), opacity (N,), colour (3, N) and, when sh_order > 0, the
//     rows of sh (45, N) that order reads, and writes the splat's column of
//     the field matrix (rows as in ops/projection.py; row 15 zero);
//   * project_bwd reads the same column, less what the gradient does not
//     need (opacity only with tight_footprint, the colour only when
//     sh_order > 0 and not only_sh), and the cotangent's rows that carry a
//     gradient into the geometry or the SH (not 6..8 at sh_order 0, not 9,
//     11 or 15); it recomputes the forward's intermediates in registers and
//     writes the gradients of pos, orient and scale, of the colour when
//     sh_order > 0 and not only_sh, and of the SH when sh_order > 0 (its
//     unused rows as zeros), so autograd keeps nothing of size N but the
//     inputs.  The opacity's gradient is cotangent row 9, and the colour's
//     at sh_order 0 rows 6..8: the wrapper hands those rows back as views.
//
// The splats are structure-of-arrays, so neighbouring threads read
// neighbouring floats of every row: each row's read and write is coalesced.
// The camera's view (4, 4), proj (4, 4) and position (3,) are read through
// device pointers into shared memory at the top of each block, never taken
// as host floats in the launch: a CUDA graph replay copies a new camera into
// those tensors, and launch arguments are frozen at capture.  width, height,
// tight_footprint and only_sh are launch arguments, sh_order a template
// parameter.
//
// The serving frame's form (payload > 0, a launch argument): the forward
// also sanitizes its column (an invalid splat takes the benign values of
// ops/rasterize_ref.py's _BENIGN, +inf depth included) and rounds rows 6..9
// (packed) or 0..9 (bf16) to bf16 and back, round to nearest even, as
// sanitize_projected then quantize_payload do; and it writes the matrix
// splat-major, each splat's 16 words one 64-byte record, because the next
// kernel of the frame (frame_glue.cu's gather_payload) reads the columns in
// depth order, at random positions: a record is two sectors there, where
// 16 rows n apart are 16.  The bytes are the same 300 a splat.  The
// backward of that form (masked, a launch argument) is sanitize's VJP
// folded in: an invalid splat's cotangent is taken as zero, and the kernel
// writes the opacity's gradient (and the colour's at sh_order 0) itself,
// the masked cotangent rows, where the plain form hands back views.
//
// What bounds both: bytes.  The forward moves 300 B a splat at sh_order 3
// (236 read, 64 written), the backward 516 B (232 + 52 read, 232 written;
// 4 more with tight_footprint);
// a few hundred float operations a splat are far below the card's rate for
// that traffic.  The design does nothing else about it than to read and write
// every byte once.
//
// Rounding.  The forward is held bit for bit against the plain PyTorch
// version (ops/kernels/projection.py:project_fields_plain) run by ATen on
// the card, so it repeats ATen's operations one rounding at a time: compiled
// with -fmad=false (no contraction); x / c for a Python float c is
// x * (1/c) with the reciprocal taken in double and rounded to float, as
// ATen's CUDA division by a CPU scalar computes it (measured on the card:
// x / (1/255) is x * 255.0f, not x * (1.0f / (float)(1/255)) and not a
// division); 1.0 / t is a reciprocal; a Python constant is
// the double literal cast to float; torch.clamp, torch.minimum and
// torch.where(x == 0, ...) (max0) keep NaN as ATen does; sqrtf and
// divisions are IEEE (nvcc's defaults), rsqrtf and logf the functions ATen
// calls.  The backward is written in the order of its plain version
// (project_fields_bwd_plain), so the two can agree bit for bit too; from the
// quad basis back to the 2D covariance that order is autograd's own (see
// _axes_vjp there: near an axis-aligned eigenvector the section cancels terms
// of ~1e5 times the cotangent, and another order rounds them differently).
//
// Plain C interface: nothing is allocated or synchronised here, and each
// entry returns cudaGetLastError() after its launch (nothing is launched for
// n == 0: a grid of zero blocks is a launch error).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// project_fwd's payload policies (ops/kernels/projection.py PAYLOAD_CODE).
constexpr int PAYLOAD_RAW = 0, PAYLOAD_F32 = 1, PAYLOAD_PACKED = 2, PAYLOAD_BF16 = 3;

constexpr int THREADS = 256;
// The backward holds ~160 registers a thread at sh_order 3: in blocks of 128
// threads three blocks (12 warps) fit an SM's register file, in blocks of
// 256 only one (8 warps).
constexpr int THREADS_BWD = 128;

// Python constants as ATen's float32 kernels see them.
constexpr float FOV_CLAMP = (float)1.3;
constexpr float COV2D_DILATION = (float)0.3;
constexpr float LAMBDA2_MIN = (float)0.1;
constexpr float AXIS_MAX_PX = (float)4096.0;
constexpr float QUAD_EXTENT = (float)2.0;
// x / ALPHA_CUTOFF as ATen computes a division by a Python float
constexpr float INV_ALPHA_CUTOFF = (float)(1.0 / (1.0 / 255.0));
constexpr float VZ_MAX = (float)-1e-6;
constexpr float RR_MIN = (float)1e-18;
constexpr float NSQ_MIN = (float)1e-24;
constexpr float DSQ_MIN = (float)1e-24;
constexpr float OPAC_MIN = (float)1e-20;

constexpr float SH_C1 = (float)0.4886025;
constexpr float NEG_SH_C1 = (float)-0.4886025;
constexpr float SH_C2_0 = (float)1.0925484, SH_C2_1 = (float)-1.0925484, SH_C2_2 = (float)0.3153916,
                SH_C2_3 = (float)-1.0925484, SH_C2_4 = (float)0.5462742;
constexpr float SH_C3_0 = (float)-0.5900436, SH_C3_1 = (float)2.8906114, SH_C3_2 = (float)-0.4570458,
                SH_C3_3 = (float)0.3731763, SH_C3_4 = (float)-0.4570458, SH_C3_5 = (float)1.4453057,
                SH_C3_6 = (float)-0.5900436;

// SH coefficient rows read at sh_order 0..3 (3 channels a basis).
__host__ __device__ constexpr int sh_rows(int order) { return order == 0 ? 0 : order == 1 ? 9 : order == 2 ? 24 : 45; }

// torch.clamp / torch.minimum / max0 as ATen computes them: a NaN input
// comes out as it went in.
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return isnan(v) ? v : fminf(v, hi); }
__device__ __forceinline__ float clamp_both(float v, float lo, float hi) {
    return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float minimum(float a, float b) { return isnan(a) ? a : (isnan(b) ? b : fminf(a, b)); }
__device__ __forceinline__ float max0(float x) { return x == 0.0f ? 0.5f * x : clamp_min(x, 0.0f); }
// torch.sign: 0 at 0 (and for NaN)
__device__ __forceinline__ float sgn(float x) { return (float)((0.0f < x) - (x < 0.0f)); }
__device__ __forceinline__ float sel(bool c, float a, float b) { return c ? a : b; }

// The camera of a launch, in shared memory: view, proj (row-major), position.
struct Cam {
    float v[16];
    float p[16];
    float c[3];
};

__device__ __forceinline__ void load_cam(Cam& cam, const float* __restrict__ view, const float* __restrict__ proj,
                                         const float* __restrict__ cpos) {
    const int t = threadIdx.x;
    if (t < 16) cam.v[t] = view[t];
    else if (t < 32) cam.p[t - 16] = proj[t - 16];
    else if (t < 35) cam.c[t - 32] = cpos[t - 32];
    __syncthreads();
}

// One splat's forward, every intermediate the backward reads.  In the
// backward (BWD) the opacity is read only for tight_footprint's radius and
// the colour only where max0's gradient needs it (sh_order > 0).
template <int SH>
struct Fwd {
    // inputs
    float px, py, pz, qx, qy, qz, qw, sx, sy, sz, op;
    float shv[sh_rows(SH) > 0 ? sh_rows(SH) : 1];
    // centre
    float vx, vy, vz, cx, cy, cw, safe_w, ndc_x, ndc_y, mean_x, mean_y;
    bool valid;
    // covariance
    float m[3][3];
    float sig[6];
    float lim_x, lim_y, vzc, tqx, tqy, vxc, vyc, focal;
    float c00, c01, c02, c11, c12, c22;
    float inv_z, a, gx, gy, cu0_0, cu0_2, cu1_1, cu1_0, cu1_2, cov_a, cov_b, cov_c;
    // eigen
    float hd, rr, radius, lambda1, l2raw, ex, ey, inv_norm, dx, dy, s1, s2, len1, len2;
    bool safe;
    float v1x, v1y, v2x, v2y, inv_l1, inv_l2, ax, ay, bx, by, rho, half_x, half_y;
    // colour
    float tx, ty, tz, depth_sq, inv_n, x, y, z;
    float xx, yy, zz, xy, yz, xz;
    float basis[15];
    float pre[3];
    float rgb[3];
};

// sig index of sigma (k, l), and the C entries (i, j) the projection uses
__device__ __forceinline__ int sig_index(int k, int l) {
    const int lo = k < l ? k : l, hi = k < l ? l : k;
    return lo == 0 ? hi : (lo == 1 ? 2 + hi : 5);
}

template <int SH, bool BWD>
__device__ __forceinline__ void project_one(Fwd<SH>& f, const Cam& cam, long long i, long long n,
                                            const float* __restrict__ pos, const float* __restrict__ orient,
                                            const float* __restrict__ scale, const float* __restrict__ opacity,
                                            const float* __restrict__ color, const float* __restrict__ sh,
                                            int width, int height, bool tight, bool only_sh) {
    const float* V = cam.v;
    const float* P = cam.p;
    f.px = __ldg(pos + i);
    f.py = __ldg(pos + n + i);
    f.pz = __ldg(pos + 2 * n + i);
    f.qx = __ldg(orient + i);
    f.qy = __ldg(orient + n + i);
    f.qz = __ldg(orient + 2 * n + i);
    f.qw = __ldg(orient + 3 * n + i);
    f.sx = __ldg(scale + i);
    f.sy = __ldg(scale + n + i);
    f.sz = __ldg(scale + 2 * n + i);
    f.op = (!BWD || tight) ? __ldg(opacity + i) : 0.0f;
#pragma unroll
    for (int r = 0; r < sh_rows(SH); ++r) f.shv[r] = __ldg(sh + r * n + i);

    // --- centre projection + viewport ---
    f.vx = ((V[0] * f.px + V[1] * f.py) + V[2] * f.pz) + V[3];
    f.vy = ((V[4] * f.px + V[5] * f.py) + V[6] * f.pz) + V[7];
    f.vz = ((V[8] * f.px + V[9] * f.py) + V[10] * f.pz) + V[11];
    f.cx = ((P[0] * f.vx + P[1] * f.vy) + P[2] * f.vz) + P[3];
    f.cy = ((P[4] * f.vx + P[5] * f.vy) + P[6] * f.vz) + P[7];
    f.cw = ((P[12] * f.vx + P[13] * f.vy) + P[14] * f.vz) + P[15];
    f.valid = f.cw > 0.0f;
    f.safe_w = sel(f.valid, f.cw, 1.0f);
    f.ndc_x = f.cx / f.safe_w;
    f.ndc_y = f.cy / f.safe_w;
    f.mean_x = (f.ndc_x + 1.0f) * (float)(0.5 * (double)width);
    f.mean_y = (1.0f - f.ndc_y) * (float)(0.5 * (double)height);

    // --- EWA covariance projection ---
    const float qx = f.qx, qy = f.qy, qz = f.qz, qw = f.qw;
    f.m[0][0] = f.sx * (1.0f - 2.0f * (qy * qy + qz * qz));
    f.m[0][1] = f.sx * (2.0f * (qx * qy + qw * qz));
    f.m[0][2] = f.sx * (2.0f * (qx * qz - qw * qy));
    f.m[1][0] = f.sy * (2.0f * (qx * qy - qw * qz));
    f.m[1][1] = f.sy * (1.0f - 2.0f * (qx * qx + qz * qz));
    f.m[1][2] = f.sy * (2.0f * (qy * qz + qw * qx));
    f.m[2][0] = f.sz * (2.0f * (qx * qz + qw * qy));
    f.m[2][1] = f.sz * (2.0f * (qy * qz - qw * qx));
    f.m[2][2] = f.sz * (1.0f - 2.0f * (qx * qx + qy * qy));
    {
        int s = 0;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = a; b < 3; ++b, ++s)
                f.sig[s] = (f.m[0][a] * f.m[0][b] + f.m[1][a] * f.m[1][b]) + f.m[2][a] * f.m[2][b];
    }
    const float p00 = P[0], p11 = P[5];
    const float aspect = p00 / p11;
    f.lim_x = (1.0f / p00) * FOV_CLAMP;
    f.lim_y = (1.0f / (p11 * aspect)) * FOV_CLAMP;
    f.vzc = clamp_max(f.vz, VZ_MAX);
    f.tqx = f.vx / f.vzc;
    f.tqy = f.vy / f.vzc;
    f.vxc = clamp_both(f.tqx, -f.lim_x, f.lim_x) * f.vzc;
    f.vyc = clamp_both(f.tqy, -f.lim_y, f.lim_y) * f.vzc;
    f.focal = (p00 * (float)width) * 0.5f;

    // C = Rv Sigma Rv^T: (rv_ik * rv_jl) * sigma_kl summed over k, then l
    float cc[6];
    {
        const int ci[6] = {0, 0, 0, 1, 1, 2}, cj[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
        for (int e = 0; e < 6; ++e) {
            float acc = 0.0f;
#pragma unroll
            for (int k = 0; k < 3; ++k)
#pragma unroll
                for (int l = 0; l < 3; ++l) {
                    const float term = (V[4 * ci[e] + k] * V[4 * cj[e] + l]) * f.sig[sig_index(k, l)];
                    acc = (k == 0 && l == 0) ? term : acc + term;
                }
            cc[e] = acc;
        }
    }
    f.c00 = cc[0]; f.c01 = cc[1]; f.c02 = cc[2]; f.c11 = cc[3]; f.c12 = cc[4]; f.c22 = cc[5];

    f.inv_z = 1.0f / f.vzc;
    f.a = f.focal * f.inv_z;
    f.gx = ((-f.focal * f.vxc) * f.inv_z) * f.inv_z;
    f.gy = ((-f.focal * f.vyc) * f.inv_z) * f.inv_z;
    f.cu0_0 = f.a * f.c00 + f.gx * f.c02;
    f.cu0_2 = f.a * f.c02 + f.gx * f.c22;
    f.cu1_1 = f.a * f.c11 + f.gy * f.c12;
    f.cu1_0 = f.a * f.c01 + f.gy * f.c02;
    f.cu1_2 = f.a * f.c12 + f.gy * f.c22;
    f.cov_a = (f.a * f.cu0_0 + f.gx * f.cu0_2) + COV2D_DILATION;
    f.cov_b = f.a * f.cu1_0 + f.gx * f.cu1_2;
    f.cov_c = (f.a * f.cu1_1 + f.gy * f.cu1_2) + COV2D_DILATION;

    // --- 2x2 eigen decomposition -> quad axes ---
    const float mid = 0.5f * (f.cov_a + f.cov_c);
    f.hd = (f.cov_a - f.cov_c) * 0.5f;
    f.rr = f.hd * f.hd + f.cov_b * f.cov_b;
    f.radius = sqrtf(clamp_min(f.rr, RR_MIN));
    f.lambda1 = mid + f.radius;
    f.l2raw = mid - f.radius;
    const float lambda2 = clamp_min(f.l2raw, LAMBDA2_MIN);
    f.ex = f.cov_b;
    f.ey = f.lambda1 - f.cov_a;
    const float norm_sq = f.ex * f.ex + f.ey * f.ey;
    f.safe = norm_sq > NSQ_MIN;
    f.inv_norm = sel(f.safe, rsqrtf(norm_sq), 0.0f);
    f.dx = sel(f.safe, f.ex * f.inv_norm, 1.0f);
    f.dy = -sel(f.safe, f.ey * f.inv_norm, 0.0f);
    f.s1 = sqrtf(2.0f * f.lambda1);
    f.s2 = sqrtf(2.0f * lambda2);
    f.len1 = clamp_max(f.s1, AXIS_MAX_PX);
    f.len2 = clamp_max(f.s2, AXIS_MAX_PX);
    f.v1x = f.len1 * f.dx;
    f.v1y = f.len1 * f.dy;
    f.v2x = f.len2 * f.dy;
    f.v2y = -f.len2 * f.dx;
    f.inv_l1 = 1.0f / (f.len1 * f.len1);
    f.inv_l2 = 1.0f / (f.len2 * f.len2);
    f.ax = f.v1x * f.inv_l1;
    f.ay = f.v1y * f.inv_l1;
    f.bx = f.v2x * f.inv_l2;
    f.by = f.v2y * f.inv_l2;
    f.half_x = QUAD_EXTENT * (fabsf(f.v1x) + fabsf(f.v2x));
    f.half_y = QUAD_EXTENT * (fabsf(f.v1y) + fabsf(f.v2y));
    f.rho = 0.0f;
    if (tight) {
        f.rho = sqrtf(clamp_min(logf(clamp_min(f.op, OPAC_MIN) * INV_ALPHA_CUTOFF), 0.0f));
        f.half_x = minimum(f.half_x, f.rho * sqrtf(f.v1x * f.v1x + f.v2x * f.v2x));
        f.half_y = minimum(f.half_y, f.rho * sqrtf(f.v1y * f.v1y + f.v2y * f.v2y));
    }

    // --- depth key + SH colour ---
    f.tx = f.px - cam.c[0];
    f.ty = f.py - cam.c[1];
    f.tz = f.pz - cam.c[2];
    f.depth_sq = (f.tx * f.tx + f.ty * f.ty) + f.tz * f.tz;
#pragma unroll
    for (int c = 0; c < 3; ++c) f.pre[c] = only_sh ? 0.5f : (BWD && SH == 0) ? 0.0f : __ldg(color + c * n + i);
    if (SH > 0) {
        f.inv_n = rsqrtf(clamp_min(f.depth_sq, DSQ_MIN));
        const float x = f.tx * f.inv_n, y = f.ty * f.inv_n, z = f.tz * f.inv_n;
        f.x = x; f.y = y; f.z = z;
        float* b = f.basis;
        b[0] = NEG_SH_C1 * y;
        b[1] = SH_C1 * z;
        b[2] = NEG_SH_C1 * x;
        if (SH >= 2) {
            f.xx = x * x; f.yy = y * y; f.zz = z * z;
            f.xy = x * y; f.yz = y * z; f.xz = x * z;
            const float xx = f.xx, yy = f.yy, zz = f.zz;
            b[3] = SH_C2_0 * f.xy;
            b[4] = SH_C2_1 * f.yz;
            b[5] = SH_C2_2 * ((2.0f * zz - xx) - yy);
            b[6] = SH_C2_3 * f.xz;
            b[7] = SH_C2_4 * (xx - yy);
            if (SH >= 3) {
                b[8] = (SH_C3_0 * y) * (3.0f * xx - yy);
                b[9] = (SH_C3_1 * f.xy) * z;
                b[10] = (SH_C3_2 * y) * ((4.0f * zz - xx) - yy);
                b[11] = (SH_C3_3 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
                b[12] = (SH_C3_4 * x) * ((4.0f * zz - xx) - yy);
                b[13] = (SH_C3_5 * z) * (xx - yy);
                b[14] = (SH_C3_6 * x) * (xx - 3.0f * yy);
            }
        }
#pragma unroll
        for (int j = 0; j < sh_rows(SH) / 3; ++j)
#pragma unroll
            for (int c = 0; c < 3; ++c) f.pre[c] = f.pre[c] + b[j] * f.shv[3 * j + c];
#pragma unroll
        for (int c = 0; c < 3; ++c) f.rgb[c] = max0(f.pre[c]);
    } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) f.rgb[c] = f.pre[c];
    }
}

template <int SH>
__global__ void __launch_bounds__(THREADS)
project_fwd_kernel(const float* __restrict__ pos, const float* __restrict__ orient,
                   const float* __restrict__ scale, const float* __restrict__ opacity,
                   const float* __restrict__ color, const float* __restrict__ sh,
                   const float* __restrict__ view, const float* __restrict__ proj,
                   const float* __restrict__ cpos, float* __restrict__ out, long long n,
                   int width, int height, bool tight, bool only_sh, int payload) {
    __shared__ Cam cam;
    load_cam(cam, view, proj, cpos);
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    Fwd<SH> f;
    project_one<SH, false>(f, cam, i, n, pos, orient, scale, opacity, color, sh, width, height, tight, only_sh);
    float row[16] = {f.mean_x, f.mean_y, f.ax, f.ay, f.bx, f.by, f.rgb[0], f.rgb[1], f.rgb[2], f.op,
                     f.depth_sq, f.valid ? 1.0f : 0.0f, f.half_x, f.half_y, -f.vz, 0.0f};
    if (payload != PAYLOAD_RAW) {
        // sanitize_projected: an invalid column takes _BENIGN's values
        // (ops/rasterize_ref.py), +inf depth included, which sorts it last
        if (!f.valid) {
#pragma unroll
            for (int r = 0; r < 16; ++r) row[r] = 0.0f;
            row[0] = -1e7f;
            row[1] = -1e7f;
            row[2] = 1.0f;
            row[5] = 1.0f;
            row[10] = INFINITY;
        }
        // quantize_payload: rows 6..9 (packed) or 0..9 (bfloat16) rounded to
        // bf16 and back, round to nearest even
        if (payload == PAYLOAD_PACKED) {
#pragma unroll
            for (int r = 6; r < 10; ++r) row[r] = __bfloat162float(__float2bfloat16_rn(row[r]));
        } else if (payload == PAYLOAD_BF16) {
#pragma unroll
            for (int r = 0; r < 10; ++r) row[r] = __bfloat162float(__float2bfloat16_rn(row[r]));
        }
        // splat-major: the splat's 16 words are one 64-byte record, which
        // the depth-order gather reads at a random position in two sectors
        float4* rec = reinterpret_cast<float4*>(out + i * 16);
#pragma unroll
        for (int q = 0; q < 4; ++q) rec[q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2], row[4 * q + 3]);
        return;
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) out[r * n + i] = row[r];
}

// max0's gradient: half at a tie, whole above 0, none below (and for NaN)
__device__ __forceinline__ float max0_grad(float x, float g) {
    return x == 0.0f ? 0.5f * g : (x >= 0.0f ? g : 0.0f);
}

template <int SH>
__global__ void __launch_bounds__(THREADS_BWD)
project_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ orient,
                   const float* __restrict__ scale, const float* __restrict__ opacity,
                   const float* __restrict__ color, const float* __restrict__ sh,
                   const float* __restrict__ view, const float* __restrict__ proj,
                   const float* __restrict__ cpos, const float* __restrict__ grad,
                   float* __restrict__ d_pos, float* __restrict__ d_orient, float* __restrict__ d_scale,
                   float* __restrict__ d_color, float* __restrict__ d_sh, float* __restrict__ d_opacity,
                   long long n, long long g_rs, long long g_cs, int width, int height, bool tight, bool only_sh,
                   bool masked) {
    __shared__ Cam cam;
    load_cam(cam, view, proj, cpos);
    const long long i = (long long)blockIdx.x * THREADS_BWD + threadIdx.x;
    if (i >= n) return;
    Fwd<SH> f;
    project_one<SH, true>(f, cam, i, n, pos, orient, scale, opacity, color, sh, width, height, tight, only_sh);
    const float* V = cam.v;
    const float* P = cam.p;
    // masked: the fields were sanitized in the forward (the payload form),
    // whose VJP zeroes an invalid column's cotangent
    const bool keep = !masked || f.valid;
    // rows 9, 11 and 15 (and 6..8 at sh_order 0) carry no gradient here:
    // the opacity's (and then the colour's) is the cotangent row itself,
    // which the kernel writes only in the masked form (else the caller
    // takes a view of the cotangent)
    float g[16];
#pragma unroll
    for (int r = 0; r < 16; ++r)
        g[r] = (!keep || r == 9 || r == 11 || r == 15 || (SH == 0 && r >= 6 && r <= 8))
                   ? 0.0f : __ldg(grad + r * g_rs + i * g_cs);
    if (masked) {
        d_opacity[i] = keep ? __ldg(grad + 9 * g_rs + i * g_cs) : 0.0f;
        if (SH == 0 && !only_sh) {
#pragma unroll
            for (int c = 0; c < 3; ++c)
                d_color[c * n + i] = keep ? __ldg(grad + (6 + c) * g_rs + i * g_cs) : 0.0f;
        }
    }

    // --- colour (rows 6..8) and the depth key (row 10) ---
    float gc[3] = {g[6], g[7], g[8]};
    float d_t[3] = {0.0f, 0.0f, 0.0f};
    float d_depth = g[10];
    if (SH > 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) gc[c] = max0_grad(f.pre[c], gc[c]);
        float db[15];
#pragma unroll
        for (int j = 0; j < sh_rows(SH) / 3; ++j) {
#pragma unroll
            for (int c = 0; c < 3; ++c) d_sh[(3 * j + c) * n + i] = f.basis[j] * gc[c];
            db[j] = (f.shv[3 * j] * gc[0] + f.shv[3 * j + 1] * gc[1]) + f.shv[3 * j + 2] * gc[2];
        }
#pragma unroll
        for (int r = sh_rows(SH); r < 45; ++r) d_sh[r * n + i] = 0.0f;
        const float x = f.x, y = f.y, z = f.z;
        float d_x = NEG_SH_C1 * db[2];
        float d_y = NEG_SH_C1 * db[0];
        float d_z = SH_C1 * db[1];
        if (SH >= 2) {
            const float xx = f.xx, yy = f.yy, zz = f.zz;
            float d_xy = SH_C2_0 * db[3];
            float d_yz = SH_C2_1 * db[4];
            float e = SH_C2_2 * db[5];
            float d_zz = 2.0f * e;
            float d_xx = -e;
            float d_yy = -e;
            const float d_xz = SH_C2_3 * db[6];
            e = SH_C2_4 * db[7];
            d_xx = d_xx + e;
            d_yy = d_yy - e;
            if (SH >= 3) {
                e = db[8] * (SH_C3_0 * y);
                d_y = d_y + SH_C3_0 * (db[8] * (3.0f * xx - yy));
                d_xx = d_xx + 3.0f * e;
                d_yy = d_yy - e;
                d_xy = d_xy + SH_C3_1 * (db[9] * z);
                d_z = d_z + db[9] * (SH_C3_1 * f.xy);
                e = db[10] * (SH_C3_2 * y);
                d_y = d_y + SH_C3_2 * (db[10] * ((4.0f * zz - xx) - yy));
                d_zz = d_zz + 4.0f * e;
                d_xx = d_xx - e;
                d_yy = d_yy - e;
                e = db[11] * (SH_C3_3 * z);
                d_z = d_z + SH_C3_3 * (db[11] * ((2.0f * zz - 3.0f * xx) - 3.0f * yy));
                d_zz = d_zz + 2.0f * e;
                d_xx = d_xx - 3.0f * e;
                d_yy = d_yy - 3.0f * e;
                e = db[12] * (SH_C3_4 * x);
                d_x = d_x + SH_C3_4 * (db[12] * ((4.0f * zz - xx) - yy));
                d_zz = d_zz + 4.0f * e;
                d_xx = d_xx - e;
                d_yy = d_yy - e;
                e = db[13] * (SH_C3_5 * z);
                d_z = d_z + SH_C3_5 * (db[13] * (xx - yy));
                d_xx = d_xx + e;
                d_yy = d_yy - e;
                e = db[14] * (SH_C3_6 * x);
                d_x = d_x + SH_C3_6 * (db[14] * (xx - 3.0f * yy));
                d_xx = d_xx + e;
                d_yy = d_yy - 3.0f * e;
            }
            d_x = ((d_x + (2.0f * x) * d_xx) + y * d_xy) + z * d_xz;
            d_y = ((d_y + (2.0f * y) * d_yy) + x * d_xy) + z * d_yz;
            d_z = ((d_z + (2.0f * z) * d_zz) + y * d_yz) + x * d_xz;
        }
        const float inv_n = f.inv_n;
        const float d_inv_n = (d_x * f.tx + d_y * f.ty) + d_z * f.tz;
        d_t[0] = d_x * inv_n;
        d_t[1] = d_y * inv_n;
        d_t[2] = d_z * inv_n;
        const float d_dsq_c = (-0.5f * d_inv_n) * ((inv_n * inv_n) * inv_n);
        d_depth = d_depth + sel(f.depth_sq >= DSQ_MIN, d_dsq_c, 0.0f);
    }
    if (SH > 0 && !only_sh) {
#pragma unroll
        for (int c = 0; c < 3; ++c) d_color[c * n + i] = gc[c];
    }
    const float d_pos_t[3] = {d_t[0] + (2.0f * f.tx) * d_depth, d_t[1] + (2.0f * f.ty) * d_depth,
                              d_t[2] + (2.0f * f.tz) * d_depth};

    // --- quad basis (rows 2..5), footprint (rows 12..13) -> 2D covariance ---
    // autograd's own operations, its sums in the order its engine adds them
    // (project_fields_bwd_plain's _axes_vjp): near an axis-aligned
    // eigenvector inv_norm reaches ~1e5 and these terms cancel, so any other
    // order rounds to other ulps of inv_norm * |g|
    float fp1[2], fp2[2];
#pragma unroll
    for (int axis = 0; axis < 2; ++axis) {
        const float gh = g[12 + axis];
        const float v1 = axis == 0 ? f.v1x : f.v1y;
        const float v2 = axis == 0 ? f.v2x : f.v2y;
        if (tight) {
            const float l1 = QUAD_EXTENT * (fabsf(v1) + fabsf(v2));
            const float sq = sqrtf(v1 * v1 + v2 * v2);
            const float l2 = f.rho * sq;
            // torch.minimum's gradient: half each at a tie
            const float tie_g = l1 == l2 ? gh * 0.5f : gh;
            const float g_l1 = l1 > l2 ? 0.0f : tie_g;
            const float g_l2 = l1 < l2 ? 0.0f : tie_g;
            const float d_q = (g_l2 * f.rho) / (2.0f * sq);
            const float s_g = g_l1 * QUAD_EXTENT;
            fp1[axis] = (d_q * v1 + d_q * v1) + s_g * sgn(v1);
            fp2[axis] = (d_q * v2 + d_q * v2) + s_g * sgn(v2);
        } else {
            const float s_g = gh * QUAD_EXTENT;
            fp1[axis] = s_g * sgn(v1);
            fp2[axis] = s_g * sgn(v2);
        }
    }
    const float d_v1x = fp1[0] + g[2] * f.inv_l1;
    const float d_v1y = fp1[1] + g[3] * f.inv_l1;
    const float d_v2x = fp2[0] + g[4] * f.inv_l2;
    const float d_v2y = fp2[1] + g[5] * f.inv_l2;
    const float d_il1 = g[3] * f.v1y + g[2] * f.v1x;
    const float d_il2 = g[5] * f.v2y + g[4] * f.v2x;
    const float nl2 = -f.len2;
    // 1/(len * len) is reciprocal(len * len) * 1.0
    const float d_ll1 = -(d_il1 * 1.0f) * (f.inv_l1 * f.inv_l1);
    const float d_ll2 = -(d_il2 * 1.0f) * (f.inv_l2 * f.inv_l2);
    const float d_len1 = ((d_ll1 * f.len1 + d_ll1 * f.len1) + d_v1y * f.dy) + d_v1x * f.dx;
    const float d_nl2 = d_v2y * f.dx;
    const float d_dx = d_v2y * nl2 + d_v1x * f.len1;
    const float d_len2 = ((d_ll2 * f.len2 + d_ll2 * f.len2) + (-d_nl2)) + d_v2x * f.dy;
    const float d_dy = d_v2x * f.len2 + d_v1y * f.len1;
    const float d_t1 = sel(f.s1 <= AXIS_MAX_PX, d_len1, 0.0f) / (2.0f * f.s1);
    const float d_t2 = sel(f.s2 <= AXIS_MAX_PX, d_len2, 0.0f) / (2.0f * f.s2);
    const float d_l2 = d_t2 * 2.0f;
    const float inv_norm = f.inv_norm;
    const float d_eyn = sel(f.safe, -d_dy, 0.0f);
    const float d_exn = sel(f.safe, d_dx, 0.0f);
    const float d_inv = sel(f.safe, d_eyn * f.ey + d_exn * f.ex, 0.0f);
    const float r = sel(f.safe, inv_norm, 1.0f);  // rsqrt(where(safe, norm_sq, 1))
    const float d_nsq = sel(f.safe, (-0.5f * d_inv) * ((r * r) * r), 0.0f);
    const float d_ey = (d_eyn * inv_norm + d_nsq * f.ey) + d_nsq * f.ey;
    const float d_l2raw = sel(f.l2raw >= LAMBDA2_MIN, d_l2, 0.0f);
    const float d_l1 = d_t1 * 2.0f + d_ey;
    const float d_mid = d_l2raw + d_l1;
    const float d_rad = (-d_l2raw) + d_l1;
    const float d_rr = sel(f.rr >= RR_MIN, d_rad / (2.0f * f.radius), 0.0f);
    const float d_hd2 = d_rr * (2.0f * f.hd);
    const float d_ac = d_hd2 * 0.5f;
    const float d_sac = d_mid * 0.5f;
    const float d_cov_a = ((-d_ey) + d_ac) + d_sac;
    const float d_cov_b = ((d_exn * inv_norm + d_nsq * f.ex) + d_nsq * f.ex) + d_rr * (2.0f * f.cov_b);
    const float d_cov_c = (-d_ac) + d_sac;

    // --- EWA: 2D covariance -> (a, gx, gy) and C ---
    const float a = f.a, gx = f.gx, gy = f.gy;
    const float d_cu00 = d_cov_a * a;
    const float d_cu02 = d_cov_a * gx;
    const float d_cu10 = d_cov_b * a;
    const float d_cu12 = d_cov_b * gx + d_cov_c * gy;
    const float d_cu11 = d_cov_c * a;
    const float d_a = ((((((d_cov_a * f.cu0_0 + d_cov_b * f.cu1_0) + d_cov_c * f.cu1_1) + d_cu00 * f.c00)
                         + d_cu02 * f.c02) + d_cu11 * f.c11) + d_cu10 * f.c01) + d_cu12 * f.c12;
    const float d_gx = ((d_cov_a * f.cu0_2 + d_cov_b * f.cu1_2) + d_cu00 * f.c02) + d_cu02 * f.c22;
    const float d_gy = ((d_cov_c * f.cu1_2 + d_cu11 * f.c12) + d_cu10 * f.c02) + d_cu12 * f.c22;
    const float d_c[6] = {
        d_cu00 * a,                                   // (0, 0)
        d_cu10 * a,                                   // (0, 1)
        (d_cu00 * gx + d_cu02 * a) + d_cu10 * gy,     // (0, 2)
        d_cu11 * a,                                   // (1, 1)
        d_cu11 * gy + d_cu12 * a,                     // (1, 2)
        d_cu02 * gx + d_cu12 * gy,                    // (2, 2)
    };
    const float inv_z = f.inv_z, vzc = f.vzc, focal = f.focal;
    const float d_inv_z = focal * d_a - (2.0f * inv_z) * (focal * (d_gx * f.vxc + d_gy * f.vyc));
    const float iz2 = inv_z * inv_z;
    const float d_vxc = -focal * (d_gx * iz2);
    const float d_vyc = -focal * (d_gy * iz2);
    float d_vzc = -d_inv_z * iz2;
    float d_vxy[2];
#pragma unroll
    for (int axis = 0; axis < 2; ++axis) {
        const float d_vc = axis == 0 ? d_vxc : d_vyc;
        const float tq = axis == 0 ? f.tqx : f.tqy;
        const float lim = axis == 0 ? f.lim_x : f.lim_y;
        const bool inside = (tq >= -lim) && (tq <= lim);
        const float d_tq = sel(inside, d_vc * vzc, 0.0f);
        d_vzc = (d_vzc + d_vc * clamp_both(tq, -lim, lim)) - (d_tq * tq) / vzc;
        d_vxy[axis] = d_tq / vzc;
    }
    const float d_vz = sel(f.vz <= VZ_MAX, d_vzc, 0.0f) - g[14];

    // C = Rv Sigma Rv^T -> the six sigma
    float d_sig[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    {
        const int ci[6] = {0, 0, 0, 1, 1, 2}, cj[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
        for (int e = 0; e < 6; ++e)
#pragma unroll
            for (int k = 0; k < 3; ++k)
#pragma unroll
                for (int l = 0; l < 3; ++l) {
                    const int s = sig_index(k, l);
                    d_sig[s] = d_sig[s] + (V[4 * ci[e] + k] * V[4 * cj[e] + l]) * d_c[e];
                }
    }
    // Sigma = M^T M -> M;  M = S R -> scale and the rotation entries
    const float qx = f.qx, qy = f.qy, qz = f.qz, qw = f.qw;
    const float rot[3][3] = {
        {1.0f - 2.0f * (qy * qy + qz * qz), 2.0f * (qx * qy + qw * qz), 2.0f * (qx * qz - qw * qy)},
        {2.0f * (qx * qy - qw * qz), 1.0f - 2.0f * (qx * qx + qz * qz), 2.0f * (qy * qz + qw * qx)},
        {2.0f * (qx * qz + qw * qy), 2.0f * (qy * qz - qw * qx), 1.0f - 2.0f * (qx * qx + qy * qy)},
    };
    const float svec[3] = {f.sx, f.sy, f.sz};
    float d_r[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        float d_m[3];
#pragma unroll
        for (int a2 = 0; a2 < 3; ++a2) {
            float acc = 0.0f;
#pragma unroll
            for (int b2 = 0; b2 < 3; ++b2) {
                const float term = (a2 == b2 ? 2.0f * f.m[r][a2] : f.m[r][b2]) * d_sig[sig_index(a2, b2)];
                acc = b2 == 0 ? term : acc + term;
            }
            d_m[a2] = acc;
        }
        d_scale[r * n + i] = (d_m[0] * rot[r][0] + d_m[1] * rot[r][1]) + d_m[2] * rot[r][2];
#pragma unroll
        for (int a2 = 0; a2 < 3; ++a2) d_r[r][a2] = d_m[a2] * svec[r];
    }
    d_orient[i] = 2.0f * (((qy * (d_r[0][1] + d_r[1][0]) + qz * (d_r[0][2] + d_r[2][0]))
                           + qw * (d_r[1][2] - d_r[2][1])) - (2.0f * qx) * (d_r[1][1] + d_r[2][2]));
    d_orient[n + i] = 2.0f * (((qx * (d_r[0][1] + d_r[1][0]) + qz * (d_r[1][2] + d_r[2][1]))
                               + qw * (d_r[2][0] - d_r[0][2])) - (2.0f * qy) * (d_r[0][0] + d_r[2][2]));
    d_orient[2 * n + i] = 2.0f * (((qx * (d_r[0][2] + d_r[2][0]) + qy * (d_r[1][2] + d_r[2][1]))
                                   + qw * (d_r[0][1] - d_r[1][0])) - (2.0f * qz) * (d_r[0][0] + d_r[1][1]));
    d_orient[3 * n + i] = 2.0f * ((qx * (d_r[1][2] - d_r[2][1]) + qy * (d_r[2][0] - d_r[0][2]))
                                  + qz * (d_r[0][1] - d_r[1][0]));

    // --- centre: mean (rows 0..1) -> clip -> view ---
    const float d_ndc_x = g[0] * (float)(0.5 * (double)width);
    const float d_ndc_y = -(g[1] * (float)(0.5 * (double)height));
    const float d_cx = d_ndc_x / f.safe_w;
    const float d_cy = d_ndc_y / f.safe_w;
    const float d_cw = sel(f.valid, -(d_cx * f.ndc_x + d_cy * f.ndc_y), 0.0f);
    const float d_extra[3] = {d_vxy[0], d_vxy[1], d_vz};
    float d_v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) d_v[c] = ((P[c] * d_cx + P[4 + c] * d_cy) + P[12 + c] * d_cw) + d_extra[c];
#pragma unroll
    for (int c = 0; c < 3; ++c)
        d_pos[c * n + i] = ((V[c] * d_v[0] + V[4 + c] * d_v[1]) + V[8 + c] * d_v[2]) + d_pos_t[c];
}

template <int SH>
cudaError_t launch_fwd(const float* const* in, float* out, long long n, int w, int h, bool tight, bool only_sh,
                       int payload, cudaStream_t s) {
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    project_fwd_kernel<SH><<<blocks, THREADS, 0, s>>>(in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7],
                                                      in[8], out, n, w, h, tight, only_sh, payload);
    return cudaGetLastError();
}

template <int SH>
cudaError_t launch_bwd(const float* const* in, float* const* out, long long n, long long g_rs, long long g_cs,
                       int w, int h, bool tight, bool only_sh, bool masked, cudaStream_t s) {
    const unsigned blocks = (unsigned)((n + THREADS_BWD - 1) / THREADS_BWD);
    project_bwd_kernel<SH><<<blocks, THREADS_BWD, 0, s>>>(in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7],
                                                      in[8], in[9], out[0], out[1], out[2], out[3], out[4],
                                                      out[5], n, g_rs, g_cs, w, h, tight, only_sh, masked);
    return cudaGetLastError();
}

}  // namespace

// Inputs float32 and contiguous: pos (3, n), orient (4, n), scale (3, n),
// opacity (n,), color (3, n), sh (45, n), view (4, 4), proj (4, 4),
// cam_pos (3,).  out: (16, n) row-major; every entry is written.  payload:
// 0 the raw fields, 1 sanitized, 2 sanitized and rows 6..9 rounded to bf16
// (packed), 3 sanitized and rows 0..9 rounded to bf16; with payload > 0 out
// is splat-major, (n, 16) row-major (16-byte aligned).
extern "C" int gsplat_project_fwd(const void* pos, const void* orient, const void* scale, const void* opacity,
                                  const void* color, const void* sh, const void* view, const void* proj,
                                  const void* cam_pos, void* out, long long n, int width, int height,
                                  int sh_order, int tight, int only_sh, int payload, void* stream) {
    if (n <= 0) return 0;
    if (sh_order < 0 || sh_order > 3 || payload < PAYLOAD_RAW || payload > PAYLOAD_BF16)
        return (int)cudaErrorInvalidValue;
    const float* in[9] = {
        static_cast<const float*>(pos), static_cast<const float*>(orient), static_cast<const float*>(scale),
        static_cast<const float*>(opacity), static_cast<const float*>(color), static_cast<const float*>(sh),
        static_cast<const float*>(view), static_cast<const float*>(proj), static_cast<const float*>(cam_pos)};
    float* o = static_cast<float*>(out);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const bool t = tight != 0, g = only_sh != 0;
    switch (sh_order) {
        case 0: return (int)launch_fwd<0>(in, o, n, width, height, t, g, payload, s);
        case 1: return (int)launch_fwd<1>(in, o, n, width, height, t, g, payload, s);
        case 2: return (int)launch_fwd<2>(in, o, n, width, height, t, g, payload, s);
        default: return (int)launch_fwd<3>(in, o, n, width, height, t, g, payload, s);
    }
}

// The same inputs and grad (16, n): entry (r, i) at grad[r * g_rs + i *
// g_cs], row-major (n, 1) or, the gradient frame's scatter_payload writes
// it so, splat-major (1, 16).  Outputs (n-strided rows, every entry
// written): d_pos (3, n), d_orient (4, n), d_scale (3, n), d_color (3, n)
// when not only_sh and sh_order > 0 or masked (else null, and not read),
// d_sh (45, n) when sh_order > 0 (else null), d_opacity (n,) when masked
// (else null).  masked: the cotangent of sanitized fields (the forward's
// payload form), zeroed where the splat is invalid.  The opacity is read
// only with tight, the colour only where d_color is written.
extern "C" int gsplat_project_bwd(const void* pos, const void* orient, const void* scale, const void* opacity,
                                  const void* color, const void* sh, const void* view, const void* proj,
                                  const void* cam_pos, const void* grad, void* d_pos, void* d_orient,
                                  void* d_scale, void* d_color, void* d_sh, void* d_opacity, long long n,
                                  long long g_rs, long long g_cs, int width, int height, int sh_order, int tight,
                                  int only_sh, int masked, void* stream) {
    if (n <= 0) return 0;
    if (sh_order < 0 || sh_order > 3) return (int)cudaErrorInvalidValue;
    if (only_sh == 0 && (sh_order > 0 || masked != 0) && d_color == nullptr) return (int)cudaErrorInvalidValue;
    if ((sh_order > 0 && d_sh == nullptr) || (masked != 0 && d_opacity == nullptr)) return (int)cudaErrorInvalidValue;
    const float* in[10] = {
        static_cast<const float*>(pos), static_cast<const float*>(orient), static_cast<const float*>(scale),
        static_cast<const float*>(opacity), static_cast<const float*>(color), static_cast<const float*>(sh),
        static_cast<const float*>(view), static_cast<const float*>(proj), static_cast<const float*>(cam_pos),
        static_cast<const float*>(grad)};
    float* out[6] = {static_cast<float*>(d_pos), static_cast<float*>(d_orient), static_cast<float*>(d_scale),
                     static_cast<float*>(d_color), static_cast<float*>(d_sh), static_cast<float*>(d_opacity)};
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const bool t = tight != 0, g = only_sh != 0, m = masked != 0;
    switch (sh_order) {
        case 0: return (int)launch_bwd<0>(in, out, n, g_rs, g_cs, width, height, t, g, m, s);
        case 1: return (int)launch_bwd<1>(in, out, n, g_rs, g_cs, width, height, t, g, m, s);
        case 2: return (int)launch_bwd<2>(in, out, n, g_rs, g_cs, width, height, t, g, m, s);
        default: return (int)launch_bwd<3>(in, out, n, g_rs, g_cs, width, height, t, g, m, s);
    }
}
