// Exact inclusive prefix sum / prefix max of a 1-D int32 array, in one pass.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/scan.py:_scan_kernel (entries
// cumsum_i32 / cummax_i32), which walks the array in ONE sequential program,
// chaining (8, 512) blocks through a carried total with double-buffered
// copies.  On this card blocks run in parallel, so the carry becomes a
// single-pass scan with decoupled look-back, in ONE launch:
//
//   * every block draws its tile index from a counter in the scratch (not
//     from blockIdx), so a block only ever waits on tiles whose blocks have
//     already started: forward progress on any schedule;
//   * it reads its tile once (16-byte loads, warp-striped: every load
//     instruction of a warp covers 512 contiguous bytes), reduces it and
//     publishes the aggregate in its 64-bit status word (tile 0 publishes
//     its inclusive prefix at once);
//   * one warp looks back over the predecessors' status words, 32 at a time,
//     adding their aggregates until it meets an inclusive prefix; the block
//     publishes its own inclusive prefix, then scans and writes its tile.
//
// The status word: (tag << 32) | value in one 64-bit store (st.release.gpu),
// read with ld.acquire.gpu, so flag and value can never tear apart.  The tag
// is 2 * epoch (aggregate) or 2 * epoch + 1 (inclusive prefix), where the
// epoch is a number the wrapper passes anew with every call: a word left by
// an earlier call, or any other word, reads as "not ready".  The tile
// counter carries the epoch in its high half too: a block that finds an old
// epoch there restarts the count at this call's.  So no call needs a memset
// launch, provided no word of the scratch carries a tag of this or a later
// epoch when the call starts.  Words left by earlier calls never do (epochs
// only grow), and the wrapper allocates and grows the scratch zeroed (the
// tags of epoch 0, which no call has).  Zeroing at allocation is required,
// not optional: a block the caching allocator hands back holds the
// process's earlier data, and small integers read as 64-bit words carry
// exactly the small epochs a young process uses next.  A status word with
// this call's tag is read as a ready prefix (a wrong sum); a counter with
// this call's epoch skips the restart, so tiles are drawn from a stale
// count, some are never scanned and the look-back may spin forever.  The
// price of the design: a launch must never run twice with one epoch, so it
// cannot be replayed from a CUDA graph (the wrapper refuses a stream
// capture), and once the 2^31 - 2 epochs are spent the wrapper zeroes the
// scratch before it starts them again.
//
// What bounds it: bytes, 8 per element (read once, write once), which this
// design moves, plus 8 bytes of status a tile.  At L = 1M that is 2.4 us at
// the data sheet's rate: launch latency and the look-back chain are of the
// same size.  Integer add and max are exact in any association order, so
// the result does not depend on the tiling or on the look-back's window and
// equals a sequential scan bit for bit.  The ragged last tile is masked with
// the operator's neutral element (0 for add, INT32_MIN for max); a pointer
// that is not 16-byte aligned takes scalar loads and stores.
//
// Tile shape: THREADS x ITEMS = 1024 x 8 elements (measured against 1024 x
// 4, the earlier three-launch kernel's tile: fewer tiles make shorter
// look-back chains; PERF.md).
//
// Plain C interface: pointers, sizes, the epoch and the stream come in as
// arguments, nothing is allocated or synchronised here, and the entry
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int ITEMS = 8;  // elements a thread, a multiple of 4
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

template <bool MAX>
__device__ __forceinline__ int warp_reduce(int v) {
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) v = Op<MAX>::combine(v, __shfl_xor_sync(FULL, v, d));
    return v;
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status_word(unsigned tag, int value) {
    return ((unsigned long long)tag << 32) | (unsigned)value;
}

// Draws this call's next tile index from `counter` = (epoch << 32) | count.
// A block that finds an older epoch there tries once to restart the count
// at this call's (one of them wins; the others' attempts fail harmlessly,
// since the word then holds this epoch), then every block takes its index
// with one atomicAdd: no retry loop, so blocks do not queue on the counter.
__device__ __forceinline__ int draw_tile(unsigned long long* counter, unsigned epoch) {
    const unsigned long long start = (unsigned long long)epoch << 32;
    const unsigned long long cur = *reinterpret_cast<volatile unsigned long long*>(counter);
    if ((unsigned)(cur >> 32) != epoch) atomicCAS(counter, cur, start);
    return (int)(unsigned)(atomicAdd(counter, 1ull) - start);
}

// The exclusive prefix of `tile` over all tiles before it, by warp 0 of the
// block (every lane returns it).  status[i] is tile i's word.
template <bool MAX>
__device__ __forceinline__ int look_back(const unsigned long long* status, int tile,
                                         unsigned tag_a, unsigned tag_p, int lane) {
    int excl = Op<MAX>::neutral();
    int hi = tile - 1;  // the nearest predecessor the window starts at
    while (true) {
        const int pred = hi - lane;
        // beyond tile 0 a lane reads as a neutral inclusive prefix (never
        // counted: tile 0 itself is one, and nearer)
        unsigned tag = tag_p;
        int val = Op<MAX>::neutral();
        bool ready = pred < 0;
        // every lane's word must be ready before the window is read
        while (true) {
            if (!ready) {
                const unsigned long long w = load_acquire(status + pred);
                tag = (unsigned)(w >> 32);
                val = (int)(unsigned)w;
                ready = tag == tag_a || tag == tag_p;
            }
            if (__all_sync(FULL, ready)) break;
        }
        const unsigned incl = __ballot_sync(FULL, tag == tag_p);
        // lanes up to and including the nearest inclusive prefix count
        const int stop = incl ? __ffs(incl) - 1 : 31;
        const int mine = lane <= stop ? val : Op<MAX>::neutral();
        excl = Op<MAX>::combine(excl, warp_reduce<MAX>(mine));
        if (incl) return excl;
        hi -= 32;
    }
}

template <bool MAX>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const int* __restrict__ in, int* __restrict__ out, unsigned long long* status,
            unsigned long long* counter, long long n, unsigned epoch, bool vec_in, bool vec_out) {
    constexpr int ROUNDS = ITEMS / 4;  // 16-byte vectors a thread
    __shared__ int s_warp[WARPS];
    __shared__ int s_tile;
    __shared__ int s_prefix;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const unsigned tag_a = 2u * epoch;
    const unsigned tag_p = 2u * epoch + 1u;

    if (tid == 0) s_tile = draw_tile(counter, epoch);
    __syncthreads();
    const int tile = s_tile;
    const long long base = (long long)tile * TILE + (long long)warp * (32 * ITEMS);

    // Round r of lane l: the 4 elements at base + (r*32 + l)*4.
    int v[ROUNDS][4];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const long long idx = base + (long long)(r * 32 + lane) * 4;
        if (vec_in && idx + 4 <= n) {
            const int4 q = *reinterpret_cast<const int4*>(in + idx);
            v[r][0] = q.x; v[r][1] = q.y; v[r][2] = q.z; v[r][3] = q.w;
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) v[r][k] = (idx + k < n) ? in[idx + k] : Op<MAX>::neutral();
        }
    }
    // Inclusive within each vector, then across the warp round by round: the
    // warp's rounds are consecutive, so each carries the one before.
    int carry = Op<MAX>::neutral();
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
#pragma unroll
        for (int k = 1; k < 4; ++k) v[r][k] = Op<MAX>::combine(v[r][k - 1], v[r][k]);
        const int inc = warp_inclusive<MAX>(v[r][3], lane);
        int prev = __shfl_up_sync(FULL, inc, 1);
        if (lane == 0) prev = Op<MAX>::neutral();
        const int seed = Op<MAX>::combine(carry, prev);
#pragma unroll
        for (int k = 0; k < 4; ++k) v[r][k] = Op<MAX>::combine(seed, v[r][k]);
        carry = Op<MAX>::combine(carry, __shfl_sync(FULL, inc, 31));
    }
    if (lane == 31) s_warp[warp] = carry;  // the warp's total
    __syncthreads();
    if (warp == 0) {
        const int w = lane < WARPS ? s_warp[lane] : Op<MAX>::neutral();
        const int inc = warp_inclusive<MAX>(w, lane);
        s_warp[lane] = inc;  // inclusive prefix of the warps' totals
        const int aggregate = __shfl_sync(FULL, inc, 31);
        int prefix = Op<MAX>::neutral();
        if (tile == 0) {
            if (lane == 0) store_release(status, status_word(tag_p, aggregate));
        } else {
            if (lane == 0) store_release(status + tile, status_word(tag_a, aggregate));
            prefix = look_back<MAX>(status, tile, tag_a, tag_p, lane);
            if (lane == 0)
                store_release(status + tile, status_word(tag_p, Op<MAX>::combine(prefix, aggregate)));
        }
        if (lane == 0) s_prefix = prefix;
    }
    __syncthreads();
    const int seed = Op<MAX>::combine(s_prefix, warp > 0 ? s_warp[warp - 1] : Op<MAX>::neutral());
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const long long idx = base + (long long)(r * 32 + lane) * 4;
        int o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = Op<MAX>::combine(seed, v[r][k]);
        if (vec_out && idx + 4 <= n) {
            *reinterpret_cast<int4*>(out + idx) = make_int4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (idx + k < n) out[idx + k] = o[k];
        }
    }
}

template <bool MAX>
cudaError_t launch(const int* in, int* out, unsigned long long* scratch, long long n, unsigned epoch,
                   cudaStream_t stream) {
    const long long tiles = (n + TILE - 1) / TILE;
    const bool vec_in = (reinterpret_cast<uintptr_t>(in) & 15) == 0;
    const bool vec_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    // scratch[0] is the tile counter, scratch[1 + i] tile i's status word
    scan_kernel<MAX><<<(unsigned)tiles, THREADS, 0, stream>>>(
        in, out, scratch + 1, scratch, n, epoch, vec_in, vec_out);
    return cudaGetLastError();
}

}  // namespace

// Elements a tile, so the caller can size the scratch: 1 + ceil(n / tile)
// 64-bit words.
extern "C" int gsplat_scan_tile() { return TILE; }

// Inclusive scan of in[0..n) into out[0..n) in one launch.  `scratch`: 1 +
// ceil(n / gsplat_scan_tile()) 64-bit words that no other call uses at
// the same time, zeroed when allocated and then written only by this
// entry.  `epoch`: in [1, 2^31 - 1), greater than that of every earlier
// call on this scratch since it last held only zeros.
// kind: 0 = add, 1 = max.
extern "C" int gsplat_scan_i32(const void* in, void* out, void* scratch, long long n, int kind,
                               unsigned epoch, void* stream) {
    if (n <= 0) return 0;
    if (epoch == 0 || epoch >= 0x7fffffffu) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int* i = static_cast<const int*>(in);
    int* o = static_cast<int*>(out);
    unsigned long long* w = static_cast<unsigned long long*>(scratch);
    return (int)(kind == 1 ? launch<true>(i, o, w, n, epoch, s) : launch<false>(i, o, w, n, epoch, s));
}
