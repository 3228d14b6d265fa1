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
// epoch is a number each call takes anew: a word left by an earlier call, or
// any other word, reads as "not ready".  The epoch lives on the device, in
// the scratch's first word, the epoch of the last call: every block reads it
// (with the tile counter beside it, in one load) and takes the one after,
// and the block that draws the call's last tile stores it back (every block
// has read it by then).  The tile counter is (epoch << 32) | count: a block
// that finds an older epoch there restarts it at this call's, so it needs no
// reset.  A call thus needs nothing from the host but pointers and sizes,
// and a launch replayed from a CUDA graph takes a fresh epoch exactly as an
// eager one does.  When the next epoch would reach `epoch_end` (2^31 - 1,
// or less through the wrapper's test hook), the call wraps instead: its
// blocks count themselves finished in a second counter of the same form,
// and the last to finish zeroes the whole scratch, so the next call starts
// again at epoch 1 with no host step.
// No call needs a memset launch, provided no word of the scratch carries a
// tag of this or a later epoch when the call starts.  Words left by earlier
// calls never do (epochs only grow between two zeroings), random words
// almost never do, and the wrapper allocates and grows the scratch zeroed
// (the tags of epoch 0, which no call has, and an epoch word that starts the
// epochs at 1).  Zeroing at allocation is required, not optional: a block
// the caching allocator hands back holds the process's earlier data, and
// small integers read as 64-bit words carry exactly the small epochs a
// scratch uses first.  A status word with this call's tag is read as a
// ready prefix (a wrong sum); a counter with this call's epoch skips its
// restart, so tiles are drawn from a stale count, some are never scanned and
// the look-back may spin forever.  The price of the design: two launches
// must never use one scratch at the same time, so the wrapper keys it by
// stream, and graphs that captured one scratch must replay in one stream's
// order (ops/kernels/scan.py).
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
// Plain C interface: pointers, sizes, the epoch end and the stream come in
// as arguments, nothing is allocated or synchronised here, and the entry
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

// The scratch: word 0 the epoch of the last call, word 1 the tile counter,
// word 2 the count of finished blocks (wrap calls only), word 3 + i tile
// i's status.  Both counters are (epoch << 32) | count.  Words 0 and 1 are
// read in one 16-byte load, so the scratch starts 16-byte aligned.
constexpr int EPOCH_WORD = 0;
constexpr int TILE_WORD = 1;
constexpr int DONE_WORD = 2;
constexpr int STATUS_WORDS = 3;

// Restarts `counter` = (epoch << 32) | count at this call's epoch if `cur`,
// the value read from it, holds an older one: a block that finds an older
// epoch there tries once (one of them wins; the others' attempts fail
// harmlessly, since the word then holds this epoch).  Returns the restart
// value.
__device__ __forceinline__ unsigned long long restart(unsigned long long* counter, unsigned long long cur,
                                                      unsigned epoch) {
    const unsigned long long start = (unsigned long long)epoch << 32;
    if ((unsigned)(cur >> 32) != epoch) atomicCAS(counter, cur, start);
    return start;
}

// The block's epoch and tile, by thread 0: the epoch word and the tile
// counter in one 16-byte load with acquire semantics (nothing after it,
// the draw included, is performed before it), then the tile index from one
// atomicAdd on the counter, no retry loop, so blocks do not queue on it.
__device__ __forceinline__ int draw_tile(unsigned long long* scratch, unsigned* epoch) {
    unsigned long long last, cur;
    asm volatile("ld.acquire.gpu.global.v2.u64 {%0, %1}, [%2];"
                 : "=l"(last), "=l"(cur) : "l"(scratch + EPOCH_WORD) : "memory");
    *epoch = (unsigned)last + 1u;
    const unsigned long long start = restart(scratch + TILE_WORD, cur, *epoch);
    return (int)(unsigned)(atomicAdd(scratch + TILE_WORD, 1ull) - start);
}

// The block that drew the last tile stores the call's epoch, once its
// look-back is done (a release store before the tile's load lies on the
// critical path of a scan that takes two waves of blocks): every block read
// the epoch word before its draw (acquire), and every other draw came before
// this one, so no block of the call reads it afterwards.  Release: the store
// is performed after the draw.
__device__ __forceinline__ void store_epoch(unsigned long long* scratch, unsigned epoch) {
    store_release(scratch + EPOCH_WORD, (unsigned long long)epoch);
}

// A wrap call only (the next epoch would reach `epoch_end`): called by lane
// 0 of warp 0 once the block is done with the scratch (every use of it
// comes before: the epoch read, the tile drawn and the status stores in this
// thread, the look-back's loads returned to the warp).  Counts the block as
// finished, with release semantics, so that its status stores are visible
// before the count; the block whose count completes the grid is the call's
// last and returns true.
__device__ __forceinline__ bool finish_block(unsigned long long* scratch, unsigned epoch, long long tiles) {
    unsigned long long* done = scratch + DONE_WORD;
    const unsigned long long start = restart(done, *reinterpret_cast<volatile unsigned long long*>(done), epoch);
    unsigned long long old;
    asm volatile("atom.release.gpu.global.add.u64 %0, [%1], %2;"
                 : "=l"(old) : "l"(done), "l"(1ull) : "memory");
    return (long long)(old - start) == tiles - 1;
}

// The wrap call's last block, warp 0: every other block has counted itself,
// so nothing reads or writes the scratch any more in this call.  Zero the
// whole scratch: epoch 0 stored, so the next call takes epoch 1, and no word
// carries a tag of it.
__device__ __forceinline__ void zero_scratch(unsigned long long* scratch, long long words, int lane) {
    __threadfence();  // what the other blocks released with their counts, before the zeros
    for (long long w = lane; w < words; w += 32) scratch[w] = 0ull;
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
scan_kernel(const int* __restrict__ in, int* __restrict__ out, unsigned long long* scratch, long long words,
            long long n, long long tiles, unsigned epoch_end, bool vec_in, bool vec_out) {
    constexpr int ROUNDS = ITEMS / 4;  // 16-byte vectors a thread
    __shared__ int s_warp[WARPS];
    __shared__ int s_tile;
    __shared__ unsigned s_epoch;
    __shared__ int s_prefix;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    unsigned long long* status = scratch + STATUS_WORDS;

    if (tid == 0) {
        unsigned e;
        s_tile = draw_tile(scratch, &e);
        s_epoch = e;
    }
    __syncthreads();
    const int tile = s_tile;
    const unsigned epoch = s_epoch;
    // Past the last epoch the call wraps: its last block to finish zeroes
    // the scratch.  Otherwise the last tile's block stores the epoch.
    const bool wrap = epoch + 1u >= epoch_end;
    const unsigned tag_a = 2u * epoch;
    const unsigned tag_p = 2u * epoch + 1u;
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
    // The epoch stored, or in a wrap call the block counted finished (and
    // the scratch zeroed by the last), while the other warps write their
    // outputs.
    if (!wrap && tile == tiles - 1 && tid == 0) store_epoch(scratch, epoch);
    if (wrap && warp == 0) {
        bool last = false;
        if (lane == 0) last = finish_block(scratch, epoch, tiles);
        if (__shfl_sync(FULL, last, 0)) zero_scratch(scratch, words, lane);
    }
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
cudaError_t launch(const int* in, int* out, unsigned long long* scratch, long long words, long long n,
                   unsigned epoch_end, cudaStream_t stream) {
    const long long tiles = (n + TILE - 1) / TILE;
    const bool vec_in = (reinterpret_cast<uintptr_t>(in) & 15) == 0;
    const bool vec_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    scan_kernel<MAX><<<(unsigned)tiles, THREADS, 0, stream>>>(
        in, out, scratch, words, n, tiles, epoch_end, vec_in, vec_out);
    return cudaGetLastError();
}

}  // namespace

// Elements a tile, so the caller can size the scratch: 3 + ceil(n / tile)
// 64-bit words.
extern "C" int gsplat_scan_tile() { return TILE; }

// Inclusive scan of in[0..n) into out[0..n) in one launch.  `scratch`:
// `words` >= 3 + ceil(n / gsplat_scan_tile()) 64-bit words that no other
// call uses at the same time, zeroed when allocated and then written only
// by this entry (it keeps its epoch there).  `epoch_end`: in [2, 2^31 - 1];
// the calls on a scratch take epochs 1, 2, ..., epoch_end - 1 and then start
// again at 1.  kind: 0 = add, 1 = max.
extern "C" int gsplat_scan_i32(const void* in, void* out, void* scratch, long long words, long long n, int kind,
                               unsigned epoch_end, void* stream) {
    if (n <= 0) return 0;
    if (epoch_end < 2u || epoch_end > 0x7fffffffu) return (int)cudaErrorInvalidValue;
    if (words < STATUS_WORDS + (n + TILE - 1) / TILE) return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int* i = static_cast<const int*>(in);
    int* o = static_cast<int*>(out);
    unsigned long long* w = static_cast<unsigned long long*>(scratch);
    return (int)(kind == 1 ? launch<true>(i, o, w, words, n, epoch_end, s)
                           : launch<false>(i, o, w, words, n, epoch_end, s));
}
