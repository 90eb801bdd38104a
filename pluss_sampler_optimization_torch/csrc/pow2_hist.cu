// Weighted pow2 histogram, for Hopper (sm_90a).
//
// Replaces the Pallas kernel ops/pallas_hist.py::_hist_kernel of the JAX
// package (launched by _ladder_counts, exposed as pow2_hist). That kernel
// builds a monotone comparison ladder c_k = sum of w over x >= 2^k on
// uint32 hi/lo planes and returns hist = c_k - c_{k+1}. This kernel
// computes the ladder's function directly: entry x with weight w adds w
// to bin 63 - clz((uint64) x), and an entry with x == 0 or w == 0 is
// dropped (negative x lands in bin 63, as on the ladder). Sums are
// uint64, exact modulo 2^64 whatever the order, so the TPU kernel's widen
// guard (16-bit weight planes against int32 wrap) is unnecessary.
// ops/pow2_hist.py's pow2_hist_plain is its plain tensor version.
//
// Bound on an H100: bytes. Per element an 8 B value and a 1 B bool weight
// (8 B for int weights) are read once, against about 8 integer issues;
// the sharded engine's 2^20-element launch moves 9.4 MB, 2.8 us at
// 3.35 TB/s. Every launch also pays a fixed start and drain of a few
// microseconds, so the design keeps each call to one device operation,
// puts every load of a thread in flight at once, and keeps the work per
// element to a few branch-free integer operations.
//
// Design.
// - One launch per call and no zero fill. Each block reduces its
//   elements into a shared 64-bin histogram and adds its non-zero bins to
//   `out` with one global atomic each. `out` is zero when the launch
//   starts because the previous launch on the same stream zeroed it: the
//   wrapper keeps, per (device, stream), the output of the next call,
//   allocated uninitialised one call ahead, and block 0 of every launch
//   writes its 64 zeros (`next`). The first call on a stream zeroes its
//   output once. A ticketed epilogue (fence, a ticket atomic, the last
//   block reading an accumulator back and re-zeroing it) would end every
//   launch with three dependent round trips to L2; this one ends with
//   fire-and-forget atomics.
// - A launch that the runtime refuses runs no block: the wrapper then
//   drops both buffers, and the next call starts from a fresh zeroed
//   output. A fault during the run (a bad pointer) is sticky: the context
//   is lost and every later launch in the process fails, so no later
//   answer can build on a half-written output.
// - 16-byte loads, all in flight at once. Elements split into a scalar
//   head (until `values` is 16-byte aligned), warp tiles of WARP_TILE =
//   256 elements, and a scalar tail. In a tile, lane l's step j (0..3) is
//   the longlong2 of elements 64j + 2l and 64j + 2l + 1, so each load
//   instruction of the warp reads 512 contiguous bytes. Bool weights are
//   read 8 at a time: lane l loads the uint2 of tile bytes 8l..8l+7, the
//   warp exchanges them through a 256-byte slice of shared memory, and
//   each lane reads back the two bytes of each of its steps. Int64
//   weights are read as longlong2 like the values. A lane issues its 5
//   (bool) or 8 (int) loads of a tile before it uses any of them. The
//   grid is as many blocks as the card holds at once (occupancy x SM
//   count, asked once per device and instantiation) but no more than the
//   tiles need, so the engine's launches run as one wave with every load
//   issued at the start; warps take tiles in a grid-stride loop. Block 0
//   takes the scalar head and tail alone (at most 3 elements a thread,
//   loaded together) where there are any.
// - Misaligned views. The head is chosen so that the weights of every
//   tile are 16-byte aligned too, where the two pointers' offsets allow
//   it (bool weights: their address plus the head divisible by 16 with
//   the head of the values' parity; int weights: the same parity);
//   otherwise the tiles read the weights with scalar loads. Every
//   element is read exactly once either way.
// - Accumulation in registers. Each thread keeps two (bin, sum) slots
//   over all its elements; a third bin pushes slot 0 to slot 1 and slot
//   1's old content to the shared histogram. A lane's tile goes into the
//   slots as one or two sums where its weighted values lie in one or two
//   bins (each of the sharded engine's launches fills one or two): the
//   top bit of their OR is the high bin, and their AND tells whether all
//   are in it, with no branch and no dependence from one element to the
//   next; otherwise element by element. At its end each thread adds its
//   slots to the shared histogram, one atomic each. The shared histogram
//   is two 32-bit words per bin, low and high, added with 32-bit atomics
//   and a carry from the low word's old value: exact modulo 2^64 with
//   native shared atomics (a 64-bit shared atomicAdd is a compare-and-
//   swap loop, which stalls when many lanes meet on one bin).
//
// The same file compiles as plain C++ (no __CUDACC__): it then exports
// pow2_hist_twin, which runs the kernel's partition serially for a given
// grid and block (plan, scalar block, tiles per warp and lane, slots and
// their evictions, the carried block histogram, the zeroing of `next`),
// pow2_hist_host, the twin at a fixed grid, and pow2_hist_plan, the plan
// of given pointers; the CPU tests build it with g++.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <atomic>
#define HD __host__ __device__ __forceinline__
#else
#define HD static inline
#endif
#ifdef __CUDA_ARCH__
#define UNROLL _Pragma("unroll")
#else
#define UNROLL
#endif

typedef long long i64;
typedef unsigned long long u64;

#define N_BINS 64
#define THREADS 256            // threads per block of the kernel
#define STEPS 4                // 16-byte value loads per lane per tile
#define WARP_TILE (64 * STEPS) // elements per warp tile
#define TILE_ELEMS (2 * STEPS) // a lane's elements of a tile
#define SCALAR_PER_THREAD 3    // the scalar block's elements a thread
static_assert(16 + WARP_TILE <= SCALAR_PER_THREAD * THREADS,
              "the scalar head and tail fit one block");

HD int clz64(u64 x) {
#ifdef __CUDA_ARCH__
    return __clzll((i64)x);
#else
    return __builtin_clzll(x);
#endif
}

// The ladder's bin of x: 63 - clz of x read as unsigned, or N_BINS (no
// bin) for x == 0 or a zero weight.
HD int ladder_bin(i64 x, i64 w) {
    if (x == 0 || w == 0) return N_BINS;
    return 63 - clz64((u64)x);
}

HD i64 weight_at(const void* weights, int w_is_bool, i64 i) {
    if (w_is_bool) return ((const unsigned char*)weights)[i] != 0;
    return ((const i64*)weights)[i];
}

// How one launch splits its n elements: `head` scalar elements, then
// `tiles` warp tiles of WARP_TILE from `head` on (values 16-byte aligned),
// then the scalar tail from `tail0` to n. `w_vec`: the tiles' weights are
// 16-byte aligned too.
struct Plan {
    i64 head, tiles, tail0, n_scalar;
    int w_vec;
};

// values' address must be 8-byte aligned, and so must int weights'.
HD Plan make_plan(u64 v_addr, u64 w_addr, int w_is_bool, i64 n) {
    const i64 hv = (i64)((v_addr >> 3) & 1);  // elements to 16 B for values
    i64 h = hv;
    int vec;
    if (w_is_bool) {
        const i64 hw = (i64)((16 - (w_addr & 15)) & 15);
        vec = (hw & 1) == hv;
        if (vec) h = hw;
    } else {
        vec = (i64)((w_addr >> 3) & 1) == hv;
    }
    Plan p;
    p.head = h < n ? h : n;
    p.tiles = (n - p.head) / WARP_TILE;
    p.tail0 = p.head + p.tiles * WARP_TILE;
    p.n_scalar = p.head + (n - p.tail0);
    p.w_vec = vec;
    return p;
}

// The j-th scalar element of a plan (j < n_scalar): the head, then the tail.
HD i64 scalar_elem(const Plan& p, i64 j) {
    return j < p.head ? j : p.tail0 + (j - p.head);
}

// Element of step j (0..STEPS-1), half q (0, 1) of lane `lane` in the
// tile that starts at element `base`: the kernel's longlong2 load number
// 32j + lane of the tile.
HD i64 tile_elem(i64 base, int j, int lane, int q) {
    return base + 64 * j + 2 * lane + q;
}

// Whether a launch has a scalar block: block 0, which takes the head and
// the tail (its loads in flight at once, apart from the tiles').
HD int scalar_block(const Plan& p) { return p.n_scalar > 0; }

// Blocks of a launch: the scalar block, if any, and the tiles' warps, at
// least one of them where there are tiles, at most `resident` in all.
HD i64 grid_blocks(const Plan& p, i64 resident, int block) {
    const i64 sb = scalar_block(p), warps = block / 32;
    i64 b = (p.tiles + warps - 1) / warps;
    if (b > resident - sb) b = resident - sb;
    if (b < 1 && p.tiles > 0) b = 1;
    return b + sb;
}

// A block's histogram: each bin's 64-bit sum as a low and a high word.
struct BlockHist {
    unsigned lo[N_BINS], hi[N_BINS];
};

// Adds c to bin b, mod 2^64: the low word, then the high word with the
// low word's carry. Shared 32-bit atomics on the card, plain adds in the
// twin.
HD void hist_add(BlockHist* h, int b, u64 c) {
    const unsigned l = (unsigned)c;
#ifdef __CUDA_ARCH__
    const unsigned old = atomicAdd(&h->lo[b], l);
#else
    const unsigned old = h->lo[b];
    h->lo[b] = old + l;
#endif
    const unsigned hi = (unsigned)(c >> 32) + (old + l < old ? 1u : 0u);
    if (hi) {
#ifdef __CUDA_ARCH__
        atomicAdd(&h->hi[b], hi);
#else
        h->hi[b] += hi;
#endif
    }
}

HD u64 hist_get(const BlockHist* h, int b) {
    return (u64)h->hi[b] << 32 | h->lo[b];
}

// A thread's two (bin, sum) slots, N_BINS when empty.
struct Slots {
    int b0, b1;
    u64 c0, c1;
};

HD void slots_init(Slots& s) {
    s.b0 = s.b1 = N_BINS;
    s.c0 = s.c1 = 0;
}

// Adds c to the slot of bin b (< N_BINS); a third bin takes slot 0,
// slot 0 moves to slot 1 and slot 1 goes to `h`. Sums are two's
// complement: exact mod 2^64.
HD void slots_put(Slots& s, int b, u64 c, BlockHist* h) {
    if (b != s.b0 && b != s.b1) {
        if (s.b1 != N_BINS) hist_add(h, s.b1, s.c1);
        s.b1 = s.b0;
        s.c1 = s.c0;
        s.b0 = b;
        s.c0 = 0;
    }
    s.c0 += b == s.b0 ? c : 0;
    s.c1 += b == s.b1 ? c : 0;
}

// One element: weight w of x into its bin's slot; dropped elements touch
// nothing.
HD void slots_add(Slots& s, i64 x, i64 w, BlockHist* h) {
    const int b = ladder_bin(x, w);
    if (b != N_BINS) slots_put(s, b, (u64)w, h);
}

// A lane's TILE_ELEMS tile elements, values x and weights w, into its
// slots. W is unsigned (bool weights, 0 or 1) or u64 (int64 weights as
// their two's complement, summed mod 2^64). Where the weighted values
// lie in one or two bins (the sharded engine's launches) masks find them
// without a branch or a dependence from one element to the next: the top
// bit h1 of the OR of the weighted values is the highest bin, which holds
// exactly the values with bit h1 set; they are all in it when their AND
// has bit h1 too, and the rest lie in one bin h2 when the same holds for
// them. The slots then take one or two sums; otherwise the elements go
// one by one.
template <typename W>
HD void slots_add_tile(Slots& s, const i64* x, const W* w, BlockHist* h) {
    u64 o1 = 0, a1 = ~0ull;
    W cw = 0;
    UNROLL for (int e = 0; e < TILE_ELEMS; ++e) {
        const u64 wm = w[e] != 0 ? ~0ull : 0;
        o1 |= (u64)x[e] & wm;
        a1 &= (u64)x[e] | ~wm;
        cw += w[e];
    }
    if (o1 == 0) return;  // weighted values, if any, are all 0: dropped
    const int h1 = 63 - clz64(o1);
    if ((a1 >> h1) & 1) {  // one bin (no weighted 0 either)
        slots_put(s, h1, (u64)cw, h);
        return;
    }
    // two bins: the weighted values at or above 2^h1 are bin h1's, the
    // other non-zero ones the rest's
    const u64 m1 = 1ull << h1;
    u64 o2 = 0, a2 = ~0ull;
    W c1 = 0, c2 = 0;
    UNROLL for (int e = 0; e < TILE_ELEMS; ++e) {
        const u64 xm = w[e] != 0 ? (u64)x[e] : 0;
        const bool in1 = xm >= m1;
        const bool in2 = !in1 & (xm != 0);
        o2 |= in2 ? xm : 0;
        a2 &= in2 ? xm : ~0ull;
        c1 += in1 ? w[e] : 0;
        c2 += in2 ? w[e] : 0;
    }
    const int h2 = o2 ? 63 - clz64(o2) : 0;
    if (o2 == 0 || ((a2 >> h2) & 1)) {
        slots_put(s, h1, (u64)c1, h);
        if (o2) slots_put(s, h2, (u64)c2, h);
        return;
    }
    UNROLL for (int e = 0; e < TILE_ELEMS; ++e) slots_add(s, x[e], (i64)w[e], h);
}

// One atomic per non-empty slot.
HD void slots_flush(Slots& s, BlockHist* h) {
    if (s.b0 != N_BINS) hist_add(h, s.b0, s.c0);
    if (s.b1 != N_BINS) hist_add(h, s.b1, s.c1);
    slots_init(s);
}

#ifdef __CUDACC__

// A lane's TILE_ELEMS bool weights of a tile, as one load.
typedef uint2 WVec;
static_assert(sizeof(WVec) == TILE_ELEMS, "one load of a lane's weights");

// Lane `lane`'s part of the warp tile at element `base`: every load
// first, then the slots. s_w is the warp's 256 bytes of shared memory.
template <bool BOOL_W>
__device__ __forceinline__ void lane_tile(const i64* __restrict__ values,
                                          const void* __restrict__ weights,
                                          i64 base, int lane, int w_vec,
                                          unsigned char* s_w, Slots& s,
                                          BlockHist* s_h) {
    const longlong2* vp = (const longlong2*)(values + base) + lane;
    longlong2 v[STEPS];
    if constexpr (BOOL_W) {
        const unsigned char* wb = (const unsigned char*)weights + base;
        unsigned wp[STEPS];  // the step's two weight bytes
        if (w_vec) {
            const WVec wl = __ldcs((const WVec*)wb + lane);
            UNROLL for (int j = 0; j < STEPS; ++j) v[j] = __ldcs(vp + 32 * j);
            ((WVec*)s_w)[lane] = wl;
            __syncwarp();
            UNROLL for (int j = 0; j < STEPS; ++j)
                wp[j] = ((const unsigned short*)s_w)[32 * j + lane];
            __syncwarp();  // the next tile's store waits for these reads
        } else {
            UNROLL for (int j = 0; j < STEPS; ++j) v[j] = __ldcs(vp + 32 * j);
            UNROLL for (int j = 0; j < STEPS; ++j)
                wp[j] = wb[tile_elem(0, j, lane, 0)]
                        | (unsigned)wb[tile_elem(0, j, lane, 1)] << 8;
        }
        i64 x[TILE_ELEMS];
        unsigned w[TILE_ELEMS];
        UNROLL for (int j = 0; j < STEPS; ++j) {
            x[2 * j] = v[j].x;
            x[2 * j + 1] = v[j].y;
            w[2 * j] = (wp[j] & 0xff) != 0;
            w[2 * j + 1] = (wp[j] >> 8) != 0;
        }
        slots_add_tile(s, x, w, s_h);
    } else {
        const i64* wi = (const i64*)weights + base;
        longlong2 w[STEPS];
        if (w_vec) {
            UNROLL for (int j = 0; j < STEPS; ++j) {
                v[j] = __ldcs(vp + 32 * j);
                w[j] = __ldcs((const longlong2*)wi + lane + 32 * j);
            }
        } else {
            UNROLL for (int j = 0; j < STEPS; ++j) {
                v[j] = __ldcs(vp + 32 * j);
                w[j].x = __ldcs(wi + tile_elem(0, j, lane, 0));
                w[j].y = __ldcs(wi + tile_elem(0, j, lane, 1));
            }
        }
        i64 x[TILE_ELEMS];
        u64 we[TILE_ELEMS];
        UNROLL for (int j = 0; j < STEPS; ++j) {
            x[2 * j] = v[j].x;
            x[2 * j + 1] = v[j].y;
            we[2 * j] = (u64)w[j].x;
            we[2 * j + 1] = (u64)w[j].y;
        }
        slots_add_tile(s, x, we, s_h);
    }
}

template <bool BOOL_W>
__global__ void __launch_bounds__(THREADS)
pow2_hist_kernel(const i64* __restrict__ values,
                 const void* __restrict__ weights, const Plan p,
                 u64* __restrict__ out, u64* __restrict__ next) {
    __shared__ BlockHist s_h;
    __shared__ __align__(16) unsigned char s_w[THREADS * TILE_ELEMS];
    if (threadIdx.x < N_BINS) {
        s_h.lo[threadIdx.x] = s_h.hi[threadIdx.x] = 0;
        if (blockIdx.x == 0) next[threadIdx.x] = 0;  // the next call's out
    }
    __syncthreads();
    Slots s;
    slots_init(s);
    const int sb = scalar_block(p);
    if (sb && blockIdx.x == 0) {  // the head and the tail, loads first
        i64 sx[SCALAR_PER_THREAD], sw[SCALAR_PER_THREAD];
        UNROLL for (int r = 0; r < SCALAR_PER_THREAD; ++r) {
            const i64 j = threadIdx.x + (i64)r * THREADS;
            sx[r] = sw[r] = 0;
            if (j < p.n_scalar) {
                const i64 i = scalar_elem(p, j);
                sx[r] = values[i];
                sw[r] = weight_at(weights, BOOL_W, i);
            }
        }
        UNROLL for (int r = 0; r < SCALAR_PER_THREAD; ++r)
            slots_add(s, sx[r], sw[r], &s_h);
    } else {
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        const i64 warps = (i64)(gridDim.x - sb) * (THREADS / 32);
        // the trip count is the same for every lane of a warp
        for (i64 k = (i64)(blockIdx.x - sb) * (THREADS / 32) + warp;
             k < p.tiles; k += warps)
            lane_tile<BOOL_W>(values, weights, p.head + k * WARP_TILE, lane,
                              p.w_vec, s_w + warp * 32 * TILE_ELEMS, s, &s_h);
    }
    slots_flush(s, &s_h);
    __syncthreads();
    if (threadIdx.x < N_BINS) {
        const u64 c = hist_get(&s_h, threadIdx.x);
        if (c) atomicAdd(&out[threadIdx.x], c);
    }
}

#define MAX_DEVICES 64

// Blocks of the instantiation the card holds at once: SM count times
// blocks per SM, asked once per device (0: not asked yet; every thread
// that asks gets the same answer).
template <bool BOOL_W>
static int resident_blocks(int dev, i64* out) {
    static std::atomic<int> resident[MAX_DEVICES];
    int slots = resident[dev].load(std::memory_order_relaxed);
    if (slots == 0) {
        int sms = 0, per_sm = 0;
        cudaError_t e = cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, pow2_hist_kernel<BOOL_W>, THREADS, 0);
        if (e != cudaSuccess) return (int)e;
        slots = per_sm * sms > 0 ? per_sm * sms : 1;
        resident[dev].store(slots, std::memory_order_relaxed);
    }
    *out = slots;
    return 0;
}

template <bool BOOL_W>
static int launch(const void* values, const void* weights, i64 n, int dev,
                  void* out, void* next, cudaStream_t stream) {
    i64 resident = 0;
    const int e = resident_blocks<BOOL_W>(dev, &resident);
    if (e) return e;
    const Plan p = make_plan((u64)(uintptr_t)values, (u64)(uintptr_t)weights,
                             BOOL_W, n);
    pow2_hist_kernel<BOOL_W>
        <<<(unsigned)grid_blocks(p, resident, THREADS), THREADS, 0, stream>>>(
            (const i64*)values, weights, p, (u64*)out, (u64*)next);
    return (int)cudaGetLastError();
}

// values: int64 [n]; weights: uint8 [n] (w_is_bool) or int64 [n], both on
// card `device`; out: int64 [64], zero (the previous launch on `stream`
// zeroed it); next: int64 [64], which this launch zeroes for the next
// one. Launches on `stream`, switching to `device` for the launch where
// it is not current, allocates nothing, returns cudaGetLastError() (or
// cudaErrorInvalidValue for an empty input, which the caller answers
// without a launch, or a pointer the kernel cannot read: values, or int
// weights, not 8-byte aligned).
extern "C" int pow2_hist_launch(const void* values, const void* weights,
                                int w_is_bool, i64 n, void* out, void* next,
                                int device, void* stream) {
    if (n < 1 || ((uintptr_t)values & 7)
        || (!w_is_bool && ((uintptr_t)weights & 7)) || device < 0
        || device >= MAX_DEVICES)
        return (int)cudaErrorInvalidValue;
    int cur = 0;
    cudaError_t e = cudaGetDevice(&cur);
    if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    cudaStream_t s = (cudaStream_t)stream;
    const int rc = w_is_bool
                       ? launch<true>(values, weights, n, device, out, next, s)
                       : launch<false>(values, weights, n, device, out, next, s);
    if (cur != device) cudaSetDevice(cur);
    return rc;
}

#else

#include <stdlib.h>

// The kernel's partition of one launch, run serially: `grid` blocks of
// `block` threads (a multiple of 32), the scalar block (block 0, where
// there is a head or a tail) taking the scalar part (element j by thread
// j % block), the other blocks' warps taking tiles in the grid-stride
// order, each lane's slots over its tile elements, each warp's fold of
// its slots, each block's carried histogram added to `out` (zero on
// entry), and `next` zeroed. Returns 0, or -1 for a block or grid the
// kernel cannot have.
extern "C" int pow2_hist_twin(const i64* values, const void* weights,
                              int w_is_bool, i64 n, i64* out, i64* next,
                              i64 grid, int block) {
    if (block < 32 || block % 32 || n < 1) return -1;
    const Plan p = make_plan((u64)(uintptr_t)values, (u64)(uintptr_t)weights,
                             w_is_bool, n);
    const i64 sb = scalar_block(p);
    if (grid < sb + (p.tiles > 0)) return -1;
    const i64 wpb = block / 32, warps = (grid - sb) * wpb;
    Slots* s = (Slots*)malloc(sizeof(Slots) * block);
    for (int b = 0; b < N_BINS; ++b) next[b] = 0;
    for (i64 bi = 0; bi < grid; ++bi) {
        BlockHist h = {{0}, {0}};
        for (int t = 0; t < block; ++t) slots_init(s[t]);
        if (sb && bi == 0) {
            for (i64 j = 0; j < p.n_scalar; ++j) {
                const i64 i = scalar_elem(p, j);
                slots_add(s[j % block], values[i],
                          weight_at(weights, w_is_bool, i), &h);
            }
        } else {
            for (i64 wi = 0; wi < wpb; ++wi)
                for (i64 k = (bi - sb) * wpb + wi; k < p.tiles; k += warps)
                    for (int lane = 0; lane < 32; ++lane) {
                        i64 x[TILE_ELEMS];
                        u64 w[TILE_ELEMS];
                        for (int j = 0; j < STEPS; ++j)
                            for (int q = 0; q < 2; ++q) {
                                const i64 i = tile_elem(
                                    p.head + k * WARP_TILE, j, lane, q);
                                x[2 * j + q] = values[i];
                                w[2 * j + q] =
                                    (u64)weight_at(weights, w_is_bool, i);
                            }
                        slots_add_tile(s[wi * 32 + lane], x, w, &h);
                    }
        }
        for (int t = 0; t < block; ++t) slots_flush(s[t], &h);
        for (int b = 0; b < N_BINS; ++b)
            out[b] = (i64)((u64)out[b] + hist_get(&h, b));
    }
    free(s);
    return 0;
}

// make_plan for given addresses: out = head, tiles, tail0, n_scalar,
// w_vec, and the build's WARP_TILE.
extern "C" void pow2_hist_plan(u64 v_addr, u64 w_addr, int w_is_bool, i64 n,
                               i64* out) {
    const Plan p = make_plan(v_addr, w_addr, w_is_bool, n);
    out[0] = p.head;
    out[1] = p.tiles;
    out[2] = p.tail0;
    out[3] = p.n_scalar;
    out[4] = p.w_vec;
    out[5] = WARP_TILE;
}

// The twin at the grid the kernel takes on a card that holds 1056 blocks
// at once (132 SMs, 8 blocks each).
extern "C" int pow2_hist_host(const i64* values, const void* weights,
                              int w_is_bool, i64 n, i64* out) {
    for (int b = 0; b < N_BINS; ++b) out[b] = 0;
    if (n < 1) return 0;
    i64 next[N_BINS];
    const Plan p = make_plan((u64)(uintptr_t)values, (u64)(uintptr_t)weights,
                             w_is_bool, n);
    return pow2_hist_twin(values, weights, w_is_bool, n, out, next,
                          grid_blocks(p, 132 * 8, THREADS), THREADS);
}

#endif
