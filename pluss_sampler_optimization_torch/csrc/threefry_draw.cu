// The device draw's random streams, for Hopper (sm_90a): kernel B3.
//
// The JAX package draws its device sample sets with jax.random
// (sampler/draw.py::_rect_draw_body, :144, and the triangular body of
// _build_tri_draw_kernel, :321): XLA code, with no Pallas original. Torch
// has no threefry, and the sample sets (with every MRC digest after them)
// depend on jax 0.9.0's exact bit streams, so this kernel computes them.
// Two entries, each over R rows (one row per bucket member, a key each)
// and n elements per row, in one launch:
//
// - randint: element i of row r is jr.randint(key_r, (B,), 0, span,
//   int64)[i]. randint splits key_r into two sub-keys (the host does the
//   split: ops/threefry_draw.py); under each, the threefry2x32 block of
//   the counter pair (i >> 32, i & 0xffffffff) gives a uint64, hi and lo;
//   the result is ((hi % span) * mult + lo % span) % span in wrapping
//   uint64 arithmetic, mult = (2^32 % span)^2 % span as jax computes it
//   in uint64. mult is 0 exactly when span is a power of two or above
//   2^32 (the square is then 2^64 mod span, or wraps to 0), and the
//   result is lo % span: one block and one remainder. Otherwise (span
//   below 2^32 and not a power of two) it is two blocks and three
//   remainders.
// - bits: element i of row r is jr.bits(key_r, (B,), uint64)[i] (one
//   block, (y0 << 32) | y1), replaced by UINT64_MAX where the optional
//   uint8 mask `valid` is 0 (_select_exact's jnp.where), and written as
//   its order-preserving int64 image x ^ 2^63, so that a signed sort
//   orders the priorities as the unsigned sort does.
//
// What bounds it on an H100: 8 B written per element (and 1 B of mask
// read by bits), 0.32 ns of one SM's share of 3.35 TB/s, about 80 issue
// slots of one SM at 1.98 GHz; against that, a threefry2x32 block is 72
// 32-bit operations (20 rounds of add, rotate and xor, and the key
// injections), and the rotate and the xor issue only on the ALU pipe (64
// lanes per SM per clock, half the issue rate): 40 ALU operations a
// block, 0.63 ALU clocks of an SM per element. So bytes and the ALU pipe
// are bounds of one order, and every operation per element beyond the
// block shows (chip_smoke.py prints both bounds, and this build's SASS
// counts per pipe beside them; PERF.md §6). The design (the first
// kernel, one thread per element in a grid-stride loop with the
// compiler's 64-bit `%`, took 2.5 times its byte bound):
//
// - the remainder by the launch's span is a reciprocal record computed
//   on the host (ops/threefry_draw.py::remainder_record): a mask for a
//   power of two, else m = floor((2^64 - 1) / span) and one correction
//   (`urem` below, with its proof); no `%` or `/` by a runtime value;
// - CPT = 4 counters per thread in pairs, all of their blocks computed
//   together, so four independent blocks are in flight; each pair is
//   written by one 16-byte store, the pairs of a warp tile side by side
//   (lane l holds pairs 64 p + 2 l), so every store of a warp covers 512
//   contiguous bytes; bits reads the mask 4 bytes a lane (one 32-bit
//   load: the tile's 128 bytes per warp) and hands each pair's two bytes
//   to its lane with a shuffle;
// - counters in 32 bits: the wrapper launches at most 2^31 columns of a
//   row at a time (ops/threefry_draw.py::SEGMENT), inside one 2^32 block
//   of counters, so c0 = i >> 32 is a launch constant (0 for every B the
//   draw asks for) and the index is a 32-bit add;
// - rows of whole blocks (n a multiple of THREADS * CPT, 16-byte
//   aligned rows, 4-byte aligned mask rows: every main-path launch) take
//   instantiations without a bound check; any other shape takes the EDGE
//   instantiation, which masks the ragged head and tail of each row in
//   the same launch (scalar stores and byte loads there only);
// - the pipes: every add issues on the FMA pipe as IMAD (x * one + y,
//   the 1 a launch parameter ptxas cannot fold), which leaves the ALU
//   pipe the rotations and the xors.
//
// Tried on an H100 and dropped, each slower than this build on the
// eight draw calls of GEMM N=2048 (PERF.md §6 lists them): the adds on
// the ALU pipe (IADD3); rotations on the FMA pipe as IMAD.WIDE.U32 by
// 2^r (both halves of the rotation, then one LOP3 takes (lo | hi) ^ x0)
// at one, two, four or all eight rotation positions, the more positions
// the slower (IMAD.WIDE seems to take the FMA pipe twice); two counters
// per thread; 256 and 512 threads per block; a longlong2 store (the
// compiler split it in two) and SELs for the mask.
//
// A third entry, randint with a span per row (the cross-request draw of
// sampler/draw.py::draw_bucket_keys_device_multi, whose rows come from
// different programs), takes each row's record (span, m, mult) and its
// output row in the launch parameter beside the row keys. The remainder
// kind is a template parameter, so one launch takes the rows of one
// kind: the wrapper (ops/threefry_draw.py::launch_randint_rows) makes at
// most three launches, one per kind present, each writing its rows in
// place. A kind picked at run time per row would put all three
// remainders' code in every thread and its branch in every warp that
// mixes kinds; a launch per kind keeps each row's instruction stream the
// solo launch's, and costs a launch only where kinds mix.
//
// The same file compiles as plain C++ (no __CUDACC__): it then exports
// threefry_randint_host, threefry_randint_rows_host, threefry_bits_host
// and threefry_urem_host,
// which run the kernels' per-thread code serially (warp tiles, lanes and
// the shuffles' sources included) and report a 16-byte store or a mask
// load the card would make misaligned; the CPU tests build it with g++
// and hold it against jax.random and the plain torch version
// (sampler/threefry.py), and the remainder against Python's `%`.

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD static inline
#endif

typedef long long i64;
typedef unsigned long long u64;
typedef unsigned int u32;

#define CPT 4      // counters per thread, in pairs
#define PAIRS (CPT / 2)
#define TILE (32 * CPT)  // elements of one warp's tile
#define THREADS 128
#define WARPS (THREADS / 32)
#define BLOCK_ELEMS (THREADS * CPT)
#define MAX_ROWS 128        // rows per launch; the wrapper splits larger calls
#define MAX_COLS (1u << 31)  // columns per launch (the wrapper's SEGMENT)
#define KS_PARITY 0x1BD11BDAu
#define SIGN_BIT 0x8000000000000000ull

// The remainder record's kinds (ops/threefry_draw.py::remainder_record).
enum { REM_POW2 = 0, REM_BIG = 1, REM_SMALL = 2 };

// Rotation amounts by position: rounds 4g..4g+3 take positions 0-3 for
// even g, 4-7 for odd g.
#define ROT(q) ((q) == 0 ? 13 : (q) == 1 ? 15 : (q) == 2 ? 26 : (q) == 3 ? 6 \
    : (q) == 4 ? 17 : (q) == 5 ? 29 : (q) == 6 ? 16 : 24)

// One launch's arguments, passed by value (the constant bank): output
// and mask rows at stride ld, n columns from counter (c0, c1); the
// span's record (d, m, mult); `one` = 1, a value ptxas cannot see, so
// a multiply by it stays an IMAD; the rows' keys (4 words a row for
// randint's two sub-keys, 2 for bits).
struct Launch {
    i64* out;
    const unsigned char* valid;
    i64 ld;
    u32 n, c0, c1, one;
    u64 d, m, mult;
    u32 k[MAX_ROWS * 4];
};

// The per-row randint launch: row r's record (d, m, mult) and the output
// row it writes, orow; L's own record is unused.
struct LaunchRows {
    Launch L;
    u64 d[MAX_ROWS], m[MAX_ROWS], mult[MAX_ROWS];
    u32 orow[MAX_ROWS];
};

#ifndef __CUDA_ARCH__
// Set by the host build where the card would make a misaligned access.
static int g_misaligned = 0;
#endif

// a + b as IMAD: the FMA pipe.
HD u32 add_(u32 a, u32 b, u32 one) { return a * one + b; }

// rotl(x, ROT(q)) ^ y.
template <int Q>
HD u32 rotxor(u32 x, u32 y) {
#ifdef __CUDA_ARCH__
    return __funnelshift_l(x, x, ROT(Q)) ^ y;
#else
    return ((x << ROT(Q)) | (x >> (32 - ROT(Q)))) ^ y;
#endif
}

#define ROUND(q)                                       \
    _Pragma("unroll") for (int j = 0; j < N; ++j) {    \
        x0[j] = add_(x0[j], x1[j], L.one);             \
        x1[j] = rotxor<q>(x1[j], x0[j]);            \
    }
#define INJECT(a, b)                                   \
    _Pragma("unroll") for (int j = 0; j < N; ++j) {    \
        x0[j] = add_(x0[j], a, L.one);                 \
        x1[j] = add_(x1[j], b, L.one);                 \
    }

// The threefry2x32 blocks of the N counters (c0, c1[j]) under key
// (k0, k1), computed together (jax/_src/prng.py's
// _threefry2x32_lowering); the words y0 stay in x0, y1 in x1.
template <int N>
HD void blocks(u32 k0, u32 k1, u32 c0, const u32 (&c1)[N], const Launch& L,
               u32 (&x0)[N], u32 (&x1)[N]) {
    const u32 k2 = k0 ^ k1 ^ KS_PARITY;
#pragma unroll
    for (int j = 0; j < N; ++j) {
        x0[j] = c0 + k0;
        x1[j] = add_(c1[j], k1, L.one);
    }
    ROUND(0) ROUND(1) ROUND(2) ROUND(3)
    INJECT(k1, k2 + 1u)
    ROUND(4) ROUND(5) ROUND(6) ROUND(7)
    INJECT(k2, k0 + 2u)
    ROUND(0) ROUND(1) ROUND(2) ROUND(3)
    INJECT(k0, k1 + 3u)
    ROUND(4) ROUND(5) ROUND(6) ROUND(7)
    INJECT(k1, k2 + 4u)
    ROUND(0) ROUND(1) ROUND(2) ROUND(3)
    INJECT(k2, k0 + 5u)
}

HD u64 mulhi64(u64 a, u64 b) {
#ifdef __CUDA_ARCH__
    return __umul64hi(a, b);
#else
    return (u64)(((unsigned __int128)a * b) >> 64);
#endif
}

// n % d by the launch's record, for every n in [0, 2^64):
// - REM_POW2 (d a power of two): n & (d - 1).
// - otherwise m = floor((2^64 - 1) / d) and q = floor(n m / 2^64).
//   Proof that n - q d lies in [0, 2d): m d <= 2^64 - 1 < 2^64 gives
//   n m / 2^64 < n / d, so q <= floor(n / d); and m d > 2^64 - 1 - d,
//   so m >= 2^64 / d - 1 and n m / 2^64 >= n / d - n / 2^64 > n / d - 1,
//   so q >= floor(n / d) - 1. Hence r = n - q d, exact in uint64 because
//   its value is below 2d <= 2^47 (d <= 2^46), needs at most one
//   subtraction of d. That holds for any d in [1, 2^63].
// - REM_BIG (d > 2^32, not a power of two): m < 2^64 / 2^32 = 2^32, so q
//   is two 32 x 32 -> 64 products, (nh m + ((nl m) >> 32)) >> 32 (no
//   carry is lost: (2^32 - 1)^2 + 2^32 - 1 < 2^64), and q < 2^32.
// - REM_SMALL (d < 2^32, not a power of two): m >= 2^32, the full
//   multiply-high; q d takes d's one word.
template <int KIND>
HD u64 urem(u64 n, u64 d, u64 m) {
    if (KIND == REM_POW2) return n & (d - 1);
    u64 qd;
    if (KIND == REM_BIG) {
        const u64 a = (u64)(u32)n * (u32)m;
        const u32 q = (u32)(((u64)(u32)(n >> 32) * (u32)m + (a >> 32)) >> 32);
        qd = (u64)q * d;
    } else {
        qd = mulhi64(n, m) * (u64)(u32)d;
    }
    const u64 r = n - qd;
    return r >= d ? r - d : r;
}

HD u64 join(u32 y0, u32 y1) { return ((u64)y0 << 32) | y1; }

// Where lane `lane`'s pair p starts in its warp tile.
HD u32 pair_off(u32 lane, int p) { return 64u * p + 2u * lane; }

HD void store_pair(i64* p, i64 a, i64 b) {
#ifdef __CUDA_ARCH__
    // one STG.E.128 (a longlong2 assignment may be split in two)
    asm volatile("st.global.v2.s64 [%0], {%1, %2};" ::"l"(p), "l"(a), "l"(b)
                 : "memory");
#else
    if ((uintptr_t)p & 15) g_misaligned = 1;
    p[0] = a;
    p[1] = b;
#endif
}

// Lane `lane`'s pairs p = 0..PAIRS-1 of the row's elements
// base + pair_off(lane, p) + {0, 1}: one 16-byte store each, or, under
// EDGE, only the elements in [0, n).
template <bool EDGE>
HD void store_row(i64* row, i64 base, u32 n, u32 lane, const i64 (&v)[CPT]) {
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
        const i64 e = base + pair_off(lane, p);
        if (!EDGE || (e >= 0 && e + 1 < (i64)n)) {
            store_pair(row + e, v[2 * p], v[2 * p + 1]);
            continue;
        }
        if (e >= 0 && e < (i64)n) row[e] = v[2 * p];
        if (e + 1 >= 0 && e + 1 < (i64)n) row[e + 1] = v[2 * p + 1];
    }
}

// The first element of the thread's tile, and its counters' low words.
// Under EDGE a row may start off a 16-byte boundary: its tiles then
// start one element early (head 1), so that pairs stay aligned.
template <bool EDGE>
HD i64 tile_base(const Launch& L, const i64* row, u32 tile, u32 lane,
                 u32 (&c1)[CPT]) {
    const u32 head = EDGE ? (u32)((uintptr_t)row >> 3) & 1u : 0u;
    const u32 base = tile * TILE - head;  // wraps to 2^32 - 1 at -1
#pragma unroll
    for (int p = 0; p < PAIRS; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            c1[2 * p + h] = L.c1 + base + pair_off(lane, p) + h;
    return EDGE ? (i64)tile * TILE - head : (i64)base;
}

// One thread of randint: lane `lane` of warp tile `tile` in row r of the
// key bank, written to output row `orow` with the span's record
// (d, m, mult).
template <int KIND, bool EDGE>
HD void randint_thread(const Launch& L, u32 r, u32 orow, u64 d, u64 m,
                       u64 mult, u32 tile, u32 lane) {
    const u32* k = L.k + 4 * r;
    i64* row = L.out + (i64)orow * L.ld;
    u32 c1[CPT], y0[CPT], y1[CPT];
    const i64 base = tile_base<EDGE>(L, row, tile, lane, c1);
    i64 v[CPT];
    blocks<CPT>(k[2], k[3], L.c0, c1, L, y0, y1);  // lo, under sub-key 2
#pragma unroll
    for (int j = 0; j < CPT; ++j)
        v[j] = (i64)urem<KIND>(join(y0[j], y1[j]), d, m);
    if (KIND == REM_SMALL) {
        blocks<CPT>(k[0], k[1], L.c0, c1, L, y0, y1);  // hi, sub-key 1
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            // hi % d < 2^32 and mult < 2^32: one 32 x 32 + 64 multiply-add,
            // below d^2 <= 2^64 (jax's uint64 sum cannot wrap here)
            const u64 hi = urem<KIND>(join(y0[j], y1[j]), d, m);
            v[j] = (i64)urem<KIND>((u64)(u32)hi * (u32)mult + (u64)v[j],
                                   d, m);
        }
    }
    store_row<EDGE>(row, base, L.n, lane, v);
}

// The CPT = 4 mask bytes a lane loads: one 32-bit word at `p`.
HD u32 mask_word(const unsigned char* p) {
#ifdef __CUDA_ARCH__
    return *reinterpret_cast<const u32*>(p);
#else
    if ((uintptr_t)p & (CPT - 1)) g_misaligned = 1;
    u32 w;
    memcpy(&w, p, 4);
    return w;
#endif
}

// All ones where byte `b` (a mask byte times 0xff: 0 or 0xff) of u is
// 0xff, else 0: one PRMT with the sign-replicating selector on the card.
HD u32 byte_ones(u32 u, u32 b) {
#ifdef __CUDA_ARCH__
    return __byte_perm(u, 0, (b | 8) * 0x1111);
#else
    return ((u >> (8 * b)) & 0x80) ? ~0u : 0u;
#endif
}

// One thread of bits: as randint_thread. Element j's mask is the word
// ok[j], all ones where valid. Without EDGE, lane l loads the mask bytes
// of tile elements CPT l .. CPT l + CPT - 1 and takes pair p's two bytes
// from the lane that loaded them (a shuffle on the card; the host build
// reads that lane's word). The image is then (y0 | ~ok) ^ 2^31 over
// y1 | ~ok: two LOP3s, UINT64_MAX's image where ok is 0.
template <bool EDGE, bool MASK>
HD void bits_thread(const Launch& L, u32 r, u32 tile, u32 lane) {
    const u32* k = L.k + 2 * r;
    i64* row = L.out + (i64)r * L.ld;
    u32 c1[CPT], y0[CPT], y1[CPT];
    const i64 base = tile_base<EDGE>(L, row, tile, lane, c1);
    blocks<CPT>(k[0], k[1], L.c0, c1, L, y0, y1);
    u32 ok[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) ok[j] = ~0u;
    if (MASK) {
        const unsigned char* vrow = L.valid + (i64)r * L.ld;
        if (EDGE) {
#pragma unroll
            for (int p = 0; p < PAIRS; ++p)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const i64 e = base + pair_off(lane, p) + h;
                    if (e >= 0 && e < (i64)L.n) ok[2 * p + h] = 0u - vrow[e];
                }
        } else {
#ifdef __CUDA_ARCH__
            const u32 mine = mask_word(vrow + base + CPT * lane);
#endif
#pragma unroll
            for (int p = 0; p < PAIRS; ++p) {
                const u32 off = pair_off(lane, p), src = off / CPT;
#ifdef __CUDA_ARCH__
                const u32 w = __shfl_sync(0xffffffffu, mine, src);
#else
                const u32 w = mask_word(vrow + base + CPT * src);
#endif
                // bytes 0 or 1, times 0xff: no carry between bytes
                const u32 u = w * 0xffu;
                ok[2 * p] = byte_ones(u, off % CPT);
                ok[2 * p + 1] = byte_ones(u, off % CPT + 1);
            }
        }
    }
    i64 v[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j)
        v[j] = (i64)join((y0[j] | ~ok[j]) ^ 0x80000000u, y1[j] | ~ok[j]);
    store_row<EDGE>(row, base, L.n, lane, v);
}

// Whether a launch needs the EDGE instantiation: rows not whole blocks,
// or out (or the mask) rows off the alignment of the 16-byte stores (or
// the CPT-byte mask loads).
static bool needs_edge(const Launch& L) {
    return L.n % BLOCK_ELEMS != 0 || ((uintptr_t)L.out & 15) || (L.ld & 1)
           || (L.valid != nullptr
               && (((uintptr_t)L.valid % CPT) || (L.ld % CPT)));
}

// Blocks per row of a launch.
static u32 grid_x(const Launch& L, bool edge) {
    const u64 n = L.n + (edge ? 1 : 0);  // a head of 1 adds an element
    return (u32)((n + BLOCK_ELEMS - 1) / BLOCK_ELEMS);
}

// Fills L from a launch's arguments; false where the kernel does not
// take them: R rows of keys (at most MAX_ROWS where limit), 1 <= n <=
// MAX_COLS, ld >= n, counters within one 2^32 block, and the span's
// record as ops/threefry_draw.py::remainder_record makes it.
static bool fill(Launch* L, const u32* keys, i64 R, int words, bool limit,
                 i64 ld, i64 n, u32 c0, u32 c1, void* out) {
    if (R < 1 || (limit && R > MAX_ROWS) || n < 1 || n > (i64)MAX_COLS
        || ld < n || (u64)c1 + (u64)n > (1ull << 32) || out == nullptr)
        return false;
    L->out = (i64*)out;
    L->valid = nullptr;
    L->ld = ld;
    L->n = (u32)n;
    L->c0 = c0;
    L->c1 = c1;
    L->one = 1;
    L->d = 1;
    L->m = L->mult = 0;
    if (limit)
        for (i64 i = 0; i < words * R; ++i) L->k[i] = keys[i];
    return true;
}

// True when (kind, m, mult) is span's record: checked on the host in
// exact integers before any launch.
static bool record_ok(u64 span, u64 m, u64 mult, int kind) {
    if (span < 1 || span > (1ull << 63)) return false;
    const bool pow2 = (span & (span - 1)) == 0;
    if (kind == REM_POW2) return pow2 && m == 0 && mult == 0;
    if (pow2 || m != ~0ull / span) return false;
    if (kind == REM_BIG) return span > (1ull << 32) && mult == 0;
    const u64 h = (1ull << 32) % span;
    return kind == REM_SMALL && span < (1ull << 32)
           && mult == (h * h) % span;
}

// Fills P from a per-row launch's arguments; false where the kernel does
// not take them: fill's conditions, every row's record of kind `kind`,
// and every output row below out_rows.
static bool fill_rows(LaunchRows* P, const u32* keys, i64 R, i64 ld, i64 n,
                      u32 c0, u32 c1, const u64* span, const u64* m,
                      const u64* mult, int kind, const u32* orow,
                      i64 out_rows, void* out) {
    if (!fill(&P->L, keys, R, 4, true, ld, n, c0, c1, out)) return false;
    for (i64 r = 0; r < R; ++r) {
        if (!record_ok(span[r], m[r], mult[r], kind) || orow[r] >= out_rows)
            return false;
        P->d[r] = span[r];
        P->m[r] = m[r];
        P->mult[r] = mult[r];
        P->orow[r] = orow[r];
    }
    return true;
}

#ifdef __CUDACC__

template <int KIND, bool EDGE>
__global__ void __launch_bounds__(THREADS)
randint_kernel(const __grid_constant__ Launch L) {
    randint_thread<KIND, EDGE>(L, blockIdx.y, blockIdx.y, L.d, L.m, L.mult,
                               blockIdx.x * WARPS + threadIdx.x / 32,
                               threadIdx.x & 31);
}

template <int KIND, bool EDGE>
__global__ void __launch_bounds__(THREADS)
randint_rows_kernel(const __grid_constant__ LaunchRows P) {
    const u32 r = blockIdx.y;
    randint_thread<KIND, EDGE>(P.L, r, P.orow[r], P.d[r], P.m[r], P.mult[r],
                               blockIdx.x * WARPS + threadIdx.x / 32,
                               threadIdx.x & 31);
}

template <bool EDGE, bool MASK>
__global__ void __launch_bounds__(THREADS)
bits_kernel(const __grid_constant__ Launch L) {
    bits_thread<EDGE, MASK>(L, blockIdx.y,
                            blockIdx.x * WARPS + threadIdx.x / 32,
                            threadIdx.x & 31);
}

// keys: the HOST's uint32 [R, 4], each row randint's two sub-keys; out:
// int64 rows on the card at stride ld, n columns from counter (c0, c1);
// (span, m, mult, kind): the span's record. Launches on `stream`,
// allocates nothing, returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int threefry_randint_launch(const u32* keys, i64 R, i64 ld, i64 n,
                                       u32 c0, u32 c1, u64 span, u64 m,
                                       u64 mult, int kind, void* out,
                                       void* stream) {
    Launch L;
    if (!fill(&L, keys, R, 4, true, ld, n, c0, c1, out)
        || !record_ok(span, m, mult, kind))
        return (int)cudaErrorInvalidValue;
    L.d = span;
    L.m = m;
    L.mult = mult;
    const bool edge = needs_edge(L);
    const dim3 grid(grid_x(L, edge), (unsigned)R);
    cudaStream_t st = (cudaStream_t)stream;
#define RANDINT(K)                                                       \
    if (edge) randint_kernel<K, true><<<grid, THREADS, 0, st>>>(L);      \
    else randint_kernel<K, false><<<grid, THREADS, 0, st>>>(L);
    if (kind == REM_POW2) { RANDINT(REM_POW2) }
    else if (kind == REM_BIG) { RANDINT(REM_BIG) }
    else { RANDINT(REM_SMALL) }
#undef RANDINT
    return (int)cudaGetLastError();
}

// randint with a span per row: as threefry_randint_launch, with row r's
// record (span[r], m[r], mult[r]), all of kind `kind`, and its output row
// orow[r] < out_rows (out is output row 0; the launch writes R of them).
extern "C" int threefry_randint_rows_launch(const u32* keys, i64 R, i64 ld,
                                            i64 n, u32 c0, u32 c1,
                                            const u64* span, const u64* m,
                                            const u64* mult, int kind,
                                            const u32* orow, i64 out_rows,
                                            void* out, void* stream) {
    LaunchRows P;
    if (!fill_rows(&P, keys, R, ld, n, c0, c1, span, m, mult, kind, orow,
                   out_rows, out))
        return (int)cudaErrorInvalidValue;
    const bool edge = needs_edge(P.L);
    const dim3 grid(grid_x(P.L, edge), (unsigned)R);
    cudaStream_t st = (cudaStream_t)stream;
#define RANDINT_ROWS(K)                                                  \
    if (edge) randint_rows_kernel<K, true><<<grid, THREADS, 0, st>>>(P); \
    else randint_rows_kernel<K, false><<<grid, THREADS, 0, st>>>(P);
    if (kind == REM_POW2) { RANDINT_ROWS(REM_POW2) }
    else if (kind == REM_BIG) { RANDINT_ROWS(REM_BIG) }
    else { RANDINT_ROWS(REM_SMALL) }
#undef RANDINT_ROWS
    return (int)cudaGetLastError();
}

// keys: the host's uint32 [R, 2]; valid: rows of bytes 0 or 1 (a bool
// tensor) on the card at stride ld, or null (every element valid); out:
// int64 rows at stride ld. Same contract as threefry_randint_launch.
extern "C" int threefry_bits_launch(const u32* keys, i64 R, i64 ld, i64 n,
                                    u32 c0, u32 c1, const void* valid,
                                    void* out, void* stream) {
    Launch L;
    if (!fill(&L, keys, R, 2, true, ld, n, c0, c1, out))
        return (int)cudaErrorInvalidValue;
    L.valid = (const unsigned char*)valid;
    const bool edge = needs_edge(L);
    const dim3 grid(grid_x(L, edge), (unsigned)R);
    cudaStream_t st = (cudaStream_t)stream;
    if (edge) {
        if (valid) bits_kernel<true, true><<<grid, THREADS, 0, st>>>(L);
        else bits_kernel<true, false><<<grid, THREADS, 0, st>>>(L);
    } else {
        if (valid) bits_kernel<false, true><<<grid, THREADS, 0, st>>>(L);
        else bits_kernel<false, false><<<grid, THREADS, 0, st>>>(L);
    }
    return (int)cudaGetLastError();
}

#else

// Serial host twins of the two entries: the same arguments minus the
// stream, any R; every thread of the launch the card would run, in
// order. Return 1 for arguments the kernel does not take, 2 where the
// card would have made a misaligned access, else 0.
template <class F>
static int run_host(Launch* L, const u32* keys, i64 R, int words, F thread) {
    const bool edge = needs_edge(*L);
    const u32 tiles = grid_x(*L, edge) * WARPS;
    g_misaligned = 0;
    for (i64 r0 = 0; r0 < R; r0 += MAX_ROWS) {  // the key bank's rows
        const i64 rows = R - r0 < MAX_ROWS ? R - r0 : MAX_ROWS;
        for (i64 i = 0; i < words * rows; ++i) L->k[i] = keys[words * r0 + i];
        for (i64 r = 0; r < rows; ++r)
            for (u32 t = 0; t < tiles; ++t)
                for (u32 lane = 0; lane < 32; ++lane)
                    thread(*L, (u32)r, t, lane, edge);
        L->out += MAX_ROWS * L->ld;
        if (L->valid) L->valid += MAX_ROWS * L->ld;
    }
    return g_misaligned ? 2 : 0;
}

// One randint thread of the instantiation of (kind, edge).
static void randint_kind(int kind, bool edge, const Launch& l, u32 r,
                         u32 orow, u64 d, u64 m, u64 mult, u32 t, u32 lane) {
    if (kind == REM_POW2)
        edge ? randint_thread<REM_POW2, true>(l, r, orow, d, m, mult, t, lane)
             : randint_thread<REM_POW2, false>(l, r, orow, d, m, mult, t,
                                               lane);
    else if (kind == REM_BIG)
        edge ? randint_thread<REM_BIG, true>(l, r, orow, d, m, mult, t, lane)
             : randint_thread<REM_BIG, false>(l, r, orow, d, m, mult, t,
                                              lane);
    else
        edge ? randint_thread<REM_SMALL, true>(l, r, orow, d, m, mult, t,
                                               lane)
             : randint_thread<REM_SMALL, false>(l, r, orow, d, m, mult, t,
                                                lane);
}

extern "C" int threefry_randint_host(const u32* keys, i64 R, i64 ld, i64 n,
                                     u32 c0, u32 c1, u64 span, u64 m,
                                     u64 mult, int kind, i64* out) {
    Launch L;
    if (!fill(&L, keys, R, 4, false, ld, n, c0, c1, out)
        || !record_ok(span, m, mult, kind))
        return 1;
    L.d = span;
    L.m = m;
    L.mult = mult;
    return run_host(&L, keys, R, 4, [kind](const Launch& l, u32 r, u32 t,
                                          u32 lane, bool edge) {
        randint_kind(kind, edge, l, r, r, l.d, l.m, l.mult, t, lane);
    });
}

// The per-row entry's twin: threefry_randint_rows_launch's arguments but
// the stream (R at most MAX_ROWS, as one launch takes).
extern "C" int threefry_randint_rows_host(const u32* keys, i64 R, i64 ld,
                                          i64 n, u32 c0, u32 c1,
                                          const u64* span, const u64* m,
                                          const u64* mult, int kind,
                                          const u32* orow, i64 out_rows,
                                          i64* out) {
    LaunchRows P;
    if (!fill_rows(&P, keys, R, ld, n, c0, c1, span, m, mult, kind, orow,
                   out_rows, out))
        return 1;
    const bool edge = needs_edge(P.L);
    const u32 tiles = grid_x(P.L, edge) * WARPS;
    g_misaligned = 0;
    for (i64 r = 0; r < R; ++r)
        for (u32 t = 0; t < tiles; ++t)
            for (u32 lane = 0; lane < 32; ++lane)
                randint_kind(kind, edge, P.L, (u32)r, P.orow[r], P.d[r],
                             P.m[r], P.mult[r], t, lane);
    return g_misaligned ? 2 : 0;
}

extern "C" int threefry_bits_host(const u32* keys, i64 R, i64 ld, i64 n,
                                  u32 c0, u32 c1, const unsigned char* valid,
                                  i64* out) {
    Launch L;
    if (!fill(&L, keys, R, 2, false, ld, n, c0, c1, out)) return 1;
    L.valid = valid;
    return run_host(&L, keys, R, 2, [valid](const Launch& l, u32 r, u32 t,
                                           u32 lane, bool edge) {
        if (edge)
            valid ? bits_thread<true, true>(l, r, t, lane)
                  : bits_thread<true, false>(l, r, t, lane);
        else
            valid ? bits_thread<false, true>(l, r, t, lane)
                  : bits_thread<false, false>(l, r, t, lane);
    });
}

// urem<kind> of each of the count numerators by span's record; 1 where
// the record is not span's.
extern "C" int threefry_urem_host(const u64* num, i64 count, u64 span, u64 m,
                                  u64 mult, int kind, u64* out) {
    if (!record_ok(span, m, mult, kind)) return 1;
    for (i64 i = 0; i < count; ++i)
        out[i] = kind == REM_POW2  ? urem<REM_POW2>(num[i], span, m)
                 : kind == REM_BIG ? urem<REM_BIG>(num[i], span, m)
                                   : urem<REM_SMALL>(num[i], span, m);
    return 0;
}

#endif
