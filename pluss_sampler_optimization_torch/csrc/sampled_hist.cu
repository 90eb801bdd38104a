// Fused decode + classify + pow2 histogram of the sampled engine, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel ops/pallas_sampled.py::_one_ref of the JAX
// package (its pl.pallas_call body). For every sample of every member
// ref of one kernel-signature bucket it decodes the mixed-radix key,
// runs the closed-form next-use classify (sampler/nextuse.py and
// sampler/sampled.py::classify_samples of this package are its plain
// tensor version), and splits the result three ways:
//   - noshare samples with ri >= 1 count into a 64-bin pow2 histogram
//     (bin 63 - clz(ri); bin 63 stays empty since ri < 2^63);
//   - share samples and sub-1 noshare samples go to the residual stream
//     as the packed key ri*16+slot, every other lane holds 2^62;
//   - masked-in samples whose line is never touched again count cold.
// The raw-noshare form (a launch flag, `raw`) keeps every noshare
// reuse exact: each found sample goes to the residual stream and the
// histogram stays zero, for the runtime-v2 state and the r10
// distribute, which read raw noshare keys. Cold counting is the same.
//
// Design. The Pallas kernel was traced per kernel signature, with the
// classify's structure baked in. Here one build serves every
// rectangular signature: the host packs the structure (schedule, loop
// starts and steps, the ref tables, each sink group's band plan, and a
// division record for every divisor) into a small int64 descriptor
// (ops/sampled_hist.py::build_descriptor), passed by value as a kernel
// parameter, so every thread reads it from the constant bank. One thread
// per sample, a grid-stride loop per member ref (grid.y), as many blocks
// as the card holds at once. The TPU kernel's comparison ladder becomes a
// direct bin by clz; lanes of a warp with the same bin are counted
// together (__match_any_sync) into a per-block shared histogram, and one
// global atomicAdd per bin per block flushes it. Integer sums do not
// depend on order, so the result is exact.
//
// Bound on an H100: integer issue slots. Per sample it reads an 8 B key
// (and a 1 B mask where the caller passes one; the engine's dispatches
// pass none) and writes an 8 B residual, against 227 to 452 32-bit
// integer instructions that the classify needs at GEMM's signatures,
// each value at its narrowest width (ops/sampled_hist.py::ops_per_sample
// counts them); the card has no int64 ALU and no integer divider. This
// kernel keeps every value in int64, so it issues more than that count.
// The design spends its issue slots and registers on that:
//   - no division instruction sequence at all: every floor division is
//     by a divisor fixed per launch, so the host ships it as a record (a
//     shift for a power of two, else a round-up multiplier and a shift)
//     and the thread spends a multiply-high, a shift and a sign fix;
//   - what depends only on the sample's position (m0, r0, j0, rr0 of
//     nextuse.py::min_position_after) is computed once per sample, and
//     what does not depend on the member sink (strategies A and B, and
//     whether strategy C exists) once per band candidate: the members
//     only add their body offsets at the end of the group;
//   - the walk keeps every value in scalars or arrays indexed by
//     compile-time constants: one kernel per source-ref level LV and per
//     head-count class NHMAX, 1 (no group has more than one band-plan
//     head) or 3 (up to three): 6 instantiations, the launch picks one
//     from the descriptor. Inside, one walk per sink level and head
//     count, head loops nested by templates, so nothing lives in local
//     memory; the descriptor costs no registers, and the per-member
//     state of a level-2 walk lives in shared memory;
//   - __launch_bounds__ cuts registers for 3 blocks of 256 per SM where
//     NHMAX is 1 (80 registers), 2 where it is 3. The grid is the card's
//     resident blocks (SMs times the occupancy), asked once per device.
// No TMA, no wgmma and no shared-memory tiling: the kernel moves 16 B
// per sample, so there is nothing for them to feed.
//
// Triangular nests (inner bounds affine in the parallel value v0; the
// descriptor's D_TRI word) take a third template parameter, TRI, so the
// rectangular instantiations are the code they were. There positions
// start from a per-thread prefix-sum base table (core/trace.py::tri_base,
// [threads, lmax + 1] int64), a device tensor of its own read through the
// read-only cache rather than part of the descriptor, and the level-1 body
// size body_at(1, v0) varies per parallel value, so a walk divides by it
// with the compiler's int64 routine: once per sample for the sample's own
// iteration and once per other iteration a candidate visits (a floor of
// C's truncating quotient, as the numerators may be negative). The three
// arms of nextuse.py::next_use_candidates_tri_group become:
//   - the sample's own iteration and a level-0 value a head or window
//     fixes: min_inner_pos per member, in the per-member slots nb;
//   - the earliest later iteration whose inner domains are nonempty:
//     each domain bound is a halfspace a*v0 + b >= 0 with a a trip or
//     start coefficient of the descriptor (a division record each), then
//     count_below and a gather of the base table.
// A candidate that is not in the band contributes nothing there, so it
// is skipped whole.
//
// Two forms of the launch carry the descriptor. The parameter form
// (sampled_hist_launch, the 12 instantiations above) passes it by value,
// up to MAX_DESC words. Longer descriptors (many refs of distinct maps,
// or many modeled threads: the loop-count table has one word per thread)
// take the buffer form (sampled_hist_launch_buf): the caller uploads the
// descriptor once to a device buffer, and each block copies it into
// shared memory before its walk (dynamic shared memory of the
// descriptor's size; past the 48 KB a launch may take by default, with
// the walk's own 17 KB, the launch asks for more, up to the card's
// opt-in limit: about 26,000 words on an H100, where the frontend's 64
// refs of a nest need about 2,540). It is one instantiation per
// source-ref level and nest kind, with NHMAX 3, which serves any head
// count: 6 more, built apart (csrc/sampled_hist_buf.cu includes this
// file with SAMPLED_HIST_BUFFER_FORM defined, so nvcc compiles the two
// forms as two libraries at once). A sink group of more than MAX_MEMBERS
// refs reaches the kernel as consecutive sub-groups of at most
// MAX_MEMBERS members, each repeating the group's heads
// (build_descriptor); the walk keeps a member only where its position is
// strictly below the best so far, in group and member order, so the
// first of equal positions wins as in the unsplit group.
//
// The per-row form (sampled_hist_launch_rows, in the buffer form's
// library) serves the service's cross-request batches
// (sampler/sampled.py::sampled_outputs_multi): one launch over R rows
// drawn from different programs whose refs share one kernel signature,
// where the JAX package runs one vmapped XLA dispatch with per-row
// operands (sampler/sampled.py::_build_ref_kernel_fused_multi there).
// Each row brings its own descriptor (its trips, body sizes, loop
// counts, offsets and band spans differ between programs), its own
// radix records and, in a triangular nest, its own base table, each in
// a device buffer at a row stride (zero-padded to the longest row). The
// block of row r stages row r's descriptor and records in shared memory,
// as the buffer form stages its one descriptor, and walks with the same
// code. The rows share one instantiation, picked on the host: their
// source-ref levels and nest kinds must agree (a signature fixes both)
// and NHMAX is the most over the rows; under the buffer form's bound of
// 2 blocks per SM (its words are shared-memory loads too). 12
// instantiations sampled_hist_kernel_rows<LV, NHMAX, TRI>, built as two
// more parts of the buffer form's library (SAMPLED_HIST_ROWS_NHMAX 1 and
// 3, one entry each: ops/_build.py compiles the three parts of
// csrc/sampled_hist_buf.cu at once and links them into one library).
//
// The same file compiles as plain C++ (no __CUDACC__): it then exports
// sampled_hist_host, a serial loop over the same per-sample code (every
// instantiation), sampled_hist_host_buf, the buffer form's,
// sampled_hist_host_rows, the per-row form's, and
// sampled_hist_divmod, the floor division and modulo by a record, which
// the CPU tests build with g++ and hold against the plain version and
// Python's // and %.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <atomic>
#define HD __host__ __device__ __forceinline__
#else
#define HD static inline

#include <vector>
#endif
#ifdef __CUDA_ARCH__
#define UNROLL _Pragma("unroll")
#else
#define UNROLL
#endif

typedef long long i64;
typedef unsigned long long u64;

// Leading zeros of x > 0: the device intrinsic on the card, the builtin
// in the host compilation passes.
HD int clz64(i64 x) {
#ifdef __CUDA_ARCH__
    return __clzll(x);
#else
    return __builtin_clzll((u64)x);
#endif
}

#define INF_I64 (1LL << 62)
#define SENTINEL (1LL << 62)
#define RATIO_SLOTS 16
#define NOSHARE_SLOT 15
#define N_BINS 64
// Words of the descriptor the kernel parameter holds (16 KB); a build
// may set a smaller one with -DMAX_DESC=n.
#ifndef MAX_DESC
#define MAX_DESC 2048
#endif
#define MAX_MEMBERS 8
#define MAX_DEPTH 3
#define THREADS 256
// Stride between one thread's per-member slots of a level-2 walk: a
// column of the block's shared array on the card, a plain array on the
// host.
#ifdef __CUDA_ARCH__
#define NB_STRIDE THREADS
#else
#define NB_STRIDE 1
#endif
// Blocks of THREADS per SM that __launch_bounds__ cuts the registers for:
// 3 (80 registers) where no group has more than one band-plan head (every
// model of the repository but heat-3d); 2 otherwise, where the walk needs
// up to 124 registers and would spill at 80 (ptxas, sm_90a). A finer
// split of NHMAX gains nothing: 0 and 1 heads fit 3 blocks alike, 2 and 3
// heads 2 blocks alike.
// The triangular walk keeps more per sample (its iteration's base, body
// size and split) and per candidate (each level's domain): 2 blocks.
#define BLOCKS_PER_SM(NHMAX, TRI) ((TRI) ? 2 : (NHMAX) <= 1 ? 3 : 2)

// A division record: three int64 words, the divisor d != 0, a multiplier
// and info = shift | DIV_NEG when d < 0. With e = |d|:
//   - e a power of two: multiplier 0, shift log2 e, and t / e = t >> shift;
//   - otherwise, with l = ceil(log2 e): multiplier M = ceil(2^(63+l) / e),
//     which is below 2^64, and shift l - 1, so that
//     t / e = umulhi(t, M) >> (l - 1) for every 0 <= t < 2^63: with
//     t = q*e + r (r < e), t*M / 2^(63+l) = t/e + t*(M*e - 2^(63+l)) /
//     (e * 2^(63+l)), and that excess is below 2^63 * e / (e * 2^(63+l))
//     = 2^-l < 1/e, so the product stays below q + (r + 1)/e <= q + 1.
// floordiv_rec folds a negative numerator onto t = ~a = -a - 1 >= 0 and
// back (floor(a/e) = ~floor(~a/e)), so with a positive divisor it is
// exact for EVERY int64 numerator; a negative divisor (a descending
// loop's step) turns floor(a/d) into -ceil(a/e), exact wherever the
// quotient fits int64 (everything but INT64_MIN / -1). No numerator
// range is assumed, so build_descriptor asserts none.
#define DIV_D 0
#define DIV_M 1
#define DIV_INFO 2
#define DIV_SIZE 3
#define DIV_NEG 64

HD u64 umulhi(u64 a, u64 b) {
#ifdef __CUDA_ARCH__
    return __umul64hi(a, b);
#else
    return (u64)(((unsigned __int128)a * b) >> 64);
#endif
}

// floor(t / |d|) for 0 <= t < 2^63.
HD u64 udiv_rec(u64 t, const i64* rec) {
    const u64 m = (u64)rec[DIV_M];
    const int s = (int)(rec[DIV_INFO] & 63);
    return (m ? umulhi(t, m) : t) >> s;
}

// floor(a / d), as Python's // and torch's floor division.
HD i64 floordiv_rec(i64 a, const i64* rec) {
    const i64 sgn = a >> 63;  // 0 or -1
    i64 q = (i64)(udiv_rec((u64)(a ^ sgn), rec) ^ (u64)sgn);
    if (rec[DIV_INFO] & DIV_NEG) {
        const i64 r = (i64)((u64)a + (u64)rec[DIV_D] * (u64)q);  // a - e*q
        q = (i64)(0ULL - (u64)q - (u64)(r != 0));
    }
    return q;
}

// a - d * floor(a / d) given q = floor(a / d): Python's %.
HD i64 floormod_rec(i64 a, i64 q, const i64* rec) {
    return (i64)((u64)a - (u64)q * (u64)rec[DIV_D]);
}

HD i64 min_i64(i64 a, i64 b) { return a < b ? a : b; }
HD i64 max_i64(i64 a, i64 b) { return a > b ? a : b; }

// Descriptor layout; ops/sampled_hist.py writes the same offsets.
#define D_LV 0
#define D_DEPTH 1
#define D_NREFS 2
#define D_THREADS 3
#define D_CHUNK 4
#define D_S_START 5
#define D_S_STEP 6
#define D_DS 7
#define D_CLS 8
#define D_W 9
#define D_NPRE0 10
#define D_NPRE1 11
#define D_NGROUPS 12
#define D_ACC 13
#define D_TRIPS 16
#define D_STARTB 19
#define D_SC 22
#define D_LSTART 25
#define D_LSTEP 28
#define D_OFF_LC 31
#define D_OFF_REFS 32
#define D_OFF_GROUPS 33
// triangular nests (D_TRI 1): per level its trip coefficient and the refs
// of its own body (npre + npost), the base table's last column lmax and
// the offset of the per-ref post-slot flags
#define D_TRI 34
#define D_TC 35
#define D_BODYC 38
#define D_LMAX 41
#define D_OFF_POST 42
// division records: chunk, threads, cls, acc[0..2], each level's step
// (n / (chunk * threads) is (n / chunk) / threads: no record of its own),
// then the triangular walk's: the deepest body size a2 and per inner
// level l (1, 2) |tc|, |sc| and |tc + sc| (at D_DIV_HS + (3 * (l - 1) +
// k) * DIV_SIZE, k = 0, 1, 2); records of 1 in a rectangular descriptor
#define D_DIV_CHUNK 43
#define D_DIV_THREADS 46
#define D_DIV_CLS 49
#define D_DIV_ACC 52
#define D_DIV_STEP 61
#define D_DIV_A2 70
#define D_DIV_HS 73
#define D_HEADER 91
// per-ref record
#define R_OFF 0
#define R_COEFF 1
#define R_CONST 4
#define R_THR 5
#define R_RATIO 6
#define R_LEVEL 7
#define R_SIZE 8
// per-group record: fixed part, then the member ref indices
#define G_NMEM 0
#define G_LEVEL 1
#define G_NHEADS 2
#define G_TERM 3
#define G_TLEVEL 4
#define G_TW 5
#define G_CONST 6
#define G_HEADS 7
// per-head record; H_CV holds the head coefficient's division record
#define H_LEVEL 0
#define H_NU 1
#define H_CV 2
#define H_RMIN (H_CV + DIV_SIZE)
#define H_RMAX (H_RMIN + 1)
#define H_SIZE (H_RMAX + 1)
#define G_MEMBERS (G_HEADS + MAX_DEPTH * H_SIZE)
#define TERM_CHECK 0
#define TERM_INTERVAL 1
#define TERM_WINDOW 2

// One level's domain in a band candidate (sampler/nextuse.py::_LevelSpec)
#define SPEC_FREE 0
#define SPEC_FIXED 1
#define SPEC_INTERVAL 2

struct Spec {
    int kind;
    bool valid;  // SPEC_FIXED
    i64 a;       // free: bound; fixed: value; interval: lo
    i64 b;       // interval: hi
};

HD i64 spec_min_val(const Spec& s) {
    if (s.kind == SPEC_FIXED) return s.valid ? s.a : INF_I64;
    if (s.kind == SPEC_INTERVAL) return s.a < s.b ? s.a : INF_I64;
    return 0;
}

// Smallest element >= x, INF when none. _LevelSpec.min_gt(x) is
// spec_min_ge(x + 1), and min_scaled_gt(scale, x) with scale > 0 is
// spec_min_ge(floor(x / scale) + 1): v * scale > x iff v > floor(x/scale).
HD i64 spec_min_ge(const Spec& s, i64 x) {
    if (s.kind == SPEC_FIXED) return (s.valid && s.a >= x) ? s.a : INF_I64;
    const i64 lo = s.kind == SPEC_INTERVAL ? s.a : 0;
    const i64 hi = s.kind == SPEC_INTERVAL ? s.b : s.a;
    const i64 nxt = max_i64(lo, x);
    return nxt < hi ? nxt : INF_I64;
}

HD bool spec_has(const Spec& s, i64 x) {
    if (s.kind == SPEC_FIXED) return s.valid && s.a == x;
    const i64 lo = s.kind == SPEC_INTERVAL ? s.a : 0;
    const i64 hi = s.kind == SPEC_INTERVAL ? s.b : s.a;
    return x >= lo && x < hi;
}

// What every group's walk reads of one sample: its thread and position,
// and the mixed-radix split of the position that
// nextuse.py::min_position_after takes of p0 (m0, r0, j0, rr0), computed
// once per sample here rather than once per member per candidate.
struct Sample {
    i64 tid, p0;
    i64 m0, r0;   // p0 = m0 * acc0 + r0
    i64 j0, rr0;  // r0 = npre0 + j0 * acc1 + rr0
    // triangular: m0 is the thread-local parallel index, and the sample's
    // own iteration has value v0, base base0 and level-1 body b1 (at least
    // 1); p0 - base0 - npre0 = cq * b1 + cr, 0 <= cr < b1
    i64 v0, base0, b1, cq, cr;
};

// The static schedule's owner thread and thread-local index of a
// normalized parallel iteration n >= 0 (core/schedule.py): with
// q = n / chunk and qq = q / threads (= n / (chunk * threads)),
// owner = q mod threads and local = qq * chunk + n mod chunk.
// Unsigned arithmetic: a caller may pass an n < 0 whose results it
// then ignores.
HD void schedule_of(const i64* d, i64 n, i64* owner, i64* local) {
    const u64 ch = (u64)d[D_DIV_CHUNK + DIV_D];
    const u64 th = (u64)d[D_DIV_THREADS + DIV_D];
    const u64 q = udiv_rec((u64)n, d + D_DIV_CHUNK);
    const u64 qq = udiv_rec(q, d + D_DIV_THREADS);
    *owner = (i64)(q - qq * th);
    *local = (i64)(qq * ch + ((u64)n - q * ch));
}

// Level l fixed to the loop VALUE v (nextuse.py's spec_from_value):
// normalize, validate, and at level 0 map to the sample thread's own
// index. Out of range, n may be anything; then valid is false and a is
// never read.
HD Spec spec_fixed(const i64* d, int l, i64 v, bool ok, i64 tid) {
    const i64* rec = d + D_DIV_STEP + l * DIV_SIZE;
    const i64 rel = v - d[D_LSTART + l];
    const i64 n = floordiv_rec(rel, rec);
    const bool on_grid = floormod_rec(rel, n, rec) == 0;
    Spec s;
    s.kind = SPEC_FIXED;
    s.b = 0;
    s.valid = ok && on_grid && n >= 0 && n < d[D_TRIPS + l];
    if (l == 0) {
        i64 owner, local;
        schedule_of(d, n, &owner, &local);
        s.valid = s.valid && owner == tid;
        s.a = local;
    } else {
        s.a = n;
    }
    return s;
}

// Position base m*acc0 [+ npre0 + n1*acc1 [+ npre1 + n2*acc2]] of a
// sink at level SL, body offset excluded; INF when a part is INF
// (min_position_after's pos + guard).
template <int SL>
HD i64 pos_base(const i64* d, i64 m, i64 n1, i64 n2) {
    if (m >= INF_I64 || (SL >= 1 && n1 >= INF_I64)
        || (SL >= 2 && n2 >= INF_I64))
        return INF_I64;
    i64 p = m * d[D_ACC];
    if constexpr (SL >= 1) p += d[D_NPRE0] + n1 * d[D_ACC + 1];
    if constexpr (SL >= 2) p += d[D_NPRE1] + n2 * d[D_ACC + 2];
    return p;
}

// Head bounds of one band-plan head at residual band start lo: the head
// value runs over [umin, umin + n_u), and is in the band iff <= umax.
HD void head_bounds(const i64* h, i64 lo, i64 W, i64* umin, i64* umax) {
    const i64* cv = h + H_CV;
    *umin = -floordiv_rec(h[H_RMAX] - lo, cv);  // ceil((lo - rmax) / cv)
    *umax = floordiv_rec(lo + W - 1 - h[H_RMIN], cv);
}

// Which of the first NH heads fixes level l (head levels are distinct),
// -1 for none.
template <int NH>
HD int head_at(const i64* g, int l) {
    int k = -1;
    UNROLL
    for (int i = 0; i < NH; ++i)
        if (g[G_HEADS + i * H_SIZE + H_LEVEL] == l) k = i;
    return k;
}

// One sink group's walk: its records, which head fixes each level (-1
// for none), and the per-member slots of a level-2 walk (slot jj at
// nb[jj * NB_STRIDE]: per-thread shared memory on the card).
struct Group {
    const i64* d;
    const i64* g;
    int hk[MAX_DEPTH];
    i64* nb;
    const i64* tri;  // the triangular base table (triangular walks only)
};

// The values of the first NH heads in a candidate: scalars, not an array,
// so that picking one by a level's head index stays a select in
// registers.
struct HeadValues {
    i64 u0, u1, u2;
};

// What the band candidates of a group reduce to, member offsets aside.
struct Acc {
    i64 min_ab;  // strategies A and B: min over candidates of the base
    bool any_c;  // strategy C exists in some candidate (SL 0 and 1)
};

// One band candidate (nextuse.py::next_use_candidates_group's emit): the
// level box from the head values u, the terminal's band start lo and
// window index kw, then the member-independent part of every strategy
// of min_position_after at sink level SL.
template <int SL, int NH>
HD void candidate(const Group& G, const Sample& s, const HeadValues& u,
                  i64 lo, i64 kw, bool ok, Acc& acc) {
    const i64* d = G.d;
    const int term = (int)G.g[G_TERM];
    const int tl = (int)G.g[G_TLEVEL];
    Spec sp[SL + 1];
    UNROLL
    for (int l = 0; l <= SL; ++l) {
        if (G.hk[l] >= 0) {
            const i64 v = G.hk[l] == 0 ? u.u0 : G.hk[l] == 1 ? u.u1 : u.u2;
            sp[l] = spec_fixed(d, l, v, ok, s.tid);
        } else if (term == TERM_WINDOW && tl == l) {
            sp[l] = spec_fixed(d, l, lo + kw, ok, s.tid);
        } else if (term == TERM_INTERVAL && tl == l) {
            const i64 start = d[D_LSTART + l];
            const i64 n_lo = max_i64(lo - start, 0);
            const i64 n_hi = min_i64(lo + d[D_W] - start, d[D_TRIPS + l]);
            sp[l].kind = SPEC_INTERVAL;
            sp[l].valid = true;
            sp[l].a = n_lo;
            sp[l].b = ok ? n_hi : n_lo;
        } else {
            sp[l].kind = SPEC_FREE;
            sp[l].valid = true;
            sp[l].a = l == 0 ? d[d[D_OFF_LC] + s.tid] : d[D_TRIPS + l];
            sp[l].b = 0;
        }
    }
    const i64 mA = spec_min_ge(sp[0], s.m0 + 1);
    const bool mB = spec_has(sp[0], s.m0);
    if constexpr (SL == 0) {
        acc.min_ab = min_i64(acc.min_ab, pos_base<0>(d, mA, 0, 0));
        acc.any_c = acc.any_c || mB;
    } else {
        const i64 n2min = SL == 2 ? spec_min_val(sp[SL]) : 0;
        const i64 pa = pos_base<SL>(d, mA, spec_min_val(sp[1]), n2min);
        const i64 pb = mB ? pos_base<SL>(d, s.m0, spec_min_ge(sp[1], s.j0 + 1),
                                         n2min)
                          : INF_I64;
        acc.min_ab = min_i64(acc.min_ab, min_i64(pa, pb));
        const bool c = mB && spec_has(sp[1], s.j0);
        if constexpr (SL == 1) {
            acc.any_c = acc.any_c || c;
        } else if (c) {
            const i64* refs = d + d[D_OFF_REFS];
            const int nm = (int)G.g[G_NMEM];
            for (int jj = 0; jj < nm; ++jj) {
                const i64 off = refs[G.g[G_MEMBERS + jj] * R_SIZE + R_OFF];
                const i64 qp1 = floordiv_rec(s.rr0 - d[D_NPRE1] - off,
                                             d + D_DIV_ACC + 2 * DIV_SIZE)
                                + 1;
                i64* slot = G.nb + jj * NB_STRIDE;
                *slot = min_i64(*slot, spec_min_ge(sp[SL], qp1));
            }
        }
    }
}

template <int SL, int NH>
HD void candidate_tri(const Group& G, const Sample& s, const HeadValues& u,
                      i64 lo, i64 kw, bool ok);

// One band candidate of either walk.
template <int SL, int NH, bool TRI>
HD void visit(const Group& G, const Sample& s, const HeadValues& u, i64 lo,
              i64 kw, bool ok, Acc& acc) {
    if constexpr (TRI) candidate_tri<SL, NH>(G, s, u, lo, kw, ok);
    else candidate<SL, NH>(G, s, u, lo, kw, ok, acc);
}

// The band plan (_band_candidates) from head K on: head K's values, each
// narrowing the band for the heads after it, then the terminal. One
// nested loop per head, unrolled by the template, so that every head's
// state sits in registers.
template <int SL, int NH, int K, bool TRI>
HD void band(const Group& G, const Sample& s, i64 lo, bool ok,
             HeadValues& u, Acc& acc) {
    const i64* d = G.d;
    if constexpr (K < NH) {
        const i64* h = G.g + G_HEADS + K * H_SIZE;
        i64 umin, umax;
        head_bounds(h, lo, d[D_W], &umin, &umax);
        const int n = (int)h[H_NU];
        for (int i = 0; i < n; ++i) {
            const i64 uk = umin + i;
            if constexpr (K == 0) u.u0 = uk;
            if constexpr (K == 1) u.u1 = uk;
            if constexpr (K == 2) u.u2 = uk;
            band<SL, NH, K + 1, TRI>(G, s, lo - h[H_CV + DIV_D] * uk,
                                     ok && uk <= umax, u, acc);
        }
    } else {
        const int term = (int)G.g[G_TERM];
        const i64 W = d[D_W];
        if (term == TERM_CHECK) {
            const bool okc = ok && lo <= 0 && lo > -W;
            // a constant ref (no head, no unit-stride terminal): no spec
            // carries the validity, so an invalid band is no candidate
            if (NH > 0 || okc) visit<SL, NH, TRI>(G, s, u, lo, 0, okc, acc);
        } else {
            const i64 nw = term == TERM_WINDOW ? G.g[G_TW] : 1;
            for (i64 kw = 0; kw < nw; ++kw)
                visit<SL, NH, TRI>(G, s, u, lo, kw, ok, acc);
        }
    }
}

// nextuse.py::next_use_candidates_group for one sink group at sink level
// SL with NH band-plan heads, then _best_sink's in-order update of
// (best, best_sink) over the group's members. Per candidate the
// member-independent part of every strategy is reduced:
//   A and B: min over candidates of the position base (the members add
//     their offsets at the end: min(x + off) = min(x) + off);
//   C at SL 0 and 1: its position is p0 - r0 (SL 0) or p0 - rr0 (SL 1)
//     plus the offset whenever it exists, and it lies after p0 iff
//     off > r0 (rr0), so only whether it exists is kept;
//   C at SL 2: the level-2 index is the smallest box element >= qp1 =
//     floor((rr0 - npre1 - off) / acc2) + 1, which depends on the member,
//     so where C exists each member's minimum index is kept in nb.
// The result equals the per-member, per-candidate minimum of the plain
// version for every input.
template <int SL, int NH>
HD void walk_group(const i64* d, const i64* g, const Sample& s, i64 line, i64* nb,
                   i64* best, i64* best_sink) {
    const Group G{d, g, {head_at<NH>(g, 0), head_at<NH>(g, 1),
                         head_at<NH>(g, 2)}, nb, nullptr};
    const int nm = (int)g[G_NMEM];
    if constexpr (SL == 2) {
        for (int jj = 0; jj < nm; ++jj) nb[jj * NB_STRIDE] = INF_I64;
    }
    Acc acc{INF_I64, false};
    HeadValues u{0, 0, 0};
    band<SL, NH, 0, false>(G, s, line * d[D_W] - g[G_CONST], true, u, acc);
    // the members, in order, each with its own body offset
    const i64* refs = d + d[D_OFF_REFS];
    for (int jj = 0; jj < nm; ++jj) {
        const i64 j = g[G_MEMBERS + jj];
        const i64 off = refs[j * R_SIZE + R_OFF];
        i64 p = acc.min_ab < INF_I64 ? acc.min_ab + off : INF_I64;
        i64 pc;
        if constexpr (SL == 0) {
            pc = acc.any_c && off > s.r0 ? s.p0 - s.r0 + off : INF_I64;
        } else if constexpr (SL == 1) {
            pc = acc.any_c && off > s.rr0 ? s.p0 - s.rr0 + off : INF_I64;
        } else {
            // n2 * acc2 > rr0 - npre1 - off makes pc > p0 (acc2 > 0)
            const i64 n2 = nb[jj * NB_STRIDE];
            pc = n2 < INF_I64 ? s.p0 - s.rr0 + d[D_NPRE1]
                                    + n2 * d[D_ACC + 2] + off
                              : INF_I64;
        }
        p = min_i64(p, pc);
        if (p < *best) {
            *best = p;
            *best_sink = j;
        }
    }
}

// ---- triangular nests (TRI): nextuse.py::next_use_candidates_tri_group

// floor(a / b) for b >= 1 that varies per sample or candidate (no record):
// C's quotient truncates toward zero, so a negative a with a remainder
// steps down by one.
HD i64 floordiv_var(i64 a, i64 b) {
    const i64 q = a / b;
    return q - (i64)((a - q * b != 0) & (a < 0));
}

// A base-table entry: through the read-only cache on the card.
HD i64 tri_load(const i64* p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

// core/trace.py's trip_at and start_at of level l at parallel value v.
HD i64 trip_at(const i64* d, int l, i64 v) {
    const i64 tc = d[D_TC + l];
    return tc == 0 ? d[D_TRIPS + l] : max_i64(d[D_TRIPS + l] + tc * v, 0);
}

HD i64 start_at(const i64* d, int l, i64 v) {
    return d[D_STARTB + l] + d[D_SC + l] * v;
}

// body_at(1, v): the accesses of one level-1 iteration.
HD i64 body1_at(const i64* d, i64 v) {
    i64 b = d[D_BODYC + 1];
    if (d[D_DEPTH] > 2) b += trip_at(d, 2, v) * d[D_BODYC + 2];
    return b;
}

// The accesses of a level-SL iteration's subloop, which a post-slot ref of
// level SL follows (ref_offset_at's inner term).
template <int SL>
HD i64 inner_at(const i64* d, i64 v) {
    if (SL + 1 >= d[D_DEPTH]) return 0;
    if constexpr (SL == 0) return trip_at(d, 1, v) * body1_at(d, v);
    else return trip_at(d, 2, v) * d[D_BODYC + 2];
}

// ref_offset_at(j, v): ref j's offset within its level's iteration.
template <int SL>
HD i64 offset_at(const i64* d, i64 j, i64 v) {
    const i64 off = d[d[D_OFF_REFS] + j * R_SIZE + R_OFF];
    return d[d[D_OFF_POST] + j] ? off + inner_at<SL>(d, v) : off;
}

// count_below(tid, n) for n >= 0: thread tid's iterations with a
// normalized index below n (n / (chunk * threads) as in schedule_of).
HD i64 count_below(const i64* d, i64 tid, i64 n) {
    const i64 ch = d[D_DIV_CHUNK + DIV_D];
    const i64 th = d[D_DIV_THREADS + DIV_D];
    const i64 q = (i64)udiv_rec(udiv_rec((u64)n, d + D_DIV_CHUNK),
                                d + D_DIV_THREADS);
    return q * ch + min_i64(max_i64(n - q * ch * th - tid * ch, 0), ch);
}

// local_to_value(tid, m) for m >= 0.
HD i64 local_to_value(const i64* d, i64 tid, i64 m) {
    const i64 ch = d[D_DIV_CHUNK + DIV_D];
    const i64 cid = (i64)udiv_rec((u64)m, d + D_DIV_CHUNK);
    const i64 n = (cid * d[D_DIV_THREADS + DIV_D] + tid) * ch + (m - cid * ch);
    return d[D_S_START] + n * d[D_S_STEP];
}

// One level's domain in a triangular candidate, in loop VALUES: free,
// fixed to a (SPEC_FIXED) or the interval [a, b) (SPEC_INTERVAL).
struct Dom {
    int kind;
    i64 a, b;
};

// dom_bounds: the index interval [lo, hi) of level l's domain at v.
HD void dom_bounds(const i64* d, int l, const Dom& dm, i64 v, i64* lo,
                   i64* hi) {
    const i64 tripv = trip_at(d, l, v);
    if (dm.kind == SPEC_FREE) {
        *lo = 0;
        *hi = tripv;
        return;
    }
    const i64 st = start_at(d, l, v);
    if (dm.kind == SPEC_FIXED) {
        const i64 n = dm.a - st;
        *lo = n;
        *hi = (n >= 0 && n < tripv) ? n + 1 : n;
        return;
    }
    const i64 lo_i = max_i64(dm.a - st, 0);
    *lo = lo_i;
    *hi = max_i64(min_i64(dm.b - st, tripv), lo_i);
}

// later_m_context's constraint a * v0 + b >= 0; rec is |a|'s record.
HD void halfspace(i64 a, i64 b, const i64* rec, i64* vlo, i64* vhi,
                  bool* ok) {
    if (a > 0) *vlo = max_i64(*vlo, -floordiv_rec(b, rec));  // ceil(-b/a)
    else if (a < 0) *vhi = min_i64(*vhi, floordiv_rec(b, rec));
    else *ok = *ok && b >= 0;
}

// later_m_context: the value and base of the earliest iteration m' > m0
// of the sample's thread whose inner domains are all nonempty; false
// where there is none.
template <int SL>
HD bool later_context(const Group& G, const Sample& s, const Dom* dm,
                      i64* v0a, i64* base_a) {
    const i64* d = G.d;
    const i64 start0 = d[D_S_START], trip0 = d[D_TRIPS];
    i64 vlo = start0, vhi = start0 + trip0 - 1;
    bool ok = true;
    UNROLL
    for (int l = 1; l <= SL; ++l) {
        const i64 st = d[D_STARTB + l], sc = d[D_SC + l];
        const i64 tr = d[D_TRIPS + l], tc = d[D_TC + l];
        const i64* rec = d + D_DIV_HS + 3 * (l - 1) * DIV_SIZE;
        if (dm[l].kind == SPEC_FREE) {
            halfspace(tc, tr - 1, rec, &vlo, &vhi, &ok);  // trip >= 1
        } else if (dm[l].kind == SPEC_FIXED) {
            const i64 u = dm[l].a;
            halfspace(-sc, u - st, rec + DIV_SIZE, &vlo, &vhi, &ok);
            halfspace(tc + sc, tr - u + st - 1, rec + 2 * DIV_SIZE, &vlo,
                      &vhi, &ok);
        } else {
            halfspace(tc, tr - 1, rec, &vlo, &vhi, &ok);
            halfspace(-sc, dm[l].b - st - 1, rec + DIV_SIZE, &vlo, &vhi,
                      &ok);
            halfspace(tc + sc, tr - dm[l].a + st - 1, rec + 2 * DIV_SIZE,
                      &vlo, &vhi, &ok);
        }
    }
    const i64 n_lo = min_i64(max_i64(vlo - start0, 0), trip0);
    const i64 m_a = max_i64(s.m0 + 1, count_below(d, s.tid, n_lo));
    ok = ok && m_a < d[d[D_OFF_LC] + s.tid];
    const i64 lmax = d[D_LMAX];
    const i64 m_ac = min_i64(max_i64(m_a, 0), lmax);
    *v0a = local_to_value(d, s.tid, m_ac);
    *base_a = tri_load(G.tri + s.tid * (lmax + 1) + m_ac);
    return ok && *v0a >= vlo && *v0a <= vhi;
}

// min_inner_pos of every member in the iteration with value v and base
// `base`, each kept as the member's minimum in nb. `own`: the sample's own
// iteration, whose split of p0 the sample holds. A member's offset lies
// in [0, b1) at SL 1 (it is inside one level-1 iteration), so with
// p0 - base - npre0 = q * b1 + rr, 0 <= rr < b1, the floor of
// (p0 - base - npre0 - off) / b1 is q when rr >= off, else q - 1.
template <int SL>
HD void inner_positions(const Group& G, const Sample& s, const Dom* dm,
                        i64 v, i64 base, bool own) {
    const i64* d = G.d;
    const int nm = (int)G.g[G_NMEM];
    if constexpr (SL == 0) {
        for (int jj = 0; jj < nm; ++jj) {
            const i64 pos = base + offset_at<0>(d, G.g[G_MEMBERS + jj], v);
            i64* slot = G.nb + jj * NB_STRIDE;
            if (pos > s.p0) *slot = min_i64(*slot, pos);
        }
    } else {
        i64 b1 = s.b1, q = s.cq, rr = s.cr;
        if (!own) {
            b1 = max_i64(body1_at(d, v), 1);
            const i64 r = s.p0 - base - d[D_NPRE0];
            q = floordiv_var(r, b1);
            rr = r - q * b1;
        }
        i64 d1lo, d1hi;
        dom_bounds(d, 1, dm[1], v, &d1lo, &d1hi);
        const i64 at1 = base + d[D_NPRE0];
        if constexpr (SL == 1) {
            for (int jj = 0; jj < nm; ++jj) {
                const i64 off = offset_at<1>(d, G.g[G_MEMBERS + jj], v);
                const i64 n1 = max_i64(d1lo, q + (rr >= off ? 1 : 0));
                i64* slot = G.nb + jj * NB_STRIDE;
                if (n1 < d1hi) *slot = min_i64(*slot, at1 + n1 * b1 + off);
            }
        } else {
            i64 d2lo, d2hi;
            dom_bounds(d, 2, dm[2], v, &d2lo, &d2hi);
            const i64 a2 = d[D_DIV_A2 + DIV_D];
            const i64 n1a = max_i64(d1lo, q + 1);
            const i64 pa = n1a < d1hi && d2lo < d2hi
                               ? at1 + n1a * b1 + d[D_NPRE1] + d2lo * a2
                               : INF_I64;
            const bool jb = q >= d1lo && q < d1hi;
            const i64 at2 = at1 + q * b1 + d[D_NPRE1];
            for (int jj = 0; jj < nm; ++jj) {
                const i64 off = offset_at<2>(d, G.g[G_MEMBERS + jj], v);
                i64 p = pa < INF_I64 ? pa + off : INF_I64;
                const i64 n2 = max_i64(
                    d2lo,
                    floordiv_rec(rr - d[D_NPRE1] - off, d + D_DIV_A2) + 1);
                if (jb && n2 < d2hi) p = min_i64(p, at2 + n2 * a2 + off);
                i64* slot = G.nb + jj * NB_STRIDE;
                *slot = min_i64(*slot, p);
            }
        }
    }
}

// One band candidate of a triangular walk (the tri group's emit): each
// level's domain in values, then a level-0 value the candidate fixes, or
// the sample's own iteration and the earliest later one.
template <int SL, int NH>
HD void candidate_tri(const Group& G, const Sample& s, const HeadValues& u,
                      i64 lo, i64 kw, bool ok) {
    if (!ok) return;  // every position of the candidate would be INF
    const i64* d = G.d;
    const int term = (int)G.g[G_TERM];
    const int tl = (int)G.g[G_TLEVEL];
    Dom dm[SL + 1];
    UNROLL
    for (int l = 0; l <= SL; ++l) {
        dm[l].b = 0;
        if (G.hk[l] >= 0) {
            dm[l].kind = SPEC_FIXED;
            dm[l].a = G.hk[l] == 0 ? u.u0 : G.hk[l] == 1 ? u.u1 : u.u2;
        } else if (term == TERM_WINDOW && tl == l) {
            dm[l].kind = SPEC_FIXED;
            dm[l].a = lo + kw;
        } else if (term == TERM_INTERVAL && tl == l) {
            dm[l].kind = SPEC_INTERVAL;  // never level 0 (band_plan)
            dm[l].a = lo;
            dm[l].b = lo + d[D_W];
        } else {
            dm[l].kind = SPEC_FREE;
            dm[l].a = 0;
        }
    }
    if (dm[0].kind != SPEC_FREE) {
        const i64 n0 = dm[0].a - d[D_S_START];  // unit steps
        if (n0 < 0 || n0 >= d[D_TRIPS]) return;
        i64 owner, m;
        schedule_of(d, n0, &owner, &m);
        if (owner != s.tid) return;
        const i64 base =
            tri_load(G.tri + s.tid * (d[D_LMAX] + 1) + min_i64(m, d[D_LMAX]));
        inner_positions<SL>(G, s, dm, dm[0].a, base, false);
        return;
    }
    inner_positions<SL>(G, s, dm, s.v0, s.base0, true);
    i64 v0a, base_a;
    if (later_context<SL>(G, s, dm, &v0a, &base_a))
        inner_positions<SL>(G, s, dm, v0a, base_a, false);
}

// next_use_candidates_tri_group for one sink group at sink level SL with
// NH heads, then _best_sink's in-order update over its members.
template <int SL, int NH>
HD void walk_group_tri(const i64* d, const i64* g, const i64* tri,
                       const Sample& s, i64 line, i64* nb, i64* best,
                       i64* best_sink) {
    const Group G{d, g, {head_at<NH>(g, 0), head_at<NH>(g, 1),
                         head_at<NH>(g, 2)}, nb, tri};
    const int nm = (int)g[G_NMEM];
    for (int jj = 0; jj < nm; ++jj) nb[jj * NB_STRIDE] = INF_I64;
    Acc acc{INF_I64, false};  // unused by the triangular candidates
    HeadValues u{0, 0, 0};
    band<SL, NH, 0, true>(G, s, line * d[D_W] - g[G_CONST], true, u, acc);
    for (int jj = 0; jj < nm; ++jj) {
        const i64 p = nb[jj * NB_STRIDE];
        if (p < *best) {
            *best = p;
            *best_sink = g[G_MEMBERS + jj];
        }
    }
}

// walk_group with the group's head count nh <= NHMAX as a template
// argument.
template <int SL, int NH, bool TRI>
HD void walk_one(const i64* d, const i64* g, const i64* tri, const Sample& s,
                 i64 line, i64* nb, i64* best, i64* best_sink) {
    if constexpr (TRI)
        walk_group_tri<SL, NH>(d, g, tri, s, line, nb, best, best_sink);
    else
        walk_group<SL, NH>(d, g, s, line, nb, best, best_sink);
}

template <int SL, int NH, int NHMAX, bool TRI>
HD void walk_nh(int nh, const i64* d, const i64* g, const i64* tri,
                const Sample& s, i64 line, i64* nb, i64* best,
                i64* best_sink) {
    if constexpr (NH == NHMAX) {
        walk_one<SL, NH, TRI>(d, g, tri, s, line, nb, best, best_sink);
    } else if (nh == NH) {
        walk_one<SL, NH, TRI>(d, g, tri, s, line, nb, best, best_sink);
    } else {
        walk_nh<SL, NH + 1, NHMAX, TRI>(nh, d, g, tri, s, line, nb, best,
                                        best_sink);
    }
}

// sampled.py::classify_samples for one sample of a source ref at level
// LV whose groups have at most NHMAX heads, of a triangular nest where
// TRI: decode, geometry, the best sink over every group, and the share
// test. hr: the division records of the key's three radices; tri: the
// base table (TRI only).
template <int LV, int NHMAX, bool TRI>
HD void classify_one(const i64* d, const i64* tri, i64 key, const i64* hr,
                     i64 rx, i64* nb, i64* packed, i64* ri_out, bool* share,
                     bool* found) {
    // decode_sample_keys: innermost level first; a padded radix is 1
    i64 n[MAX_DEPTH];
    i64 q = floordiv_rec(key, hr + 2 * DIV_SIZE);
    n[2] = floormod_rec(key, q, hr + 2 * DIV_SIZE);
    key = q;
    q = floordiv_rec(key, hr + DIV_SIZE);
    n[1] = floormod_rec(key, q, hr + DIV_SIZE);
    key = q;
    n[0] = floormod_rec(key, floordiv_rec(key, hr), hr);
    // _sample_geometry; n[0] >= 0, as a floor modulo by a positive radix
    Sample s;
    i64 m;
    schedule_of(d, n[0], &s.tid, &m);
    const i64 v0 = d[D_S_START] + n[0] * d[D_S_STEP];
    const i64* refs = d + d[D_OFF_REFS];
    const i64* rr = refs + rx * R_SIZE;
    if constexpr (TRI) {
        // tri_position: the iteration's base, the ref's offset at v0, and
        // the inner indices by body_at(1, v0) and body_at(2, v0) = a2
        s.m0 = m;
        s.v0 = v0;
        s.base0 = tri_load(tri + s.tid * (d[D_LMAX] + 1)
                           + min_i64(m, d[D_LMAX]));
        const i64 body1 = d[D_DEPTH] > 1 ? body1_at(d, v0) : 0;
        s.p0 = s.base0 + offset_at<LV>(d, rx, v0);
        if constexpr (LV >= 1) s.p0 += d[D_NPRE0] + n[1] * body1;
        if constexpr (LV >= 2)
            s.p0 += d[D_NPRE1] + n[2] * d[D_DIV_A2 + DIV_D];
        // the split of p0 in its own iteration, shared by every candidate
        s.b1 = max_i64(body1, 1);
        const i64 r = s.p0 - s.base0 - d[D_NPRE0];
        s.cq = d[D_DEPTH] > 1 ? floordiv_var(r, s.b1) : 0;
        s.cr = r - s.cq * s.b1;
    } else {
        s.p0 = m * d[D_ACC] + rr[R_OFF];
        if constexpr (LV >= 1) s.p0 += d[D_NPRE0] + n[1] * d[D_ACC + 1];
        if constexpr (LV >= 2) s.p0 += d[D_NPRE1] + n[2] * d[D_ACC + 2];
    }
    i64 flat = rr[R_CONST] + v0 * rr[R_COEFF];
    UNROLL
    for (int l = 1; l <= LV; ++l) {
        const i64 vl = d[D_STARTB + l] + d[D_SC + l] * v0
                       + n[l] * d[D_LSTEP + l];
        flat += vl * rr[R_COEFF + l];
    }
    const i64 line = floordiv_rec(flat * d[D_DS], d + D_DIV_CLS);
    if constexpr (!TRI) {
        s.m0 = floordiv_rec(s.p0, d + D_DIV_ACC);
        s.r0 = s.p0 - s.m0 * d[D_ACC];
        s.j0 = floordiv_rec(s.r0 - d[D_NPRE0], d + D_DIV_ACC + DIV_SIZE);
        s.rr0 = s.r0 - d[D_NPRE0] - s.j0 * d[D_ACC + 1];
    }
    // _best_sink: groups in order, members in order, first minimum wins
    i64 best = INF_I64, best_sink = 0;
    const i64* g = d + d[D_OFF_GROUPS];
    const int ng = (int)d[D_NGROUPS];
    for (int gi = 0; gi < ng; ++gi) {
        const int level = (int)g[G_LEVEL], nh = (int)g[G_NHEADS];
        if (level == 0)
            walk_nh<0, 0, NHMAX, TRI>(nh, d, g, tri, s, line, nb, &best,
                                      &best_sink);
        else if (level == 1)
            walk_nh<1, 0, NHMAX, TRI>(nh, d, g, tri, s, line, nb, &best,
                                      &best_sink);
        else
            walk_nh<2, 0, NHMAX, TRI>(nh, d, g, tri, s, line, nb, &best,
                                      &best_sink);
        g += G_MEMBERS + g[G_NMEM];
    }
    const bool fnd = best < INF_I64;
    const i64 ri = fnd ? best - s.p0 : 0;
    const i64 thr = refs[best_sink * R_SIZE + R_THR];
    const i64 dthr = ri - thr;
    const bool shr = fnd && thr > 0
                     && (ri < 0 ? -ri : ri) > (dthr < 0 ? -dthr : dthr);
    const i64 slot = shr ? refs[best_sink * R_SIZE + R_RATIO] : NOSHARE_SLOT;
    *packed = ri * RATIO_SLOTS + slot;
    *ri_out = ri;
    *share = shr;
    *found = fnd;
}

// One sample's contribution: residual lane, histogram bin, cold count.
// Returns the bin (0..63) of a noshare ri >= 1 sample, 64 for a cold
// sample, -1 otherwise. Under `raw` no sample is binned: every found
// sample writes its packed key (noshare slot 15) to the residual.
template <int LV, int NHMAX, bool TRI>
HD int sample_step(const i64* d, const i64* tri, i64 key, bool mk,
                   const i64* hr, i64 rx, i64* nb, bool raw,
                   i64* residual) {
    if (!mk) {  // masked-out lane: nothing but the sentinel
        *residual = SENTINEL;
        return -1;
    }
    i64 packed, ri;
    bool shr, fnd;
    classify_one<LV, NHMAX, TRI>(d, tri, key, hr, rx, nb, &packed, &ri, &shr,
                                 &fnd);
    const bool nosh = !raw && fnd && !shr && ri >= 1;
    *residual = (fnd && !nosh) ? packed : SENTINEL;
    if (nosh) return 63 - clz64(ri);
    return fnd ? -1 : N_BINS;
}

// The most band-plan heads of any group of a descriptor: NHMAX 1 serves
// up to one, NHMAX 3 more.
HD int max_heads(const i64* d) {
    int nh = 0;
    const i64* g = d + d[D_OFF_GROUPS];
    for (i64 gi = 0; gi < d[D_NGROUPS]; ++gi) {
        if (g[G_NHEADS] > nh) nh = (int)g[G_NHEADS];
        g += G_MEMBERS + g[G_NMEM];
    }
    return nh;
}

// Words of one row's radix records in the per-row form.
#define HR_WORDS (MAX_DEPTH * DIV_SIZE)

#if !defined(__CUDACC__) || defined(SAMPLED_HIST_ROWS_NHMAX)
// The per-row form's checks, on the host copy of the rows' descriptors:
// true where the launch does not take them (rows the grid cannot hold, a
// row stride below the row, a row whose header is out of range, rows
// whose level or nest kind differ, a base table where the rows are not
// triangular or none where they are). Sets the rows' level, nest kind
// and most heads of any group.
static bool rows_args(i64 R, i64 B, i64 ld, const i64* descs, int dld,
                      const void* tris, i64 tld, int* lv, int* tri,
                      int* nh) {
    if (R < 1 || R > 65535 || B < 1 || ld < B || dld < D_HEADER)
        return true;
    *lv = (int)descs[D_LV];
    *tri = descs[D_TRI] != 0;
    *nh = 0;
    for (i64 r = 0; r < R; ++r) {
        const i64* d = descs + r * dld;
        if (d[D_LV] != *lv || (d[D_TRI] != 0) != (*tri != 0)
            || d[D_OFF_GROUPS] < D_HEADER || d[D_OFF_GROUPS] >= dld)
            return true;
        const int h = max_heads(d);
        if (h > *nh) *nh = h;
    }
    return *lv < 0 || *lv >= MAX_DEPTH || *nh > MAX_DEPTH
           || (*tri != 0) != (tris != nullptr) || (*tri && tld < 1);
}
#endif

#ifdef __CUDACC__

// The launch's constants, passed by value: kernel parameters live in the
// constant bank, which every lane of a warp reads at one address at no
// cost in registers, and the compiler may keep them as instruction
// operands or in uniform registers.
struct Params {
    i64 hr[MAX_DEPTH * DIV_SIZE];  // the radices' division records
    i64 desc[MAX_DESC];            // build_descriptor's words
};

// The buffer form's constants: the radices' records alone.
struct ParamsBuf {
    i64 hr[MAX_DEPTH * DIV_SIZE];
};

// One block's share of the launch, with the descriptor at d: row
// blockIdx.y, a grid-stride loop over its lanes, then the block's
// histogram and cold count flushed. s_hist arrives zeroed and synced.
template <int LV, int NHMAX, bool TRI>
__device__ __forceinline__ void block_rows(
    const i64* d, const i64* hr, const i64* __restrict__ keys,
    const unsigned char* __restrict__ mask, i64 B, i64 ld,
    const i64* __restrict__ rx, const i64* __restrict__ tri, bool raw,
    i64* __restrict__ residual, u64* __restrict__ hist,
    u64* __restrict__ cold, i64* s_nb, u64* s_hist) {
    const i64 r = blockIdx.y;
    const i64 rxv = rx[r];
    const i64 in = r * ld;   // row r of keys and mask
    const i64 base = r * B;  // row r of residual
    const i64 stride = (i64)gridDim.x * blockDim.x;
    // b0 is the same for every thread of the block, so every lane of a
    // warp runs every iteration and __match_any_sync sees the full warp
    for (i64 b0 = (i64)blockIdx.x * blockDim.x; b0 < B; b0 += stride) {
        const i64 b = b0 + threadIdx.x;
        int bin = -1;
        if (b < B) {
            const bool mk = mask == nullptr || mask[in + b] != 0;
            bin = sample_step<LV, NHMAX, TRI>(d, tri, keys[in + b], mk, hr,
                                              rxv, s_nb + threadIdx.x, raw,
                                              residual + base + b);
        }
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (bin >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
            atomicAdd(&s_hist[bin], (u64)__popc(peers));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < N_BINS; i += blockDim.x)
        if (s_hist[i]) atomicAdd(&hist[r * N_BINS + i], s_hist[i]);
    if (threadIdx.x == 0 && s_hist[N_BINS])
        atomicAdd(&cold[r], s_hist[N_BINS]);
}

#ifndef SAMPLED_HIST_BUFFER_FORM
template <int LV, int NHMAX, bool TRI>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM(NHMAX, TRI))
sampled_hist_kernel(const i64* __restrict__ keys,
                    const unsigned char* __restrict__ mask, i64 B, i64 ld,
                    const __grid_constant__ Params pr,
                    const i64* __restrict__ rx,
                    const i64* __restrict__ tri, bool raw,
                    i64* __restrict__ residual, u64* __restrict__ hist,
                    u64* __restrict__ cold) {
    __shared__ i64 s_nb[MAX_MEMBERS * THREADS];  // walk_group's nb
    __shared__ u64 s_hist[N_BINS + 1];  // + cold
    for (int i = threadIdx.x; i <= N_BINS; i += blockDim.x) s_hist[i] = 0;
    __syncthreads();
    block_rows<LV, NHMAX, TRI>(pr.desc, pr.hr, keys, mask, B, ld, rx, tri,
                               raw, residual, hist, cold, s_nb, s_hist);
}
#elif !defined(SAMPLED_HIST_ROWS_NHMAX)

// The buffer form: the descriptor in a device buffer of desc_len words,
// copied into the block's shared memory (the launch's dynamic shared
// memory, desc_len words) before the walk.
template <int LV, bool TRI>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM(3, TRI))
sampled_hist_kernel_buf(const i64* __restrict__ keys,
                        const unsigned char* __restrict__ mask, i64 B,
                        i64 ld, const __grid_constant__ ParamsBuf pr,
                        const i64* __restrict__ desc, int desc_len,
                        const i64* __restrict__ rx,
                        const i64* __restrict__ tri, bool raw,
                        i64* __restrict__ residual, u64* __restrict__ hist,
                        u64* __restrict__ cold) {
    extern __shared__ i64 s_desc[];
    __shared__ i64 s_nb[MAX_MEMBERS * THREADS];
    __shared__ u64 s_hist[N_BINS + 1];
    for (int i = threadIdx.x; i < desc_len; i += blockDim.x)
        s_desc[i] = desc[i];
    for (int i = threadIdx.x; i <= N_BINS; i += blockDim.x) s_hist[i] = 0;
    __syncthreads();
    block_rows<LV, 3, TRI>(s_desc, pr.hr, keys, mask, B, ld, rx, tri, raw,
                           residual, hist, cold, s_nb, s_hist);
}
#else

// The per-row form: row blockIdx.y's descriptor (dld words at
// descs + r * dld, zero-padded), its radix records (hrs + r * HR_WORDS)
// and, TRI, its base table (tris + r * tld), the first two staged in the
// block's shared memory (dld + HR_WORDS words of dynamic shared memory).
template <int LV, int NHMAX, bool TRI>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM(3, TRI))
sampled_hist_kernel_rows(const i64* __restrict__ keys,
                         const unsigned char* __restrict__ mask, i64 B,
                         i64 ld, const i64* __restrict__ descs, int dld,
                         const i64* __restrict__ hrs,
                         const i64* __restrict__ rx,
                         const i64* __restrict__ tris, i64 tld, bool raw,
                         i64* __restrict__ residual, u64* __restrict__ hist,
                         u64* __restrict__ cold) {
    extern __shared__ i64 s_desc[];
    __shared__ i64 s_nb[MAX_MEMBERS * THREADS];
    __shared__ u64 s_hist[N_BINS + 1];
    const i64 r = blockIdx.y;
    const i64* d = descs + r * dld;
    for (int i = threadIdx.x; i < dld; i += blockDim.x) s_desc[i] = d[i];
    i64* s_hr = s_desc + dld;
    for (int i = threadIdx.x; i < HR_WORDS; i += blockDim.x)
        s_hr[i] = hrs[r * HR_WORDS + i];
    for (int i = threadIdx.x; i <= N_BINS; i += blockDim.x) s_hist[i] = 0;
    __syncthreads();
    block_rows<LV, NHMAX, TRI>(s_desc, s_hr, keys, mask, B, ld, rx,
                               TRI ? tris + r * tld : nullptr, raw, residual,
                               hist, cold, s_nb, s_hist);
}
#endif

#define MAX_DEVICES 64
// Dynamic shared memory a launch may take without asking: 48 KB less the
// walk's static s_nb and s_hist.
#define DEFAULT_DYNAMIC_SMEM \
    (48 * 1024 - (MAX_MEMBERS * THREADS + N_BINS + 1) * sizeof(i64))

// The launch's grid: as many blocks as the card holds at once (`slots`),
// split over the R rows, no more per row than its lanes need.
static dim3 grid_of(int slots, i64 R, i64 B) {
    i64 bx = (slots + R - 1) / R;
    const i64 need = (B + THREADS - 1) / THREADS;
    if (bx > need) bx = need;
    if (bx < 1) bx = 1;
    return dim3((unsigned)bx, (unsigned)R);
}

// The card's SM count times `kernel`'s resident blocks per SM at `smem`
// bytes of dynamic shared memory; 0 and the error code where a query
// fails.
template <typename K>
static int resident_slots(K kernel, size_t smem, int* slots) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          THREADS, smem);
    *slots = per_sm * sms > 0 ? per_sm * sms : 1;
    return (int)e;
}

// Arguments either form refuses: a descriptor shorter than its header or
// past the form's limit, rows the grid cannot hold, a row stride below
// the row, a level or head count without an instantiation, and a base
// table where the nest is not triangular (or none where it is).
static bool bad_args(i64 R, i64 B, i64 ld, const i64* desc, int desc_len,
                     int limit, const void* tri) {
    return desc_len < D_HEADER || desc_len > limit || R < 1 || R > 65535
           || B < 1 || ld < B || desc[D_LV] < 0 || desc[D_LV] >= MAX_DEPTH
           || max_heads(desc) > MAX_DEPTH || (desc[D_TRI] != 0) != (tri != 0);
}

#ifndef SAMPLED_HIST_BUFFER_FORM
typedef int (*LaunchFn)(const void*, const void*, i64, i64, i64,
                        const Params&, const void*, const void*, bool, void*,
                        void*, void*, cudaStream_t);

#define LAUNCH_PARAMS                                                     \
    const void *keys, const void *mask, i64 R, i64 B, i64 ld,            \
        const Params &pr, const void *rx, const void *tri, bool raw,     \
        void *residual, void *hist, void *cold, cudaStream_t stream

template <int LV, int NHMAX, bool TRI>
int launch(LAUNCH_PARAMS) {
    // the resident blocks, asked once per device (0: not asked yet; every
    // thread that asks gets the same answer)
    static std::atomic<int> resident[MAX_DEVICES];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    int slots = resident[dev].load(std::memory_order_relaxed);
    if (slots == 0) {
        const int rc =
            resident_slots(sampled_hist_kernel<LV, NHMAX, TRI>, 0, &slots);
        if (rc != 0) return rc;
        resident[dev].store(slots, std::memory_order_relaxed);
    }
    sampled_hist_kernel<LV, NHMAX, TRI><<<grid_of(slots, R, B), THREADS, 0,
                                          stream>>>(
        (const i64*)keys, (const unsigned char*)mask, B, ld, pr, (const i64*)rx,
        (const i64*)tri, raw, (i64*)residual, (u64*)hist, (u64*)cold);
    return (int)cudaGetLastError();
}

// The library builds in two parts at once (ops/_build.py::PARTS): part 0
// (SAMPLED_HIST_TRI_PART 0) holds the rectangular instantiations, the
// table and the entry, part 1 the triangular ones, which part 0 declares
// `extern template` so that it compiles none of them; each kernel is
// the code one compile of all twelve gives it. A build without the
// define (one with -D flags, tools/b1_launch.py's) holds all twelve.
#define TRI_LAUNCHES(X) X(0, 1) X(0, 3) X(1, 1) X(1, 3) X(2, 1) X(2, 3)
#if defined(SAMPLED_HIST_TRI_PART) && SAMPLED_HIST_TRI_PART == 1
#define TRI_INSTANCE(LV, NH) template int launch<LV, NH, true>(LAUNCH_PARAMS);
TRI_LAUNCHES(TRI_INSTANCE)
#else
#if defined(SAMPLED_HIST_TRI_PART)
#define TRI_EXTERN(LV, NH) \
    extern template int launch<LV, NH, true>(LAUNCH_PARAMS);
TRI_LAUNCHES(TRI_EXTERN)
#endif

// [TRI][LV][0]: NHMAX 1 (groups of at most one head), [TRI][LV][1]:
// NHMAX 3
#define LAUNCH_ROW(LV, TRI) {launch<LV, 1, TRI>, launch<LV, 3, TRI>}
static const LaunchFn LAUNCH[2][MAX_DEPTH][2] = {
    {LAUNCH_ROW(0, false), LAUNCH_ROW(1, false), LAUNCH_ROW(2, false)},
    {LAUNCH_ROW(0, true), LAUNCH_ROW(1, true), LAUNCH_ROW(2, true)}};
// keys: int64 [R, B] on the card, row r at keys + r * ld (ld >= B: a
// column span of a wider buffer); mask: uint8 [R, B] with the same row
// stride, or null when every lane is live; residual: int64 [R, B],
// contiguous; desc: the HOST's int64 [desc_len]
// (build_descriptor); hrec: the host's int64 [9], the division records
// of the three radices; rx: int64 [R]; tri: for a triangular descriptor
// the base table, int64 [threads, lmax + 1] on the card (null
// otherwise); raw: nonzero for the raw-noshare form; hist: int64 [R, 64]
// and cold: int64 [R], both zeroed by the caller. Launches the instantiation of the descriptor's source-ref level
// (desc[D_LV]), most heads per group and nest kind on `stream`,
// allocates nothing, returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int sampled_hist_launch(const void* keys, const void* mask,
                                   i64 R, i64 B, i64 ld, const i64* desc,
                                   int desc_len, const i64* hrec,
                                   const void* rx, const void* tri, int raw,
                                   void* residual, void* hist, void* cold,
                                   void* stream) {
    if (bad_args(R, B, ld, desc, desc_len, MAX_DESC, tri))
        return (int)cudaErrorInvalidValue;
    Params pr;
    for (int i = 0; i < MAX_DEPTH * DIV_SIZE; ++i) pr.hr[i] = hrec[i];
    for (int i = 0; i < desc_len; ++i) pr.desc[i] = desc[i];
    return LAUNCH[desc[D_TRI] != 0][desc[D_LV]][max_heads(desc) > 1](
        keys, mask, R, B, ld, pr, rx, tri, raw != 0, residual, hist, cold,
        (cudaStream_t)stream);
}
#endif  // SAMPLED_HIST_TRI_PART

#elif !defined(SAMPLED_HIST_ROWS_NHMAX)
typedef int (*LaunchBufFn)(const void*, const void*, i64, i64, i64,
                           const ParamsBuf&, const void*, int, const void*,
                           const void*, bool, void*, void*, void*,
                           cudaStream_t);

template <int LV, bool TRI>
static int launch_buf(const void* keys, const void* mask, i64 R, i64 B,
                      i64 ld, const ParamsBuf& pr, const void* desc,
                      int desc_len, const void* rx, const void* tri, bool raw,
                      void* residual, void* hist, void* cold,
                      cudaStream_t stream) {
    // the resident blocks depend on the descriptor's shared bytes: asked
    // per launch (the buffer form is the rare one); past the default 48 KB
    // a launch may take, the kernel is allowed the descriptor's size first
    const size_t smem = (size_t)desc_len * sizeof(i64);
    if (smem > DEFAULT_DYNAMIC_SMEM) {
        const cudaError_t e = cudaFuncSetAttribute(
            sampled_hist_kernel_buf<LV, TRI>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    int slots = 0;
    const int rc =
        resident_slots(sampled_hist_kernel_buf<LV, TRI>, smem, &slots);
    if (rc != 0) return rc;
    sampled_hist_kernel_buf<LV, TRI><<<grid_of(slots, R, B), THREADS, smem,
                                       stream>>>(
        (const i64*)keys, (const unsigned char*)mask, B, ld, pr,
        (const i64*)desc, desc_len, (const i64*)rx, (const i64*)tri,
        raw, (i64*)residual, (u64*)hist, (u64*)cold);
    return (int)cudaGetLastError();
}

// [TRI][LV]
static const LaunchBufFn LAUNCH_BUF[2][MAX_DEPTH] = {
    {launch_buf<0, false>, launch_buf<1, false>, launch_buf<2, false>},
    {launch_buf<0, true>, launch_buf<1, true>, launch_buf<2, true>}};

// The buffer form: as sampled_hist_launch, with desc_dev the same
// desc_len words on the card (desc, the host's copy, picks the
// instantiation); any length from the header up.
extern "C" int sampled_hist_launch_buf(const void* keys, const void* mask,
                                       i64 R, i64 B, i64 ld, const i64* desc,
                                       int desc_len, const void* desc_dev,
                                       const i64* hrec, const void* rx,
                                       const void* tri, int raw,
                                       void* residual, void* hist, void* cold,
                                       void* stream) {
    if (desc_dev == nullptr
        || bad_args(R, B, ld, desc, desc_len, 0x7fffffff, tri))
        return (int)cudaErrorInvalidValue;
    ParamsBuf pr;
    for (int i = 0; i < MAX_DEPTH * DIV_SIZE; ++i) pr.hr[i] = hrec[i];
    return LAUNCH_BUF[desc[D_TRI] != 0][desc[D_LV]](
        keys, mask, R, B, ld, pr, desc_dev, desc_len, rx, tri, raw != 0,
        residual, hist, cold, (cudaStream_t)stream);
}

#else
typedef int (*LaunchRowsFn)(const void*, const void*, i64, i64, i64,
                            const void*, int, const void*, const void*,
                            const void*, i64, bool, void*, void*, void*,
                            cudaStream_t);

template <int LV, int NHMAX, bool TRI>
static int launch_rows(const void* keys, const void* mask, i64 R, i64 B,
                       i64 ld, const void* descs, int dld, const void* hrs,
                       const void* rx, const void* tris, i64 tld, bool raw,
                       void* residual, void* hist, void* cold,
                       cudaStream_t stream) {
    // as launch_buf: the shared bytes are the longest row's descriptor
    // and its radix records, asked per launch
    const size_t smem = (size_t)(dld + HR_WORDS) * sizeof(i64);
    if (smem > DEFAULT_DYNAMIC_SMEM) {
        const cudaError_t e = cudaFuncSetAttribute(
            sampled_hist_kernel_rows<LV, NHMAX, TRI>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    int slots = 0;
    const int rc = resident_slots(sampled_hist_kernel_rows<LV, NHMAX, TRI>,
                                  smem, &slots);
    if (rc != 0) return rc;
    sampled_hist_kernel_rows<LV, NHMAX, TRI>
        <<<grid_of(slots, R, B), THREADS, smem, stream>>>(
            (const i64*)keys, (const unsigned char*)mask, B, ld,
            (const i64*)descs, dld, (const i64*)hrs, (const i64*)rx,
            (const i64*)tris, tld, raw, (i64*)residual, (u64*)hist,
            (u64*)cold);
    return (int)cudaGetLastError();
}

// [TRI][LV], this part's NHMAX
#define NH SAMPLED_HIST_ROWS_NHMAX
static const LaunchRowsFn LAUNCH_ROWS[2][MAX_DEPTH] = {
    {launch_rows<0, NH, false>, launch_rows<1, NH, false>,
     launch_rows<2, NH, false>},
    {launch_rows<0, NH, true>, launch_rows<1, NH, true>,
     launch_rows<2, NH, true>}};
#undef NH
#define ROWS_ENTRY_(n) sampled_hist_launch_rows##n
#define ROWS_ENTRY(n) ROWS_ENTRY_(n)

// The per-row form: keys, mask, R, B, ld, rx, raw, residual, hist and
// cold as sampled_hist_launch; descs: the HOST's int64 [R, dld], row r
// row r's descriptor zero-padded to dld words (which pick and check the
// instantiation), descs_dev the same words on the card; hrs_dev: int64
// [R, HR_WORDS] on the card, row r's radix records; tris_dev: for
// triangular rows, int64 [R, tld] on the card, row r's base table
// (null otherwise). The entry of this part, sampled_hist_launch_rows1 or
// sampled_hist_launch_rows3, takes the rows whose NHMAX is its own.
extern "C" int ROWS_ENTRY(SAMPLED_HIST_ROWS_NHMAX)(
    const void* keys, const void* mask, i64 R, i64 B, i64 ld,
    const i64* descs, int dld, const void* descs_dev, const void* hrs_dev,
    const void* rx, const void* tris_dev, i64 tld, int raw, void* residual,
    void* hist, void* cold, void* stream) {
    int lv = 0, tri = 0, nh = 0;
    if (descs_dev == nullptr || hrs_dev == nullptr
        || rows_args(R, B, ld, descs, dld, tris_dev, tld, &lv, &tri, &nh)
        || (nh > 1 ? 3 : 1) != SAMPLED_HIST_ROWS_NHMAX)
        return (int)cudaErrorInvalidValue;
    return LAUNCH_ROWS[tri][lv](
        keys, mask, R, B, ld, descs_dev, dld, hrs_dev, rx, tris_dev, tld,
        raw != 0, residual, hist, cold, (cudaStream_t)stream);
}
#endif

#else

template <int LV, int NHMAX, bool TRI>
static void host_rows(const i64* keys, const unsigned char* mask, i64 R,
                      i64 B, const i64* desc, const i64* hrec,
                      const i64* rx, const i64* tri, bool raw,
                      i64* residual, i64* hist, i64* cold) {
    i64 nb[MAX_MEMBERS];
    for (i64 r = 0; r < R; ++r) {
        for (i64 b = 0; b < B; ++b) {
            const i64 i = r * B + b;
            const bool mk = mask == nullptr || mask[i] != 0;
            const int bin = sample_step<LV, NHMAX, TRI>(
                desc, tri, keys[i], mk, hrec, rx[r], nb, raw, residual + i);
            if (bin == N_BINS) cold[r] += 1;
            else if (bin >= 0) hist[r * N_BINS + bin] += 1;
        }
    }
}

typedef void (*HostFn)(const i64*, const unsigned char*, i64, i64,
                       const i64*, const i64*, const i64*, const i64*, bool,
                       i64*, i64*, i64*);
#define HOST_ROW(LV, TRI) {host_rows<LV, 1, TRI>, host_rows<LV, 3, TRI>}
static const HostFn HOST[2][MAX_DEPTH][2] = {
    {HOST_ROW(0, false), HOST_ROW(1, false), HOST_ROW(2, false)},
    {HOST_ROW(0, true), HOST_ROW(1, true), HOST_ROW(2, true)}};

// Serial host twin of the kernel, same arguments minus the row stride and
// the stream (tri on the host), and through the same instantiation.
extern "C" int sampled_hist_host(const i64* keys, const unsigned char* mask,
                                 i64 R, i64 B, const i64* desc,
                                 int desc_len, const i64* hrec,
                                 const i64* rx, const i64* tri, int raw,
                                 i64* residual, i64* hist, i64* cold) {
    if (desc_len < D_HEADER || desc_len > MAX_DESC || R < 1 || B < 1
        || desc[D_LV] < 0 || desc[D_LV] >= MAX_DEPTH
        || max_heads(desc) > MAX_DEPTH || (desc[D_TRI] != 0) != (tri != 0))
        return 1;
    HOST[desc[D_TRI] != 0][desc[D_LV]][max_heads(desc) > 1](
        keys, mask, R, B, desc, hrec, rx, tri, raw != 0, residual, hist,
        cold);
    return 0;
}

// Serial host twin of the buffer form: any descriptor length, the
// instantiation with NHMAX 3, the descriptor read from a copy, as each
// block of the card reads its shared copy.
extern "C" int sampled_hist_host_buf(const i64* keys,
                                     const unsigned char* mask, i64 R, i64 B,
                                     const i64* desc, int desc_len,
                                     const i64* hrec, const i64* rx,
                                     const i64* tri, int raw, i64* residual,
                                     i64* hist, i64* cold) {
    if (desc_len < D_HEADER || R < 1 || B < 1 || desc[D_LV] < 0
        || desc[D_LV] >= MAX_DEPTH || max_heads(desc) > MAX_DEPTH
        || (desc[D_TRI] != 0) != (tri != 0))
        return 1;
    const std::vector<i64> staged(desc, desc + desc_len);
    HOST[desc[D_TRI] != 0][desc[D_LV]][1](keys, mask, R, B, staged.data(),
                                          hrec, rx, tri, raw != 0, residual,
                                          hist, cold);
    return 0;
}

// Serial host twin of the per-row form: sampled_hist_launch_rows'
// arguments but the row stride, the device copies and the stream (keys
// and mask rows contiguous, descs [R, dld], hrs [R, HR_WORDS] and tris
// [R, tld] on the host); row r through the launch's one instantiation
// with its own staged descriptor, records and base table.
extern "C" int sampled_hist_host_rows(const i64* keys,
                                      const unsigned char* mask, i64 R,
                                      i64 B, const i64* descs, int dld,
                                      const i64* hrs, const i64* rx,
                                      const i64* tris, i64 tld, int raw,
                                      i64* residual, i64* hist, i64* cold) {
    int lv = 0, tri = 0, nh = 0;
    if (rows_args(R, B, B, descs, dld, tris, tld, &lv, &tri, &nh)) return 1;
    const HostFn fn = HOST[tri][lv][nh > 1];
    for (i64 r = 0; r < R; ++r) {
        const std::vector<i64> staged(descs + r * dld,
                                      descs + (r + 1) * dld);
        fn(keys + r * B, mask ? mask + r * B : nullptr, 1, B, staged.data(),
           hrs + r * HR_WORDS, rx + r, tri ? tris + r * tld : nullptr,
           raw != 0, residual + r * B, hist + r * N_BINS, cold + r);
    }
    return 0;
}

// q = floor(a / d) and r = a - d * q for n numerators by one division
// record, through the kernel's own routine.
extern "C" void sampled_hist_divmod(const i64* a, i64 n, const i64* rec,
                                    i64* q, i64* r) {
    for (i64 i = 0; i < n; ++i) {
        q[i] = floordiv_rec(a[i], rec);
        r[i] = floormod_rec(a[i], q[i], rec);
    }
}

#endif
