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
//
// Design. The Pallas kernel was traced per kernel signature, with the
// classify's structure baked in. Here one build serves every
// rectangular signature: the host packs the structure (schedule, loop
// starts and steps, the ref tables, and each sink group's band plan)
// into a small int64 descriptor (ops/sampled_hist.py::build_descriptor)
// that every block copies into shared memory and every thread walks.
// One thread per sample, a grid-stride loop per member ref (grid.y).
// The TPU kernel's comparison ladder becomes a direct bin by clz into
// a per-block shared histogram; one global atomicAdd per bin per block
// flushes it. Integer sums do not depend on order, so the result is
// exact. Every division that can see a negative numerator or divisor
// floors (floordiv_i64/floormod_i64), as jnp and torch do.
//
// Bound on an H100: per sample it reads an 8 B key (and a 1 B mask
// where the caller passes one; the engine's dispatches pass none) and
// writes an 8 B residual, while the classify costs 600 to 1,500 int64
// operations at GEMM's signatures (ops/sampled_hist.py::ops_per_sample
// counts them) and the card has no int64 ALU. So it is bound by integer
// operations, not bytes: the design keeps each sample's whole classify
// in registers and writes nothing to memory but the residual and the
// per-block histogram. No TMA and no wgmma: this is the simple, exact
// version, and speed comes in a later change.
//
// The same file compiles as plain C++ (no __CUDACC__): it then exports
// sampled_hist_host, a serial loop over the same per-sample code, which
// the CPU tests build with g++ to check the descriptor walk.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD static inline
#endif

typedef long long i64;

// Leading zeros of x > 0: the device intrinsic on the card, the builtin
// in the host compilation passes.
HD int clz64(i64 x) {
#ifdef __CUDA_ARCH__
    return __clzll(x);
#else
    return __builtin_clzll((unsigned long long)x);
#endif
}

#define INF_I64 (1LL << 62)
#define SENTINEL (1LL << 62)
#define RATIO_SLOTS 16
#define NOSHARE_SLOT 15
#define N_BINS 64
#define MAX_DESC 2048
#define MAX_MEMBERS 8
#define MAX_DEPTH 3

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
#define D_HEADER 34
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
#define H_LEVEL 0
#define H_NU 1
#define H_CV 2
#define H_RMIN 3
#define H_RMAX 4
#define H_SIZE 5
#define G_MEMBERS (G_HEADS + MAX_DEPTH * H_SIZE)
#define TERM_CHECK 0
#define TERM_INTERVAL 1
#define TERM_WINDOW 2

HD i64 floordiv_i64(i64 a, i64 b) {
    i64 q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
    return q;
}

HD i64 floormod_i64(i64 a, i64 b) {
    i64 r = a % b;
    if (r != 0 && ((r < 0) != (b < 0))) r += b;
    return r;
}

HD i64 cdiv_i64(i64 a, i64 b) { return -floordiv_i64(-a, b); }
HD i64 min_i64(i64 a, i64 b) { return a < b ? a : b; }
HD i64 max_i64(i64 a, i64 b) { return a > b ? a : b; }

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

HD i64 spec_min_gt(const Spec& s, i64 x) {
    if (s.kind == SPEC_FIXED) return (s.valid && s.a > x) ? s.a : INF_I64;
    if (s.kind == SPEC_INTERVAL) {
        i64 nxt = max_i64(s.a, x + 1);
        return nxt < s.b ? nxt : INF_I64;
    }
    i64 nxt = max_i64(0, x + 1);
    return nxt < s.a ? nxt : INF_I64;
}

HD i64 spec_eq(const Spec& s, i64 x) {
    if (s.kind == SPEC_FIXED) return (s.valid && s.a == x) ? x : INF_I64;
    if (s.kind == SPEC_INTERVAL) return (x >= s.a && x < s.b) ? x : INF_I64;
    return (x >= 0 && x < s.a) ? x : INF_I64;
}

HD i64 spec_min_scaled_gt(const Spec& s, i64 scale, i64 x) {
    if (s.kind == SPEC_FIXED)
        return (s.valid && s.a * scale > x) ? s.a : INF_I64;
    i64 lo = s.kind == SPEC_INTERVAL ? s.a : 0;
    i64 hi = s.kind == SPEC_INTERVAL ? s.b : s.a;
    i64 nxt = max_i64(lo, floordiv_i64(x, scale) + 1);
    return nxt < hi ? nxt : INF_I64;
}

// Position of ref `off` at (m, n1, n2), INF when any part is INF
// (nextuse.py::min_position_after's pos + guard).
HD i64 guarded_pos(const i64* d, int lv, i64 off, i64 m, i64 n1, i64 n2) {
    if (m >= INF_I64 || n1 >= INF_I64 || n2 >= INF_I64) return INF_I64;
    i64 p = m * d[D_ACC] + off;
    if (lv >= 1) p += d[D_NPRE0] + n1 * d[D_ACC + 1];
    if (lv >= 2) p += d[D_NPRE1] + n2 * d[D_ACC + 2];
    return p;
}

// nextuse.py::min_position_after: minimal position of a sink (level lv,
// body offset off) strictly after p0 over the level box `sp`.
HD i64 min_position_after(const i64* d, int lv, i64 off, i64 p0,
                          const Spec* sp) {
    i64 a0 = d[D_ACC];
    i64 m0 = floordiv_i64(p0, a0);
    i64 r0 = p0 - m0 * a0;
    if (lv == 0) {
        i64 pa = guarded_pos(d, 0, off, spec_min_gt(sp[0], m0), 0, 0);
        i64 pb = guarded_pos(d, 0, off, spec_eq(sp[0], m0), 0, 0);
        return min_i64(pa, pb > p0 ? pb : INF_I64);
    }
    i64 np0 = d[D_NPRE0], np1 = d[D_NPRE1];
    i64 a1 = d[D_ACC + 1];
    i64 j0 = floordiv_i64(r0 - np0, a1);
    i64 rr0 = r0 - np0 - j0 * a1;
    i64 mA = spec_min_gt(sp[0], m0);
    i64 mB = spec_eq(sp[0], m0);
    if (lv == 1) {
        i64 pa = guarded_pos(d, 1, off, mA, spec_min_val(sp[1]), 0);
        i64 pb = guarded_pos(d, 1, off, mB, spec_min_gt(sp[1], j0), 0);
        i64 pc = guarded_pos(d, 1, off, mB, spec_eq(sp[1], j0), 0);
        return min_i64(min_i64(pa, pb), pc > p0 ? pc : INF_I64);
    }
    i64 a2 = d[D_ACC + 2];
    i64 n2min = spec_min_val(sp[2]);
    i64 pa = guarded_pos(d, 2, off, mA, spec_min_val(sp[1]), n2min);
    i64 pb = guarded_pos(d, 2, off, mB, spec_min_gt(sp[1], j0), n2min);
    // need np1 + n2*a2 + off > rr0
    i64 n2c = spec_min_scaled_gt(sp[2], a2, rr0 - np1 - off);
    i64 pc = guarded_pos(d, 2, off, mB, spec_eq(sp[1], j0), n2c);
    return min_i64(min_i64(pa, pb), pc > p0 ? pc : INF_I64);
}

// Per-sample state of one sink group's candidate walk.
struct GroupWalk {
    const i64* d;
    const i64* g;
    int level;     // sink level
    i64 tid, p0;
    int fk[MAX_DEPTH];  // 0 free, 1 fixval, 2 interval (value space)
    i64 fa[MAX_DEPTH], fb[MAX_DEPTH];
    i64 bests[MAX_MEMBERS];
};

HD i64 owner_tid(const i64* d, i64 n) {
    return floormod_i64(floordiv_i64(n, d[D_CHUNK]), d[D_THREADS]);
}

HD i64 local_index(const i64* d, i64 n) {
    i64 c = d[D_CHUNK];
    return floordiv_i64(n, c * d[D_THREADS]) * c + floormod_i64(n, c);
}

// nextuse.py::next_use_candidates_group's emit: assemble the level box
// of one candidate and reduce every member sink over it.
HD void emit(GroupWalk& w, bool ok, bool any_fixed) {
    const i64* d = w.d;
    Spec sp[MAX_DEPTH];
    for (int l = 0; l <= w.level; ++l) {
        i64 start = d[D_LSTART + l], step = d[D_LSTEP + l];
        i64 trip = d[D_TRIPS + l];
        if (w.fk[l] == 2) {
            i64 n_lo = max_i64(w.fa[l] - start, 0);
            i64 n_hi = min_i64(w.fb[l] - start, trip);
            sp[l].kind = SPEC_INTERVAL;
            sp[l].valid = true;
            sp[l].a = n_lo;
            sp[l].b = ok ? n_hi : n_lo;
        } else if (w.fk[l] == 1) {
            i64 rel = w.fa[l] - start;
            i64 n = floordiv_i64(rel, step);
            bool okv = ok && floormod_i64(rel, step) == 0 && n >= 0
                       && n < trip;
            sp[l].kind = SPEC_FIXED;
            sp[l].b = 0;
            if (l == 0) {
                okv = okv && owner_tid(d, n) == w.tid;
                sp[l].a = local_index(d, n);
            } else {
                sp[l].a = n;
            }
            sp[l].valid = okv;
        } else {
            sp[l].kind = SPEC_FREE;
            sp[l].valid = true;
            sp[l].a = l == 0 ? d[d[D_OFF_LC] + w.tid] : trip;
            sp[l].b = 0;
        }
    }
    const i64* refs = d + d[D_OFF_REFS];
    int nm = (int)w.g[G_NMEM];
    for (int jj = 0; jj < MAX_MEMBERS; ++jj) {
        if (jj >= nm) break;
        i64 j = w.g[G_MEMBERS + jj];
        i64 p = min_position_after(d, w.level, refs[j * R_SIZE + R_OFF],
                                   w.p0, sp);
        if (!any_fixed && !ok) p = INF_I64;
        w.bests[jj] = min_i64(w.bests[jj], p);
    }
}

// The terminal node of the band plan (nextuse.py::_band_candidates).
HD void terminal(GroupWalk& w, i64 lo_cur, bool ok) {
    const i64* g = w.g;
    i64 W = w.d[D_W];
    int term = (int)g[G_TERM];
    bool any_fixed = g[G_NHEADS] > 0 || term != TERM_CHECK;
    if (term == TERM_CHECK) {
        emit(w, ok && lo_cur <= 0 && lo_cur > -W, any_fixed);
        return;
    }
    int l = (int)g[G_TLEVEL];
    if (term == TERM_INTERVAL) {
        w.fk[l] = 2;
        w.fa[l] = lo_cur;
        w.fb[l] = lo_cur + W;
        emit(w, ok, true);
    } else {
        w.fk[l] = 1;
        for (i64 k = 0; k < g[G_TW]; ++k) {
            w.fa[l] = lo_cur + k;
            emit(w, ok, true);
        }
    }
    w.fk[l] = 0;
}

// One head node: enumerate its n_u values, then recurse by hand (the
// plan has at most MAX_DEPTH heads).
HD void head_bounds(const i64* h, i64 lo_cur, i64 W, i64* u_min,
                    i64* u_max) {
    i64 cv = h[H_CV];
    *u_min = cdiv_i64(lo_cur - h[H_RMAX], cv);
    *u_max = floordiv_i64(lo_cur + W - 1 - h[H_RMIN], cv);
}

HD void walk_group(GroupWalk& w, i64 line) {
    const i64* g = w.g;
    i64 W = w.d[D_W];
    int nh = (int)g[G_NHEADS];
    for (int l = 0; l < MAX_DEPTH; ++l) w.fk[l] = 0;
    i64 lo = line * W - g[G_CONST];
    if (nh == 0) {
        terminal(w, lo, true);
        return;
    }
    const i64* h0 = g + G_HEADS;
    const i64* h1 = h0 + H_SIZE;
    const i64* h2 = h1 + H_SIZE;
    int l0 = (int)h0[H_LEVEL], l1 = (int)h1[H_LEVEL], l2 = (int)h2[H_LEVEL];
    i64 u0min, u0max;
    head_bounds(h0, lo, W, &u0min, &u0max);
    for (i64 i0 = 0; i0 < h0[H_NU]; ++i0) {
        i64 u0 = u0min + i0;
        i64 lo1 = lo - h0[H_CV] * u0;
        bool ok1 = u0 <= u0max;
        w.fk[l0] = 1;
        w.fa[l0] = u0;
        if (nh == 1) {
            terminal(w, lo1, ok1);
            continue;
        }
        i64 u1min, u1max;
        head_bounds(h1, lo1, W, &u1min, &u1max);
        for (i64 i1 = 0; i1 < h1[H_NU]; ++i1) {
            i64 u1 = u1min + i1;
            i64 lo2 = lo1 - h1[H_CV] * u1;
            bool ok2 = ok1 && u1 <= u1max;
            w.fk[l1] = 1;
            w.fa[l1] = u1;
            if (nh == 2) {
                terminal(w, lo2, ok2);
                continue;
            }
            i64 u2min, u2max;
            head_bounds(h2, lo2, W, &u2min, &u2max);
            for (i64 i2 = 0; i2 < h2[H_NU]; ++i2) {
                i64 u2 = u2min + i2;
                w.fk[l2] = 1;
                w.fa[l2] = u2;
                terminal(w, lo2 - h2[H_CV] * u2, ok2 && u2 <= u2max);
            }
            w.fk[l2] = 0;
        }
        w.fk[l1] = 0;
    }
}

// sampled.py::classify_samples for one sample: decode, geometry, the
// best sink over every group, and the share test.
HD void classify_one(const i64* d, i64 key, i64 h0, i64 h1, i64 h2,
                     i64 rx, i64* packed, i64* ri_out, bool* share,
                     bool* found) {
    // decode_sample_keys: innermost level first
    i64 n[MAX_DEPTH];
    n[2] = floormod_i64(key, h2);
    key = floordiv_i64(key, h2);
    n[1] = floormod_i64(key, h1);
    key = floordiv_i64(key, h1);
    n[0] = floormod_i64(key, h0);
    int lv = (int)d[D_LV];
    // _sample_geometry
    i64 tid = owner_tid(d, n[0]);
    i64 m = local_index(d, n[0]);
    i64 v0 = d[D_S_START] + n[0] * d[D_S_STEP];
    const i64* refs = d + d[D_OFF_REFS];
    const i64* rr = refs + rx * R_SIZE;
    i64 p0 = m * d[D_ACC] + rr[R_OFF];
    if (lv >= 1) p0 += d[D_NPRE0] + n[1] * d[D_ACC + 1];
    if (lv >= 2) p0 += d[D_NPRE1] + n[2] * d[D_ACC + 2];
    i64 flat = rr[R_CONST] + v0 * rr[R_COEFF];
    for (int l = 1; l <= lv; ++l) {
        i64 vl = d[D_STARTB + l] + d[D_SC + l] * v0 + n[l] * d[D_LSTEP + l];
        flat += vl * rr[R_COEFF + l];
    }
    i64 line = floordiv_i64(flat * d[D_DS], d[D_CLS]);
    // _best_sink
    i64 best = INF_I64, best_sink = 0;
    const i64* g = d + d[D_OFF_GROUPS];
    int ng = (int)d[D_NGROUPS];
    GroupWalk w;
    w.d = d;
    w.tid = tid;
    w.p0 = p0;
    for (int gi = 0; gi < ng; ++gi) {
        w.g = g;
        w.level = (int)g[G_LEVEL];
        int nm = (int)g[G_NMEM];
        for (int jj = 0; jj < MAX_MEMBERS; ++jj) w.bests[jj] = INF_I64;
        walk_group(w, line);
        for (int jj = 0; jj < MAX_MEMBERS; ++jj) {
            if (jj >= nm) break;
            if (w.bests[jj] < best) {
                best = w.bests[jj];
                best_sink = g[G_MEMBERS + jj];
            }
        }
        g += G_MEMBERS + nm;
    }
    bool fnd = best < INF_I64;
    i64 ri = fnd ? best - p0 : 0;
    i64 thr = refs[best_sink * R_SIZE + R_THR];
    i64 dthr = ri - thr;
    bool shr = fnd && thr > 0 && (ri < 0 ? -ri : ri) > (dthr < 0 ? -dthr : dthr);
    i64 slot = shr ? refs[best_sink * R_SIZE + R_RATIO] : NOSHARE_SLOT;
    *packed = ri * RATIO_SLOTS + slot;
    *ri_out = ri;
    *share = shr;
    *found = fnd;
}

// One sample's contribution: residual lane, histogram bin, cold count.
// Returns the bin (0..63) of a noshare ri >= 1 sample, 64 for a cold
// sample, -1 otherwise.
HD int sample_step(const i64* d, i64 key, bool mk, i64 h0, i64 h1, i64 h2,
                   i64 rx, i64* residual) {
    if (!mk) {  // masked-out lane: nothing but the sentinel
        *residual = SENTINEL;
        return -1;
    }
    i64 packed, ri;
    bool shr, fnd;
    classify_one(d, key, h0, h1, h2, rx, &packed, &ri, &shr, &fnd);
    bool nosh = fnd && !shr && ri >= 1;
    *residual = (fnd && !nosh) ? packed : SENTINEL;
    if (nosh) return 63 - clz64(ri);
    return fnd ? -1 : N_BINS;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(256)
sampled_hist_kernel(const i64* __restrict__ keys,
                    const unsigned char* __restrict__ mask, i64 B,
                    const i64* __restrict__ desc, int desc_len, i64 h0,
                    i64 h1, i64 h2, const i64* __restrict__ rx,
                    i64* __restrict__ residual,
                    unsigned long long* __restrict__ hist,
                    unsigned long long* __restrict__ cold) {
    __shared__ i64 s_desc[MAX_DESC];
    __shared__ unsigned long long s_hist[N_BINS + 1];  // + cold
    for (int i = threadIdx.x; i < desc_len; i += blockDim.x)
        s_desc[i] = desc[i];
    for (int i = threadIdx.x; i <= N_BINS; i += blockDim.x) s_hist[i] = 0;
    __syncthreads();
    const i64 r = blockIdx.y;
    const i64 rxv = rx[r];
    const i64 base = r * B;
    for (i64 b = (i64)blockIdx.x * blockDim.x + threadIdx.x; b < B;
         b += (i64)gridDim.x * blockDim.x) {
        bool mk = mask == nullptr || mask[base + b] != 0;
        int bin = sample_step(s_desc, keys[base + b], mk, h0, h1, h2, rxv,
                              residual + base + b);
        if (bin >= 0) atomicAdd(&s_hist[bin], 1ULL);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < N_BINS; i += blockDim.x)
        if (s_hist[i]) atomicAdd(&hist[r * N_BINS + i], s_hist[i]);
    if (threadIdx.x == 0 && s_hist[N_BINS])
        atomicAdd(&cold[r], s_hist[N_BINS]);
}

// keys/residual: int64 [R, B]; mask: uint8 [R, B], or null when every
// lane is live; desc: int64
// [desc_len]; rx: int64 [R]; hist: int64 [R, 64] and cold: int64 [R],
// both zeroed by the caller. Launches on `stream`, allocates nothing,
// returns cudaGetLastError() (or cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int sampled_hist_launch(const void* keys, const void* mask,
                                   i64 R, i64 B, const void* desc,
                                   int desc_len, i64 h0, i64 h1, i64 h2,
                                   const void* rx, void* residual,
                                   void* hist, void* cold, void* stream) {
    if (desc_len > MAX_DESC || R < 1 || R > 65535 || B < 1)
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    i64 bx = (B + threads - 1) / threads;
    if (bx > 1024) bx = 1024;
    dim3 grid((unsigned)bx, (unsigned)R);
    sampled_hist_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const i64*)keys, (const unsigned char*)mask, B, (const i64*)desc,
        desc_len, h0, h1, h2, (const i64*)rx, (i64*)residual,
        (unsigned long long*)hist, (unsigned long long*)cold);
    return (int)cudaGetLastError();
}

#else

// Serial host twin of the kernel, same arguments minus the stream.
extern "C" int sampled_hist_host(const i64* keys, const unsigned char* mask,
                                 i64 R, i64 B, const i64* desc,
                                 int desc_len, i64 h0, i64 h1, i64 h2,
                                 const i64* rx, i64* residual, i64* hist,
                                 i64* cold) {
    if (desc_len > MAX_DESC || R < 1 || B < 1) return 1;
    for (i64 r = 0; r < R; ++r) {
        for (i64 b = 0; b < B; ++b) {
            i64 i = r * B + b;
            bool mk = mask == nullptr || mask[i] != 0;
            int bin = sample_step(desc, keys[i], mk, h0, h1, h2, rx[r],
                                  residual + i);
            if (bin == N_BINS) cold[r] += 1;
            else if (bin >= 0) hist[r * N_BINS + bin] += 1;
        }
    }
    return 0;
}

#endif
