// Native sampler runtime (serial + thread-parallel).
//
// C++ twin of the reference's generated samplers + runtime-v1
// histogram layer (c_lib/test/sampler/gemm-t4-pluss-pro-model-ri-omp-seq.cpp,
// c_lib/test/runtime/pluss_utils.h), generalized over the loop-nest IR
// (pluss_sampler_optimization_tpu/ir.py) instead of generated per
// benchmark. It plays three roles:
//
// 1. fast oracle: bit-exact against the Python serial oracle
//    (oracle/serial.py) at any size, hundreds of times faster — large-N
//    parity tests for the TPU engines anchor on it;
// 2. speed baseline: its single-core walk is the reference protocol's
//    "serial C++ sampler" (BASELINE.md) that bench.py compares the TPU
//    engines against;
// 3. parallel native engine: pluss_run(parallel=1) runs one std::thread
//    per *simulated* thread — the execution model of the reference's
//    `ri` variant (#pragma omp parallel for over tids, ...ri.cpp:67)
//    done with the thread-local-histogram + merge-at-join reduction
//    that is the reference's only genuinely race-free design
//    (src/unsafe_utils.rs:32-35,105-151). Every piece of sampler state
//    is tid-owned, so the output is bit-identical to the serial walk.
//
// The walk mirrors the reference exactly: per simulated thread, chunks
// in static dispatch order (pluss_utils.h:410-425), the body reference
// sequence in program order, a per-(thread, array) last-access-time
// hash map (LAT_*, ...ri-omp-seq.cpp:47-49), reuse = count[tid] - LAT
// (:110), share classification |reuse-0| vs |reuse-thr| (:203-207),
// noshare pow2-binned on insertion (pluss_utils.h:924-927, share kept
// raw :928-937), and the per-nest -1 flush + LAT clear (:303-319).
//
// Exposed as a flat-array C ABI consumed via ctypes (native/__init__.py).

#include <algorithm>
#include <array>
#include <atomic>
#include <cstdint>
#include <map>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kMaxDepth = 3;
constexpr int kNoShareBins = 64;  // pow2 exponent bins
constexpr int kColdBin = kNoShareBins;  // the -1 flush bin
constexpr int kNoShareSlots = kNoShareBins + 1;

struct Ref {
  int64_t level;
  std::array<int64_t, kMaxDepth> coeffs;
  int64_t cnst;
  int64_t array;
  int64_t slot;  // 0 = pre, 1 = post
  int64_t share_threshold;  // -1 = thread-private
  int64_t share_ratio;
};

struct Nest {
  int64_t depth;
  std::array<int64_t, kMaxDepth> trips, starts, steps;
  // triangular bounds: affine-in-parallel-value coefficients, 0 when
  // rectangular (ir.py::Loop.trip_at / start_at)
  std::array<int64_t, kMaxDepth> trip_coeffs, start_coeffs;
  // refs grouped per (level, slot), program order preserved
  std::array<std::vector<Ref>, kMaxDepth> pre, post;
};

struct State {
  int64_t thread_num, chunk_size, ds, cls, n_arrays;
  std::vector<int64_t> count;  // per-tid access clock (runs across nests)
  // LAT[tid * n_arrays + array]: line -> last access position
  std::vector<std::unordered_map<int64_t, int64_t>> lat;
  // noshare_bins[tid * kNoShareSlots + bin]
  int64_t* noshare_bins;
  // per-tid share[(ratio, raw reuse)] -> count. Keeping the maps
  // tid-local makes the parallel walk race-free by construction (the
  // TLS + merge-at-join reduction); the serial walk uses the same
  // layout so both paths emit identically ordered output.
  std::vector<std::map<std::array<int64_t, 2>, int64_t>> share;
};

inline int pow2_bin(int64_t reuse) {
  // _polybench_to_highest_power_of_two (pluss_utils.h:665-679): the bin
  // key is 1 << (63 - clz(reuse)); we store the exponent.
  return 63 - __builtin_clzll(static_cast<uint64_t>(reuse));
}

// `clock` is the thread's access counter, kept in a walk-local instead
// of s.count[tid]: the per-tid counters share cache lines, and the
// clock increments on EVERY simulated access — through the vector it
// would ping-pong between cores and erase the parallel walk's scaling.
inline void access(State& s, int64_t tid, const Ref& r,
                   const int64_t* ivs, int64_t& clock) {
  int64_t flat = r.cnst;
  for (int64_t l = 0; l <= r.level; ++l) flat += r.coeffs[l] * ivs[l];
  const int64_t addr = flat * s.ds / s.cls;
  auto& table = s.lat[tid * s.n_arrays + r.array];
  auto it = table.find(addr);
  if (it != table.end()) {
    const int64_t reuse = clock - it->second;
    bool is_share = false;
    if (r.share_threshold >= 0) {
      // distance_to(reuse, 0) > distance_to(reuse, threshold)
      const int64_t d0 = reuse < 0 ? -reuse : reuse;
      const int64_t dt = reuse - r.share_threshold < 0
                             ? r.share_threshold - reuse
                             : reuse - r.share_threshold;
      is_share = d0 > dt;
    }
    if (is_share) {
      s.share[tid][{r.share_ratio, reuse}] += 1;
    } else {
      s.noshare_bins[tid * kNoShareSlots + pow2_bin(reuse)] += 1;
    }
    it->second = clock;
  } else {
    table.emplace(addr, clock);
  }
  clock += 1;
}

void body(State& s, const Nest& nest, int64_t tid, int64_t level,
          int64_t* ivs, int64_t& clock) {
  for (const Ref& r : nest.pre[level]) access(s, tid, r, ivs, clock);
  if (level + 1 < nest.depth) {
    // triangular levels: bounds affine in the parallel value ivs[0]
    const int64_t trip =
        std::max<int64_t>(0, nest.trips[level + 1] +
                                 nest.trip_coeffs[level + 1] * ivs[0]);
    const int64_t start =
        nest.starts[level + 1] + nest.start_coeffs[level + 1] * ivs[0];
    const int64_t step = nest.steps[level + 1];
    for (int64_t n = 0; n < trip; ++n) {
      ivs[level + 1] = start + n * step;
      body(s, nest, tid, level + 1, ivs, clock);
    }
  }
  for (const Ref& r : nest.post[level]) access(s, tid, r, ivs, clock);
}

// One simulated thread's full chunk walk over one nest
// (getNextStaticChunk order, pluss_utils.h:410-425). Touches only
// tid-owned state, so it is safe to run tids concurrently.
void walk_tid(State& s, const Nest& nest, int64_t tid) {
  const int64_t trip0 = nest.trips[0];
  const int64_t n_chunks = (trip0 + s.chunk_size - 1) / s.chunk_size;
  int64_t clock = s.count[tid];  // clocks run across nests
  for (int64_t cid = tid; cid < n_chunks; cid += s.thread_num) {
    const int64_t lo = cid * s.chunk_size;
    const int64_t hi = std::min(lo + s.chunk_size, trip0);
    for (int64_t n = lo; n < hi; ++n) {
      int64_t ivs[kMaxDepth];
      ivs[0] = nest.starts[0] + n * nest.steps[0];
      body(s, nest, tid, 0, ivs, clock);
    }
  }
  s.count[tid] = clock;
}

int64_t run_impl(
    bool parallel,
    int64_t thread_num, int64_t chunk_size, int64_t ds, int64_t cls,
    int64_t n_nests, const int64_t* depths, const int64_t* trips,
    const int64_t* starts, const int64_t* steps,
    const int64_t* trip_coeffs, const int64_t* start_coeffs,
    const int64_t* nest_ref_off, const int64_t* ref_levels,
    const int64_t* ref_coeffs, const int64_t* ref_consts,
    const int64_t* ref_arrays, const int64_t* ref_slots,
    const int64_t* ref_share_thresholds, const int64_t* ref_share_ratios,
    int64_t n_arrays, int64_t* noshare_bins, int64_t* share_out,
    int64_t* share_count_out, int64_t share_cap,
    int64_t* per_tid_accesses) {
  State s;
  s.thread_num = thread_num;
  s.chunk_size = chunk_size;
  s.ds = ds;
  s.cls = cls;
  s.n_arrays = n_arrays;
  s.count.assign(thread_num, 0);
  s.lat.resize(thread_num * n_arrays);
  s.share.resize(thread_num);
  s.noshare_bins = noshare_bins;
  for (int64_t i = 0; i < thread_num * kNoShareSlots; ++i)
    noshare_bins[i] = 0;

  std::vector<Nest> nests(n_nests);
  for (int64_t k = 0; k < n_nests; ++k) {
    Nest& nest = nests[k];
    nest.depth = depths[k];
    for (int l = 0; l < kMaxDepth; ++l) {
      nest.trips[l] = trips[k * kMaxDepth + l];
      nest.starts[l] = starts[k * kMaxDepth + l];
      nest.steps[l] = steps[k * kMaxDepth + l];
      nest.trip_coeffs[l] = trip_coeffs[k * kMaxDepth + l];
      nest.start_coeffs[l] = start_coeffs[k * kMaxDepth + l];
    }
    for (int64_t i = nest_ref_off[k]; i < nest_ref_off[k + 1]; ++i) {
      Ref r;
      r.level = ref_levels[i];
      for (int l = 0; l < kMaxDepth; ++l)
        r.coeffs[l] = ref_coeffs[i * kMaxDepth + l];
      r.cnst = ref_consts[i];
      r.array = ref_arrays[i];
      r.slot = ref_slots[i];
      r.share_threshold = ref_share_thresholds[i];
      r.share_ratio = ref_share_ratios[i];
      (r.slot == 0 ? nest.pre : nest.post)[r.level].push_back(r);
    }
  }

  for (const Nest& nest : nests) {
    if (parallel) {
      // one OS thread per simulated thread, barrier per nest (the
      // implicit barrier of the reference's per-nest omp region).
      // Exceptions must not cross the extern "C" boundary or escape a
      // worker (either aborts the host interpreter): contain them and
      // surface rc 2.
      std::atomic<int> err{0};
      std::vector<std::thread> workers;
      workers.reserve(thread_num);
      try {
        for (int64_t tid = 0; tid < thread_num; ++tid)
          workers.emplace_back([&s, &nest, &err, tid] {
            try {
              walk_tid(s, nest, tid);
            } catch (...) {
              err.store(1);
            }
          });
      } catch (...) {  // thread spawn failed (resource exhaustion)
        err.store(1);
      }
      for (auto& w : workers)
        if (w.joinable()) w.join();
      if (err.load() != 0) return 2;
    } else {
      for (int64_t tid = 0; tid < thread_num; ++tid)
        walk_tid(s, nest, tid);
    }
    // per-nest -1 flush + LAT clear (...ri-omp-seq.cpp:303-319)
    for (int64_t tid = 0; tid < thread_num; ++tid) {
      for (int64_t a = 0; a < n_arrays; ++a) {
        auto& table = s.lat[tid * n_arrays + a];
        if (!table.empty()) {
          s.noshare_bins[tid * kNoShareSlots + kColdBin] +=
              static_cast<int64_t>(table.size());
          table.clear();
        }
      }
    }
  }

  int64_t total = 0;
  for (int64_t t = 0; t < thread_num; ++t)
    total += static_cast<int64_t>(s.share[t].size());
  *share_count_out = total;
  int64_t written = 0;
  // tid-major emit over per-tid sorted maps == the old global
  // {tid, ratio, reuse}-sorted map order
  for (int64_t t = 0; t < thread_num && written < share_cap; ++t) {
    for (const auto& kv : s.share[t]) {
      if (written >= share_cap) break;
      share_out[written * 4 + 0] = t;
      share_out[written * 4 + 1] = kv.first[0];
      share_out[written * 4 + 2] = kv.first[1];
      share_out[written * 4 + 3] = kv.second;
      ++written;
    }
  }
  for (int64_t t = 0; t < thread_num; ++t) per_tid_accesses[t] = s.count[t];
  return total > share_cap ? 1 : 0;
}

}  // namespace

extern "C" {

// parallel != 0 runs one std::thread per simulated thread (the
// reference `ri` variant's execution model) with bit-identical output
// to the serial walk. Returns 0 on success, 1 when share quadruples
// exceed share_cap (the required count is still written to
// share_count_out), 2 when parallel execution failed (thread spawn or
// a worker exception).
int64_t pluss_run(
    int64_t parallel,
    int64_t thread_num, int64_t chunk_size, int64_t ds, int64_t cls,
    int64_t n_nests, const int64_t* depths, const int64_t* trips,
    const int64_t* starts, const int64_t* steps,
    const int64_t* trip_coeffs, const int64_t* start_coeffs,
    const int64_t* nest_ref_off, const int64_t* ref_levels,
    const int64_t* ref_coeffs, const int64_t* ref_consts,
    const int64_t* ref_arrays, const int64_t* ref_slots,
    const int64_t* ref_share_thresholds, const int64_t* ref_share_ratios,
    int64_t n_arrays,
    int64_t* noshare_bins,  // (thread_num * kNoShareSlots), zeroed here
    int64_t* share_out,     // (share_cap * 4): tid, ratio, value, count
    int64_t* share_count_out, int64_t share_cap,
    int64_t* per_tid_accesses) {
  return run_impl(
      parallel != 0, thread_num, chunk_size, ds, cls, n_nests, depths,
      trips, starts, steps, trip_coeffs, start_coeffs, nest_ref_off,
      ref_levels, ref_coeffs, ref_consts, ref_arrays, ref_slots,
      ref_share_thresholds, ref_share_ratios, n_arrays, noshare_bins,
      share_out, share_count_out, share_cap, per_tid_accesses);
}

// Batched classify+histogram reduction: the sampled engine's CPU fast
// path (SamplerConfig.kernel_backend = "native"/auto). The classify
// stays in XLA (sampled.py's "raw" kernel form emits packed keys +
// found mask); this single -O3/-march=native pass replaces the
// sort-based unique reduction, which dominates the chunk wall on a
// host core. Semantics mirror sampled.py::decode_pairs +
// fold_results exactly:
//
//   packed = reuse * 16 + slot  (slot 15 = noshare; arithmetic
//   right-shift / low-mask reproduce Python's floored divmod for
//   negative keys)
//
// - noshare with reuse >= 1: pow2 bin 63 - clz(reuse) in
//   noshare_bins[0..63] (fold_results re-bins 2^e to 2^e, so the
//   folded state is bit-identical to the raw-key stream);
// - cold (!found): noshare_bins[64];
// - everything else (share slots, and noshare with reuse < 1, which
//   hist_update keeps raw): an exact residual (key, count) map.
//
// mask may be null (every element valid). Returns the residual pair
// count; when it exceeds share_cap NOTHING is written (no partial
// accumulation — a regrown re-call must not double-count) and the
// caller re-calls with bigger buffers. On success noshare_bins is
// ACCUMULATED into (callers keep one per-ref array across chunks)
// and the pairs are written key-sorted.
int64_t pluss_classify_reduce(
    const int64_t* packed, const uint8_t* found, const uint8_t* mask,
    int64_t n,
    int64_t* noshare_bins,  // (65,): 64 pow2 bins + cold at [64]
    int64_t* share_keys, int64_t* share_counts, int64_t share_cap) {
  std::array<int64_t, kNoShareSlots> local{};
  std::unordered_map<int64_t, int64_t> residual;
  for (int64_t i = 0; i < n; ++i) {
    if (mask != nullptr && mask[i] == 0) continue;
    if (found[i] == 0) {
      ++local[kColdBin];
      continue;
    }
    const int64_t p = packed[i];
    const int64_t reuse = p >> 4;
    const int64_t slot = p & 15;
    if (slot == 15 && reuse >= 1) {
      ++local[63 - __builtin_clzll(static_cast<uint64_t>(reuse))];
    } else {
      ++residual[p];
    }
  }
  const int64_t sz = static_cast<int64_t>(residual.size());
  if (sz > share_cap) return sz;
  for (int k = 0; k < kNoShareSlots; ++k) noshare_bins[k] += local[k];
  std::vector<std::pair<int64_t, int64_t>> pairs(residual.begin(),
                                                 residual.end());
  std::sort(pairs.begin(), pairs.end());
  int64_t w = 0;
  for (const auto& kv : pairs) {
    share_keys[w] = kv.first;
    share_counts[w] = kv.second;
    ++w;
  }
  return sz;
}

}  // extern "C"
