// Weighted pow2 histogram, for Hopper (sm_90a).
//
// Replaces the Pallas kernel ops/pallas_hist.py::_hist_kernel of the JAX
// package (launched by _ladder_counts, exposed as pow2_hist). That kernel
// builds a monotone comparison ladder c_k = sum of w over x >= 2^k on
// uint32 hi/lo planes and returns hist = c_k - c_{k+1}. This kernel
// computes the ladder's function directly: entry x with weight w adds w
// to bin 63 - clz((uint64) x), and an entry with x == 0 is dropped
// (negative x lands in bin 63, as on the ladder). ops/pow2_hist.py's
// pow2_hist_plain is its plain tensor version.
//
// Design. One thread per element in a grid-stride loop whose trip count
// is the same for every thread of a block; a 64-entry unsigned 64-bit
// histogram per block in shared memory, filled with shared atomics; one
// global atomicAdd per non-zero bin per block into the int64 (64,)
// output, which the caller zeroes. Bool weights (one byte each) are
// aggregated within the warp first: lanes with the same bin find each
// other with __match_any_sync, and the lowest of them adds the group's
// size. The sampled engine's noshare ri fall into one or two bins, so
// without that a block's threads would all queue on one shared address.
// Integer weights (int64) add one atomic per element. Integer sums do not
// depend on order, so the result is exact, and int64 accumulation makes
// the TPU kernel's widen guard (16-bit weight planes over 2048-step
// super-chunks against int32 wrap) unnecessary.
//
// Bound on an H100: bytes. Each element costs an 8 B value and a 1 B bool
// weight (8 B for int weights) read once, the output 512 B; the work is
// a compare and a clz per element. For the sampled engine's 2^20
// elements per launch that is 9.4 MB over 3.35 TB/s, ~2.8 us, below the
// few microseconds a launch itself takes, so launch latency sets its
// time. No TMA and no vector loads: this is the simple, exact version,
// and speed is later work.
//
// The same file compiles as plain C++ (no __CUDACC__): it then exports
// pow2_hist_host, a serial loop over the same binning, which the CPU
// tests build with g++.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD static inline
#endif

typedef long long i64;
typedef unsigned long long u64;

#define N_BINS 64

// The ladder's bin of x: 63 - clz of x read as unsigned, or N_BINS (no
// bin) for x == 0 or a zero weight.
HD int ladder_bin(i64 x, i64 w) {
    if (x == 0 || w == 0) return N_BINS;
#ifdef __CUDA_ARCH__
    return 63 - __clzll(x);
#else
    return 63 - __builtin_clzll((u64)x);
#endif
}

HD i64 weight_at(const void* weights, int w_is_bool, i64 i) {
    if (w_is_bool) return ((const unsigned char*)weights)[i] != 0;
    return ((const i64*)weights)[i];
}

#ifdef __CUDACC__

template <bool BOOL_W>
__global__ void __launch_bounds__(256)
pow2_hist_kernel(const i64* __restrict__ values,
                 const void* __restrict__ weights, i64 n,
                 u64* __restrict__ out) {
    __shared__ u64 s_hist[N_BINS];
    for (int i = threadIdx.x; i < N_BINS; i += blockDim.x) s_hist[i] = 0;
    __syncthreads();
    const i64 stride = (i64)gridDim.x * blockDim.x;
    // base is the same for every thread of the block, so every lane of a
    // warp runs every iteration and __match_any_sync sees the full warp
    for (i64 base = (i64)blockIdx.x * blockDim.x; base < n; base += stride) {
        const i64 i = base + threadIdx.x;
        int bin = N_BINS;
        i64 w = 0;
        if (i < n) {
            w = weight_at(weights, BOOL_W, i);
            bin = ladder_bin(values[i], w);
        }
        if (BOOL_W) {
            const unsigned peers = __match_any_sync(0xffffffffu, bin);
            if (bin < N_BINS && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
                atomicAdd(&s_hist[bin], (u64)__popc(peers));
        } else if (bin < N_BINS) {
            atomicAdd(&s_hist[bin], (u64)w);  // two's complement: exact mod 2^64
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < N_BINS; i += blockDim.x)
        if (s_hist[i]) atomicAdd(&out[i], s_hist[i]);
}

// values: int64 [n]; weights: uint8 [n] (w_is_bool) or int64 [n]; out:
// int64 [64], zeroed by the caller. Launches on `stream`, allocates
// nothing, returns cudaGetLastError() (or cudaErrorInvalidValue for an
// empty input, which the caller answers without a launch).
extern "C" int pow2_hist_launch(const void* values, const void* weights,
                                int w_is_bool, i64 n, void* out,
                                void* stream) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    i64 blocks = (n + threads - 1) / threads;
    if (blocks > 1024) blocks = 1024;
    cudaStream_t s = (cudaStream_t)stream;
    if (w_is_bool)
        pow2_hist_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
            (const i64*)values, weights, n, (u64*)out);
    else
        pow2_hist_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(
            (const i64*)values, weights, n, (u64*)out);
    return (int)cudaGetLastError();
}

#else

// Serial host twin of the kernel, same arguments minus the stream.
extern "C" int pow2_hist_host(const i64* values, const void* weights,
                              int w_is_bool, i64 n, i64* out) {
    for (i64 i = 0; i < n; ++i) {
        const i64 w = weight_at(weights, w_is_bool, i);
        const int bin = ladder_bin(values[i], w);
        if (bin < N_BINS) ((u64*)out)[bin] += (u64)w;
    }
    return 0;
}

#endif
