// The device draw's random streams, for Hopper (sm_90a): kernel B3.
//
// The JAX package draws its device sample sets with jax.random
// (sampler/draw.py::_rect_draw_body, :144, and the triangular body of
// _build_tri_draw_kernel, :321): XLA code, with no Pallas original. Torch
// has no threefry, and the sample sets (with every MRC digest after them)
// depend on jax 0.9.0's exact bit streams, so this kernel computes them.
// Two entries, each over R rows (one row per bucket member, a key each)
// and B elements per row, in one launch:
//
// - randint: element i of row r is jr.randint(key_r, (B,), 0, span,
//   int64)[i]. randint splits key_r into two sub-keys (the host does the
//   split: ops/threefry_draw.py); under each, the threefry2x32 block of
//   the counter pair (i >> 32, i & 0xffffffff) gives a uint64, hi and lo;
//   the result is ((hi % span) * mult + lo % span) % span in wrapping
//   uint64 arithmetic, with mult = (2^32 % span)^2 % span computed here
//   in uint64 as jax does: for span > 2^32 the square is 2^64 and wraps
//   to 0, so hi is not needed and its block is skipped (the launch's
//   span is uniform, so is the branch).
// - bits: element i of row r is jr.bits(key_r, (B,), uint64)[i] (one
//   block, (y0 << 32) | y1), replaced by UINT64_MAX where the optional
//   uint8 mask `valid` is 0 (_select_exact's jnp.where), and written as
//   its order-preserving int64 image x ^ 2^63, so that a signed sort
//   orders the priorities as the unsigned sort does.
//
// Bound on an H100: 8 B written per element (and 1 B of mask read by
// bits) against about 80 32-bit integer issues per threefry block (20
// rounds of add, rotate and xor, 5 key injections) and a software 64-bit
// remainder per randint stream: at the main path's sizes the two bounds
// are of one order. This first kernel is the simple form: one thread per
// element in a grid-stride loop, the rotations as funnel shifts, plain
// `%` (the compiler's 64-bit division routine). Division by the launch's
// span through a precomputed reciprocal would cut the remainder; B1's
// division records (ops/sampled_hist.py::div_record) are proved for int64
// numerators only, and these are full uint64.
//
// The same file compiles as plain C++ (no __CUDACC__): it then exports
// threefry_randint_host and threefry_bits_host, serial loops over the same
// per-element code, which the CPU tests build with g++ and hold against
// jax.random and the plain torch version (sampler/threefry.py).

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <atomic>
#define HD __host__ __device__ __forceinline__
#else
#define HD static inline
#endif

typedef long long i64;
typedef unsigned long long u64;
typedef unsigned int u32;

#define MAX_ROWS 128  // rows per launch; the wrapper splits larger calls
#define THREADS 256
#define KS_PARITY 0x1BD11BDAu
#define SIGN_BIT 0x8000000000000000ull

HD u32 rotl32(u32 x, int r) {
#ifdef __CUDA_ARCH__
    return __funnelshift_l(x, x, r);
#else
    return (x << r) | (x >> (32 - r));
#endif
}

// Four rounds of threefry2x32 with rotations a, b, c, d.
#define ROUNDS4(a, b, c, d)                  \
    x0 += x1; x1 = rotl32(x1, a) ^ x0;       \
    x0 += x1; x1 = rotl32(x1, b) ^ x0;       \
    x0 += x1; x1 = rotl32(x1, c) ^ x0;       \
    x0 += x1; x1 = rotl32(x1, d) ^ x0;

// The threefry2x32 block of counter (c0, c1) under key (k0, k1), as the
// uint64 (y0 << 32) | y1 (jax/_src/prng.py's _threefry2x32_lowering).
HD u64 block64(u32 k0, u32 k1, u32 c0, u32 c1) {
    const u32 k2 = k0 ^ k1 ^ KS_PARITY;
    u32 x0 = c0 + k0, x1 = c1 + k1;
    ROUNDS4(13, 15, 26, 6)
    x0 += k1; x1 += k2 + 1u;
    ROUNDS4(17, 29, 16, 24)
    x0 += k2; x1 += k0 + 2u;
    ROUNDS4(13, 15, 26, 6)
    x0 += k0; x1 += k1 + 3u;
    ROUNDS4(17, 29, 16, 24)
    x0 += k1; x1 += k2 + 4u;
    ROUNDS4(13, 15, 26, 6)
    x0 += k2; x1 += k0 + 5u;
    return ((u64)x0 << 32) | x1;
}

// random.py's multiplier in uint64: for span > 2^32, m * m wraps to 0.
HD u64 randint_mult(u64 span) {
    const u64 m = (1ull << 32) % span;
    return (m * m) % span;
}

// Element i of randint under sub-keys k = (k1a, k1b, k2a, k2b).
HD i64 randint_one(const u32* k, u64 i, u64 span, u64 mult) {
    const u32 c0 = (u32)(i >> 32), c1 = (u32)i;
    const u64 lo = block64(k[2], k[3], c0, c1) % span;
    if (mult == 0) return (i64)lo;  // ((hi % span) * 0 + lo) % span
    const u64 hi = block64(k[0], k[1], c0, c1) % span;
    return (i64)((hi * mult + lo) % span);
}

// Element i of bits under key k = (k0, k1), as its int64 image.
HD i64 bits_one(const u32* k, u64 i, bool valid) {
    const u64 x = valid ? block64(k[0], k[1], (u32)(i >> 32), (u32)i)
                        : ~0ull;
    return (i64)(x ^ SIGN_BIT);
}

#ifdef __CUDACC__

// The rows' keys, passed by value (the constant bank).
struct Keys {
    u32 k[MAX_ROWS * 4];
};

__global__ void __launch_bounds__(THREADS)
randint_kernel(i64* __restrict__ out, i64 B, u64 span, u64 mult,
               const __grid_constant__ Keys p) {
    const i64 r = blockIdx.y;
    const u32* k = p.k + 4 * r;
    i64* row = out + r * B;
    const i64 stride = (i64)gridDim.x * blockDim.x;
    for (i64 b = (i64)blockIdx.x * blockDim.x + threadIdx.x; b < B;
         b += stride)
        row[b] = randint_one(k, (u64)b, span, mult);
}

__global__ void __launch_bounds__(THREADS)
bits_kernel(const unsigned char* __restrict__ valid, i64* __restrict__ out,
            i64 B, const __grid_constant__ Keys p) {
    const i64 r = blockIdx.y;
    const u32* k = p.k + 2 * r;
    i64* row = out + r * B;
    const unsigned char* v = valid == nullptr ? nullptr : valid + r * B;
    const i64 stride = (i64)gridDim.x * blockDim.x;
    for (i64 b = (i64)blockIdx.x * blockDim.x + threadIdx.x; b < B;
         b += stride)
        row[b] = bits_one(k, (u64)b, v == nullptr || v[b] != 0);
}

#define MAX_DEVICES 64

// Blocks in x for R rows of B: the card's resident blocks of `kernel`
// (SM count times occupancy, asked once per device into `cache`) split
// over the rows, no more than the row needs.
template <typename K>
static int grid_x(K kernel, std::atomic<int>* cache, i64 R, i64 B,
                  unsigned* bx) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    int slots = cache[dev].load(std::memory_order_relaxed);
    if (slots == 0) {
        int sms = 0, per_sm = 0;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                              THREADS, 0);
        if (e != cudaSuccess) return (int)e;
        slots = per_sm * sms > 0 ? per_sm * sms : 1;
        cache[dev].store(slots, std::memory_order_relaxed);
    }
    i64 x = (slots + R - 1) / R;
    const i64 need = (B + THREADS - 1) / THREADS;
    if (x > need) x = need;
    *bx = (unsigned)(x < 1 ? 1 : x);
    return 0;
}

static std::atomic<int> randint_slots[MAX_DEVICES];
static std::atomic<int> bits_slots[MAX_DEVICES];

// keys: the HOST's uint32 [R, 4], each row randint's two sub-keys;
// out: int64 [R, B] on the card, contiguous. 1 <= R <= MAX_ROWS, B >= 1,
// span >= 1. Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments the kernel
// does not take).
extern "C" int threefry_randint_launch(const u32* keys, i64 R, i64 B,
                                       u64 span, void* out, void* stream) {
    if (R < 1 || R > MAX_ROWS || B < 1 || span < 1)
        return (int)cudaErrorInvalidValue;
    Keys p;
    for (i64 i = 0; i < 4 * R; ++i) p.k[i] = keys[i];
    unsigned bx = 1;
    int rc = grid_x(randint_kernel, randint_slots, R, B, &bx);
    if (rc != 0) return rc;
    randint_kernel<<<dim3(bx, (unsigned)R), THREADS, 0,
                     (cudaStream_t)stream>>>((i64*)out, B, span,
                                             randint_mult(span), p);
    return (int)cudaGetLastError();
}

// keys: the host's uint32 [R, 2]; valid: uint8 [R, B] on the card,
// contiguous, or null (every element valid); out: int64 [R, B],
// contiguous. Same contract as threefry_randint_launch.
extern "C" int threefry_bits_launch(const u32* keys, i64 R, i64 B,
                                    const void* valid, void* out,
                                    void* stream) {
    if (R < 1 || R > MAX_ROWS || B < 1) return (int)cudaErrorInvalidValue;
    Keys p;
    for (i64 i = 0; i < 2 * R; ++i) p.k[i] = keys[i];
    unsigned bx = 1;
    int rc = grid_x(bits_kernel, bits_slots, R, B, &bx);
    if (rc != 0) return rc;
    bits_kernel<<<dim3(bx, (unsigned)R), THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)valid, (i64*)out, B, p);
    return (int)cudaGetLastError();
}

#else

// Serial host twins of the two entries: same arguments minus the stream,
// any R.
extern "C" int threefry_randint_host(const u32* keys, i64 R, i64 B,
                                     u64 span, i64* out) {
    if (R < 1 || B < 1 || span < 1) return 1;
    const u64 mult = randint_mult(span);
    for (i64 r = 0; r < R; ++r)
        for (i64 b = 0; b < B; ++b)
            out[r * B + b] = randint_one(keys + 4 * r, (u64)b, span, mult);
    return 0;
}

extern "C" int threefry_bits_host(const u32* keys, i64 R, i64 B,
                                  const unsigned char* valid, i64* out) {
    if (R < 1 || B < 1) return 1;
    for (i64 r = 0; r < R; ++r)
        for (i64 b = 0; b < B; ++b)
            out[r * B + b] = bits_one(
                keys + 2 * r, (u64)b,
                valid == nullptr || valid[r * B + b] != 0);
    return 0;
}

#endif
