"""jax.random's threefry2x32 streams, without JAX.

The device draw (sampler/draw.py) must reproduce the JAX package's
sample sets for a seed, so it reproduces the bits jax 0.9.0 draws,
with `jax_threefry_partitionable` on (that release's default):

- `threefry2x32` is jax/_src/prng.py's hash: 20 rounds of add, rotate
  and xor with the rotations (13, 15, 26, 6) and (17, 29, 16, 24), and
  a key injection after every four, from the key pair and
  k0 ^ k1 ^ 0x1BD11BDA;
- a key is a pair of uint32 words. `seed_key(seed)` is `jr.key`
  (threefry_seed: high word, low word of the 64-bit seed),
  `fold_in(key, d)` hashes the counter pair (0, d) and `split(key)`
  hashes (0, 0) and (0, 1): the partitionable split counts like a
  fold_in;
- element i of a stream hashes the counter pair (i >> 32, i & 0xffffffff)
  (iota_2x32_shape); `bits64` joins the two words as
  (y0 << 32) | y1, and `randint` draws two such streams under
  `split(key)` and maps them onto [0, span) as jax.random.randint
  does, in wrapping uint64 arithmetic.

The key schedule runs on the host on Python ints (a few blocks per
draw). The per-element streams are the plain torch versions of kernel
B3 (csrc/threefry_draw.cu): int64 tensors holding uint32 words, masked
to 32 bits after every add, and uint64 results as their int64 bit
patterns.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
# The order-preserving int64 image of a uint64 pattern is x ^ 2^63: a
# signed sort of the images is the unsigned sort of the patterns.
SIGN = -(1 << 63)
# The largest span `randint` takes: urem's Horner steps stay below 2^62.
# The device draw's box limit (sampler/draw.py) is this bound.
MAX_SPAN = 1 << 46


def _rotl(x, r: int):
    # x < 2^32 and r <= 29, so x << r stays below 2^61 in an int64
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0: int, k1: int, x0, x1):
    """The threefry2x32 block of counters (x0, x1) under key (k0, k1):
    Python ints or int64 tensors of 32-bit words, elementwise."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def seed_key(seed: int) -> tuple[int, int]:
    """jr.key(seed) for an integer seed (its low 64 bits)."""
    return (seed >> 32) & M32, seed & M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """jr.fold_in(key, data) for data read as uint32."""
    return threefry2x32(key[0], key[1], 0, data & M32)


def split(key: tuple[int, int]) -> tuple[tuple[int, int], tuple[int, int]]:
    """jr.split(key): the two sub-keys."""
    return (threefry2x32(key[0], key[1], 0, 0),
            threefry2x32(key[0], key[1], 0, 1))


def randint_multiplier(span: int) -> int:
    """random.py's `multiplier`: (2^32 % span)^2 % span in uint64. For
    span > 2^32 the square is 2^64, which wraps to 0."""
    m = (1 << 32) % span
    return ((m * m) & M64) % span


def _counters(n: int, device):
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & M32


def _join(y0, y1):
    """(y0 << 32) | y1 as the int64 bit pattern of the uint64."""
    hi = torch.where(y0 >= 1 << 31, y0 - (1 << 32), y0)
    return hi * (1 << 32) | y1  # |hi * 2^32| <= 2^63: no overflow


def bits64(key: tuple[int, int], n: int, device="cpu"):
    """jr.bits(key, (n,), uint64), as int64 bit patterns."""
    c_hi, c_lo = _counters(n, device)
    return _join(*threefry2x32(key[0], key[1], c_hi, c_lo))


def urem(x, span: int):
    """The unsigned remainder of int64 bit patterns x by 0 < span <= MAX_SPAN:
    Horner over x's four 16-bit limbs, every step below 2^62."""
    r = torch.zeros_like(x)
    for shift in (48, 32, 16, 0):
        r = ((r << 16) | ((x >> shift) & 0xFFFF)) % span
    return r


def randint(key: tuple[int, int], n: int, span: int, device="cpu"):
    """jr.randint(key, (n,), 0, span, int64) for 1 <= span <= MAX_SPAN.

    jax computes ((hi % span) * mult + lo % span) % span in uint64. Its
    multiplier is 0 for span > 2^32, leaving lo % span; for smaller
    spans no term reaches 2^64 ((span - 1)^2 + span - 1 < span^2), so
    the product's remainder is taken exactly, mult split in 16-bit
    halves."""
    if not 1 <= span <= MAX_SPAN:
        raise ValueError(f"span must be in [1, 2^46], got {span}")
    k1, k2 = split(key)
    lo = urem(bits64(k2, n, device), span)
    mult = randint_multiplier(span)
    if mult == 0:
        return lo
    hi = urem(bits64(k1, n, device), span)
    prod = ((hi * (mult >> 16)) % span << 16) + hi * (mult & 0xFFFF)
    return (prod % span + lo) % span
