"""jax.random's threefry streams in the port, bit for bit (tolerance 0).

The port's host key schedule (sampler/threefry.py: `seed_key`,
`fold_in`, `split`, and sampler/draw.py's `_draw_base_key`) against
jax.random's key data; its two per-element streams, `bits64` and
`randint`, in the plain torch version and in the g++ build of kernel
B3's source (csrc/threefry_draw.cu, its host twin), against `jr.bits`
and `jr.randint` of the installed jax, for made keys and spans and under
hypothesis. The int64 image the kernel writes for a priority sorts as
the unsigned priorities do.
"""

import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pluss_sampler_optimization_torch.ops import threefry_draw as TD
from pluss_sampler_optimization_torch.sampler import draw as TDR
from pluss_sampler_optimization_torch.sampler import threefry as TF
from pluss_sampler_optimization_tpu.sampler import draw as JD

CSRC = os.path.join(os.path.dirname(__file__), "..",
                    "pluss_sampler_optimization_torch", "csrc")
SEEDS = [0, 1, (1 << 32) - 1, (1 << 32) + 5, 0 * 1000003 + 5,
         7 * 1000003 + 3, 123456789 * 1000003 + 11]
NS = [1, 17, (1 << 14) + 3]
# 2^32 + 1 and up: randint's multiplier (2^32 % span)^2 wraps to 0 in
# uint64; 8,577,357,823 is GEMM-2048's depth-3 box
SPANS = [1, 2, 3, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, (1 << 45) - 1,
         8_577_357_823, 1 << 46]


def _kd(key) -> tuple:
    return tuple(int(x) for x in np.asarray(jr.key_data(key)))


def _jkey(key):
    return jr.wrap_key_data(np.asarray(key, dtype=np.uint32))


def test_key_schedule_matches_jax():
    """key, fold_in and split, and the draw's base key with the fold of
    every attempt, equal jax.random's key data."""
    for seed in SEEDS:
        assert TF.seed_key(seed) == _kd(jr.key(np.uint64(seed)))
        jb = JD._draw_base_key(seed)
        base = TDR._draw_base_key(seed)
        assert base == _kd(jb)
        for attempt in range(8):
            jk = jr.fold_in(jb, attempt)
            k = TF.fold_in(base, attempt)
            assert k == _kd(jk)
            assert list(TF.split(k)) == [_kd(x) for x in jr.split(jk)]


@pytest.fixture(scope="module")
def host_twin(tmp_path_factory):
    """csrc/threefry_draw.cu built as plain C++: threefry_randint_host
    and threefry_bits_host run the kernel's per-element code serially."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("b3") / "libthreefry_draw_host.so"
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
         "-o", str(out), os.path.join(CSRC, "threefry_draw.cu")],
        check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.threefry_randint_host.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_ulonglong, ctypes.c_void_p]
    lib.threefry_bits_host.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p]

    def randint(keys, n, span):
        w = np.array([[*a, *b] for a, b in map(TF.split, keys)], np.uint32)
        out = np.empty((len(keys), n), np.int64)
        assert lib.threefry_randint_host(w.ctypes.data, len(keys), n, span,
                                         out.ctypes.data) == 0
        return out

    def bits(keys, n, valid=None):
        w = np.array(keys, np.uint32)
        out = np.empty((len(keys), n), np.int64)
        v = None if valid is None else np.ascontiguousarray(
            valid, dtype=np.uint8)
        assert lib.threefry_bits_host(
            w.ctypes.data, len(keys), n,
            None if v is None else v.ctypes.data, out.ctypes.data) == 0
        return out

    return randint, bits


def _image(u64: np.ndarray) -> np.ndarray:
    """The order-preserving int64 image x ^ 2^63 of uint64 values."""
    return (u64 ^ np.uint64(1 << 63)).view(np.int64)


@pytest.mark.parametrize("n", NS)
def test_streams_match_jax(n, host_twin):
    """bits64 and randint (plain, and the g++ twin of the kernel, two
    rows per call) equal jr.bits and jr.randint for every span."""
    twin_randint, twin_bits = host_twin
    keys = [TF.fold_in(TDR._draw_base_key(s), 3) for s in SEEDS[2:5]]
    jbits = [np.asarray(jr.bits(_jkey(k), (n,), jnp.uint64)) for k in keys]
    for k, jb in zip(keys, jbits):
        np.testing.assert_array_equal(TF.bits64(k, n).numpy(),
                                      jb.view(np.int64))
    want = np.stack([_image(jb) for jb in jbits])
    np.testing.assert_array_equal(twin_bits(keys, n), want)
    np.testing.assert_array_equal(TD.threefry_bits_plain(keys, n).numpy(),
                                  want)
    for span in SPANS:
        want = np.stack([
            np.asarray(jr.randint(_jkey(k), (n,), 0, span, dtype=jnp.int64))
            for k in keys])
        for k, w in zip(keys, want):
            np.testing.assert_array_equal(TF.randint(k, n, span).numpy(), w)
        np.testing.assert_array_equal(twin_randint(keys, n, span), want)
        np.testing.assert_array_equal(
            TD.threefry_randint_plain(keys, n, span).numpy(), want)


def test_randint_multiplier_wraps():
    """random.py's multiplier in uint64: (2^32 % span)^2 reaches 2^64 and
    wraps to 0 for every span past 2^32 (jax's own arithmetic shows it)."""
    for span in SPANS:
        m = np.uint64((1 << 32) % span)
        with np.errstate(over="ignore"):
            want = int((m * m) % np.uint64(span))
        assert TF.randint_multiplier(span) == want
        if span > 1 << 32:
            assert want == 0


def test_masked_bits_and_their_order(host_twin):
    """bits with a valid mask: UINT64_MAX's image (int64 max) where it is
    False, in the plain version and the twin; a signed sort of the
    images is the unsigned sort of the priorities."""
    _, twin_bits = host_twin
    keys = [TF.fold_in(TDR._draw_base_key(9), 0), (0, 0)]
    n = 4099
    valid = np.random.default_rng(2).random((2, n)) < 0.6
    got = TD.threefry_bits_plain(keys, n, "cpu", torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), twin_bits(keys, n, valid))
    raw = np.stack([np.asarray(jr.bits(_jkey(k), (n,), jnp.uint64))
                    for k in keys])
    pri = np.where(valid, raw, np.iinfo(np.uint64).max).astype(np.uint64)
    np.testing.assert_array_equal(got.numpy(), _image(pri))
    assert (got.numpy()[~valid] == np.iinfo(np.int64).max).all()
    order = torch.sort(got, dim=1).values.numpy()
    np.testing.assert_array_equal(order, _image(np.sort(pri, axis=1)))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, (1 << 64) - 1), span=st.integers(1, 1 << 46))
def test_randint_hypothesis(seed, span):
    """Any seed and any span the device draw takes: bit-equal."""
    key = TDR._draw_base_key(seed)
    want = np.asarray(jr.randint(_jkey(key), (33,), 0, span,
                                 dtype=jnp.int64))
    np.testing.assert_array_equal(TF.randint(key, 33, span).numpy(), want)


def test_entries_dispatch_and_reject_on_the_cpu():
    """On the CPU the entries take the plain versions and launch nothing;
    "cuda" raises; bad arguments raise ValueError."""
    keys = [(1, 2)]
    n0 = TD.LAUNCHES
    assert torch.equal(TD.threefry_randint(keys, 5, 7, "cpu"),
                       TD.threefry_randint_plain(keys, 5, 7))
    assert torch.equal(TD.threefry_bits(keys, 5, "cpu", backend="torch"),
                       TD.threefry_bits_plain(keys, 5))
    assert TD.LAUNCHES == n0
    with pytest.raises(ValueError, match="CUDA device"):
        TD.threefry_randint(keys, 5, 7, "cpu", backend="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        TD.threefry_bits(keys, 5, "cpu", backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        TD.threefry_randint(keys, 5, 7, "cpu", backend="pallas")
    for args in ((keys, 5, 0), (keys, 5, (1 << 46) + 1), (keys, 0, 7),
                 ([(1 << 32, 0)], 5, 7), ([], 5, 7), ([(1, 2, 3)], 5, 7)):
        with pytest.raises(ValueError):
            TD.threefry_randint_plain(*args)
    valid = torch.ones((1, 5), dtype=torch.bool)
    for bad in (valid.long(), valid[:, :4], torch.ones((2, 5), dtype=bool)):
        with pytest.raises(ValueError, match="valid"):
            TD.threefry_bits_plain(keys, 5, "cpu", bad)


def test_threefry_module_imports_no_jax():
    """The port's threefry is its own: no jax name reaches it."""
    import pluss_sampler_optimization_torch.sampler.threefry as mod

    assert not any(getattr(v, "__module__", "").startswith("jax")
                   for v in vars(mod).values())
    assert jax.config.jax_threefry_partitionable
