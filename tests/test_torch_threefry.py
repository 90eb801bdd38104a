"""jax.random's threefry streams in the port, bit for bit (tolerance 0).

The port's host key schedule (sampler/threefry.py: `seed_key`,
`fold_in`, `split`, and sampler/draw.py's `_draw_base_key`) against
jax.random's key data; its two per-element streams, `bits64` and
`randint`, in the plain torch version and in the g++ build of kernel
B3's source (csrc/threefry_draw.cu, its host twin, which runs every
thread of a launch with the kernel's own per-thread code), against
`jr.bits` and `jr.randint` of the installed jax, for made keys and spans
and under hypothesis. The int64 image the kernel writes for a priority
sorts as the unsigned priorities do. The kernel's remainder by its
launch's record (ops/threefry_draw.py::remainder_record; the twin's
`threefry_urem_host`) equals Python's `%` on edge numerators and spans
and under hypothesis.
"""

import ctypes
import os
import shutil
import subprocess
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
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
# 1026 and 17: ragged rows (not whole blocks, not a multiple of the
# kernel's counters per thread); 2048: whole blocks (the instantiations
# without a bound check)
NS = [1, 17, 1026, 2048, (1 << 14) + 3]
# 2^32 + 1 and up: randint's multiplier (2^32 % span)^2 wraps to 0 in
# uint64; 8,577,357,823 and 4,190,209 are GEMM-2048's depth-3 and depth-2
# boxes, 3,616,805,375 and 2,356,225 syrk-tri N=1536's
SPANS = [1, 2, 3, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, (1 << 45) - 1,
         8_577_357_823, 1 << 46, 4_190_209, 3_616_805_375, 2_356_225]
# the record's edge spans: every kind, the main paths' boxes, primes
# (2^31 - 1, the primes next to 2^32, 2^40 and 2^46, 10^9 + 7)
RECORD_SPANS = [1, 2, 3, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, 4_190_209,
                8_577_357_823, 2_356_225, 3_616_805_375, (1 << 45) - 1,
                1 << 46, 2_147_483_647, 4_294_967_291, 4_294_967_311,
                1_099_511_627_791, 70_368_744_177_643, 1_000_000_007]
M64 = (1 << 64) - 1


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
    """csrc/threefry_draw.cu built as plain C++: threefry_randint_host,
    threefry_bits_host and threefry_urem_host run the kernels' per-thread
    code serially, with the launch arguments the card's entries take.
    The entries below allocate their outputs (and copy the mask) `shift`
    elements (bytes) into a buffer, so a row can start off the card's
    alignment, and check the twin saw no misaligned access (rc 2)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("b3") / "libthreefry_draw_host.so"
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
         "-o", str(out), os.path.join(CSRC, "threefry_draw.cu")],
        check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    C = ctypes
    lib.threefry_randint_host.argtypes = [
        C.c_void_p, C.c_longlong, C.c_longlong, C.c_longlong, C.c_uint,
        C.c_uint, C.c_ulonglong, C.c_ulonglong, C.c_ulonglong, C.c_int,
        C.c_void_p]
    lib.threefry_bits_host.argtypes = [
        C.c_void_p, C.c_longlong, C.c_longlong, C.c_longlong, C.c_uint,
        C.c_uint, C.c_void_p, C.c_void_p]
    lib.threefry_urem_host.argtypes = [
        C.c_void_p, C.c_longlong, C.c_ulonglong, C.c_ulonglong,
        C.c_ulonglong, C.c_int, C.c_void_p]

    def rows(R, n, shift):
        buf = np.empty(R * n + 2, np.int64)
        return buf[shift:shift + R * n].reshape(R, n)

    def randint(keys, n, span, c0=0, c1=0, shift=0, rec=None):
        rec = TD.remainder_record(span) if rec is None else rec
        w = TD.randint_words(keys)
        out = rows(len(keys), n, shift)
        rc = lib.threefry_randint_host(
            w.ctypes.data, len(keys), n, n, c0, c1, span, rec.recip,
            rec.mult, rec.kind, out.ctypes.data)
        return rc, out

    def bits(keys, n, valid=None, c0=0, c1=0, shift=0, vshift=0):
        w = np.array(keys, np.uint32)
        out = rows(len(keys), n, shift)
        v = None
        if valid is not None:
            vb = np.empty(valid.size + 4, np.uint8)
            v = vb[vshift:vshift + valid.size]
            v[:] = valid.reshape(-1)
        rc = lib.threefry_bits_host(
            w.ctypes.data, len(keys), n, n, c0, c1,
            None if v is None else v.ctypes.data, out.ctypes.data)
        return rc, out

    def urem(nums, span, rec=None):
        rec = TD.remainder_record(span) if rec is None else rec
        n = np.array(nums, np.uint64)
        out = np.empty_like(n)
        rc = lib.threefry_urem_host(n.ctypes.data, len(n), span, rec.recip,
                                    rec.mult, rec.kind, out.ctypes.data)
        return rc, [int(x) for x in out]

    def randint_ok(*a, **kw):
        rc, out = randint(*a, **kw)
        assert rc == 0
        return out

    def bits_ok(*a, **kw):
        rc, out = bits(*a, **kw)
        assert rc == 0
        return out

    return SimpleNamespace(randint=randint_ok, bits=bits_ok, urem=urem,
                           randint_rc=randint, bits_rc=bits)


def _image(u64: np.ndarray) -> np.ndarray:
    """The order-preserving int64 image x ^ 2^63 of uint64 values."""
    return (u64 ^ np.uint64(1 << 63)).view(np.int64)


@pytest.mark.parametrize("n", NS)
def test_streams_match_jax(n, host_twin):
    """bits64 and randint (plain, and the g++ twin of the kernel, two
    rows per call) equal jr.bits and jr.randint for every span."""
    twin_randint, twin_bits = host_twin.randint, host_twin.bits
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
    twin_bits = host_twin.bits
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


def _edge_numerators(span: int) -> list:
    """0, span - 1, span, 2^63 - 1, 2^63, 2^64 - 1, and the neighbours
    of span's first, second and last multiples below 2^64 and of the
    multiple nearest 2^63."""
    last = M64 // span * span
    mid = (1 << 63) // span * span
    nums = {0, span - 1, span, (1 << 63) - 1, 1 << 63, M64}
    for k in (span, 2 * span, last, mid):
        nums.update(k + d for d in (-1, 0, 1))
    return sorted(x for x in nums if 0 <= x <= M64)


@pytest.mark.parametrize("span", RECORD_SPANS)
def test_remainder_record_edges(span, host_twin):
    """The record's remainder, in its Python model and in the kernel's
    code (the twin), equals Python's % on the edge numerators; its kind
    and multiplier are what the kernel's branches assume."""
    rec = TD.remainder_record(span)
    pow2 = span & (span - 1) == 0
    assert rec.kind == (TD.REM_POW2 if pow2 else TD.REM_BIG
                        if span > 1 << 32 else TD.REM_SMALL)
    assert rec.mult == TF.randint_multiplier(span)
    assert (rec.mult != 0) == (rec.kind == TD.REM_SMALL)
    if rec.kind == TD.REM_BIG:
        assert rec.recip < 1 << 32
    nums = _edge_numerators(span)
    want = [x % span for x in nums]
    assert [TD.record_urem(x, span, rec) for x in nums] == want
    rc, got = host_twin.urem(nums, span)
    assert rc == 0 and got == want


def test_remainder_record_refusals(host_twin):
    """Spans outside [1, 2^46] have no record; the kernel's entries
    refuse a record that is not the span's (rc 1: the card's launcher
    returns cudaErrorInvalidValue, and the wrapper raises)."""
    for span in (0, (1 << 46) + 1):
        with pytest.raises(ValueError, match="span"):
            TD.remainder_record(span)
    for span in (12345, 8_577_357_823, 1 << 20):
        rec = TD.remainder_record(span)
        for bad in (rec._replace(recip=rec.recip + 1),
                    rec._replace(mult=rec.mult + 1),
                    rec._replace(kind=(rec.kind + 1) % 3)):
            assert host_twin.urem([5], span, bad)[0] == 1
            assert host_twin.randint_rc([(1, 2)], 8, span, rec=bad)[0] == 1


@settings(max_examples=200, deadline=None)
@given(n=st.integers(0, M64), span=st.integers(1, 1 << 46))
def test_remainder_record_hypothesis(n, span):
    """Any uint64 numerator by any span the draw takes: the record's
    remainder is n % span."""
    assert TD.record_urem(n, span, TD.remainder_record(span)) == n % span


def test_remainder_twin_sweep(host_twin):
    """The kernel's remainder code (the twin) on numpy-seeded uint64
    numerators by numpy-seeded spans of every kind: Python's %."""
    rng = np.random.default_rng(5)
    spans = [int(x) for x in rng.integers(1, 1 << 46, size=40)]
    spans += [int(x) for x in rng.integers(1, 1 << 32, size=20)]
    spans += [1 << int(e) for e in rng.integers(0, 47, size=5)]
    for span in spans:
        nums = [int(x) for x in rng.integers(0, 1 << 64, size=64,
                                             dtype=np.uint64)]
        rc, got = host_twin.urem(nums, span)
        assert rc == 0 and got == [x % span for x in nums], span


def _streams_at(key, c0: int, c1: int, n: int):
    """The uint64 bit patterns (as int64) of counters (c0, c1 + e)."""
    x1 = torch.arange(n, dtype=torch.int64) + c1
    y0, y1 = TF.threefry2x32(key[0], key[1], torch.full_like(x1, c0), x1)
    return TF._join(y0, y1)


def test_counters_past_the_first_block(host_twin):
    """The general path: a launch at counter (c0, c1) with c0 != 0 (a
    column past 2^32, which the wrapper reaches through its segments)
    and c1 up to 2^32 - 1, against the threefry block of those counters
    and randint's arithmetic in Python integers."""
    keys = [(7, 9), (0xDEADBEEF, 0x12345678)]
    n, c0, c1 = 1000, 1, (1 << 32) - 1000
    pri = np.stack([_streams_at(k, c0, c1, n).numpy() for k in keys])
    np.testing.assert_array_equal(
        host_twin.bits(keys, n, c0=c0, c1=c1),
        pri ^ np.int64(-(1 << 63)))
    for span in (4_190_209, 8_577_357_823, 1 << 40):
        mult = TF.randint_multiplier(span)
        want = []
        for k in keys:
            k1, k2 = TF.split(k)
            hi = _streams_at(k1, c0, c1, n).numpy().view(np.uint64)
            lo = _streams_at(k2, c0, c1, n).numpy().view(np.uint64)
            want.append([((int(h) % span) * mult + int(x) % span) % span
                         for h, x in zip(hi, lo)])
        np.testing.assert_array_equal(
            host_twin.randint(keys, n, span, c0=c0, c1=c1), np.array(want))
    # a launch's counters stay in one 2^32 block
    assert host_twin.bits_rc(keys, n + 1, c0=c0, c1=c1)[0] == 1


def test_launch_blocks_cover_rows_and_segments():
    """The wrapper's launches: MAX_ROWS rows and SEGMENT columns each,
    covering [R, B] once, each inside one 2^32 block of counters."""
    R, B = TD.MAX_ROWS + 2, (1 << 32) + 5
    blocks = list(TD.launch_blocks(R, B))
    assert len(blocks) == 2 * 3
    for r0, rows, c, cols in blocks:
        assert rows == (TD.MAX_ROWS if r0 == 0 else 2)
        assert cols <= TD.SEGMENT and c >> 32 == (c + cols - 1) >> 32
    assert sum(rows * cols for _, rows, _, cols in blocks) == R * B


def test_twin_off_alignment(host_twin):
    """Rows that start off the card's alignment (out one element in, a
    mask one byte in, an odd row stride) take the bound-checked path:
    equal to plain, and no misaligned access (the twin checks)."""
    keys = [TF.fold_in(TDR._draw_base_key(4), 1), (3, 5), (11, 13)]
    rng = np.random.default_rng(8)
    for n in (2048, 1027):
        valid = rng.random((3, n)) < 0.5
        want = TD.threefry_bits_plain(keys, n, "cpu",
                                      torch.from_numpy(valid)).numpy()
        for shift, vshift in ((1, 0), (0, 1), (1, 3), (0, 0)):
            np.testing.assert_array_equal(
                host_twin.bits(keys, n, valid, shift=shift, vshift=vshift),
                want)
        for span in (12345, 8_577_357_823):
            np.testing.assert_array_equal(
                host_twin.randint(keys, n, span, shift=1),
                TD.threefry_randint_plain(keys, n, span).numpy())


def test_sass_counts_by_pipe():
    """The SASS counts chip_smoke.py prints beside B3's bound: per entry,
    instructions by pipe up to the last EXIT, predicated ones included,
    NOPs and the padding after EXIT left out."""
    from pluss_sampler_optimization_torch.ops import _build

    listing = "\n".join([
        "\t\tFunction : _Z14randint_kernelILi1ELb0EEv6Launch",
        "\t.headerflags\t@\"EF_CUDA_SM90\"",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
        "        /*0010*/                   IMAD R4, R4, UR9, R5 ;",
        "        /*0020*/                   IMAD.WIDE.U32 R2, R3, R6, RZ ;",
        "        /*0030*/                   SHF.L.W.U32.HI R4, R4, 0xd, R4 ;",
        "        /*0040*/                   LOP3.LUT R4, R4, R5, RZ, 0x3c, "
        "!PT ;",
        "        /*0050*/               @!P0 SEL R8, R9, 0xffffffff, P1 ;",
        "        /*0060*/                   VIADD R10, R4, 0x1 ;",
        "        /*0070*/                   UIADD3 UR4, UR4, 0x1, URZ ;",
        "        /*0080*/                   NOP ;",
        "        /*0090*/                   STG.E.128 desc[UR4][R6.64], R8 ;",
        "        /*00a0*/                   EXIT ;",
        "        /*00b0*/                   BRA 0xb0;",
        "\t\tFunction : _Z11bits_kernelILb0ELb1EEv6Launch",
        "        /*0000*/                   IADD3 R1, R1, 0x1, RZ ;",
        "        /*0010*/                   EXIT ;",
    ])
    assert _build.count_sass(listing) == {
        "randint_kernel<1, false>": {"alu": 3, "fma": 2, "uniform": 1,
                                     "other": 4, "total": 10},
        "bits_kernel<false, true>": {"alu": 1, "fma": 0, "uniform": 0,
                                     "other": 1, "total": 2},
    }


def test_wrapper_mirrors_the_kernels_launch_shape():
    """ops/threefry_draw.py's CPT, THREADS and MAX_ROWS are the source's
    (chip_smoke.py sizes B3's threads and instantiations from them)."""
    import re

    with open(os.path.join(CSRC, "threefry_draw.cu")) as f:
        src = f.read()
    defined = {k: int(v) for k, v in re.findall(
        r"^#define (CPT|THREADS|MAX_ROWS) (\d+)", src, re.M)}
    assert defined == {"CPT": TD.CPT, "THREADS": TD.THREADS,
                       "MAX_ROWS": TD.MAX_ROWS}


@pytest.mark.parametrize("call,per_element", [
    # (kind, span or a mask, R, B): (ALU only, FMA only, all) per element
    (("randint", 8_577_357_823, 2, 3), (42, 4, 82)),  # above 2^32
    (("randint", 4_190_209, 1, 5), (86, 19, 190)),  # below: 2 blocks, 3 rems
    (("randint", 1 << 20, 1, 4), (41, 0, 73)),  # a power of two
    (("randint", 1 << 46, 1, 4), (42, 0, 74)),
    (("bits", None, 3, 2), (41, 0, 73)),
    (("bits", "mask", 1, 7), (43, 0, 75)),
])
def test_b3_bound_counts_what_the_function_needs(call, per_element):
    """chip_smoke.py's B3 bound counts the streams' own operations per
    element (a block: 20 rotates and 20 xors on the ALU pipe, 32 adds),
    not the built code's, and its bytes: 8 B written, 1 B of mask read."""
    import chip_smoke

    kind, arg, R, B = call
    need = chip_smoke._b3_need((kind, [(0, 0)] * R, B, arg, "cpu"))
    n = R * B
    assert (need["alu"], need["fma"], need["total"]) == tuple(
        x * n for x in per_element)
    assert need["bytes"] == (9 if arg == "mask" else 8) * n


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
