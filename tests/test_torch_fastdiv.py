"""Kernel B1's division by records, its operation count and its build
report.

csrc/sampled_hist.cu divides only by divisors fixed per launch, each
shipped as a division record (ops/sampled_hist.py::div_record): a shift
for a power of two, else a round-up multiplier and a shift, with a sign
fix for negative numerators and divisors. Built as plain C++ with g++,
its `sampled_hist_divmod` runs the kernel's own floordiv_rec and
floormod_rec, held here against Python's // and %:

- as a hypothesis property over every divisor that a rectangular
  model's descriptors and radices hold, plus made ones (1, powers of
  two up to 2^62, odd, around 2^31 and 2^63, negative), on numerators
  across the whole int64 range;
- on every divisor's edge numerators (0, +-1, multiples of d and their
  neighbours, the ends of int64).

Every comparison is exact. The records hold for every int64 numerator,
so nothing is excluded but INT64_MIN // -1, whose quotient does not fit.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

import pluss_sampler_optimization_torch as T
from pluss_sampler_optimization_torch.models import REGISTRY
from pluss_sampler_optimization_torch.ops import _build
from pluss_sampler_optimization_torch.ops import sampled_hist as sh
from pluss_sampler_optimization_torch.sampler import sampled as S

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
RECT = sorted(
    name for name in REGISTRY
    if not any(n.is_triangular for n in REGISTRY[name](8).nests)
)
MADE = sorted(
    {1, 3, 5, 7, 11, 641, 2047, 8194, 16781312, 6700417}
    | {1 << k for k in range(63)}
    | {(1 << 31) - 1, 1 << 31, (1 << 31) + 1, (1 << 32) - 1, (1 << 32) + 1}
    | {(1 << 62) + 1, I64_MAX, I64_MAX - 2}
    | {-1, -2, -3, -7, -8, -2047, -((1 << 31) + 1), -I64_MAX}
)


@pytest.fixture(scope="module")
def divmod_fn(tmp_path_factory):
    """csrc/sampled_hist.cu built as plain C++: divmod(a, d) runs the
    kernel's floor division and modulo by div_record(d) on an int64
    array."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    src = sh.__file__.replace("ops/sampled_hist.py", "csrc/sampled_hist.cu")
    out = tmp_path_factory.mktemp("fastdiv") / "libsampled_hist_host.so"
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
         "-Wall", "-Werror", "-o", str(out), src],
        check=True, capture_output=True, timeout=300,
    )
    fn = ctypes.CDLL(str(out)).sampled_hist_divmod
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_longlong, p, p, p]
    fn.restype = None

    def run(a, d):
        a = np.ascontiguousarray(a, dtype=np.int64)
        rec = np.asarray(sh.div_record(d), dtype=np.int64)
        q, r = np.empty_like(a), np.empty_like(a)
        fn(a.ctypes.data, len(a), rec.ctypes.data, q.ctypes.data,
           r.ctypes.data)
        return q, r

    return run


def _model_divisors() -> set:
    """Every divisor of every rectangular model's descriptors (header
    and head records) and radices, at two sizes."""
    out = set()
    cfg = T.SamplerConfig(ratio=0.5, seed=1)
    for name in RECT:
        for n in (16, 13):
            trace, rows = S._program_rows(REGISTRY[name](n),
                                          T.MachineConfig())
            for (k, _), members in S._bucket_rows(trace, rows).items():
                nt, ri0 = trace.nests[k], members[0][1]
                d = sh.build_descriptor(nt, ri0)
                at = list(range(sh.D_DIV_CHUNK, sh.D_HEADER, sh.DIV_SIZE))
                g = int(d[sh.D_OFF_GROUPS])
                for _ in range(int(d[sh.D_NGROUPS])):
                    heads = g + sh.G_FIXED - sh.MAX_DEPTH * sh.H_SIZE
                    at += [heads + k * sh.H_SIZE + 2
                           for k in range(sh.MAX_DEPTH)]
                    g += sh.G_FIXED + int(d[g])
                out.update(int(d[i]) for i in at)
                highs, _ = S._sample_highs(nt, ri0, cfg)
                out.update(int(x) for x in S._pad_highs(highs))
    return out


@pytest.fixture(scope="module")
def divisors():
    found = _model_divisors()
    assert {1, 2, 4, 64, -1} <= found  # chunk, threads, cls, adi's step
    return sorted(found | set(MADE))


def _want(a, d):
    q = [x // d for x in a]
    return q, [x - d * y for x, y in zip(a, q)]


def _check(divmod_fn, a, d):
    a = [x for x in a if not (x == I64_MIN and d == -1)]
    q, r = divmod_fn(np.array(a, dtype=np.int64), d)
    want_q, want_r = _want(a, d)
    assert [int(x) for x in q] == want_q, d
    assert [int(x) for x in r] == want_r, d
    assert want_r == [x % d for x in a]


@settings(max_examples=400, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_floor_divmod_matches_python(divmod_fn, divisors, data):
    d = data.draw(st.sampled_from(divisors), label="divisor")
    a = data.draw(st.lists(
        st.one_of(
            st.integers(I64_MIN, I64_MAX),
            st.integers(-(1 << 40), 1 << 40),
            st.integers(max(I64_MIN, -4 * abs(d)), min(I64_MAX, 4 * abs(d))),
        ),
        min_size=1, max_size=64,
    ), label="numerators")
    _check(divmod_fn, a, d)


def test_floor_divmod_edges(divmod_fn, divisors):
    for d in divisors:
        e = abs(d)
        a = {0, 1, -1, I64_MIN, I64_MIN + 1, I64_MAX, I64_MAX - 1}
        top = I64_MAX // e * e
        for m in (e, 2 * e, 3 * e, top, -top, (1 << 40) // e * e):
            for x in (m - 1, m, m + 1, -m - 1, -m, -m + 1):
                if I64_MIN <= x <= I64_MAX:
                    a.add(x)
        _check(divmod_fn, sorted(a), d)


@pytest.mark.parametrize("d", [3, 2047, 8194, 16781312, (1 << 31) + 1,
                               I64_MAX, -7, 1, 64, -1, 1 << 62])
def test_div_record_form(d):
    """A power of two is a bare shift; any other divisor a multiplier
    in [2^63, 2^64) (stored as int64 bits) with shift ceil(log2 |d|) - 1."""
    div, mul, info = sh.div_record(d)
    e = abs(d)
    assert div == d and bool(info & sh.DIV_NEG) == (d < 0)
    shift = info & 63
    if e & (e - 1) == 0:
        assert (mul, shift) == (0, e.bit_length() - 1)
    else:
        m = mul % (1 << 64)
        assert 1 << 63 <= m < 1 << 64
        assert m == -(-(1 << (63 + e.bit_length())) // e)
        assert shift == e.bit_length() - 1


@pytest.mark.parametrize("d", [0, 1 << 63, -(1 << 63)])
def test_div_record_rejects(d):
    with pytest.raises(ValueError):
        sh.div_record(d)


def test_ops_per_sample_gemm_2048():
    """The operation bound (32-bit issues per sample) of GEMM's four
    kernel signatures at the main path's N=2048, ratio 0.1 (radices 2047,
    the last iteration excluded), as ops_per_sample's docstring states
    them."""
    cfg = T.SamplerConfig(ratio=0.1, seed=0)
    trace, rows = S._program_rows(REGISTRY["gemm"](2048), T.MachineConfig())
    got = {}
    for (k, _), members in S._bucket_rows(trace, rows).items():
        nt, ri0 = trace.nests[k], members[0][1]
        highs, _ = S._sample_highs(nt, ri0, cfg)
        label = ",".join(nt.tables.ref_names[ri] for _, ri in members)
        d = sh.build_descriptor(nt, ri0)
        # every split of p0 follows from the sample's indices: no division
        assert sh._split_free(d, int(d[sh.D_LV]))
        got[label] = sh.ops_per_sample(d, S._pad_highs(highs))
    assert got == {"C0,C1": 441, "A0": 245, "B0": 227, "C2,C3": 452}


def test_ops_per_sample_charges_the_split_where_it_is_not_free():
    """Where a ref's body offset takes r0 out of [0, acc0) or rr0 out of
    [0, acc1), the split of p0 needs its divisions: an unsigned 64-bit
    one by acc0 and a signed 32-bit one by acc1 (GEMM N=2048's {A0},
    neither a power of two), their remainders and the subtraction, in
    place of the two index sums."""
    cfg = T.SamplerConfig(ratio=0.1, seed=0)
    trace, rows = S._program_rows(REGISTRY["gemm"](2048), T.MachineConfig())
    (k, _), members = next(
        (key, m) for key, m in S._bucket_rows(trace, rows).items()
        if [trace.nests[key[0]].tables.ref_names[ri] for _, ri in m]
        == ["A0"])
    nt, ri0 = trace.nests[k], members[0][1]
    highs = S._pad_highs(S._sample_highs(nt, ri0, cfg)[0])
    d = sh.build_descriptor(nt, ri0)
    free = sh.ops_per_sample(d, highs)
    d[int(d[sh.D_OFF_REFS]) + ri0 * sh.R_SIZE] = int(d[sh.D_ACC + 1])
    assert not sh._split_free(d, 2)
    assert sh.ops_per_sample(d, highs) - free == (4 + 2) + 1 + 1 + 5 + 1 - 2


@pytest.mark.parametrize("d, words, signed, want", [
    (1, 2, True, 0), (-1, 1, True, 1), (64, 1, True, 1), (64, 2, False, 2),
    (-8, 1, True, 2), (2047, 1, False, 2), (2047, 2, False, 6),
    (2047, 1, True, 5), (2047, 2, True, 12), (-7, 1, True, 8),
])
def test_division_issue_cost(d, words, signed, want):
    """ops_per_sample's price of a floor division by a record: nothing by
    1, a shift by a power of two (the floor for either sign), else a
    multiply-high (one 32-bit, four 64-bit) and a shift, the sign fold
    only for a numerator that may be negative, and -ceil's correction for
    a negative divisor."""
    assert sh._div(d, words, signed) == want


def test_ptxas_report_names_every_instantiation():
    """chip_smoke.py's build lines: ptxas' registers, stack and spills per
    kernel instantiation, template arguments kept."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_Z19sampled_hist_kernelILi2ELi1EEvPKxPKhx6ParamsS1_PxPyS6_' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_Z19sampled_hist_kernelILi2ELi1EEvPKxPKhx6ParamsS1_PxPyS6_",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers, 16904 bytes smem",
        "ptxas info    : Compiling entry function "
        "'_Z16pow2_hist_kernelILb1EEvPKxPKvxPy' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_Z16pow2_hist_kernelILb1EEvPKxPKvxPy",
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 14 registers, used 1 barriers, 512 bytes smem",
    ])
    assert _build.ptxas_report(log) == [
        {"name": "sampled_hist_kernel<2, 1>", "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 80},
        {"name": "pow2_hist_kernel<true>", "stack": 8, "spill_stores": 4,
         "spill_loads": 12, "registers": 14},
    ]
