"""Kernel B2's partition, run serially on the CPU, against its plain version.

csrc/pow2_hist.cu built as plain C++ with g++ exports

- `pow2_hist_twin`: one launch of the kernel run serially for a given
  grid and block: the plan (scalar head to the values' 16-byte
  boundary, warp tiles, scalar tail), the scalar block's head and
  tail, each lane's tile elements folded into its two (bin, sum) slots
  (one or two sums where the tile's weighted values lie in one or two
  bins, else element by element) and their evictions, each block's
  carried 32-bit-word histogram added to `out` (zero on entry), and the
  zeroing of `next`, the next launch's output;
- `pow2_hist_plan`: the plan of a launch from its pointers.

The twin must equal `pow2_hist_plain` for bool and int64 weights over
sizes from 1 to 2^16, every element offset 0-15 of values and of
weights into 16-byte aligned buffers (independently), and grids from one
block to more blocks than tiles, in a chain of launches where each
launch's output is the buffer the one before it zeroed. Every
comparison is exact.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pluss_sampler_optimization_torch.ops import pow2_hist as TP

CSRC = os.path.join(os.path.dirname(__file__), "..",
                    "pluss_sampler_optimization_torch", "csrc")
SIZES = (1, 15, 16, 17, 255, 4097, 1 << 16)
OFFSETS = range(16)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    path = tmp_path_factory.mktemp("pow2_hist") / "libpow2_hist_twin.so"
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
         "-o", str(path), os.path.join(CSRC, "pow2_hist.cu")],
        check=True, capture_output=True, timeout=120,
    )
    so = ctypes.CDLL(str(path))
    so.pow2_hist_twin.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ]
    so.pow2_hist_twin.restype = ctypes.c_int
    so.pow2_hist_plan.argtypes = [
        ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    so.pow2_hist_plan.restype = None
    return so


def _aligned(n_bytes: int) -> np.ndarray:
    """A zeroed uint8 buffer whose data starts on a 64-byte boundary."""
    raw = np.zeros(n_bytes + 64, dtype=np.uint8)
    off = (-raw.ctypes.data) % 64
    return raw[off:off + n_bytes]


def _made(n: int, bool_w: bool, seed: int, data: str = "all_bins"):
    """16-byte aligned buffers of n + 16 values and of their weights
    (bool, or int64 with zeros and negatives). "all_bins": values over
    all 64 bins, 0 and negatives included; "few_bins": as the sharded
    engine's launches, values >= 1 in bins 12 and 13 with a third bin
    (20) at 1% of the elements, so most lanes' tiles hold one or two
    bins and some three."""
    rng = np.random.default_rng(seed)
    m = n + 16
    vals = _aligned(8 * m).view(np.int64)
    if data == "few_bins":
        vals[:] = rng.integers(1 << 12, 1 << 14, size=m)
        vals[rng.random(m) < 0.01] = 1 << 20
    else:
        e = rng.integers(0, 63, size=m).astype(np.int64)
        lo = np.left_shift(np.int64(1), e)
        vals[:] = lo + rng.integers(0, 1 << 62, size=m) % lo
        vals[rng.random(m) < 0.05] = 0
        neg = rng.random(m) < 0.05
        vals[neg] = -rng.integers(1, 1 << 62, size=int(neg.sum()))
    if bool_w:
        w = _aligned(m).view(np.bool_)
        w[:] = rng.random(m) < 0.7
    else:
        w = _aligned(8 * m).view(np.int64)
        w[:] = rng.integers(-3, 1 << 40, size=m)
        w[rng.random(m) < 0.1] = 0
    return vals, w


def _plan(lib, v, w, n):
    out = np.zeros(6, dtype=np.int64)
    lib.pow2_hist_plan(v.ctypes.data, w.ctypes.data, int(w.dtype == bool),
                       n, out.ctypes.data)
    return dict(zip(("head", "tiles", "tail0", "n_scalar", "w_vec",
                     "warp_tile"), out.tolist()))


def _grids(plan):
    """(grid, block) pairs: the scalar block where there is one, and one
    tile block, a few small ones, more blocks (and warps) than tiles, and
    the launcher's grid at 256 threads."""
    sb, tiles = int(plan["n_scalar"] > 0), plan["tiles"]
    return ((sb + 1, 256), (sb + 3, 64), (sb + tiles + 3, 32),
            (sb + max(1, -(-tiles // 8)), 256))


class _Chain:
    """Launches of the twin as the wrapper chains them on one stream:
    each launch's output is the buffer the previous one zeroed."""

    def __init__(self, lib):
        self.lib = lib
        self.out = np.zeros(64, dtype=np.int64)  # a stream's first output

    def __call__(self, v, w, grid, block):
        nxt = np.full(64, -1, dtype=np.int64)
        rc = self.lib.pow2_hist_twin(v.ctypes.data, w.ctypes.data,
                                     int(w.dtype == bool), len(v),
                                     self.out.ctypes.data, nxt.ctypes.data,
                                     grid, block)
        got, self.out = self.out, nxt
        assert not nxt.any(), "the next launch's output was not zeroed"
        return rc, got


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("weights", ["bool", "int"])
@pytest.mark.parametrize("data", ["all_bins", "few_bins"])
def test_twin_matches_plain(lib, data, weights, n):
    vals, wts = _made(n, weights == "bool", seed=n, data=data)
    launch = _Chain(lib)
    for vo in OFFSETS:
        for wo in OFFSETS:
            v, w = vals[vo:vo + n], wts[wo:wo + n]
            want = TP.pow2_hist_plain(torch.from_numpy(v.copy()),
                                      torch.from_numpy(w.copy())).numpy()
            for grid, block in _grids(_plan(lib, v, w, n)):
                rc, got = launch(v, w, grid, block)
                assert rc == 0
                np.testing.assert_array_equal(
                    got, want, err_msg=f"offsets {vo}/{wo}, grid {grid}x"
                                       f"{block}")


@pytest.mark.parametrize("weights", ["bool", "int"])
def test_plan_aligns_the_tiles(lib, weights):
    """The tiles start where values are 16-byte aligned, and where the
    weights' offset allows it (bool: same parity of the head; int64:
    same parity of the element offset) the weights too; head + tiles +
    tail cover n."""
    n = 4097
    vals, wts = _made(n, weights == "bool", seed=1)
    wsize = wts.itemsize
    for vo in OFFSETS:
        for wo in OFFSETS:
            v, w = vals[vo:vo + n], wts[wo:wo + n]
            p = _plan(lib, v, w, n)
            h = p["head"]
            assert 0 <= h < 16
            assert (v.ctypes.data + 8 * h) % 16 == 0
            tile = p["warp_tile"]
            assert p["tail0"] == h + p["tiles"] * tile
            assert p["n_scalar"] == h + n - p["tail0"] < 16 + tile
            aligned = (w.ctypes.data + wsize * h) % 16 == 0
            assert bool(p["w_vec"]) == aligned == ((wo - vo) % 2 == 0)
            if vo == wo == 0:
                assert h == 0 and p["w_vec"] == 1


def test_twin_back_to_back_calls_and_host_entry(lib):
    """Launches in a row on one chain give the same answer; int64
    weights whose bin totals pass 2^32 and wrap 2^64 carry exactly
    through the 32-bit words; pow2_hist_host (the twin at a fixed grid,
    as test_torch_sharded.py uses it) agrees; grids and blocks the
    kernel cannot have are refused."""
    n = 1 << 14
    vals, w = _made(n, True, seed=3)
    v, w = vals[1:n + 1], w[3:n + 3]
    want = TP.pow2_hist_plain(torch.from_numpy(v.copy()),
                              torch.from_numpy(w.copy())).numpy()
    launch = _Chain(lib)
    for grid in (5, 5, 2):
        rc, got = launch(v, w, grid, 256)
        assert rc == 0
        np.testing.assert_array_equal(got, want)
    big = _aligned(8 * n).view(np.int64)
    big[:] = np.random.default_rng(4).integers(-(1 << 62), 1 << 62, size=n)
    want = TP.pow2_hist_plain(torch.from_numpy(v.copy()),
                              torch.from_numpy(big.copy())).numpy()
    assert np.abs(want).max() > 1 << 40
    rc, got = launch(v, big, 3, 64)
    np.testing.assert_array_equal(got, want)
    host = lib.pow2_hist_host
    host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_longlong, ctypes.c_void_p]
    out = np.empty(64, dtype=np.int64)
    assert host(v.ctypes.data, big.ctypes.data, 0, n, out.ctypes.data) == 0
    np.testing.assert_array_equal(out, want)
    for grid, block in ((1, 256), (2, 48)):
        assert lib.pow2_hist_twin(v.ctypes.data, big.ctypes.data, 0, n,
                                  out.ctypes.data, launch.out.ctypes.data,
                                  grid, block) == -1
