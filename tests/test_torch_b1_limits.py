"""Kernel B1 past its old descriptor limits, on the CPU.

B1 (csrc/sampled_hist.cu) took its descriptor as a kernel parameter of
at most MAX_DESC = 2048 words and sink groups of at most MAX_MEMBERS = 8
refs; build_descriptor raised past either. The frontend accepts up to 64
refs per nest, so documents the JAX package runs would have raised on
the card. Now a longer group travels as consecutive sub-groups, and a
longer descriptor takes the buffer form (a device copy that each block
stages in shared memory). The made nests of
tests/_torch_made.py go past both limits; the kernel source built as
plain C++ with g++ (its host twin: sampled_hist_host for the parameter
form, sampled_hist_host_buf for the buffer form) is held against the
plain torch version on them, with a mask and without. Every comparison
is exact.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
from _torch_made import (
    made_program,
    made_tri_program,
    past_limits_programs,
)

import pluss_sampler_optimization_torch as T
from pluss_sampler_optimization_torch.ir import Loop, ParallelNest, Program, Ref
from pluss_sampler_optimization_torch.ops import sampled_hist as sh
from pluss_sampler_optimization_torch.sampler import sampled as TS

N = 12
# member rows of a bucket run through the twin and the plain version:
# the first two and the last (the plain classify of the 64-map bucket
# walks 64 groups per row)
ROWS = (0, 1, -1)


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """{form: run(nt, ri0, keys, mask, highs, rx, desc)} of the g++ build."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    src = sh.__file__.replace("ops/sampled_hist.py", "csrc/sampled_hist.cu")
    out = tmp_path_factory.mktemp("twin") / "libsampled_hist_host.so"
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
         "-Wall", "-Werror", "-o", str(out), src],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p, q = ctypes.c_void_p, ctypes.c_longlong
    fns = {"param": lib.sampled_hist_host, "buffer": lib.sampled_hist_host_buf}
    for fn in fns.values():
        fn.argtypes = [p, p, q, q, p, ctypes.c_int, p, p, p, ctypes.c_int, p,
                       p, p]
        fn.restype = ctypes.c_int

    def runner(form):
        def run(nt, keys, mask, highs, rx, d):
            R, B = keys.shape
            res = np.empty_like(keys)
            hist = np.zeros((R, sh.N_BINS), np.int64)
            cold = np.zeros(R, np.int64)
            m8 = None if mask is None else mask.astype(np.uint8)
            hrec = sh.radix_records(highs)
            tri = (np.ascontiguousarray(nt.tri_base, np.int64) if nt.tri
                   else None)
            rc = fns[form](
                keys.ctypes.data, None if m8 is None else m8.ctypes.data, R,
                B, d.ctypes.data, len(d), hrec.ctypes.data, rx.ctypes.data,
                None if tri is None else tri.ctypes.data, 0,
                res.ctypes.data, hist.ctypes.data, cold.ctypes.data)
            assert rc == 0
            return res, hist, cold
        return run

    return {form: runner(form) for form in fns}


def _buckets(prog, machine, cfg, rng):
    """Per kernel-signature bucket: (nt, ri0, keys, mask, highs, rx), the
    keys drawn as the engine draws them, a random mask, key-0 padding."""
    trace, rows = TS._program_rows(prog, machine)
    for (k, _), members in TS._bucket_rows(trace, rows).items():
        nt = trace.nests[k]
        ri0 = members[0][1]
        highs, s = TS._sample_highs(nt, ri0, cfg)
        if s == 0:
            continue
        members = [members[p] for p in sorted({p % len(members)
                                               for p in ROWS})]
        ks = [TS.draw_sample_keys(nt, ri, cfg, seed=idx)[0]
              for idx, ri in members]
        B = max(len(x) for x in ks) + 5
        keys = np.zeros((len(ks), B), np.int64)
        mask = rng.random((len(ks), B)) < 0.9
        for j, x in enumerate(ks):
            keys[j, :len(x)] = x
            mask[j, len(x):] = False
        rx = np.array([ri for _, ri in members], np.int64)
        yield nt, ri0, keys, mask, TS._pad_highs(highs), rx


def _twin_vs_plain(twins, prog, machine, cfg, rng, forms=None) -> list:
    """Each bucket through the twin of its descriptor's form (or of every
    form in `forms`), with the mask and without, against the plain
    version; returns the descriptors."""
    descs = []
    for nt, ri0, keys, mask, ph, rx in _buckets(prog, machine, cfg, rng):
        d = sh.build_descriptor(nt, ri0)
        descs.append(d)
        for form in forms or (sh.desc_form(d),):
            for m in (mask, None):
                got = twins[form](nt, keys, m, ph, rx, d)
                want = sh.sampled_hist_plain(
                    nt, ri0, torch.from_numpy(keys),
                    None if m is None else torch.from_numpy(m), ph,
                    torch.from_numpy(rx))
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b.numpy())
    return descs


@pytest.mark.parametrize("k", range(4), ids=["distinct64", "one-map9",
                                              "one-map17", "one-map9-tri"])
def test_made_nests_past_the_limits(k, twins):
    """Each made nest: build_descriptor no longer raises, the group of 9
    or 17 members travels as sub-groups of at most MAX_MEMBERS, the 64
    distinct maps take the buffer form, and the twin of the form each
    descriptor takes equals the plain version."""
    prog = past_limits_programs(Loop, ParallelNest, Program, Ref, N)[k]
    descs = _twin_vs_plain(twins, prog, T.MachineConfig(),
                           T.SamplerConfig(ratio=0.5, seed=k),
                           np.random.default_rng(k))
    assert descs
    for d in descs:
        g, sizes = int(d[sh.D_OFF_GROUPS]), []
        for _ in range(int(d[sh.D_NGROUPS])):
            sizes.append(int(d[g]))
            g += sh.G_FIXED + int(d[g])
        assert g == len(d) and max(sizes) <= sh.MAX_MEMBERS
    forms = {sh.desc_form(d) for d in descs}
    if k == 0:
        assert len(descs[0]) > sh.MAX_DESC and forms == {"buffer"}
        assert int(descs[0][sh.D_NGROUPS]) == 64
    else:
        assert forms == {"param"}
        assert any(int(d[sh.D_NGROUPS]) > 2 for d in descs) == (k == 2)


def test_descriptor_groups_split_in_member_order():
    """_sink_groups' group of 17 becomes [8, 8, 1] consecutive members,
    each sub-group led by the group's first member."""
    prog = past_limits_programs(Loop, ParallelNest, Program, Ref, N)[2]
    nt = TS._program_rows(prog, T.MachineConfig())[0].nests[0]
    whole = TS._sink_groups(nt, 0)
    split = sh.descriptor_groups(nt, 0)
    assert [len(m) for _, m in split] == [8, 8, 1] + [len(g) for g in
                                                       whole[1:]]
    assert [j for _, m in split for j in m] == [j for g in whole for j in g]
    assert {s0 for s0, _ in split[:3]} == {whole[0][0]}


@pytest.mark.parametrize("tri", [False, True], ids=["rect", "tri"])
def test_buffer_form_twin_on_every_head_count(tri, twins):
    """The made programs reach groups of 0-3 heads at every level: the
    buffer form's instantiation (NHMAX 3) equals the parameter form's
    and the plain version on each of their buckets."""
    make = made_tri_program if tri else made_program
    _twin_vs_plain(twins, make(Loop, ParallelNest, Program, Ref),
                   T.MachineConfig(), T.SamplerConfig(ratio=0.6, seed=3),
                   np.random.default_rng(11), forms=("param", "buffer"))


def test_forms_by_length():
    """desc_form: the parameter form up to MAX_DESC words, the buffer
    form past it; device_descriptor makes a copy only on a card."""
    prog = past_limits_programs(Loop, ParallelNest, Program, Ref, 8)[0]
    nt = TS._program_rows(prog, T.MachineConfig())[0].nests[0]
    d = sh.build_descriptor(nt, 0)
    assert sh.desc_form(d) == "buffer"
    assert sh.desc_form(d[:sh.MAX_DESC]) == "param"
    assert sh.device_descriptor(d, "cpu") is None
