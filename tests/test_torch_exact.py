"""The port's exact engines against the JAX package (exact).

- the host-only functions the port takes verbatim (the periodic
  engine's validation tiers, the analytic engine's planning, fits and
  folds, the dense fold and geometry, the structural signature) are
  pinned to the JAX package's source;
- dense, stream (chunk_m 1, 2, None), periodic and analytic
  (host_cutoff=0 and the default) fold to the JAX package's run_numpy
  states on the programs of its tests/test_periodic.py and
  tests/test_analytic.py and on two odd machines; two analytic cases at
  sizes where the affine fits engage;
- the plain raw classify and kernel B1's g++ host twin over whole period
  boxes (every row, each loop's last iteration and every thread's last
  period included, the canonical radices of _box_geometry) equal the
  JAX package's raw kernel (`_kernels_for(nt, ri)["raw"]`) on syrk and
  syrk-tri;
- run_exact's route equals the one the JAX package's validate_periodic
  and validate_analytic give, for every registry model; the periodic
  rejections raise the JAX package's messages; the dense memory route
  and the unit-step gate's route to dense;
- the sharded forms on 2- and 8-device CPU meshes equal one device.

The JAX package's jit engines run in one case each (its run_numpy is
the reference elsewhere). Every comparison is exact.
"""

import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_made import tri_step2_program
from test_torch_classify import host_twin  # noqa: F401 (a fixture)

import pluss_sampler_optimization_torch as T
import pluss_sampler_optimization_tpu as J
from pluss_sampler_optimization_torch.analysis import validate as TV
from pluss_sampler_optimization_torch.core.trace import ProgramTrace as TTrace
from pluss_sampler_optimization_torch.ir import (
    Loop as TLoop,
    ParallelNest as TNest,
    Program as TProgram,
    Ref as TRef,
)
from pluss_sampler_optimization_torch.models import REGISTRY as T_MODELS
from pluss_sampler_optimization_torch.ops import sampled_hist as sh
from pluss_sampler_optimization_torch.ops.histogram import SENTINEL
from pluss_sampler_optimization_torch.parallel import (
    build_mesh,
    run_analytic_sharded,
    run_dense_sharded,
    run_exact_sharded,
    run_periodic_sharded,
)
from pluss_sampler_optimization_torch.sampler import analytic as TA
from pluss_sampler_optimization_torch.sampler import dense as TD
from pluss_sampler_optimization_torch.sampler import periodic as TP
from pluss_sampler_optimization_torch.sampler import stream as TSt
from pluss_sampler_optimization_tpu.analysis import validate as JV
from pluss_sampler_optimization_tpu.core.trace import ProgramTrace as JTrace
from pluss_sampler_optimization_tpu.ir import (
    Loop as JLoop,
    ParallelNest as JNest,
    Program as JProgram,
    Ref as JRef,
)
from pluss_sampler_optimization_tpu.models import REGISTRY as J_MODELS
from pluss_sampler_optimization_tpu.oracle import run_numpy
from pluss_sampler_optimization_tpu.sampler import analytic as JA
from pluss_sampler_optimization_tpu.sampler import dense as JD
from pluss_sampler_optimization_tpu.sampler import periodic as JP
from pluss_sampler_optimization_tpu.sampler import sampled as JS
from pluss_sampler_optimization_tpu.sampler import stream as JSt

CPU = "cpu"


def _src(fn) -> str:
    """A function's source from its `def` line (decorators differ: the
    port caches with functools where the JAX package counts)."""
    src = inspect.getsource(inspect.unwrap(fn))
    return src[src.index("def "):]


VERBATIM = (
    [(TP, JP, f) for f in (
        "_validate_nest", "_check_array", "_check_exhaustive",
        "_inner_min", "_inner_max", "_phase_count", "_ref_period_lines",
        "_signatures", "validate_periodic")]
    + [(TD, JD, f) for f in ("nest_geometry", "dense_bytes_estimate",
                             "_fold_dense_outputs", "_ceil_log2")]
    + [(TA, JA, f) for f in (
        "_box_geometry", "_probe_positions", "_plan_period_ref",
        "_finish_period_ref", "_first_round_keys_estimate",
        "_period_blocks", "_eval_periods_block",
        "_eval_periods_block_inner", "_eval_period_ref", "_eval_period",
        "_fit_affine", "_fold", "_registry_family_builders")]
    # the analytic engine's structural signature: the port's copy of
    # analysis/validate.py (their ids keep the engine's module name)
    + [(TV, JV, f) for f in ("_coeff_class", "_sign_class",
                             "_loop_signature", "_ref_signature",
                             "structural_signature")]
)


def _verbatim_id(port, name) -> str:
    mod = "analytic" if port is TV else port.__name__.rsplit(".", 1)[1]
    return f"{mod}.{name}"


@pytest.mark.parametrize("port,ref,name", VERBATIM,
                         ids=[_verbatim_id(p, f) for p, _, f in VERBATIM])
def test_host_functions_are_verbatim(port, ref, name):
    assert _src(getattr(port, name)) == _src(getattr(ref, name))


def test_verbatim_constants():
    for a, b in ((TP._TIER_B_MAX_REACH, JP._TIER_B_MAX_REACH),
                 (TP._EXHAUSTIVE_CAP, JP._EXHAUSTIVE_CAP),
                 (TSt._ELEM_BUDGET, JSt._ELEM_BUDGET),
                 (TD._REF_BITS, JD._REF_BITS),
                 (TA._MIN_PROBES, JA._MIN_PROBES),
                 (TA._ROW_FIT_MIN, JA._ROW_FIT_MIN),
                 (TA._ROW_MARGIN, JA._ROW_MARGIN),
                 (TA._HOST_FOLD_MAX_ACCESSES, JA._HOST_FOLD_MAX_ACCESSES),
                 (TA.AUDITED_FAMILIES, JA.AUDITED_FAMILIES)):
        assert a == b


def _assert_same(port_res, jax_res):
    assert port_res.total_accesses == jax_res.total_accesses
    assert port_res.per_tid_accesses == jax_res.per_tid_accesses
    P = len(jax_res.state.noshare)
    for t in range(P):
        assert port_res.state.noshare[t] == jax_res.state.noshare[t], t
        assert port_res.state.share[t] == jax_res.state.share[t], t


def _machines():
    return [(T.MachineConfig(), J.MachineConfig()),
            (T.MachineConfig(thread_num=3, chunk_size=5),
             J.MachineConfig(thread_num=3, chunk_size=5)),
            (T.MachineConfig(thread_num=7, chunk_size=3),
             J.MachineConfig(thread_num=7, chunk_size=3))]


# the JAX package's tests/test_periodic.py programs (model, args)
PERIODIC = [("gemm", (16,)), ("gemm", (13,)), ("gemm", (32,)),
            ("2mm", (8,)), ("3mm", (6,)), ("jacobi-2d", (10, 2)),
            ("heat-3d", (16,)), ("mvt", (16,))]


def _build(reg, model, args):
    if len(args) == 2:
        return reg[model](args[0], tsteps=args[1])
    return reg[model](*args)


@pytest.mark.parametrize("model,args", PERIODIC,
                         ids=[f"{m}{a}" for m, a in PERIODIC])
def test_periodic_dense_stream_match_numpy(model, args):
    tp, jp = _build(T_MODELS, model, args), _build(J_MODELS, model, args)
    for tm, jm in _machines()[:1 if model not in ("gemm", "2mm") else 3]:
        want = run_numpy(jp, jm)
        _assert_same(TP.run_periodic(tp, tm, device=CPU), want)
        _assert_same(TD.run_dense(tp, tm, device=CPU), want)
        _assert_same(TSt.run_stream(tp, tm, device=CPU), want)


# the JAX package's tests/test_analytic.py programs (adi and fdtd-2d:
# its multi-nest stencils)
ANALYTIC = [("syrk", 24), ("syrk", 40), ("syrk-tri", 24),
            ("syrk-tri", 33), ("trmm", 24), ("trisolv", 32),
            ("covariance", 24), ("gemm", 24), ("adi", 12), ("fdtd-2d", 12)]


@pytest.mark.parametrize("model,n", ANALYTIC,
                         ids=[f"{m}{n}" for m, n in ANALYTIC])
def test_analytic_matches_numpy(model, n):
    tp, jp = T_MODELS[model](n), J_MODELS[model](n)
    want = run_numpy(jp, J.MachineConfig())
    tm = T.MachineConfig()
    _assert_same(TA.run_analytic(tp, tm, batch=1 << 12, host_cutoff=0,
                                 device=CPU), want)
    _assert_same(TA.run_analytic(tp, tm, batch=1 << 12, device=CPU), want)


@pytest.mark.parametrize("model,n", [("syrk-tri", 12), ("trmm", 11),
                                     ("covariance", 9), ("jacobi-2d", 10)])
@pytest.mark.parametrize("chunk_m", [1, 2, None])
def test_stream_chunks_and_dense_match_numpy(model, n, chunk_m):
    tp, jp = T_MODELS[model](n), J_MODELS[model](n)
    for tm, jm in _machines()[:2]:
        want = run_numpy(jp, jm)
        _assert_same(TSt.run_stream(tp, tm, chunk_m=chunk_m, device=CPU),
                     want)
        if chunk_m is None:
            _assert_same(TD.run_dense(tp, tm, device=CPU), want)


@pytest.mark.parametrize("model,n,threads,chunk", [
    ("syrk", 104, 3, 5), ("syrk-tri", 118, 5, 2)])
def test_analytic_fits_engage(model, n, threads, chunk):
    """Sizes where the row and period fits engage (N >= _ROW_FIT_MIN
    rows, enough periods for v0 classes), odd machines."""
    tp, jp = T_MODELS[model](n), J_MODELS[model](n)
    tm = T.MachineConfig(thread_num=threads, chunk_size=chunk)
    jm = J.MachineConfig(thread_num=threads, chunk_size=chunk)
    counters: dict = {}
    got = TA.run_analytic(tp, tm, batch=1 << 14, host_cutoff=0,
                          device=CPU, counters=counters)
    _assert_same(got, run_numpy(jp, jm))
    assert counters["dispatches"] > 0


def test_analytic_odd_geometry():
    tp, jp = T_MODELS["syrk-tri"](26), J_MODELS["syrk-tri"](26)
    tm = T.MachineConfig(thread_num=3, chunk_size=5)
    jm = J.MachineConfig(thread_num=3, chunk_size=5)
    _assert_same(TA.run_analytic(tp, tm, batch=1 << 12, host_cutoff=0,
                                 device=CPU), run_numpy(jp, jm))


def test_jax_engines_equal_the_port():
    """The JAX package's own jit engines, one case each."""
    tm, jm = T.MachineConfig(), J.MachineConfig()
    tp, jp = T_MODELS["gemm"](12), J_MODELS["gemm"](12)
    _assert_same(TD.run_dense(tp, tm, device=CPU), JD.run_dense(jp, jm))
    _assert_same(TSt.run_stream(tp, tm, chunk_m=2, device=CPU),
                 JSt.run_stream(jp, jm, chunk_m=2))
    _assert_same(TP.run_periodic(tp, tm, device=CPU),
                 JP.run_periodic(jp, jm))
    tp, jp = T_MODELS["syrk-tri"](20), J_MODELS["syrk-tri"](20)
    _assert_same(TA.run_analytic(tp, tm, batch=1 << 12, host_cutoff=0,
                                 device=CPU),
                 JA.run_analytic(jp, jm, batch=1 << 12, host_cutoff=0))


def _box_keys(nt, ri, n0):
    """Every key of one (ref, period) box under the canonical radices
    (rows of t2 keys, `stride` apart), and the padded highs."""
    t1, t2, box, highs = TA._box_geometry(nt, ri, n0)
    base = n0 * highs[1] * highs[2]
    keys = (base + np.arange(t1, dtype=np.int64)[:, None] * highs[2]
            + np.arange(t2, dtype=np.int64)[None, :]).ravel()
    return keys, highs


@pytest.mark.parametrize("model,n", [("syrk", 13), ("syrk-tri", 13)])
def test_raw_classify_and_twin_on_whole_period_boxes(model, n, host_twin):
    """B1's raw form as the analytic engine launches it — one row of
    every key of a period box, the canonical radices, each loop's last
    iteration and every period (so every thread's last one) — through
    the plain version and the kernel's g++ twin, against the JAX
    package's raw kernel."""
    tm, jm = T.MachineConfig(), J.MachineConfig()
    tt, jt = TTrace(T_MODELS[model](n), tm), JTrace(J_MODELS[model](n), jm)
    for tnt, jnt in zip(tt.nests, jt.nests):
        for ri in range(tnt.tables.n_refs):
            kern = JS._kernels_for(jnt, ri)["raw"]
            rx = np.array([ri], np.int64)
            boxes = []
            for n0 in range(tnt.schedule.trip):
                keys, highs = _box_keys(tnt, ri, n0)
                if len(keys):
                    boxes.append(keys)
            keys = np.concatenate(boxes)
            ph = TA._pad_highs(highs)
            packed, found = kern(jnp.asarray(keys), ph, jnt.vals,
                                 np.int64(ri))
            want = np.where(np.asarray(found), np.asarray(packed), SENTINEL)
            res, _, cold = sh.sampled_hist_plain(
                tnt, ri, torch.from_numpy(keys)[None], None, ph,
                torch.from_numpy(rx), raw=True)
            np.testing.assert_array_equal(res[0].numpy(), want)
            assert int(cold[0]) == int((~np.asarray(found)).sum())
            res_t, hist_t, cold_t = host_twin(tnt, ri, keys[None], None, ph,
                                              rx, raw=True)
            np.testing.assert_array_equal(res_t[0], want)
            assert int(cold_t[0]) == int(cold[0]) and not hist_t.any()
            # the engine's own classify of the same keys, in chunks
            kernel = TA._RawClassify(tnt, ri, "auto", [torch.device(CPU)])
            pk, fd = TA._classify_keys(tnt, kernel, ri, keys, highs, 97)
            np.testing.assert_array_equal(np.where(fd, pk, SENTINEL), want)


def _jax_route(jp, jm) -> str:
    try:
        JP.validate_periodic(jp, jm)
        return "periodic"
    except NotImplementedError:
        pass
    try:
        JA.validate_analytic(jp, jm)
        return "analytic"
    except NotImplementedError:
        return "dense"


@pytest.mark.parametrize("name", sorted(J_MODELS))
def test_run_exact_routes_as_jax(name):
    tm, jm = T.MachineConfig(), J.MachineConfig()
    tp, jp = T_MODELS[name](9), J_MODELS[name](9)
    res = TP.run_exact(tp, tm, device=CPU)
    assert res.engine == _jax_route(jp, jm)
    _assert_same(res, run_numpy(jp, jm))
    assert TA.audited_family(tp) == JA.audited_family(jp)
    assert TA.audited_family(tp.name) == JA.audited_family(jp.name)


def _skipgap(Loop, ParallelNest, Program, Ref):
    """The JAX package's period-skipping program (tests/test_periodic.py)."""
    return Program(name="skipgap", nests=(ParallelNest(
        loops=(Loop(16), Loop(2)),
        refs=(Ref("A0", "A", level=1, coeffs=(8, 1)),
              Ref("A1", "A", level=1, coeffs=(8, 1), const=32)),
    ),))


@pytest.mark.parametrize("case", ["syrk-tri", "syrk", "skipgap"])
def test_periodic_rejections_match(case):
    if case == "skipgap":
        tp = _skipgap(TLoop, TNest, TProgram, TRef)
        jp = _skipgap(JLoop, JNest, JProgram, JRef)
    else:
        tp, jp = T_MODELS[case](10), J_MODELS[case](10)
    for tm, jm in _machines()[:2]:
        with pytest.raises(NotImplementedError) as te:
            TP.validate_periodic(tp, tm)
        with pytest.raises(NotImplementedError) as je:
            JP.validate_periodic(jp, jm)
        assert str(te.value) == str(je.value)


def test_dense_memory_route(monkeypatch, capsys):
    monkeypatch.setattr(TD, "_available_bytes", lambda device=None: 1024)
    tm, jm = T.MachineConfig(), J.MachineConfig()
    routed = TD.run_dense(T_MODELS["gemm"](16), tm, device=CPU)
    assert "routing to the periodic engine" in capsys.readouterr().err
    _assert_same(routed, run_numpy(J_MODELS["gemm"](16), jm))
    routed = TD.run_dense(T_MODELS["syrk-tri"](9), tm, device=CPU)
    err = capsys.readouterr().err
    assert re.fullmatch(
        r"dense: predicted sort working set \d+ GB exceeds available 0 GB; "
        r"routing to the stream engine \(bit-identical output\)\n", err)
    _assert_same(routed, run_numpy(J_MODELS["syrk-tri"](9), jm))
    # the sharded form's per-tid devices take no route
    _assert_same(run_dense_sharded(T_MODELS["gemm"](8), tm,
                                   build_mesh(devices=[CPU] * 2)),
                 run_numpy(J_MODELS["gemm"](8), jm))
    assert capsys.readouterr().err == ""
    assert (TD.dense_bytes_estimate(T_MODELS["gemm"](64), tm)
            == JD.dense_bytes_estimate(J_MODELS["gemm"](64), jm))


def test_available_bytes_reads_the_card_on_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (12345, 99999))
    assert TD._available_bytes("cuda") == 12345
    assert TD._available_bytes(CPU) > 0


def test_tri_step2_routes_to_dense():
    tm, jm = T.MachineConfig(), J.MachineConfig()
    tp = tri_step2_program(TLoop, TNest, TProgram, TRef)
    jp = tri_step2_program(JLoop, JNest, JProgram, JRef)
    res = TP.run_exact(tp, tm, device=CPU)
    assert res.engine == "dense" == _jax_route(jp, jm)
    want = run_numpy(jp, jm)
    _assert_same(res, want)
    _assert_same(TSt.run_stream(tp, tm, device=CPU), want)
    for fn in (TA.validate_analytic,
               lambda p, m: T.run_sampled(p, m, T.SamplerConfig(),
                                          device=CPU)):
        with pytest.raises(NotImplementedError,
                           match="unit steps only; use the dense or "
                           "stream engine"):
            fn(tp, tm)


def test_share_capacity_error_text():
    tm = T.MachineConfig()
    for fn, model in ((TD.run_dense, "syrk"), (TSt.run_stream, "syrk"),
                      (TP.run_periodic, "bicg")):
        with pytest.raises(RuntimeError,
                           match=r"share-value capacity exceeded; raise "
                           r"max_share \(needed 2, have 1\)"
                           if fn is not TD.run_dense else r"needed 4"):
            fn(T_MODELS[model](16), tm, max_share=1, device=CPU)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_forms_equal_one_device(n_dev):
    """Each sharded form equals the port's one-device engine and the JAX
    package's run_numpy on the same program and machine."""
    mesh = build_mesh(devices=[CPU] * n_dev)
    tm, jm = T.MachineConfig(), J.MachineConfig()
    for model, n in (("gemm", 16), ("jacobi-2d", 10)):
        tp = T_MODELS[model](n)
        want = run_numpy(J_MODELS[model](n), jm)
        one = TP.run_periodic(tp, tm, device=CPU)
        _assert_same(one, want)
        _assert_same(run_periodic_sharded(tp, tm, mesh), one)
        res = run_exact_sharded(tp, tm, mesh)
        assert res.engine == "periodic"
        _assert_same(res, want)
    for model, n in (("syrk", 24), ("syrk-tri", 20)):
        tp = T_MODELS[model](n)
        want = run_numpy(J_MODELS[model](n), jm)
        one = TA.run_analytic(tp, tm, batch=1 << 12, host_cutoff=0,
                              device=CPU)
        _assert_same(one, want)
        counters: dict = {}
        got = run_analytic_sharded(tp, tm, mesh, batch=1 << 12,
                                   host_cutoff=0, counters=counters)
        _assert_same(got, want)
        assert counters["dispatches"] == n_dev * counters["fetches"]
    m8, jm8 = T.MachineConfig(thread_num=8), J.MachineConfig(thread_num=8)
    tp = tri_step2_program(TLoop, TNest, TProgram, TRef)
    want = run_numpy(tri_step2_program(JLoop, JNest, JProgram, JRef), jm8)
    _assert_same(TD.run_dense(tp, m8, device=CPU), want)
    res = run_exact_sharded(tp, m8, mesh)
    assert res.engine == "dense"
    _assert_same(res, want)
    want = run_numpy(J_MODELS["gemm"](16), jm8)
    _assert_same(TD.run_dense(T_MODELS["gemm"](16), m8, device=CPU), want)
    _assert_same(run_dense_sharded(T_MODELS["gemm"](16), m8, mesh), want)
    if n_dev == 8:
        with pytest.raises(ValueError, match="not divisible by mesh size"):
            run_dense_sharded(T_MODELS["gemm"](8), tm, mesh)


def test_exact_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog, m = T_MODELS["gemm"](8), T.MachineConfig()
    for fn in (TP.run_exact, TP.run_periodic, TD.run_dense, TSt.run_stream,
               TA.run_analytic):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(prog, m)
    # the kernel backend on CPU tensors is an error, not the plain path
    with pytest.raises(ValueError, match="CUDA tensors"):
        TA.run_analytic(T_MODELS["syrk"](24), m, host_cutoff=0, device=CPU,
                        kernel_backend="cuda")
