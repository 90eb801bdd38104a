"""The port's frontend, static analysis and their CLI modes against the
JAX package, on the CPU.

analysis/ and frontend/{__init__,schema,parse}.py are byte-equal copies
(tests/test_torch_host.py::COPIED). frontend/fuzz.py keeps the JAX
package's generators and mutators and runs its engine checks on a
device (CUDA unless the CPU is asked for): the documents, machines and
mutants of seeds 0-24 must equal the JAX package's, and check_seed must
pass on the CPU. The CLI's --list-models, --dump-ir, --dump-ir-dir,
--program-json (with a rejected document's diagnostics), --mrc-out and
the analyze mode (with --analysis-json) print the JAX CLI's lines, but
the analysis' own wall time; the tool twins print the JAX tools'
lines. The port's analysis path imports no JAX.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch
from _torch_threads import one_thread_env, one_torch_thread  # noqa: F401
from _torch_native import native_built

import pluss_sampler_optimization_torch as T
from pluss_sampler_optimization_torch.cli import main as t_main
from pluss_sampler_optimization_torch.frontend import fuzz as t_fuzz
from pluss_sampler_optimization_torch.frontend.schema import (
    program_to_json as t_to_json,
)
from pluss_sampler_optimization_torch.models import REGISTRY as T_MODELS
from pluss_sampler_optimization_torch.oracle import run_numpy
from pluss_sampler_optimization_torch.runtime.baseline import load_baseline
from pluss_sampler_optimization_torch.tools import check_ir as t_check_ir
from pluss_sampler_optimization_torch.tools import fuzz_ir as t_fuzz_ir
from pluss_sampler_optimization_torch.tools import (
    make_baseline as t_make_baseline,
)
from pluss_sampler_optimization_torch.tools import (
    verify_analytic as t_verify_analytic,
)
from pluss_sampler_optimization_tpu.cli import main as j_main
from pluss_sampler_optimization_tpu.frontend import fuzz as j_fuzz
from pluss_sampler_optimization_tpu.frontend.schema import (
    program_to_json as j_to_json,
)

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _built():
    native_built()


def _jax_tool(name):
    """tools/<name>.py of the JAX package, imported from its path."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", range(25))
def test_fuzz_generators_equal_the_jax_package(seed):
    """Seed by seed: the same document, machine, program and mutants."""
    assert t_fuzz.generate_doc(seed) == j_fuzz.generate_doc(seed)
    assert (dataclasses.asdict(t_fuzz.generate_machine(seed))
            == dataclasses.asdict(j_fuzz.generate_machine(seed)))
    assert (t_to_json(t_fuzz.generate_program(seed))
            == j_to_json(j_fuzz.generate_program(seed)))
    doc = t_fuzz.generate_doc(seed)
    assert (t_fuzz.mutate_invalid(doc, seed)
            == j_fuzz.mutate_invalid(doc, seed))


@pytest.mark.parametrize("seed", range(5))
def test_check_seed_on_the_cpu(seed):
    """The whole contract on the CPU: round trip, exact engine equal to
    the numpy oracle, sampled drift, native route bit-identical to the
    solo run, every mutant rejected with its code."""
    r = t_fuzz.check_seed(seed, device="cpu", kernel_backends=("native",),
                          sharded=seed == 0)
    assert r["ok"], r["errors"]
    assert r["mutants_rejected"] == "4/4"


def test_batched_check_is_refused():
    """The batched check (run_sampled_multi, ported with the service)
    is no longer refused: a seed's program in a 3-job union bucket is
    bit-identical to its solo run, in check_seed and in fuzz_ir."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # small ops: a thread team only spins
    try:
        r = t_fuzz.check_seed(0, device="cpu", batched=True, sampled=False)
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(
                io.StringIO()):
            rc = t_fuzz_ir.main(["--seeds", "1", "--batched", "--device",
                                 "cpu"])
    finally:
        torch.set_num_threads(n)
    assert r["ok"], r["errors"]
    assert rc == 0 and out.getvalue().startswith("fuzz: 1/1 seeds passed")


def _mask_wall(text: str) -> str:
    """The analysis' own wall time, the one field the CLIs may differ
    in: the summary's "(x ms)" and the JSON's "wall_s"."""
    text = re.sub(r"\(\d+\.\d ms\)", "(ms)", text)
    return re.sub(r'"wall_s": [0-9.e-]+', '"wall_s": 0', text)


def _both(argv, capsys, port_extra=("--device", "cpu")):
    """(JAX CLI rc and stdout, port CLI rc and stdout) for `argv`."""
    out = []
    for fn, extra in ((j_main, ("--platform", "cpu")), (t_main, port_extra)):
        try:
            rc = fn([*argv, *extra])
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else str(e.code)
        out.append((rc, capsys.readouterr().out))
    return out


SAME_STDOUT = [
    ["--list-models"],
    ["--dump-ir", "syrk-tri", "--n", "12"],
    ["--dump-ir", "jacobi-2d", "--n", "10", "--tsteps", "2"],
    ["analyze", "--model", "syrk-tri", "--n", "16"],
    ["analyze", "--model", "gemm", "--n", "12", "--analysis-json"],
    ["analyze", "--model", "adi", "--n", "8", "--tsteps", "2"],
    ["acc", "--model", "trmm", "--n", "12", "--engine", "native"],
    ["acc", "--model", "jacobi-2d", "--n", "12", "--tsteps", "2",
     "--engine", "native-par", "--threads", "3"],
]


@pytest.mark.parametrize("argv", SAME_STDOUT,
                         ids=lambda a: "".join(x.strip("-")[:5] for x in a))
def test_cli_prints_the_jax_lines(argv, capsys):
    (jrc, want), (trc, got) = _both(argv, capsys)
    assert jrc == trc == 0
    assert _mask_wall(got) == _mask_wall(want)
    assert len(got.splitlines()) >= 3


def test_program_json_and_mrc_out(tmp_path, capsys):
    """A dumped document through --program-json: acc (native and
    periodic, with --mrc-out) and analyze print the JAX CLI's lines and
    write its MRC bytes; acc and sample print what --model prints."""
    doc = tmp_path / "gemm.json"
    assert t_main(["--dump-ir", "gemm", "--n", "16"]) == 0
    doc.write_text(capsys.readouterr().out)
    for engine in ("native", "periodic"):
        outs = []
        for side, fn, extra in (("j", j_main, ("--platform", "cpu")),
                                ("t", t_main, ("--device", "cpu"))):
            mrc = tmp_path / f"{side}{engine}.mrc"
            assert fn(["acc", "--program-json", str(doc), "--engine", engine,
                       "--mrc-out", str(mrc), *extra]) == 0
            outs.append((capsys.readouterr().out, mrc.read_bytes()))
        assert outs[0] == outs[1]
        assert len(outs[0][1]) > 0
    (_, want), (_, got) = _both(["analyze", "--program-json", str(doc)],
                                capsys)
    assert _mask_wall(got) == _mask_wall(want)
    for mode, extra in (("acc", ("--engine", "periodic")),
                        ("sample", ("--ratio", "0.3"))):
        base = [mode, *extra, "--device", "cpu"]
        assert t_main([*base, "--model", "gemm", "--n", "16"]) == 0
        by_model = capsys.readouterr().out
        assert t_main([*base, "--program-json", str(doc)]) == 0
        assert capsys.readouterr().out == by_model


def test_dump_ir_dir(tmp_path, monkeypatch, capsys):
    """--dump-ir-dir: the same lines and the same files."""
    files = {}
    for side, fn in (("j", j_main), ("t", t_main)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        assert fn(["--dump-ir-dir", "irs", "--n", "10"]) == 0
        files[side] = (capsys.readouterr().out,
                       {p: (tmp_path / side / "irs" / p).read_text()
                        for p in sorted(os.listdir(tmp_path / side / "irs"))})
    assert files["t"] == files["j"]
    assert len(files["t"][1]) == len(T_MODELS)


@pytest.mark.parametrize("doc,mode", [
    ({"ir_version": 1, "name": "none", "nests": []}, "acc"),
    ({"ir_version": 2, "name": "v", "nests": []}, "analyze"),
    ({"ir_version": 1, "name": "m", "machine": {"ds": 0}, "nests": []},
     "sample"),
])
def test_rejected_document_prints_the_jax_diagnostics(doc, mode, tmp_path,
                                                      capsys):
    path = tmp_path / "doc.json"
    path.write_text(json.dumps(doc))
    (jrc, _), (trc, _) = _both([mode, "--program-json", str(path)], capsys)
    assert isinstance(trc, str) and trc == jrc
    assert "frontend rejected program" in trc


def test_program_json_refused_in_trace_mode(capsys):
    (jrc, _), (trc, _) = _both(["trace", "--program-json", "x.json"],
                               capsys, ())
    assert trc == jrc and "acc|speed|sample|analyze" in trc


def test_check_ir_twin_prints_the_jax_lines(tmp_path, capsys):
    """tools/check_ir.py's twin: --fixtures (every fixture's code), the
    registry table and --json (wall times masked), --ir-json."""
    j_tool = _jax_tool("check_ir")
    doc = tmp_path / "trmm.json"
    doc.write_text(json.dumps(t_to_json(T_MODELS["trmm"](12))))
    bad = tmp_path / "bad.json"
    bad.write_text('{"ir_version": 1, "name": "x", "nests": []}')
    for argv in (["--fixtures"], ["--n", "10"],
                 ["--json", "--model", "syrk-tri", "--n", "12"],
                 ["--ir-json", str(doc), str(bad)]):
        rcs = [j_tool.main(argv), None]
        want = capsys.readouterr().out
        rcs[1] = t_check_ir.main(argv)
        got = capsys.readouterr().out
        mask = re.compile(r'("wall_ms": [0-9.]+|\s+\d+\.\d$)', re.M)
        assert rcs[0] == rcs[1]
        assert mask.sub("", got) == mask.sub("", want)
        if argv == ["--fixtures"]:
            assert got == "fixtures: 28/28 produced their expected " \
                "diagnostic code\n"


def test_fuzz_ir_twin_on_the_cpu(capsys):
    assert t_fuzz_ir.main(["--seeds", "2", "--start-seed", "7", "--device",
                           "cpu", "--kernel-backend", "torch"]) == 0
    assert capsys.readouterr().out.startswith("fuzz: 2/2 seeds passed")


def test_make_baseline_twin(tmp_path, capsys):
    """The native walk's baseline, in the JAX package's file format,
    equals the numpy oracle."""
    out = tmp_path / "gemm16.json.gz"
    assert t_make_baseline.main(["--model", "gemm", "--n", "16", "--out",
                                 str(out)]) == 0
    assert capsys.readouterr().out.startswith(f"{out}: ")
    base = load_baseline("gemm", 16, T.MachineConfig(), path=str(out))
    want = run_numpy(T_MODELS["gemm"](16), T.MachineConfig())
    assert base["total_accesses"] == want.total_accesses
    for t in range(4):
        assert base["state"].noshare[t] == want.state.noshare[t]
        assert base["state"].share[t] == want.state.share[t]


def test_verify_analytic_twin_prints_pass(capsys):
    """The audit on the CPU (B1's plain raw form): the JAX tool's PASS
    line."""
    assert t_verify_analytic.main(["--model", "trmm", "--n", "16",
                                   "--machine", "3,2", "--device",
                                   "cpu"]) == 0
    assert capsys.readouterr().out == (
        "PASS: trmm N=16 machine 3x2 — 92 (ref, period) evaluations "
        "match brute force, and run_analytic's final state (class fits "
        "included) equals the all-periods-direct fold\n")


def test_analysis_imports_no_jax(tmp_path):
    """A process where `import jax` fails imports the port's native,
    analysis and frontend and runs `analyze` on the CPU."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import pluss_sampler_optimization_torch.native as n\n"
        "import pluss_sampler_optimization_torch.analysis\n"
        "import pluss_sampler_optimization_torch.frontend\n"
        "from pluss_sampler_optimization_torch.cli import main\n"
        "rc = main(['analyze', '--model', 'syrk-tri', '--n', '16',"
        " '--device', 'cpu'])\n"
        "assert rc == 0 and n.available()\n"
        "assert not any(m.startswith('pluss_sampler_optimization_tpu')"
        " for m in sys.modules)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=one_thread_env())
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.endswith("ok\n")
    assert "verdict ok" in proc.stdout


def test_fuzz_seeds_through_the_frontend_route_b1_on_new_shapes():
    """Frontend documents reach B1's descriptor: every bucket of every
    fuzz seed 0-24 builds one, in the parameter form."""
    from pluss_sampler_optimization_torch.ops import sampled_hist as sh
    from pluss_sampler_optimization_torch.sampler import sampled as TS

    n = 0
    for seed in range(25):
        prog = t_fuzz.generate_program(seed)
        trace, rows = TS._program_rows(prog, t_fuzz.generate_machine(seed))
        for (k, _), members in TS._bucket_rows(trace, rows).items():
            d = sh.build_descriptor(trace.nests[k], members[0][1])
            assert sh.desc_form(d) == "param"
            n += 1
    assert n > 25
