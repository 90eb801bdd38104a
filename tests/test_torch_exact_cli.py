"""The port's CLI modes acc, speed and trace against the JAX CLI.

`acc` and `trace` lines equal the JAX CLI's byte for byte (its runs in a
subprocess with --platform cpu, the port's in this process with --device
cpu): the exact router on a triangular model, the periodic engine on an
odd machine diffed against the serial oracle, and the trace logs.
`speed` prints the JAX CLI's line format; the refusals of flags that do
not apply raise as there. The native engines (the C++ serial walk and
its threaded form) print the JAX CLI's lines.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

from pluss_sampler_optimization_torch.cli import main

ROOT = os.path.join(os.path.dirname(__file__), "..")

# (arguments) run by both CLIs; N <= 32
SAME_LINES = [
    ["acc", "--model", "syrk-tri", "--n", "20", "--engine", "exact"],
    ["acc", "--model", "gemm", "--n", "13", "--engine", "periodic",
     "--threads", "3", "--chunk", "5", "--diff-against", "oracle"],
    ["trace", "--model", "syrk", "--n", "16", "--limit", "12",
     "--min-reuse", "64", "--tid", "1"],
]


@pytest.mark.parametrize("argv", SAME_LINES, ids=lambda a: a[0] + a[2])
def test_lines_equal_the_jax_cli(argv, capsys):
    want = subprocess.run(
        [sys.executable, "-m", "pluss_sampler_optimization_tpu", *argv,
         "--platform", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert want.returncode == 0, want.stderr
    assert main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want.stdout
    assert len(got.splitlines()) > 10


@pytest.mark.parametrize("engine", ["dense", "stream", "periodic",
                                    "analytic", "exact", "numpy"])
def test_acc_engines_agree_with_the_oracle(engine, capsys):
    argv = ["acc", "--model", "gemm", "--n", "12", "--engine", engine,
            "--diff-against", "oracle", "--device", "cpu"]
    assert main(argv) == 0
    assert capsys.readouterr().out.endswith(
        f"acc dumps identical: {engine} vs oracle\n")


def test_shard_and_oracle_options(capsys):
    base = ["acc", "--model", "syrk", "--n", "12", "--device", "cpu"]
    assert main([*base, "--engine", "analytic"]) == 0
    want = capsys.readouterr().out
    for engine in ("analytic", "exact"):
        assert main([*base, "--engine", engine, "--shard"]) == 0
        assert capsys.readouterr().out == want
    assert main([*base, "--engine", "oracle", "--schedule", "dynamic"]) == 0
    assert "max iteration count" in capsys.readouterr().out
    assert main([*base, "--engine", "oracle", "--runtime", "v2"]) == 0
    capsys.readouterr()


def test_speed_line_format(capsys):
    argv = ["speed", "--model", "gemm", "--n", "8", "--engine", "periodic",
            "--reps", "3", "--device", "cpu"]
    assert main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 5
    for rep in range(3):
        assert re.fullmatch(
            rf"periodic gemm-8x8x8 run {rep}: \d+\.\d{{6}} s", lines[rep]
        ), lines[rep]
    assert re.fullmatch(r"periodic gemm-8x8x8: best \d+\.\d{6} s, mean "
                        r"\d+\.\d{6} s over 3 runs", lines[3])
    assert re.fullmatch(r"periodic gemm-8x8x8: cache-flush overhead "
                        r"\d+\.\d{6} s/rep \(excluded from the timings "
                        r"above\)", lines[4])


@pytest.mark.parametrize("argv,match", [
    (["acc", "--engine", "dense", "--schedule", "dynamic"],
     "oracle engine only"),
    (["acc", "--engine", "sampled", "--shard"], "--shard applies"),
    (["acc", "--engine", "periodic", "--device-draw"], "--device-draw"),
    (["acc", "--engine", "stream", "--kernel-backend", "torch"],
     "--kernel-backend"),
    (["speed", "--diff-against", "oracle"], "--diff-against compares"),
    (["acc", "--diff-against", "pallas"], "unknown --diff-against"),
    (["acc", "--engine", "dense", "--r10"], "--r10 needs a sampled"),
    (["sample", "--engine", "periodic"], "sample mode needs"),
    (["acc", "--model", "gemm", "--tsteps", "2"], "no time-step"),
])
def test_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        main([*argv, "--n", "8", "--device", "cpu"])


@pytest.mark.parametrize("engine", ["native", "native-par"])
def test_native_engines_print_the_jax_lines(engine, capsys):
    """acc and --diff-against oracle through the native engines: the JAX
    CLI's lines (its CLI in this process, as the JAX package's tests
    call it)."""
    from _torch_native import native_built

    from pluss_sampler_optimization_tpu.cli import main as j_main

    native_built()
    argv = ["acc", "--model", "syrk", "--n", "14", "--threads", "3",
            "--engine", engine]
    assert j_main([*argv, "--platform", "cpu"]) == 0
    want = capsys.readouterr().out
    assert main([*argv, "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert main([*argv, "--diff-against", "oracle", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.endswith(
        f"acc dumps identical: {engine} vs oracle\n")


def test_acc_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in ("dense", "exact", "analytic"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["acc", "--n", "8", "--engine", engine])
