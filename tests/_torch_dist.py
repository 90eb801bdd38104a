"""Multi-process runs of the port's sharded engine, for the tests.

`run_workers(world, device)` starts one Python process per rank on
localhost (gloo for device "cpu", NCCL for "cuda", one card per rank),
each running `initialize_distributed` -> `build_global_mesh` ->
`run_sampled_sharded` on GEMM N=`n` (or the registry's `model` built
with `args`), and returns what each rank printed.
`expected(device)` is the single-process answer the ranks must give.
The host draw by default; `cfg=DEVICE_DRAW, runs=DEVICE_RUNS` takes
the device draw, which every rank replays on its own device (its
sample sets depend on the batch, so each run is held against the
single-process engines at its own batch). Imports no JAX, so the tests
on a machine with cards can use it.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

from _torch_threads import one_thread_env

import pluss_sampler_optimization_torch as T
from pluss_sampler_optimization_torch.models import REGISTRY
from pluss_sampler_optimization_torch.parallel import run_sampled_sharded
from pluss_sampler_optimization_torch.runtime.baseline import state_to_json

ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG = {"ratio": 0.3, "seed": 0, "device_draw": False}
# the default chunking, and small chunks with 1 pair slot so padding and
# capacity regrows happen across ranks
RUNS = ({}, {"batch": 40, "capacity": 1})
# the device draw: batches that divide over 2 and 4 ranks, the second
# with many steps per ref and 1 pair slot
DEVICE_DRAW = {"ratio": 0.3, "seed": 0, "device_draw": True}
DEVICE_RUNS = ({"batch": 1 << 10}, {"batch": 64, "capacity": 1})

WORKER = r"""
import dataclasses, json, sys
import torch.distributed as dist
import pluss_sampler_optimization_torch as T
from pluss_sampler_optimization_torch.models import REGISTRY
from pluss_sampler_optimization_torch.parallel import (
    build_global_mesh, initialize_distributed, run_sampled_sharded)
from pluss_sampler_optimization_torch.runtime.baseline import state_to_json

addr, world, rank, device, prog, cfg, runs = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
    json.loads(sys.argv[5]), json.loads(sys.argv[6]), json.loads(sys.argv[7]))
initialize_distributed(addr, world, rank, device=device)
initialize_distributed(addr, world, rank, device=device)  # no-op
try:
    initialize_distributed(addr, world, (rank + 1) % world, device=device)
    conflict = "accepted"
except ValueError as e:
    conflict = "ValueError" if "conflicting" in str(e) else str(e)
mesh = build_global_mesh()
out = []
for kw in runs:
    state, results = run_sampled_sharded(
        REGISTRY[prog[0]](*prog[1]), T.MachineConfig(),
        T.SamplerConfig(**cfg), mesh, device=device, **kw)
    out.append({"state": state_to_json(state),
                "results": [dataclasses.asdict(r) for r in results]})
print(json.dumps({
    "mesh": [str(d) for d in mesh.devices], "conflict": conflict,
    "runs": out,
    "jax": sorted(m for m in sys.modules if m == "jax"
                  or m.startswith(("jax.", "pluss_sampler_optimization_tpu"))),
}))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _program(n: int, model: str, args) -> list:
    """[model, args] as the worker builds the program."""
    return [model, list((n,) if args is None else args)]


def run_workers(world: int, device: str, n: int = 16,
                timeout: float = 180, cfg: dict = CFG,
                runs: tuple = RUNS, model: str = "gemm",
                args: tuple | None = None) -> list:
    """Each rank's printed dict, in rank order; raises if one fails."""
    addr = f"localhost:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, addr, str(world), str(rank),
             device, json.dumps(_program(n, model, args)), json.dumps(cfg),
             json.dumps(runs)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=one_thread_env(),
        )
        for rank in range(world)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"rank failed (rc {p.returncode}):\n{err}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def expected(device: str, n: int = 16, cfg: dict = CFG,
             batch: int | None = None, model: str = "gemm",
             args: tuple | None = None) -> tuple:
    """(run_sampled's state, the one-device sharded results), as the
    workers print them."""
    name, pargs = _program(n, model, args)
    prog, m = REGISTRY[name](*pargs), T.MachineConfig()
    cfg = T.SamplerConfig(**cfg)
    state, _ = T.run_sampled(prog, m, cfg, device=device, batch=batch)
    _, single = run_sampled_sharded(prog, m, cfg, device=device,
                                    batch=batch)
    return json.loads(json.dumps(
        (state_to_json(state), [dataclasses.asdict(r) for r in single])))


def check_workers(outs: list, device: str, n: int = 16, cfg: dict = CFG,
                  runs: tuple = RUNS, model: str = "gemm",
                  args: tuple | None = None) -> None:
    """Every rank printed the same runs, each equal to `expected` (at
    the run's batch under the device draw, whose sample sets depend on
    it)."""
    assert all(o == outs[0] for o in outs)
    got = outs[0]
    assert len(got["mesh"]) == len(outs)
    assert got["conflict"] == "ValueError"
    assert got["jax"] == []
    assert len(got["runs"]) == len(runs)
    want = None
    for kw, run in zip(runs, got["runs"]):
        batch = kw.get("batch") if cfg.get("device_draw") else None
        if want is None or batch is not None:
            want = expected(device, n, cfg, batch, model, args)
        assert run["state"] == want[0]
        assert run["results"] == want[1]
