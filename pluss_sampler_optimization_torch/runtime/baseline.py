"""Recorded serial-oracle baselines for the benchmark.

The reference's accuracy/speed protocol compares against its serial
C++ sampler run on the same workload (Makefile:39-41, README.md:10-12)
— but a full serial traversal of the north-star config (GEMM N=4096,
~2.6e11 accesses) takes the better part of an hour, far too slow to
re-measure inside every benchmark invocation. This module records one
native serial run — PRIState histograms, measured wall time, machine
config — into a JSON file under `baselines/` so bench.py can score
sampled-engine accuracy (MRC L1 error) and speedup against the stored
oracle. `tools/make_baseline.py` produces the files.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os

from ..config import MachineConfig
from .hist import PRIState

BASELINE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "baselines",
)


def _tag_fields(machine: MachineConfig) -> tuple:
    # cache_kb deliberately excluded: it doesn't affect the serial run
    return (machine.thread_num, machine.chunk_size, machine.ds, machine.cls)


def baseline_path(model: str, n: int, machine: MachineConfig) -> str:
    tag = f"{model}{n}"
    if _tag_fields(machine) != _tag_fields(MachineConfig()):
        tag += f"-t{machine.thread_num}c{machine.chunk_size}" \
               f"d{machine.ds}l{machine.cls}"
    return os.path.join(BASELINE_DIR, f"{tag}.json.gz")


def state_to_json(state: PRIState) -> dict:
    return {
        "thread_num": state.thread_num,
        "bin_noshare": state.bin_noshare,
        "noshare": [
            {str(k): v for k, v in h.items()} for h in state.noshare
        ],
        "share": [
            {
                str(r): {str(k): v for k, v in h.items()}
                for r, h in per.items()
            }
            for per in state.share
        ],
    }


def state_from_json(d: dict) -> PRIState:
    return PRIState(
        thread_num=d["thread_num"],
        bin_noshare=d["bin_noshare"],
        noshare=[
            {int(k): float(v) for k, v in h.items()} for h in d["noshare"]
        ],
        share=[
            {
                int(r): {int(k): float(v) for k, v in h.items()}
                for r, h in per.items()
            }
            for per in d["share"]
        ],
    )


def save_baseline(
    model: str,
    n: int,
    machine: MachineConfig,
    serial_seconds: float,
    total_accesses: int,
    state: PRIState,
    path: str | None = None,
    conditions: dict | None = None,
) -> str:
    path = path or baseline_path(model, n, machine)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    doc = {
        "model": model,
        "n": n,
        "machine": dataclasses.asdict(machine),
        "serial_seconds": serial_seconds,
        "total_accesses": total_accesses,
        "engine": "native-serial",
        # measurement conditions (reps, per-rep times, load average):
        # a recorded wall time without them is not reproducible
        "conditions": conditions or {},
        "state": state_to_json(state),
    }
    with gzip.open(path, "wt") as f:
        json.dump(doc, f)
    return path


def load_baseline(
    model: str, n: int, machine: MachineConfig, path: str | None = None
) -> dict | None:
    """Stored baseline dict with `state` decoded, or None if absent or
    recorded under a different machine config.

    cache_kb is excluded from the config comparison (and from the file
    tag): the serial traversal's histograms and wall time don't depend
    on it — it only parameterizes the AET->MRC stage, which consumers
    compute fresh.
    """
    path = path or baseline_path(model, n, machine)
    if not os.path.exists(path):
        return None
    with gzip.open(path, "rt") as f:
        doc = json.load(f)

    def sans_cache(d: dict) -> dict:
        return {k: v for k, v in d.items() if k != "cache_kb"}

    if sans_cache(doc["machine"]) != sans_cache(dataclasses.asdict(machine)):
        return None
    doc["state"] = state_from_json(doc["state"])
    return doc
