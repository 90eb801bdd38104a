"""Generative IR fuzzer: the standing correctness harness.

Each seed deterministically produces one random *valid* loop-nest
document inside the documented model-family caps (depth 1-3,
rectangular parallel loop, unit-step triangular inner loops, positive
suffix-product strides, 1-4 arrays, optional RMW write pairs, bounded
total accesses) and a batch of *invalid* mutants. `check_seed` then
asserts the full frontend contract on that seed:

- round-trip: parse(program_to_json(p)) reproduces p exactly;
- exact path: run_exact's PRIState is bit-identical to the numpy
  oracle's, and the folded MRC bytes match exactly;
- sampled path: run_sampled's folded MRC stays within `drift_max` of
  the oracle fold (sampling is approximate by design — the bound is
  the contract, bit-identity is not);
- rejection: every invalid mutant is refused by the frontend with a
  machine-readable diagnostic carrying the expected code — never a
  crash, never a silent acceptance.

Module import is numpy + stdlib only; engines are imported inside
`check_seed` so the frontend package itself stays instant.

The port's copy of the JAX package's frontend/fuzz.py: the generators
and mutators are the same code, so every seed gives the same documents;
`check_seed` and `run_seeds` take the device the engines run on (CUDA
unless the caller asks for the CPU, as every entry point of the port),
and the batched check runs run_sampled_multi (the service's batches).
Drives: pluss_sampler_optimization_torch/tools/fuzz_ir.py,
chip_smoke.py's frontend phase, tests/test_torch_frontend.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import MachineConfig
from ..ir import Loop, ParallelNest, Program, Ref
from .parse import (
    F_FIELD,
    F_LIMIT,
    F_MACHINE,
    F_RANGE,
    F_VERSION,
    MAX_DOC_DEPTH,
    parse_program_doc,
)
from .schema import program_to_json

ARRAYS = ("A", "B", "C", "D")

#: Default sampled-engine fidelity bound. MRC values live in [0, 1],
#: so real breakage (wrong reuse distances, broken interleaving)
#: drives the max-abs drift to O(1); the bound only needs to sit
#: above the estimator's granularity floor on fuzzer-scale programs.
#: That floor is NOT sampling noise: a MIN_ACCESSES-scale nest split
#: over 2-5 threads gives each per-thread trace a few hundred
#: accesses, the MRC is a coarse step function, and a single
#: histogram-bin shift between the sampled estimator and the exact
#: fold costs ~0.3 in max-abs even at ratio 1.0. Calibration
#: (100-seed sweep at ratio 0.5): worst 0.355, second-worst 0.274,
#: from small deep-triangular nests.
DRIFT_MAX = 0.40
RATIO = 0.5

#: Redraw floor: a program with only a handful of total accesses has
#: an MRC of 2-3 giant steps, where the sampled estimator's boundary
#: effects are O(1) of the curve — statistically meaningless to bound.
#: The generator redraws (from the same deterministic stream) until
#: the candidate clears this, so every fuzzed program is big enough
#: for the drift bound to be a real assertion.
MIN_ACCESSES = 600


def _nest_accesses(nest: ParallelNest) -> int:
    lp0 = nest.loops[0]
    total = 0
    for i in range(lp0.trip):
        v0 = lp0.start + i * lp0.step
        for r in nest.refs:
            c = 1
            for k in range(1, r.level + 1):
                c *= max(0, nest.loops[k].trip_at(v0))
            total += c
    return total


def generate_program(seed: int) -> Program:
    """One random valid Program (tests/test_fuzz.py's generator
    idiom, widened with 1-4 arrays and RMW write pairs so the
    frontend's write tri-state and the race lattice get exercised).
    Redraws until the candidate has >= MIN_ACCESSES total accesses."""
    rng = np.random.default_rng(seed)
    program = _candidate(rng, seed)
    for _ in range(50):
        if _nest_accesses(program.nests[0]) >= MIN_ACCESSES:
            break
        program = _candidate(rng, seed)
    return program


def _candidate(rng, seed: int) -> Program:
    depth = int(rng.integers(1, 4))
    tri = depth >= 2 and rng.random() < 0.35

    # the parallel trip scales inversely with depth so every depth
    # can clear MIN_ACCESSES (a depth-1 nest has only trip0 x refs
    # accesses; a depth-3 nest multiplies three levels)
    trip0_lo, trip0_hi = {1: (120, 400), 2: (16, 48),
                          3: (6, 16)}[depth]
    loops = []
    for l in range(depth):
        start = int(rng.integers(0, 3))
        step = 1 if tri else int(rng.choice([1, 1, 2]))
        trip = (int(rng.integers(trip0_lo, trip0_hi)) if l == 0
                else int(rng.integers(2, 8)))
        if tri and l == depth - 1:
            tc = int(rng.choice([-1, 1]))
            if tc < 0:
                lp0 = loops[0]
                v0_max = lp0.start + (lp0.trip - 1) * lp0.step
                trip = int(rng.integers(1, max(2, v0_max + 1)))
            loops.append(Loop(trip, start=start, step=1, trip_coeff=tc,
                              start_coeff=int(rng.choice([0, 1]))))
        else:
            loops.append(Loop(trip, start=start, step=step))
    nest_loops = tuple(loops)

    # exact per-level value extents (enumerate the small parallel
    # range); suffix products make head-dominant strides
    lp0 = nest_loops[0]
    v0s = [lp0.start + i * lp0.step for i in range(lp0.trip)]
    extents = []
    for lp in nest_loops:
        vmax = 0
        for v0 in v0s:
            tr = lp.trip_at(v0)
            if tr > 0:
                vmax = max(vmax, lp.start_at(v0) + (tr - 1) * lp.step)
        extents.append(max(1, vmax) + 1)

    def _coeffs(lv: int):
        coeffs = []
        for l in range(lv + 1):
            c = 1
            for k in range(l + 1, lv + 1):
                c *= extents[k]
            coeffs.append(c)
        if lv >= 1 and rng.random() < 0.4:
            z = int(rng.integers(0, lv + 1))
            coeffs[z] = 0
            if all(c == 0 for c in coeffs):
                coeffs[lv] = 1
        return tuple(coeffs)

    n_arrays = int(rng.integers(1, 5))
    refs = []
    n_refs = int(rng.integers(1, 6))
    ridx = 0
    for _ in range(n_refs):
        lv = int(rng.integers(0, depth))
        coeffs = _coeffs(lv)
        slot = "pre"
        if lv < depth - 1 and rng.random() < 0.25:
            slot = "post"
        thr = int(rng.integers(1, 60)) if rng.random() < 0.3 else None
        array = str(rng.choice(ARRAYS[:n_arrays]))
        const = int(rng.integers(0, 3))
        if rng.random() < 0.3:
            # RMW pair: read+write through one map (gemm's C0/C1
            # shape) — the duplicated-map case the write tri-state's
            # `None` derivation and the race detector key on
            refs.append(Ref(name=f"R{ridx}", array=array, level=lv,
                            coeffs=coeffs, const=const, slot=slot,
                            share_threshold=thr, write=False))
            refs.append(Ref(name=f"R{ridx + 1}", array=array,
                            level=lv, coeffs=coeffs, const=const,
                            slot=slot, write=True))
            ridx += 2
        else:
            write = bool(rng.random() < 0.15) or None
            refs.append(Ref(name=f"R{ridx}", array=array, level=lv,
                            coeffs=coeffs, const=const, slot=slot,
                            share_threshold=thr, write=write))
            ridx += 1

    return Program(name=f"fuzz{seed}", nests=(ParallelNest(
        loops=nest_loops, refs=tuple(refs)),))


def generate_machine(seed: int) -> MachineConfig:
    rng = np.random.default_rng(seed + 7919)
    return MachineConfig(
        thread_num=int(rng.integers(2, 6)),
        chunk_size=int(rng.integers(1, 5)),
    )


def generate_doc(seed: int) -> dict:
    """The frontend document for this seed (machine knobs embedded)."""
    return program_to_json(generate_program(seed),
                           machine=generate_machine(seed))


# Mutation table: name -> (mutator, expected diagnostic code). Every
# mutator takes a deep-copied valid document and damages it in place.

def _deep_list(levels: int):
    node = [1]
    for _ in range(levels):
        node = [node]
    return node


def _mutations():
    def bad_version(d):
        d["ir_version"] = 99

    def unknown_field(d):
        d["schedule"] = "static"

    def drop_trip(d):
        del d["nests"][0]["loops"][0]["trip"]

    def step_zero(d):
        d["nests"][0]["loops"][-1]["step"] = 0

    def trip_string(d):
        d["nests"][0]["loops"][0]["trip"] = "16"

    def coeffs_long(d):
        d["nests"][0]["refs"][0]["coeffs"].append(1)
        d["nests"][0]["refs"][0]["coeffs"].append(1)
        d["nests"][0]["refs"][0]["coeffs"].append(1)
        d["nests"][0]["refs"][0]["coeffs"].append(1)

    def bad_slot(d):
        d["nests"][0]["refs"][0]["slot"] = "mid"

    def huge_trip(d):
        d["nests"][0]["loops"][0]["trip"] = 1 << 50

    def no_nests(d):
        d["nests"] = []

    def parallel_tri(d):
        d["nests"][0]["loops"][0]["trip_coeff"] = 1

    def deep_coeffs(d):
        d["nests"][0]["refs"][0]["coeffs"] = _deep_list(
            MAX_DOC_DEPTH + 4)

    def bad_machine(d):
        d["machine"] = {"ds": 0}

    return {
        "bad_version": (bad_version, F_VERSION),
        "unknown_field": (unknown_field, F_FIELD),
        "drop_trip": (drop_trip, F_FIELD),
        "step_zero": (step_zero, "V_STEP_ZERO"),
        "trip_string": (trip_string, "V_COEFF_SHAPE"),
        "coeffs_long": (coeffs_long, "V_COEFF_SHAPE"),
        "bad_slot": (bad_slot, "V_SLOT"),
        "huge_trip": (huge_trip, F_RANGE),
        "no_nests": (no_nests, "V_NO_NESTS"),
        "parallel_tri": (parallel_tri, "V_PARALLEL_TRIANGULAR"),
        "deep_coeffs": (deep_coeffs, F_LIMIT),
        "bad_machine": (bad_machine, F_MACHINE),
    }


def mutate_invalid(doc: dict, seed: int, count: int = 4) -> list:
    """`count` deterministic (mutant_name, damaged_doc, expected_code)
    triples for this seed, each derived from a fresh copy of `doc`."""
    import copy

    rng = np.random.default_rng(seed + 104729)
    table = _mutations()
    names = rng.permutation(sorted(table))[:count]
    out = []
    for name in names:
        mutator, code = table[str(name)]
        damaged = copy.deepcopy(doc)
        mutator(damaged)
        out.append((str(name), damaged, code))
    return out


def _fold_mrc(state, machine: MachineConfig) -> np.ndarray:
    from ..runtime.aet import aet_mrc
    from ..runtime.cri import cri_distribute

    rih = cri_distribute(state, machine.thread_num, machine.thread_num)
    return np.asarray(aet_mrc(rih, machine), dtype=np.float64)


def _states_equal(a, b, thread_num: int) -> bool:
    for t in range(thread_num):
        if a.noshare[t] != b.noshare[t] or a.share[t] != b.share[t]:
            return False
    return True


def _sharded_mesh(device):
    """Two shards for the sharded check: two cards where the run's device
    is a card and there are two, else two shards of the one device."""
    import torch

    from ..parallel.mesh import build_mesh

    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        return build_mesh(2)
    return build_mesh(devices=[dev, dev])


def check_seed(seed: int, ratio: float = RATIO,
               drift_max: float = DRIFT_MAX,
               n_mutants: int = 4, sampled: bool = True,
               batched: bool = False, sharded: bool = False,
               kernel_backends: tuple = (), device=None) -> dict:
    """Run the full contract for one seed on `device` (CUDA unless the
    CPU is asked for); returns a result dict with `ok` plus per-check
    fields (never raises on a contract failure — failures land in
    `errors` so a sweep reports them all).

    `sampled=False` skips the sampled-engine drift check.

    `batched=True` additionally runs the seed's program through
    run_sampled_multi in a 3-job union bucket (primary, a companion
    from seed+1, primary again) and requires job 0 bit-identical to
    the solo run and job 2 bit-identical to job 0. `sharded=True` runs
    run_sampled_sharded on a 2-shard mesh (`_sharded_mesh`) and
    requires bit-identity to solo. Both imply a solo sampled run.

    `kernel_backends` re-runs the solo sampled config once per named
    backend ("cuda" | "torch" | "native") and requires each run's
    PRIState AND folded MRC bit-identical to the solo run — the solo
    run is itself drift-checked against the numpy oracle, so every
    backend is transitively pinned to the oracle. Implies a solo
    sampled run."""
    from ..oracle.numpy_ref import run_numpy
    from ..sampler.periodic import run_exact

    errors = []
    program = generate_program(seed)
    machine = generate_machine(seed)
    doc = generate_doc(seed)

    res = parse_program_doc(doc)
    if res.program != program:
        errors.append("roundtrip: parsed program differs from source")

    oracle = run_numpy(program, machine)
    mrc_oracle = _fold_mrc(oracle.state, machine)

    exact = run_exact(program, machine, device=device)
    exact_ok = True
    for t in range(machine.thread_num):
        if (exact.state.noshare[t] != oracle.state.noshare[t]
                or exact.state.share[t] != oracle.state.share[t]):
            exact_ok = False
    mrc_exact = _fold_mrc(exact.state, machine)
    if not exact_ok or mrc_exact.tobytes() != mrc_oracle.tobytes():
        errors.append("exact: PRIState/MRC not bit-identical to oracle")

    drift = 0.0
    if sampled or batched or sharded or kernel_backends:
        from ..config import SamplerConfig
        from ..sampler.sampled import run_sampled

        cfg = SamplerConfig(ratio=ratio, seed=seed)
        state, _ = run_sampled(program, machine, cfg, device=device)
        mrc_sampled = _fold_mrc(state, machine)
        k = min(len(mrc_sampled), len(mrc_oracle))
        drift = float(np.max(
            np.abs(mrc_sampled[:k] - mrc_oracle[:k]))) if k else 0.0
        if sampled and drift > drift_max:
            errors.append(
                f"sampled: MRC drift {drift:.3f} exceeds {drift_max}")

    for backend in kernel_backends:
        import dataclasses as _dc

        state_b, _ = run_sampled(
            program, machine, _dc.replace(cfg, kernel_backend=backend),
            device=device)
        if (not _states_equal(state_b, state, machine.thread_num)
                or _fold_mrc(state_b, machine).tobytes()
                != mrc_sampled.tobytes()):
            errors.append(
                f"kernel_backend={backend}: PRIState/MRC not "
                "bit-identical to solo")

    if batched:
        from ..sampler.sampled import run_sampled_multi

        # a 3-job union bucket: the companion forces genuinely mixed
        # batch membership, and the repeated primary must come back
        # bit-identical to the first copy
        companion = (generate_program(seed + 1),
                     generate_machine(seed + 1),
                     SamplerConfig(ratio=ratio, seed=seed + 1), False)
        outs = run_sampled_multi([
            (program, machine, cfg, False), companion,
            (program, machine, cfg, False),
        ], device=device)
        b0, b2 = outs[0][0], outs[2][0]
        if (not _states_equal(b0, state, machine.thread_num)
                or _fold_mrc(b0, machine).tobytes()
                != mrc_sampled.tobytes()):
            errors.append(
                "batched: job 0 PRIState/MRC not bit-identical to solo")
        if (not _states_equal(b2, b0, machine.thread_num)
                or _fold_mrc(b2, machine).tobytes()
                != _fold_mrc(b0, machine).tobytes()):
            errors.append(
                "batched: repeated member diverges inside one bucket")

    if sharded:
        from ..parallel.sharded import run_sampled_sharded

        state_sh, _ = run_sampled_sharded(
            program, machine, cfg, mesh=_sharded_mesh(
                "cuda" if device is None else device))
        if (not _states_equal(state_sh, state, machine.thread_num)
                or _fold_mrc(state_sh, machine).tobytes()
                != mrc_sampled.tobytes()):
            errors.append(
                "sharded: PRIState/MRC not bit-identical to solo "
                "on the 2-device mesh")

    rejected = 0
    mutants = mutate_invalid(doc, seed, count=n_mutants)
    for name, damaged, code in mutants:
        try:
            mres = parse_program_doc(damaged)
        except Exception as e:  # a crash is exactly the bug we hunt
            errors.append(f"mutant {name}: parser raised {e!r}")
            continue
        codes = [d.code for d in mres.errors()]
        if mres.program is not None:
            errors.append(f"mutant {name}: accepted (expected {code})")
        elif code not in codes:
            errors.append(
                f"mutant {name}: rejected with {codes}, expected {code}")
        else:
            rejected += 1

    return {
        "seed": seed,
        "ok": not errors,
        "program": program.name,
        "depth": len(program.nests[0].loops),
        "refs": len(program.nests[0].refs),
        "accesses": res.total_accesses,
        "sampled_drift": round(drift, 4),
        "mutants_rejected": f"{rejected}/{len(mutants)}",
        "errors": errors,
    }


def run_seeds(n: int, start: int = 0, ratio: float = RATIO,
              drift_max: float = DRIFT_MAX, n_mutants: int = 4,
              sampled: bool = True, batched: bool = False,
              sharded: bool = False, kernel_backends: tuple = (),
              progress=None, device=None) -> dict:
    """Sweep seeds [start, start+n) on `device`; summary dict with
    every failing seed's result embedded (empty `failures` == clean
    sweep)."""
    failures = []
    worst: Optional[dict] = None
    for seed in range(start, start + n):
        r = check_seed(seed, ratio=ratio, drift_max=drift_max,
                       n_mutants=n_mutants, sampled=sampled,
                       batched=batched, sharded=sharded,
                       kernel_backends=kernel_backends, device=device)
        if worst is None or r["sampled_drift"] > worst["sampled_drift"]:
            worst = r
        if not r["ok"]:
            failures.append(r)
        if progress is not None:
            progress(r)
    return {
        "seeds": n,
        "start": start,
        "ratio": ratio,
        "drift_max": drift_max,
        "passed": n - len(failures),
        "failed": len(failures),
        "worst_drift": worst["sampled_drift"] if worst else 0.0,
        "worst_drift_seed": worst["seed"] if worst else None,
        "failures": failures,
    }
