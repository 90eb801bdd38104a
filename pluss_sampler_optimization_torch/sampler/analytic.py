"""Analytic exact engine: closed-form next-use, aggregated per period.

Port of the JAX package's sampler/analytic.py. The periodic engine
(sampler/periodic.py) rejects two program classes — triangular nests
(per-period trip counts) and arrays mixing parallel-loop coefficients
(syrk's A[i][k] vs A[j][k]). This engine gives those classes an exact
path:

1. **The closed-form next-use solver is exact per access.** For any
   supported nest (affine refs, unit-step triangular bounds), every
   access's reuse interval is solved in O(1) by the machinery the
   sampled engine uses (sampler/nextuse.py) — over the thread's whole
   remaining trace, so NO skip-free-reuse precondition is needed. The
   exact histogram of one period (all inner iterations of one parallel
   iteration v0) is one classify over the period's box. On CUDA that
   classify is kernel B1's raw-noshare form (csrc/sampled_hist.cu
   through ops/sampled_hist.py::sampled_hist(raw=True): every found
   key's packed slot comes back in `residual`, 2^62 where the line is
   never touched again); on the CPU, and under kernel_backend "torch",
   its plain version.

2. **Per-period histograms are piecewise affine in v0.** Within a
   class of structurally equivalent periods — same chunk position,
   same line-granule phase, away from the thread's trailing chunks —
   the histogram's slot values and counts are affine functions of v0.
   The engine VERIFIES this at >= _MIN_PROBES probe periods per class
   (ends, middle and seeded random interiors, all exact evaluations);
   an exact affine fit through all probes is then summed over the class
   in closed form, with the per-period count identity sum(slot counts)
   + cold == box size checked across the class. Any class that fails
   the fit — or is too small to probe — is bisected down to
   period-by-period evaluation (exact, just slower). Large 3-deep boxes
   apply the same fit one level down, along the rows of a period.

The host planning (boxes, probes, row plans, fits, bisection, folds) is
the JAX package's code verbatim; each classify chunk of up to `batch`
keys is one launch (per shard with a mesh) and one read back, and the
distinct slots of each row or box are counted on the host (np.unique).
Nests at or below _HOST_FOLD_MAX_ACCESSES fold through the host lexsort
(oracle/numpy_ref.py::fold_nest_numpy), exact by construction. A mesh
splits each chunk into equal slices, one per shard, reassembled by
position (parallel/sharded.py::run_analytic_sharded); each key's solve
is independent, so the results are the single device's.

Exactness is PROVEN (pinned against the serial oracle in the JAX
package's tests/test_analytic.py) for the audited families
(AUDITED_FAMILIES); another family routed here by `run_exact` inherits
the probe-backed verification, and `warn_if_unaudited` says so.
"""

from __future__ import annotations

import contextlib
import functools
import re
import sys
import time

import numpy as np
import torch

from ..analysis.validate import structural_signature
from ..config import MachineConfig
from ..core.trace import NestTrace
from ..ir import Program
from ..ops.histogram import SENTINEL
from ..oracle.serial import OracleResult
from ..runtime.hist import PRIState
from .periodic import _phase_count
from .sampled import (
    _NOSHARE_SLOT,
    _RATIO_SLOTS,
    _pad_highs,
    _program_rows,
    check_native,
    default_batch,
    resolve_device,
)

_MIN_PROBES = 6  # exact evaluations per fitted class (incl. random)
_COLD_KEY = "cold"


class _Telemetry:
    """The run's host spans and counters: `span(name)` adds the block's
    host seconds to the active run's spans[name], `count(name)` adds to
    its counters (no-ops outside a run_analytic call given spans= or
    counters=); `warn_once` prints a warning once per key."""

    def __init__(self) -> None:
        self.spans: dict | None = None
        self.counters: dict | None = None
        self._warned: set = set()

    @contextlib.contextmanager
    def span(self, name: str, **_labels):
        if self.spans is None:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = (self.spans.get(name, 0.0)
                                + time.perf_counter() - t0)

    def count(self, name: str, n: int = 1) -> None:
        if self.counters is not None:
            self.counters[name] = self.counters.get(name, 0) + n

    def warn_once(self, key, message: str, **_data) -> None:
        if key in self._warned:
            return
        self._warned.add(key)
        print(message, file=sys.stderr)


telemetry = _Telemetry()

# Model families whose analytic-route exactness is PROVEN — pinned
# bit-equal vs the oracle across sizes/geometries by the JAX package's
# tests/test_analytic.py and/or covered by recorded
# tools/verify_analytic.py audits. `run_exact`'s analytic route warns
# for any family outside this set. Names record the *provenance* of the
# audits (the Program.name prefix before the size suffix); the
# membership test itself is signature-derived — see `audited_family`.
AUDITED_FAMILIES = frozenset({
    "gemm", "syrk", "syrk-tri", "trmm", "trisolv", "covariance",
    "adi", "fdtd2d",
})


@functools.lru_cache(maxsize=None)
def _registry_family_builders() -> dict:
    """family name (Program.name prefix) -> (builder, takes_tsteps)
    for every registry model, so a bare name can be re-anchored to the
    IR its family's builder produces."""
    import inspect

    from ..models import REGISTRY

    out: dict = {}
    for fn in REGISTRY.values():
        has_t = "tsteps" in inspect.signature(fn).parameters
        prog = fn(8, tsteps=1) if has_t else fn(8)
        out[re.split(r"-\d", prog.name)[0]] = (fn, has_t)
    return out


@functools.lru_cache(maxsize=None)
def _audited_signatures(families: frozenset) -> frozenset:
    """Structural signatures (analysis/validate.py::structural_signature)
    of the audited families' IR (token size n=8; signatures are
    size-invariant). Time-axis models are seeded at tsteps in {1, 2, 3}:
    fdtd2d's first time step lacks the previous iteration's state, so
    ts=1/ts=2/ts>=3 are three distinct (all audited) signature
    variants."""
    sigs = set()
    for fam, (fn, has_t) in _registry_family_builders().items():
        if fam not in families:
            continue
        for ts in (1, 2, 3) if has_t else (1,):
            prog = fn(8, tsteps=ts) if has_t else fn(8)
            sigs.add(structural_signature(prog))
    return frozenset(sigs)


def audited_family(name_or_program) -> bool:
    """True when a Program (or a Program.name, e.g. 'syrk-tri-24x24')
    has the structural signature of an audited family.

    A Program is matched by its own signature. A bare name is mapped
    family -> registry builder -> signature (rebuilt at a token size;
    for time-axis names the '-t<k>' suffix picks the signature
    variant); names from families the registry does not know fall back
    to plain `AUDITED_FAMILIES` membership."""
    families = AUDITED_FAMILIES  # module attr: tests monkeypatch it
    sigs = _audited_signatures(families)
    if isinstance(name_or_program, Program):
        return structural_signature(name_or_program) in sigs
    name = name_or_program
    fam = re.split(r"-\d", name)[0]
    builders = _registry_family_builders()
    if fam not in builders:
        return fam in families
    fn, has_t = builders[fam]
    if not has_t:
        return structural_signature(fn(8)) in sigs
    m = re.search(r"-t(\d+)$", name)
    ts = min(int(m.group(1)), 3) if m else 1
    return structural_signature(fn(8, tsteps=max(ts, 1))) in sigs


def warn_if_unaudited(program: Program) -> None:
    """Exact-router guard: a one-line stderr warning (once per family
    per process) when the analytic route serves a model whose
    structure is outside the audited set, instead of silently claiming
    bit-exactness."""
    if audited_family(program):
        return
    family = re.split(r"-\d", program.name)[0]
    telemetry.warn_once(
        ("analytic_unaudited", family),
        f"exact router: model {program.name!r} is outside the audited "
        "analytic-engine allowlist (tests/test_analytic.py); exactness "
        "is probe-backed, not proven — run tools/verify_analytic.py "
        "once for this (program, machine) to remove the assumption",
        kind="analytic_unaudited", model=program.name,
    )


def _analytic_default_batch(device) -> int:
    """Per-launch classify size: 2^15 keys on the CPU (a working set
    that stays in a host core's cache, the JAX package's CPU choice),
    the sampled engine's default_batch (2^20) on CUDA."""
    dev = torch.device(device)
    return 1 << 15 if dev.type == "cpu" else default_batch(dev)


def _box_geometry(nt: NestTrace, ref_idx: int, n0: int):
    """(t1, t2, box, highs) of one ref's inner box at period n0.

    `highs` is the CANONICAL radix — nest-wide maximum trips, not this
    period's box — so every period of a (possibly triangular) nest
    shares one decode radix and a whole block of periods classifies in
    one dispatch group (_eval_periods_block); only keys inside the
    period's real box are ever generated."""
    lv = int(nt.tables.ref_levels[ref_idx])
    v0 = nt.schedule.value(n0)
    t1 = int(nt.trip_at(1, v0)) if lv >= 1 else 1
    t2 = int(nt.trip_at(2, v0)) if lv >= 2 else 1
    highs = [
        nt.nest.loops[0].trip,
        max(nt.max_trips[1], 1) if lv >= 1 else 1,
        max(nt.max_trips[2], 1) if lv >= 2 else 1,
    ]
    return t1, t2, t1 * t2, highs


def _probe_positions(n: int, rng) -> set[int]:
    """Indices of one segment's probe members: both ends, the middle,
    and random draws until _MIN_PROBES distinct positions (the dedup
    loop keeps the documented probe count even when a draw collides
    with a fixed position). Single source for every fit level."""
    pos = {0, 1, n // 2, n - 2, n - 1}
    while len(pos) < min(_MIN_PROBES, n):
        pos.add(int(rng.integers(0, n)))
    return pos


_ROW_FIT_MIN = 96  # rows below this: classify the whole box directly
_ROW_MARGIN = 4  # leading/trailing rows always evaluated directly
# (margins and special-row neighborhoods are deliberately tight: a row
# outside them that deviates just fails its segment's fit and bisects —
# slower, never wrong — so these control speed, not soundness)



class _RawClassify:
    """One ref's classify on the run's devices: kernel B1's raw-noshare
    form (ops/sampled_hist.py::sampled_hist(raw=True), one [1, n] launch
    per call) where the backend resolves to the kernel, its plain
    version otherwise ("auto": the kernel for CUDA tensors, the plain
    version for CPU ones; "torch": plain; "cuda": the kernel, raising on
    the CPU). `devices` are where an unsharded call runs (the first
    one). The descriptor is made once; the value index, a triangular
    nest's base table and the descriptor's buffer-form copy (past the
    parameter form's words) once per device."""

    def __init__(self, nt: NestTrace, ref_idx: int, backend: str,
                 devices):
        from ..ops.sampled_hist import build_descriptor

        self.nt, self.ref_idx, self.backend = nt, ref_idx, backend
        self.devices = list(devices)
        self.desc = (None if backend == "torch"
                     else build_descriptor(nt, ref_idx))
        self._dev: dict = {}

    def _on(self, dev):
        if dev not in self._dev:
            from ..ops.sampled_hist import device_descriptor, tri_table

            kernel = self.backend == "cuda" or (
                self.backend == "auto" and dev.type == "cuda")
            self._dev[dev] = (
                torch.tensor([self.ref_idx], dtype=torch.int64,
                             device=dev),
                tri_table(self.nt, dev) if self.nt.tri and kernel
                else None,
                device_descriptor(self.desc, dev) if kernel else None,
            )
        return self._dev[dev]

    def __call__(self, keys: np.ndarray, ph, dev):
        """The residual of `keys` classified on `dev`: each found key's
        packed (reuse, slot) key, SENTINEL where never touched again."""
        from ..ops.sampled_hist import sampled_hist

        rx, tri, desc_dev = self._on(dev)
        chunk = torch.from_numpy(keys).to(dev)[None]
        residual, _hist, _cold = sampled_hist(
            self.nt, self.ref_idx, chunk, None, ph, rx, self.backend,
            self.desc, tri, raw=True, desc_dev=desc_dev,
        )
        return residual[0]


def _classify_keys(nt, kernel, ref_idx, keys, highs, batch, sharding=None):
    """(packed, found) for an arbitrary key vector, classified in
    chunks of at most `batch` keys, one launch each (host numpy arrays).

    `sharding` (a parallel/mesh.py::Mesh) splits each chunk into equal
    slices, one launch per shard on its device (the chunk padded with
    repeats of keys[0] to a multiple of the shard count); every key's
    classification is an independent closed-form solve, so the
    positionally reassembled outputs, cut to the chunk's keys, are the
    single-device call's."""
    ph = _pad_highs(highs)
    devs = kernel.devices[:1] if sharding is None else sharding.devices
    n_dev = len(devs)
    outs = []
    n = len(keys)
    with telemetry.span("classify", keys=n):
        for s0 in range(0, n, batch):
            n_valid = min(batch, n - s0)
            chunk = keys[s0 : s0 + n_valid]
            pad = (-n_valid) % n_dev
            if pad:
                chunk = np.concatenate(
                    [chunk, np.full(pad, keys[0], dtype=np.int64)])
            per = len(chunk) // n_dev
            res = []
            for i, dev in enumerate(devs):
                telemetry.count("dispatches")
                res.append(kernel(chunk[i * per : (i + 1) * per], ph, dev))
            with telemetry.span("fetch"):
                telemetry.count("fetches")
                r = np.concatenate([x.cpu().numpy() for x in res]
                                   )[:n_valid]
                telemetry.count("bytes_fetched_to_host", r.nbytes)
            outs.append(r)
    packed = np.concatenate(outs)
    return packed, packed != SENTINEL


def _slots_of(packed, found):
    slots: dict[int, int] = {}
    u, c = np.unique(packed[found], return_counts=True)
    for kk, cc in zip(u.tolist(), c.tolist()):
        slots[int(kk)] = int(cc)
    return slots, int((~found).sum())


def _plan_period_ref(nt, ref_idx: int, n0: int):
    """Host-only row plan for one (ref, period): which rows are
    evaluated directly (margins, enumerated special rows), the
    per-phase row classes with their first-round probe rows, and the
    initial `want` set — everything a batched prefetch needs before
    any classify runs. Returns None for an empty box; kind "full" for
    shallow/small boxes that classify every point."""
    from .sampled import _sink_groups

    t1, t2, box, highs = _box_geometry(nt, ref_idx, n0)
    if box == 0:
        return None
    base = n0 * highs[1] * highs[2]
    lv = int(nt.tables.ref_levels[ref_idx])
    if lv < 2 or t1 < _ROW_FIT_MIN:
        return {"kind": "full", "box": box, "base": base, "highs": highs,
                "t1": t1, "t2": t2}

    W = nt.machine.lines_per_element_block
    t = nt.tables
    sched = nt.schedule
    v0 = int(sched.value(n0))
    # rows whose inner value coincides with a parallel value the
    # source thread is about to execute (mixed-coefficient special
    # rows): this period's own v0 (syrk's j == i) AND the thread's
    # next few period values — an inter-chunk source's translating
    # reuse lands in the next chunk, so rows aligned with THAT
    # period's parallel value deviate too (found by the exhaustive
    # per-period sweep; tests/test_analytic.py pins it). Each center
    # gets a +-2 neighborhood evaluated directly.
    spec: set[int] = set()
    lp1 = nt.nest.loops[1]
    s1 = int(nt.start_at(1, v0))
    tid0 = int(sched.owner_tid(n0))
    m0 = int(sched.local_index(n0))
    lc0 = sched.local_count(tid0)
    # reach: the source thread's own remaining chunk plus the WHOLE
    # next chunk (2K periods) — a translating reuse lands at most one
    # owned chunk ahead for every registered model, and a model whose
    # reuse lands beyond the enumerated centers degrades to bisection
    # via the probe verification, not to a wrong result when a probe
    # catches it (see the soundness note in the module docstring)
    centers = [v0] + [
        int(sched.local_to_value(tid0, m0 + q))
        for q in range(1, 2 * sched.chunk + 1)
        if m0 + q < lc0
    ]
    for vc in centers:
        for dd in range(-2, 3):
            num = vc + dd - s1
            if num % lp1.step == 0:
                n1c = num // lp1.step
                if 0 <= n1c < t1:
                    spec.update(
                        x for x in range(n1c - 2, n1c + 3)
                        if 0 <= x < t1
                    )
    direct_rows = (
        set(range(min(_ROW_MARGIN, t1)))
        | set(range(max(t1 - _ROW_MARGIN, 0), t1))
        | spec
    )
    # line-granule phase along n1: rows repeat mod W unless every
    # relevant level-1 coefficient is granule-aligned
    sinks_all = {ref_idx}
    for grp in _sink_groups(nt, ref_idx):
        sinks_all.update(grp)
    phase = (
        W if any(int(t.ref_coeffs[j][1]) % W for j in sinks_all) else 1
    )
    rng = np.random.default_rng((n0, ref_idx))
    interior = [r for r in range(t1) if r not in direct_rows]
    classes = []
    want: set[int] = set(direct_rows)
    for p in range(phase):
        members = [r for r in interior if r % phase == p]
        if not members:
            continue
        if len(members) <= _MIN_PROBES + 4:
            want.update(members)
            classes.append((members, None))
            continue
        probe_rows = sorted(
            members[i] for i in _probe_positions(len(members), rng)
        )
        want.update(probe_rows)
        classes.append((members, probe_rows))
    return {
        "kind": "rows", "t1": t1, "t2": t2, "base": base,
        "highs": highs, "direct": sorted(direct_rows),
        "classes": classes, "want": sorted(want), "rng": rng,
    }


def _finish_period_ref(nt, kernel, ref_idx, n0, plan, row_memo, batch,
                       sharding=None):
    """Fit + aggregate one (ref, period) from a prefilled row memo.

    Large 3-deep boxes apply the engine's affine-fit machinery ONE
    LEVEL DOWN, along the n1 (row) axis inside the period: per-row
    histograms are piecewise affine in n1 by the same translation
    argument as the v0 level (each row shifts the touched-line pattern
    by a fixed amount), with the same defenses — exact row probes
    incl. randomized ones, exact integer fits, bisection on structural
    breaks (e.g. the coincidence row v1 == v0 of a mixed-coefficient
    array), margins and enumerated special rows evaluated directly,
    and the per-row count identity sum(slots)+cold == t2 enforced
    across each fitted segment. This is what makes a period cost ~40
    classified rows instead of t1: the classify itself is the engine's
    dominant cost (measured ~5.6M points/s single-core). Bisection
    rows missing from the memo are classified on demand.
    """
    t2 = plan["t2"]
    base = plan["base"]
    highs = plan["highs"]
    rng = plan["rng"]

    stride = plan["highs"][2]  # canonical radix row stride (>= t2)

    def eval_rows(rows: list) -> None:
        rows = [r for r in rows if r not in row_memo]
        if not rows:
            return
        keys = np.concatenate([
            base + r * stride + np.arange(t2, dtype=np.int64)
            for r in rows
        ])
        packed, found = _classify_keys(
            nt, kernel, ref_idx, keys, highs, batch, sharding
        )
        for i, r in enumerate(rows):
            row_memo[r] = _slots_of(
                packed[i * t2 : (i + 1) * t2],
                found[i * t2 : (i + 1) * t2],
            )

    def row_dict(r: int) -> dict:
        slots, cold = row_memo[r]
        d = {(0, kk): cc for kk, cc in slots.items()}
        if cold:
            d[(0, _COLD_KEY)] = cold
        return d

    out: dict[int, int] = {}
    cold_total = 0

    def add_direct(r: int) -> None:
        slots, cold = row_memo[r]
        nonlocal cold_total
        cold_total += cold
        for kk, cc in slots.items():
            out[kk] = out.get(kk, 0) + cc

    def fit_rows(members: list, probe_rows=None) -> None:
        nonlocal cold_total
        if len(members) <= _MIN_PROBES + 4:
            eval_rows(members)
            for r in members:
                add_direct(r)
            return
        if probe_rows is None:
            probe_rows = sorted(
                members[p] for p in _probe_positions(len(members), rng)
            )
        with telemetry.span("probe_verify", level="row",
                            probes=len(probe_rows)):
            eval_rows(probe_rows)
            model = _fit_affine(
                probe_rows, [row_dict(r) for r in probe_rows]
            )
        if model is None:
            mid = len(members) // 2
            fit_rows(members[:mid])
            fit_rows(members[mid:])
            return
        # per-row count identity across the whole segment: the model
        # total is affine in n1 and must equal the constant t2
        for r_chk in (members[0], members[len(members) // 2],
                      members[-1]):
            total = sum(c + d * r_chk for (a, b, c, d) in model.values())
            if total != t2:
                # identity miss = structural surprise: take the sound
                # path (bisect toward direct evaluation), never abort
                # and never emit the suspect model
                mid = len(members) // 2
                fit_rows(members[:mid])
                fit_rows(members[mid:])
                return
        ms = np.asarray(members, dtype=np.int64)
        for (_ri, _si, is_cold), (a, b, c, d) in model.items():
            cnts = c + d * ms
            if is_cold:
                cold_total += int(cnts.sum())
            elif b == 0:
                out[a] = out.get(a, 0) + int(cnts.sum())
            else:
                for vv, cc in zip((a + b * ms).tolist(), cnts.tolist()):
                    if cc:
                        out[vv] = out.get(vv, 0) + cc

    for r in plan["direct"]:
        add_direct(r)
    for members, probe_rows in plan["classes"]:
        fit_rows(members, probe_rows)
    return out, cold_total


def _first_round_keys_estimate(nt, ref_idx: int, n0) -> int:
    """Host-side estimate of one (ref, period)'s first-dispatch key
    volume — the full box for shallow/small boxes, ~the probed/direct
    row set otherwise. Only block sizing depends on this (memory and
    dispatch granularity), never results."""
    t1, t2, box, _ = _box_geometry(nt, ref_idx, int(n0))
    lv = int(nt.tables.ref_levels[ref_idx])
    if lv < 2 or t1 < _ROW_FIT_MIN:
        return max(box, 1)
    return max(min(box, 64 * max(t2, 1)), 1)


def _period_blocks(nt, ref_idx: int, n0s, batch: int):
    """Split a period list into dispatch blocks whose estimated
    first-round key volume stays near a few batches, so an arbitrarily
    long period list (adi's all-direct head) becomes a handful of
    mega-dispatches instead of one dispatch per period, while a block
    of large boxes (syrk N>=1024 rows plans) never concatenates an
    unbounded host key buffer."""
    budget = max(4 * batch, 1 << 18)
    blocks: list[list[int]] = []
    cur: list[int] = []
    acc = 0
    for n0 in n0s:
        cur.append(int(n0))
        acc += _first_round_keys_estimate(nt, ref_idx, n0)
        if acc >= budget:
            blocks.append(cur)
            cur, acc = [], 0
    if cur:
        blocks.append(cur)
    return blocks


def _eval_periods_block(nt, kernel, ref_idx, n0s, batch, sharding=None):
    """{n0: (slots, cold)} for a BLOCK of periods of one ref: all the
    periods' first-round rows (and full small boxes) classify in one
    chunked mega-dispatch, killing the per-call overhead that
    dominated period-by-period evaluation (measured ~3 ms/dispatch
    against ~10k-point row sets at syrk-tri N=1536)."""
    with telemetry.span("period_block", ref=int(ref_idx),
                        periods=len(n0s)):
        return _eval_periods_block_inner(
            nt, kernel, ref_idx, n0s, batch, sharding
        )


def _eval_periods_block_inner(nt, kernel, ref_idx, n0s, batch,
                              sharding=None):
    plans = {}
    segs = []  # (n0, row | "full", start, length)
    parts = []
    off = 0
    for n0 in n0s:
        plan = _plan_period_ref(nt, ref_idx, n0)
        plans[n0] = plan
        if plan is None:
            continue
        stride = plan["highs"][2]
        if plan["kind"] == "full":
            grid = (
                plan["base"]
                + np.arange(plan["t1"], dtype=np.int64)[:, None] * stride
                + np.arange(plan["t2"], dtype=np.int64)[None, :]
            ).ravel()
            parts.append(grid)
            segs.append((n0, "full", off, plan["box"]))
            off += plan["box"]
        else:
            t2, base = plan["t2"], plan["base"]
            for r in plan["want"]:
                parts.append(
                    base + r * stride + np.arange(t2, dtype=np.int64)
                )
                segs.append((n0, r, off, t2))
                off += t2
    results: dict = {}
    if off:
        # the canonical radix (_box_geometry) is n0-invariant, so the
        # whole block classifies in one chunked call
        packed, found = _classify_keys(
            nt, kernel, ref_idx, np.concatenate(parts),
            plans[segs[0][0]]["highs"], batch, sharding,
        )
        memos: dict[int, dict] = {}
        for n0, r, s, ln in segs:
            pf = (packed[s : s + ln], found[s : s + ln])
            if r == "full":
                results[n0] = _slots_of(*pf)
            else:
                memos.setdefault(n0, {})[r] = _slots_of(*pf)
        for n0 in n0s:
            plan = plans[n0]
            if plan is None:
                results[n0] = ({}, 0)
            elif plan["kind"] == "rows":
                results[n0] = _finish_period_ref(
                    nt, kernel, ref_idx, n0, plan, memos.get(n0, {}),
                    batch, sharding,
                )
    else:
        for n0 in n0s:
            results[n0] = ({}, 0)
    return results


def _eval_period_ref(nt, kernel, ref_idx, n0, batch, sharding=None):
    """Exact histogram of ONE ref's accesses in ONE period, as
    {packed_key: count} plus the cold count (see _finish_period_ref
    for the row-fit machinery)."""
    return _eval_periods_block(
        nt, kernel, ref_idx, [n0], batch, sharding
    )[n0]


def _eval_period(nt, nest_kernels, n0, batch, sharding=None):
    """{(ref_idx, packed) | (ref_idx, "cold"): count} for one period."""
    out: dict = {}
    for ri, kernel in nest_kernels:
        slots, cold = _eval_period_ref(nt, kernel, ri, n0, batch, sharding)
        for kk, cc in slots.items():
            out[(ri, kk)] = cc
        if cold:
            out[(ri, _COLD_KEY)] = cold
    return out


def _fit_affine(ns: list, evals: list) -> dict | None:
    """Exact affine model {slot_id: (a, b, c, d)} with value = a + b*n,
    count = c + d*n, fitted through EVERY probe (integers, no
    residual), or None when the class is not affine.

    The model is derived from the two CLOSEST-spaced probes (matched
    by sorted value — slot value curves can cross over a class's full
    span, but between adjacent members a crossing would break the
    verification below and soundly reject the fit) and then verified
    against every other probe as a MULTISET: the predicted
    {(value(n), count(n))} must equal the evaluated set exactly,
    independent of order.
    """
    order = sorted(range(len(ns)), key=lambda i: ns[i])
    ns = [ns[i] for i in order]
    evals = [evals[i] for i in order]
    gaps = [ns[i + 1] - ns[i] for i in range(len(ns) - 1)]
    i0 = gaps.index(min(gaps))
    na, nb = ns[i0], ns[i0 + 1]

    def grouped(ev):
        per: dict = {}
        for (ri, kk), cc in ev.items():
            per.setdefault((ri, kk == _COLD_KEY), []).append((kk, cc))
        for items in per.values():
            items.sort(key=lambda t: (
                (t[0] if t[0] != _COLD_KEY else -2), t[1]
            ))
        return per

    ga, gb = grouped(evals[i0]), grouped(evals[i0 + 1])
    if set(ga) != set(gb):
        return None
    dn = nb - na
    model = {}
    for gk in ga:
        ia, ib = ga[gk], gb[gk]
        if len(ia) != len(ib):
            return None
        for si, ((ka, ca), (kb, cb)) in enumerate(zip(ia, ib)):
            if ka == _COLD_KEY:
                a, b = _COLD_KEY, 0
            else:
                if (kb - ka) % dn:
                    return None
                b = (kb - ka) // dn
                a = ka - b * na
            if (cb - ca) % dn:
                return None
            d = (cb - ca) // dn
            c = ca - d * na
            model[(gk[0], si, gk[1])] = (a, b, c, d)
    # multiset verification at every other probe
    for i, n in enumerate(ns):
        if i in (i0, i0 + 1):
            continue
        predicted: dict = {}
        for (ri, _si, is_cold), (a, b, c, d) in model.items():
            kk = _COLD_KEY if is_cold else a + b * n
            cnt = c + d * n
            if cnt < 0:
                return None
            if cnt:
                predicted[(ri, kk)] = predicted.get((ri, kk), 0) + cnt
        if predicted != evals[i]:
            return None
    return model


def _fold(state: PRIState, tid: int, packed, count: float) -> None:
    """One slot into the PRIState with runtime-v1 conventions (noshare
    pow2-binned on insertion, share raw, cold as the raw -1 key)."""
    if packed == _COLD_KEY:
        state.update_noshare(tid, -1, count)
        return
    value, slot = divmod(int(packed), _RATIO_SLOTS)
    if slot == _NOSHARE_SLOT:
        state.update_noshare(tid, value, count)
    else:
        state.update_share(tid, slot, value, count)



def validate_analytic(program: Program, machine: MachineConfig) -> None:
    """Raise NotImplementedError when a nest is outside the solver's
    closed-form family (the same gate as the sampled engine: affine
    refs with dominant positive strides, unit-step triangular bounds).
    """
    _program_rows(program, machine)


# Nests at or below this many total accesses fold through the host
# lexsort (oracle/numpy_ref.py::fold_nest_numpy) instead of the
# classify machinery: the whole per-thread sort is milliseconds there.
# Exactness is unchanged: the host fold is the numpy oracle's own code.
_HOST_FOLD_MAX_ACCESSES = 1 << 22


def run_analytic(
    program: Program,
    machine: MachineConfig,
    batch: int | None = None,
    seed: int = 0,
    mesh=None,
    host_cutoff: int | None = None,
    device=None,
    kernel_backend: str = "auto",
    spans: dict | None = None,
    counters: dict | None = None,
) -> OracleResult:
    """Exact engine for any nest the closed-form solver covers;
    bit-identical to the serial oracle / dense / stream engines. Runs
    on CUDA unless `device="cpu"` (or a mesh of CPU devices).

    `mesh` (parallel/mesh.py::Mesh) splits every classify launch's keys
    over its shards (see _classify_keys) — same results, because each
    key's solve is independent and the outputs reassemble positionally.

    `host_cutoff` (default _HOST_FOLD_MAX_ACCESSES) is the nest size at
    or below which the exact fold runs as one host lexsort per thread
    instead of the period machinery; pass 0 to force every nest through
    the period/fit machinery. `batch` is the keys per classify launch
    (default: 2^15 on the CPU, 2^20 on CUDA). `kernel_backend` picks the
    classify as the sampled engine's knob does ("auto": kernel B1's raw
    form on CUDA, the plain version on the CPU). Each row's or box's
    slots are counted on the host (np.unique after one read back per
    chunk). `spans` gathers host seconds ("classify", "fetch",
    "period_block", "probe_verify", "fold"), `counters` the launches
    ("dispatches") and read backs ("fetches").
    """
    trace, _ = _program_rows(program, machine)  # the gate
    if mesh is not None:
        devices = list(mesh.devices)
        if device is not None and torch.device(device).type != (
                devices[0].type):
            raise ValueError(f"device={device!r} disagrees with the "
                             f"mesh's devices {mesh.devices}")
    else:
        devices = [resolve_device(device)]
    for d in devices:
        check_native(kernel_backend, d)
    if kernel_backend == "native":  # the CPU's plain classify: the
        kernel_backend = "torch"    # native route is the sampled engine's
    if batch is None:
        batch = _analytic_default_batch(devices[0])
    sharding = mesh if mesh is not None and mesh.size > 1 else None
    if host_cutoff is None:
        host_cutoff = _HOST_FOLD_MAX_ACCESSES
    telemetry.spans, telemetry.counters = spans, counters
    try:
        return _run_analytic(trace, machine, batch, seed, sharding,
                             host_cutoff, devices, kernel_backend)
    finally:
        telemetry.spans = telemetry.counters = None


def _run_analytic(trace, machine, batch, seed, sharding, host_cutoff,
                  devices, backend) -> OracleResult:
    P = machine.thread_num
    state = PRIState(P)
    rng = np.random.default_rng(seed)
    per_tid = [0] * P
    for tid in range(P):
        per_tid[tid] = sum(nt.tid_length(tid) for nt in trace.nests)
    for k, nt in enumerate(trace.nests):
        if sum(nt.tid_length(t) for t in range(P)) <= host_cutoff:
            from ..oracle.numpy_ref import fold_nest_numpy

            with telemetry.span("fold", nest=k, route="host_lexsort"):
                for tid in range(P):
                    fold_nest_numpy(nt, tid, state)
            continue
        nest_kernels = [
            (ri, _RawClassify(nt, ri, backend, devices))
            for ri in range(nt.tables.n_refs)
        ]
        sched = nt.schedule
        trip0 = sched.trip
        K, T = sched.chunk, sched.threads
        if nt.tri:
            # v0-level fitting cannot engage on a triangular nest: the
            # per-period histogram's own slot count grows with the
            # period's row count, so no two periods share a slot
            # structure. Every period is evaluated exactly instead —
            # the per-period row fits already cut a period to ~40
            # classified rows, and ref-major BLOCKS amortize the
            # dispatch overhead that would otherwise dominate.
            tid_of_t = np.asarray(
                sched.owner_tid(np.arange(trip0, dtype=np.int64))
            )
            for ri, kern in nest_kernels:
                for blk in _period_blocks(nt, ri, range(trip0), batch):
                    res = _eval_periods_block(
                        nt, kern, ri, blk, batch, sharding
                    )
                    with telemetry.span("fold", nest=k, route="direct"):
                        for n0, (slots, cold) in res.items():
                            tid = int(tid_of_t[n0])
                            for kk, cc in slots.items():
                                _fold(state, tid, kk, float(cc))
                            if cold:
                                _fold(state, tid, _COLD_KEY, float(cold))
            continue
        g = _phase_count(nt)
        n_all = np.arange(trip0, dtype=np.int64)
        tid_of = np.asarray(sched.owner_tid(n_all))
        m_of = np.asarray(sched.local_index(n_all))
        lc = np.array([sched.local_count(t) for t in range(T)])
        # Trailing-chunk periods see end-of-thread truncation (their
        # reuses may have no successor period); evaluate them directly.
        tail = m_of >= np.maximum(lc[tid_of] - 2 * K, 0)
        # Leading periods can deviate from the class's affine line at
        # v0-coincidence values (e.g. the special row j == v0 sitting
        # inside the first line block deviated at exactly v0 == W for
        # syrk): for the zero-const affine maps of this family, such
        # thresholds live within O(W) of the parallel range's edges,
        # so a 2W + chunk-round head margin is evaluated directly.
        # The trailing edge is inside the tail mask already.
        head = n_all < (
            2 * nt.machine.lines_per_element_block + K * T
        )
        v0_all = np.asarray(sched.value(n_all))
        phase = (v0_all % g) if g > 1 else np.zeros_like(n_all)
        cls_key = (n_all % K) * g + phase
        direct: list[int] = n_all[tail | (head & ~tail)].tolist()
        eval_memo: dict[int, dict] = {}

        def peval(n: int) -> dict:
            if n not in eval_memo:
                eval_memo[n] = _eval_period(
                    nt, nest_kernels, n, batch, sharding
                )
            return eval_memo[n]

        def peval_block(ns) -> None:
            """Prefetch many periods' exact evaluations into the memo
            as ref-major key-bounded mega-dispatches. Results are
            identical to per-period peval calls by construction: the
            memo entries are built from the same _eval_periods_block
            evaluations, only grouped."""
            missing = sorted(
                {int(n) for n in ns} - eval_memo.keys()
            )
            if not missing:
                return
            per_ref: dict[int, dict] = {}
            for ri, kern in nest_kernels:
                res: dict = {}
                for blk in _period_blocks(nt, ri, missing, batch):
                    res.update(_eval_periods_block(
                        nt, kern, ri, blk, batch, sharding
                    ))
                per_ref[ri] = res
            for n in missing:
                out: dict = {}
                for ri, _ in nest_kernels:
                    slots, cold = per_ref[ri][n]
                    for kk, cc in slots.items():
                        out[(ri, kk)] = cc
                    if cold:
                        out[(ri, _COLD_KEY)] = cold
                eval_memo[n] = out

        def fit_or_split(members: np.ndarray) -> None:
            """Fit one affine segment over `members`, bisecting on
            failure: mid-class structural breaks exist and are
            N-dependent (e.g. syrk's translating reuse value crosses
            the share threshold at some v0, flipping its packed slot),
            so the class is piecewise affine and recursive bisection
            finds the segments. Exhausted segments fall back to exact
            period-by-period evaluation — the fit never gates
            correctness, only speed."""
            if len(members) <= _MIN_PROBES + 4:
                direct.extend(members.tolist())
                return
            probe_ns = sorted(
                int(members[p])
                for p in _probe_positions(len(members), rng)
            )
            with telemetry.span("probe_verify", level="v0",
                                probes=len(probe_ns)):
                peval_block(probe_ns)
                model = _fit_affine(
                    probe_ns, [peval(n) for n in probe_ns]
                )
            if model is None:
                mid = len(members) // 2
                fit_or_split(members[:mid])
                fit_or_split(members[mid:])
                return
            # the per-period total-count identity must hold for EVERY
            # member: sum over slots of (c + d*n) + cold == box(n). The
            # model total is affine; box(n) is affine or (doubly
            # triangular) quadratic in n, so checking THREE points
            # separates them — an affine function agreeing with the
            # model at 3 points is the model.
            for n_chk in (
                int(members[0]),
                int(members[len(members) // 2]),
                int(members[-1]),
            ):
                total = sum(
                    c + d * n_chk for (a, b, c, d) in model.values()
                )
                box_chk = sum(
                    _box_geometry(nt, ri, n_chk)[2]
                    for ri, _ in nest_kernels
                )
                if total != box_chk:
                    # identity miss = structural surprise: take the
                    # sound path instead of emitting the suspect model
                    mid = len(members) // 2
                    fit_or_split(members[:mid])
                    fit_or_split(members[mid:])
                    return
            for (ri, si, is_cold), (a, b, c, d) in model.items():
                for n in members.tolist():
                    cnt = c + d * n
                    if cnt:
                        _fold(
                            state, int(tid_of[n]),
                            a if is_cold else a + b * n, float(cnt),
                        )

        for ck in np.unique(cls_key):
            members = n_all[(cls_key == ck) & ~tail & ~head]
            if len(members):
                fit_or_split(members)
        peval_block(direct)
        with telemetry.span("fold", nest=k, route="direct"):
            for n in direct:
                ev = peval(int(n))
                for (ri, kk), cc in ev.items():
                    _fold(state, int(tid_of[n]), kk, float(cc))
    return OracleResult(
        state=state,
        total_accesses=sum(per_tid),
        per_tid_accesses=per_tid,
    )
