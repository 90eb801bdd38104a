"""Audit a sampled run's dispatch economics from its telemetry JSON;

The port's twin of the JAX package's tools/check_dispatch_stats.py: the same
command line and output, on the port's modules.
exit nonzero when cross-ref fusion silently regressed.

The fused sampled engine (pluss_sampler_optimization_torch/sampler/
sampled.py::_sampled_outputs_fused and the sharded twin) promises one
dispatch per kernel-signature bucket per chunk group, and exports the
plan as gauges: `ref_buckets` (buckets that dispatched) and
`expected_chunks` (the largest per-bucket dispatch count). A fusion
regression — refs falling out of their bucket, a chunk plan
fragmenting — shows up as `dispatches` exceeding the bucket plan's
ceiling, long before any wall-time benchmark notices. This checker is
the contract's enforcement point:

    dispatches <= ref_buckets * expected_chunks + capacity_regrows

(each capacity regrow legitimately re-runs one bucket dispatch).
Runs with kernel_backend="native" export their own plan, checked the
same way:

    dispatches_native <= native_chunk_plan

(native regrows are host-side C re-calls, never re-dispatches, so the
plan is a hard ceiling). Exercised from the test suite
(tests/test_torch_telemetry.py) like the other check_* tools, so tier-1
catches regressions.

    python -m pluss_sampler_optimization_torch.tools.check_dispatch_stats TELEMETRY.json [more.json ...]

Documents without the fusion gauges (unfused runs, other engines) are
skipped by default; pass --require-fused to fail on them instead —
the bench sidecar for a --fuse-refs run should never lack the gauges.
"""

from __future__ import annotations

import argparse
import json
import sys


def check(doc) -> tuple[str | None, str | None]:
    """(error, note) for one parsed telemetry document. error=None
    means the document passes; note=None means nothing to report.
    Single source of truth for the tool AND the tests."""
    if not isinstance(doc, dict):
        return "document is not a JSON object", None
    counters = doc.get("counters")
    gauges = doc.get("gauges")
    if not isinstance(counters, dict) or not isinstance(gauges, dict):
        return "missing counters/gauges objects", None
    # native fast-path accounting rides the same sidecar: the serial
    # runner exports its chunk plan as the `native_chunk_plan` counter
    # (a counter, not a gauge, so multi-rep bench accumulation keeps
    # the bound meaningful) and stamps every native dispatch into
    # `dispatches_native`. One native chunk is exactly one raw-kernel
    # dispatch, and capacity regrows happen host-side (a C re-call,
    # never a re-dispatch), so the plan is a hard ceiling.
    native = counters.get("dispatches_native")
    native_note = None
    if native is not None:
        plan = counters.get("native_chunk_plan")
        if plan is None:
            return (
                f"dispatches_native {native:g} recorded without a "
                "native_chunk_plan counter — native accounting "
                "regressed",
                None,
            )
        if native > plan:
            return (
                f"dispatches_native {native:g} exceed the chunk "
                f"plan {plan:g} — native fast path re-dispatched",
                None,
            )
        native_note = f"native {native:g} <= plan {plan:g}"
    union = gauges.get("ref_buckets_union")
    buckets = union if union is not None else gauges.get("ref_buckets")
    chunks = gauges.get("expected_chunks")
    if buckets is None or chunks is None:
        if native_note:
            # the native path is serial by construction, so lacking
            # the fusion gauges is its normal shape
            return None, (
                f"{native_note}; no fusion gauges (native/unfused "
                "run) — fusion bound skipped"
            )
        return None, "no fusion gauges (unfused run?) — skipped"
    # batched (cross-request) runs export ref_buckets_union: the bound
    # is over the UNION bucket plan, the whole point of merging —
    # K requests' dispatches must not exceed one union plan's ceiling
    kind = "union buckets" if union is not None else "buckets"
    dispatches = counters.get("dispatches", 0)
    regrows = counters.get("capacity_regrows", 0)
    bound = buckets * chunks + regrows
    if dispatches > bound:
        return (
            f"dispatches {dispatches:g} exceed the bucket plan's "
            f"ceiling {bound:g} ({kind} {buckets:g} * "
            f"expected_chunks {chunks:g} + capacity_regrows "
            f"{regrows:g}) — cross-ref fusion regressed",
            None,
        )
    note = (
        f"dispatches {dispatches:g} <= {bound:g} "
        f"({buckets:g} {kind} * {chunks:g} chunks + {regrows:g} "
        "regrows)"
    )
    if native_note:
        note += f"; {native_note}"
    return None, note


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="+", help="telemetry JSON file(s)")
    ap.add_argument(
        "--require-fused", action="store_true",
        help="fail documents that lack the fusion gauges instead of "
        "skipping them",
    )
    args = ap.parse_args(argv)
    rc = 0
    for path in args.paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"{path}: unreadable ({e})", file=sys.stderr)
            rc = 1
            continue
        error, note = check(doc)
        if error is None and note and "skipped" in note and (
            args.require_fused
        ):
            error, note = f"{note} but --require-fused is set", None
        if error:
            rc = 1
            print(f"{path}: {error}", file=sys.stderr)
        else:
            print(f"{path}: OK ({note})")
    return rc


if __name__ == "__main__":
    sys.exit(main())
