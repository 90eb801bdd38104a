"""Assemble cross-process Chrome traces from a shared run ledger.

The port's twin of the JAX package's tools/assemble_trace.py: the same
command line and output, on the port's modules.

A fabric run (service/fabric/) writes two kinds of request rows into
the shared ledger: the router's rows (source `fabric.router`, carrying
the `router` span block — queue/route/wire/RTT splits measured on the
router's clock) and each worker's rows (source `service`, carrying the
worker-side queue_s/batch_wait_s/execute_s stages measured on the
worker's clock). Both carry the same trace_id — the router propagates
it over the wire (service/fabric/wire.py `trace` blocks), so the rows
join offline with no shared clock and no sidecar:

    python -m pluss_sampler_optimization_torch.tools.assemble_trace LEDGER.jsonl --list
    python -m pluss_sampler_optimization_torch.tools.assemble_trace LEDGER.jsonl --trace-id ab12... \
        --out trace.json
    python -m pluss_sampler_optimization_torch.tools.assemble_trace LEDGER.jsonl --out-dir traces/

The output is one Chrome trace (chrome://tracing / Perfetto) per
request: the router track lays out router_queue -> route -> wire_out
-> worker_rtt -> wire_back, and the worker track sits inside the RTT
with the worker's own stages nested. Placement uses only single-host
monotonic deltas (the wire split is RTT minus the worker's
self-reported span, halved) — cross-host timestamps are never
compared, so the picture is honest about what a two-clock system can
know. The JSON is byte-deterministic for a given ledger (sorted keys,
sorted trace ids), so goldens can pin it.

Exit code is 0 when every requested trace assembled, 1 when a
--trace-id was not found (or the ledger has no joinable traces and
one was demanded).
"""

from __future__ import annotations

import argparse
import os
import sys


def load_rows(path: str) -> list:
    """Valid ledger rows, via the same scan the auditors use."""
    from pluss_sampler_optimization_torch.runtime.obs import ledger

    return ledger.scan(path)["valid"]


def main(argv=None) -> int:
    from pluss_sampler_optimization_torch.runtime.obs import fleet

    ap = argparse.ArgumentParser()
    ap.add_argument("ledger", help="shared run ledger JSONL file")
    ap.add_argument("--trace-id", default=None,
                    help="assemble only this trace id")
    ap.add_argument("--out", default=None,
                    help="write a single assembled trace here "
                    "(requires --trace-id, or a ledger with exactly "
                    "one joinable trace)")
    ap.add_argument("--out-dir", default=None,
                    help="write every assembled trace as "
                    "<out-dir>/<trace_id>.trace.json")
    ap.add_argument("--list", action="store_true",
                    help="list joinable trace ids (router row + "
                    "worker row counts) and exit")
    args = ap.parse_args(argv)

    if not os.path.isfile(args.ledger):
        print(f"{args.ledger}: not a file", file=sys.stderr)
        return 1

    rows = load_rows(args.ledger)
    if args.list:
        idx = fleet.trace_index(rows)
        for tid in sorted(idx):
            slot = idx[tid]
            print(
                f"{tid}: router={'yes' if slot['router'] else 'no'} "
                f"workers={len(slot['workers'])}"
            )
        print(f"{args.ledger}: {len(idx)} trace id(s)")
        return 0

    traces = fleet.assemble_traces(rows, trace_id=args.trace_id)
    if args.trace_id and args.trace_id not in traces:
        print(
            f"{args.ledger}: trace {args.trace_id} not joinable "
            "(no router row)",
            file=sys.stderr,
        )
        return 1
    if not traces:
        print(f"{args.ledger}: no joinable traces", file=sys.stderr)
        return 1

    if args.out:
        if len(traces) != 1:
            print(
                f"--out needs exactly one trace, got {len(traces)} "
                "(use --trace-id or --out-dir)",
                file=sys.stderr,
            )
            return 1
        (tid, doc), = traces.items()
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(fleet.trace_text(doc))
        print(f"{args.out}: trace {tid} "
              f"({len(doc['traceEvents'])} events)")
        return 0

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        for tid in sorted(traces):
            path = os.path.join(args.out_dir,
                                f"{tid}.trace.json")
            with open(path, "w", encoding="utf-8") as f:
                f.write(fleet.trace_text(traces[tid]))
        print(f"{args.out_dir}: {len(traces)} trace(s) written")
        return 0

    for tid in sorted(traces):
        doc = traces[tid]
        spans = {
            ev["name"]: ev["dur"]
            for ev in doc["traceEvents"] if ev.get("ph") == "X"
        }
        total = spans.get("request", 0.0) / 1e6
        rtt = spans.get("worker_rtt", 0.0) / 1e6
        print(
            f"{tid}: total={total:.6f}s rtt={rtt:.6f}s "
            f"events={len(doc['traceEvents'])}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
