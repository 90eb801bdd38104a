"""Validate (and optionally garbage-collect) a run ledger.

The port's twin of the JAX package's tools/check_ledger.py: the same
command line and output, on the port's modules.

The run ledger (pluss_sampler_optimization_torch/runtime/obs/ledger.py)
is an append-only JSONL file; writers validate rows before appending,
so in normal operation every line is valid — but a crash can truncate
the tail line, a version bump strands old rows, and a long-lived
ledger grows without bound. This tool is the offline auditor, the
tools/check_service_store.py pattern applied to the ledger:

- invalid lines: unparseable JSON or schema violations (reported with
  line numbers, via the SAME `validate_row` the writers use);
- stale rows: older than --max-age-days (0 disables the age check);
- with --max-rows N, rows beyond the newest N are surplus.

With --gc the ledger is compacted in place (atomic rewrite keeping
only valid, fresh rows — newest --max-rows of them) and the exit code
is 0; without --gc the exit code is nonzero when anything invalid or
stale was found, so CI can gate on ledger health.

    python -m pluss_sampler_optimization_torch.tools.check_ledger LEDGER.jsonl [--gc]
        [--max-age-days N] [--max-rows N] [--stats]

--stats additionally prints the ledger aggregate over the valid rows
(the CLI `stats` mode's table, including batch occupancy and
batched-vs-solo latency joined on batch_id). When rows carry
`worker_id` (a shared ledger written by a serving fabric,
service/fabric/), --stats also prints the per-worker `workers:` line
and validates that every row's worker matches its fingerprint's
consistent-hash ring assignment (service/fabric/ring.py) — each row
may sit at most one ring position deeper per recorded
`worker_disconnect` re-dispatch hop in its degrade chain. A sharding
violation means a router bug (or a mis-set --worker-id) broke
fingerprint affinity, and fails the check like an invalid line.

When the ledger also carries router rows (source `fabric.router`,
written by a tracing-enabled router sharing the workers' ledger),
--stats additionally validates the TRACE JOIN — every fabric worker
row's trace_id must appear in some router row, i.e. trace propagation
over the wire (service/fabric/wire.py `trace` blocks) actually reached
the workers — and the aggregate gains the `fleet:` line (per-worker
share of routed rows, wire and router-overhead p50/p95). The join
check is vacuous on ledgers with no router rows (standalone serves,
tracing disabled).
"""

from __future__ import annotations

import argparse
import os
import sys


def scan_ledger(path: str, max_age_days: float = 0.0,
                max_rows: int = 0) -> dict:
    """Classify every line. Returns {"valid": [rows...],
    "invalid": [(line_no, error)], "stale": [rows...],
    "surplus": [rows...]} — stale/surplus rows are valid rows that
    --gc would drop. Thin wrapper over ledger.scan, the shared
    implementation the serve-mode background GC (ledger.LedgerGC)
    also compacts through."""
    from pluss_sampler_optimization_torch.runtime.obs import ledger

    return ledger.scan(path, max_age_days=max_age_days,
                       max_rows=max_rows)


def check_worker_sharding(rows, ring_workers: int = 0) -> list[str]:
    """Fabric-sharding violations across request rows (empty = clean).

    Rows carrying both `worker_id` and `fingerprint` must sit on the
    ring where the router's consistent hash puts them: the first
    preference entry normally, one position deeper for every
    `worker_disconnect` re-dispatch hop recorded in the row's degrade
    chain. The ring is rebuilt from the worker-id set (contiguous ids
    0..max seen, the supervisor's assignment — override the fleet
    size with `ring_workers` when workers were idle), which is valid
    because HashRing is a pure function of the id set."""
    from pluss_sampler_optimization_torch.service.fabric.ring import (
        HashRing,
    )

    sharded = [
        row for row in rows
        if row.get("kind") == "request"
        and row.get("worker_id") is not None
        and row.get("fingerprint")
    ]
    if not sharded:
        return []
    n = ring_workers or (
        max(int(row["worker_id"]) for row in sharded) + 1
    )
    ring = HashRing(range(n))
    violations = []
    for row in sharded:
        hops = sum(
            1 for d in (row.get("degraded") or [])
            if isinstance(d, dict)
            and d.get("reason") == "worker_disconnect"
        )
        allowed = ring.preference(row["fingerprint"], k=1 + hops)
        if int(row["worker_id"]) not in allowed:
            violations.append(
                f"fingerprint {row['fingerprint'][:16]}... served by "
                f"worker {row['worker_id']} but the ring assigns "
                f"{allowed} ({hops} re-dispatch hop(s) recorded)"
            )
    return violations


def check_trace_join(rows) -> list[str]:
    """Trace-join violations across a fabric's shared ledger (empty =
    clean). Applies only when router rows (source fabric.router) are
    present: every worker request row (worker_id stamped, source
    "service") must carry a trace_id the router also recorded —
    proving the wire-level trace propagation, not just that both
    sides wrote rows. Vacuous (always clean) on standalone or
    tracing-off ledgers."""
    from pluss_sampler_optimization_torch.runtime.obs import ledger

    router_tids = {
        row.get("trace_id") for row in rows
        if row.get("kind") == "request"
        and row.get("source") == ledger.ROUTER_SOURCE
        and row.get("trace_id")
    }
    if not router_tids:
        return []
    violations = []
    for row in rows:
        if (row.get("kind") != "request"
                or row.get("worker_id") is None
                or row.get("source") != "service"):
            continue
        tid = row.get("trace_id")
        if tid not in router_tids:
            violations.append(
                f"worker {row['worker_id']} row trace_id "
                f"{str(tid)[:16]} has no matching router row"
            )
    return violations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ledger", help="run ledger JSONL file")
    ap.add_argument("--gc", action="store_true",
                    help="compact the ledger in place (atomic "
                    "rewrite), dropping invalid lines and stale/"
                    "surplus rows instead of only reporting them")
    ap.add_argument("--max-age-days", type=float, default=0.0,
                    help="treat rows older than this as stale "
                    "(0 = no age limit)")
    ap.add_argument("--max-rows", type=int, default=0,
                    help="with --gc keep only the newest N rows "
                    "(0 = unbounded); without --gc surplus rows are "
                    "reported")
    ap.add_argument("--stats", action="store_true",
                    help="also print the ledger aggregate (per-engine "
                    "latency/cache table, batch occupancy p50/p95 and "
                    "batched-vs-solo latency from batch_id rows; "
                    "rows with worker_id add the per-worker line and "
                    "the fabric ring-sharding validation)")
    ap.add_argument("--ring-workers", type=int, default=0,
                    help="fabric fleet size for the sharding check "
                    "(0 = infer max worker_id + 1 from the rows)")
    args = ap.parse_args(argv)

    if not os.path.isfile(args.ledger):
        print(f"{args.ledger}: not a file", file=sys.stderr)
        return 1

    scan = scan_ledger(args.ledger, args.max_age_days, args.max_rows)
    for line_no, error in scan["invalid"]:
        print(f"{args.ledger}:{line_no}: INVALID: {error}",
              file=sys.stderr)
    if scan["stale"]:
        print(
            f"{args.ledger}: {len(scan['stale'])} stale row(s) "
            f"(older than {args.max_age_days:g} days)",
            file=sys.stderr,
        )
    if scan["surplus"]:
        print(
            f"{args.ledger}: {len(scan['surplus'])} surplus row(s) "
            f"(beyond the newest {args.max_rows})",
            file=sys.stderr,
        )

    n_bad = (
        len(scan["invalid"]) + len(scan["stale"])
        + len(scan["surplus"])
    )
    if args.gc and n_bad:
        from pluss_sampler_optimization_torch.runtime.obs import ledger

        ledger.compact(args.ledger, max_age_days=args.max_age_days,
                       max_rows=args.max_rows)

    print(
        f"{args.ledger}: {len(scan['valid'])} valid, "
        f"{len(scan['invalid'])} invalid, {len(scan['stale'])} stale, "
        f"{len(scan['surplus'])} surplus"
        + (f"; compacted to {len(scan['valid'])} rows"
           if args.gc and n_bad else "")
    )
    shard_violations = 0
    trace_violations = 0
    if args.stats:
        from pluss_sampler_optimization_torch.runtime.obs import ledger

        for line in ledger.format_stats(ledger.aggregate(scan["valid"])):
            print(line)
        violations = check_worker_sharding(
            scan["valid"], ring_workers=args.ring_workers
        )
        shard_violations = len(violations)
        for v in violations:
            print(f"{args.ledger}: SHARDING: {v}", file=sys.stderr)
        if any(
            row.get("worker_id") is not None for row in scan["valid"]
        ):
            print(
                "sharding: "
                + ("clean (every row on its ring assignment)"
                   if not violations
                   else f"{shard_violations} violation(s)")
            )
        joins = check_trace_join(scan["valid"])
        trace_violations = len(joins)
        for v in joins:
            print(f"{args.ledger}: TRACE: {v}", file=sys.stderr)
        if any(
            row.get("source") == ledger.ROUTER_SOURCE
            for row in scan["valid"]
        ):
            print(
                "trace join: "
                + ("clean (every worker row joins a router row)"
                   if not joins
                   else f"{trace_violations} orphan worker row(s)")
            )
    if args.gc:
        return 0
    return 1 if (n_bad or shard_violations or trace_violations) else 0


if __name__ == "__main__":
    sys.exit(main())
