"""Audit (and optionally garbage-collect) a service result store.

The port's twin of the JAX package's tools/check_service_store.py: the same
command line and output, on the port's modules.

The analysis service's on-disk cache (service/cache.py) is
content-addressed and versioned; the in-process load path already
tolerates corruption by treating bad entries as misses. This tool is
the offline counterpart: it walks a cache directory, validates every
record against the versioned schema (the SAME
service.cache.validate_record the loader uses — one source of truth,
the tools/check_telemetry_schema.py pattern), and reports

- corrupt entries: unparseable JSON, wrong store_version, missing
  required keys, or a fingerprint that does not match the address;
- stale entries: older than --max-age-days (0 disables the age check);
- quarantined entries: `*.corrupt` files the in-process loader
  renamed aside after a failed validation (service/cache.py) — kept
  for post-mortem, reported here, deleted by --gc;
- stray files: non-record files inside the store tree.

With --gc, corrupt, stale, and quarantined entries (and orphaned
.tmp files from interrupted writers) are deleted; the exit code is
then 0 because the store has been repaired. Without --gc the exit
code is nonzero when anything invalid was found, so CI can gate on
store health (quarantined files are informational: the loader
already repaired the live address).

    python -m pluss_sampler_optimization_torch.tools.check_service_store CACHE_DIR [--gc]
        [--max-age-days N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def scan_store(cache_dir: str, max_age_days: float = 0.0) -> dict:
    """Classify every file under the store. Returns
    {"valid": [...], "corrupt": [(path, reasons)], "stale": [...],
    "tmp": [...], "stray": [...]} with paths relative walking order.
    """
    from pluss_sampler_optimization_torch.service.cache import (
        validate_record,
    )

    out: dict = {"valid": [], "corrupt": [], "stale": [], "tmp": [],
                 "quarantined": [], "stray": []}
    now = time.time()
    max_age_s = max_age_days * 86400.0
    for root, _dirs, files in os.walk(cache_dir):
        for name in sorted(files):
            path = os.path.join(root, name)
            if name.endswith(".tmp"):
                out["tmp"].append(path)
                continue
            if name.endswith(".corrupt"):
                out["quarantined"].append(path)
                continue
            if not name.endswith(".json"):
                out["stray"].append(path)
                continue
            fingerprint = name[: -len(".json")]
            try:
                with open(path) as f:
                    rec = json.load(f)
            except (OSError, ValueError) as e:
                out["corrupt"].append((path, [f"unreadable: {e}"]))
                continue
            errors = validate_record(rec, fingerprint)
            if errors:
                out["corrupt"].append((path, errors))
                continue
            if max_age_s > 0 and (
                now - float(rec.get("created_at", 0))
            ) > max_age_s:
                out["stale"].append(path)
                continue
            out["valid"].append(path)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cache_dir", help="service result store directory")
    ap.add_argument("--gc", action="store_true",
                    help="delete corrupt/stale entries and orphaned "
                    ".tmp files instead of only reporting them")
    ap.add_argument("--max-age-days", type=float, default=0.0,
                    help="treat entries older than this as stale "
                    "(0 = no age limit)")
    args = ap.parse_args(argv)

    if not os.path.isdir(args.cache_dir):
        print(f"{args.cache_dir}: not a directory", file=sys.stderr)
        return 1

    scan = scan_store(args.cache_dir, args.max_age_days)
    for path, errors in scan["corrupt"]:
        for err in errors:
            print(f"{path}: CORRUPT: {err}", file=sys.stderr)
    for path in scan["stale"]:
        print(f"{path}: stale (older than "
              f"{args.max_age_days:g} days)", file=sys.stderr)
    for path in scan["tmp"]:
        print(f"{path}: orphaned tmp file", file=sys.stderr)
    for path in scan["quarantined"]:
        print(f"{path}: quarantined corrupt record", file=sys.stderr)
    for path in scan["stray"]:
        print(f"{path}: stray file (not a store record)",
              file=sys.stderr)

    removed = 0
    if args.gc:
        doomed = (
            [p for p, _ in scan["corrupt"]]
            + scan["stale"] + scan["tmp"] + scan["quarantined"]
        )
        for path in doomed:
            try:
                os.unlink(path)
                removed += 1
            except OSError as e:
                print(f"{path}: gc failed ({e})", file=sys.stderr)

    n_bad = len(scan["corrupt"]) + len(scan["stale"]) + len(scan["tmp"])
    print(
        f"{args.cache_dir}: {len(scan['valid'])} valid, "
        f"{len(scan['corrupt'])} corrupt, {len(scan['stale'])} stale, "
        f"{len(scan['tmp'])} tmp, "
        f"{len(scan['quarantined'])} quarantined, "
        f"{len(scan['stray'])} stray"
        + (f"; removed {removed}" if args.gc else "")
    )
    if args.gc:
        return 0 if removed >= n_bad else 1
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
