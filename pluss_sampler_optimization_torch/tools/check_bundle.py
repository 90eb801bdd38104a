"""Validate (and optionally garbage-collect) a post-mortem bundle dir.

The port's twin of the JAX package's tools/check_bundle.py: the same
command line and output, on the port's modules.

The flight recorder
(pluss_sampler_optimization_torch/runtime/obs/recorder.py) writes
atomic, schema-versioned post-mortem bundles (BUNDLE_*.json) on
anomaly triggers; it validates every bundle BEFORE the write with
`validate_bundle`, so in normal operation every file is valid — but a
crashed writer's leftover temp file, a hand-edited bundle, or a
version bump can strand bad files, and a long soak run accumulates
bundles without bound. This tool is the offline auditor, the
tools/check_ledger.py / check_service_store.py pattern applied to the
bundle dir:

- invalid bundles: unparseable JSON or schema violations (via the
  SAME `validate_bundle` the writer uses);
- stale bundles: older than --max-age-days (0 disables the check);
- with --max-bundles N, bundles beyond the newest N are surplus.

With --gc the offending files are deleted and the exit code is 0;
without --gc the exit code is nonzero when anything invalid / stale /
surplus was found, so CI can gate on bundle health.

    python -m pluss_sampler_optimization_torch.tools.check_bundle BUNDLE_DIR [--gc]
        [--max-age-days N] [--max-bundles N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def scan_bundles(bundle_dir: str, max_age_days: float = 0.0,
                 max_bundles: int = 0) -> dict:
    """Classify every BUNDLE_*.json in the dir. Returns
    {"valid": [(name, doc)], "invalid": [(name, error)],
    "stale": [name], "surplus": [name]} — stale/surplus are valid
    bundles that --gc would delete (surplus = oldest beyond the
    newest max_bundles, by bundle ts)."""
    from pluss_sampler_optimization_torch.runtime.obs.recorder import (
        validate_bundle,
    )

    out: dict = {"valid": [], "invalid": [], "stale": [],
                 "surplus": []}
    now = time.time()
    max_age_s = max_age_days * 86400.0
    names = sorted(
        n for n in os.listdir(bundle_dir)
        if n.startswith("BUNDLE_") and n.endswith(".json")
    )
    fresh: list = []
    for name in names:
        path = os.path.join(bundle_dir, name)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            out["invalid"].append((name, f"invalid JSON: {e}"))
            continue
        errors = validate_bundle(doc)
        if errors:
            out["invalid"].append((name, "; ".join(errors)))
            continue
        if max_age_s > 0 and (now - float(doc["ts"])) > max_age_s:
            out["stale"].append(name)
            continue
        fresh.append((name, doc))
    fresh.sort(key=lambda nd: float(nd[1]["ts"]))
    if max_bundles > 0 and len(fresh) > max_bundles:
        cut = len(fresh) - max_bundles
        out["surplus"] = [name for name, _doc in fresh[:cut]]
        fresh = fresh[cut:]
    out["valid"] = fresh
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("bundle_dir",
                    help="flight-recorder bundle directory "
                    "(--debug-bundle-dir of a serve run)")
    ap.add_argument("--gc", action="store_true",
                    help="delete invalid/stale/surplus bundle files "
                    "instead of only reporting them")
    ap.add_argument("--max-age-days", type=float, default=0.0,
                    help="treat bundles older than this as stale "
                    "(0 = no age limit)")
    ap.add_argument("--max-bundles", type=int, default=0,
                    help="keep only the newest N bundles "
                    "(0 = unbounded); older ones are surplus")
    args = ap.parse_args(argv)

    if not os.path.isdir(args.bundle_dir):
        print(f"{args.bundle_dir}: not a directory", file=sys.stderr)
        return 1

    scan = scan_bundles(args.bundle_dir, args.max_age_days,
                        args.max_bundles)
    for name, error in scan["invalid"]:
        print(f"{args.bundle_dir}/{name}: INVALID: {error}",
              file=sys.stderr)
    if scan["stale"]:
        print(
            f"{args.bundle_dir}: {len(scan['stale'])} stale "
            f"bundle(s) (older than {args.max_age_days:g} days)",
            file=sys.stderr,
        )
    if scan["surplus"]:
        print(
            f"{args.bundle_dir}: {len(scan['surplus'])} surplus "
            f"bundle(s) (beyond the newest {args.max_bundles})",
            file=sys.stderr,
        )

    doomed = (
        [name for name, _err in scan["invalid"]]
        + scan["stale"] + scan["surplus"]
    )
    removed = 0
    if args.gc:
        for name in doomed:
            try:
                os.unlink(os.path.join(args.bundle_dir, name))
                removed += 1
            except OSError as e:
                print(f"{args.bundle_dir}/{name}: gc failed: {e}",
                      file=sys.stderr)

    print(
        f"{args.bundle_dir}: {len(scan['valid'])} valid, "
        f"{len(scan['invalid'])} invalid, {len(scan['stale'])} "
        f"stale, {len(scan['surplus'])} surplus"
        + (f"; removed {removed}" if args.gc else "")
    )
    if args.gc:
        return 0 if removed >= len(doomed) else 1
    return 1 if doomed else 0


if __name__ == "__main__":
    sys.exit(main())
