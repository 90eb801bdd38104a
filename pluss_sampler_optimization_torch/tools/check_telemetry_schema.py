"""Validate telemetry JSON against the documented schema (README

The port's twin of the JAX package's tools/check_telemetry_schema.py: the same
command line and output, on the port's modules.
"Observability"); exit nonzero on drift.

The telemetry layer (pluss_sampler_optimization_torch/runtime/
telemetry.py) promises a stable export shape keyed by
`schema_version`; downstream tooling (bench sidecar consumers,
artifact collectors, the JAX package's own checker) parses it blind.
This checker is the contract's enforcement point — it is exercised from
the test suite (tests/test_torch_telemetry.py), so an export-shape
change that forgets the schema bump fails tier-1.

    python -m pluss_sampler_optimization_torch.tools.check_telemetry_schema TELEMETRY.json [more.json ...]
"""

from __future__ import annotations

import argparse
import json
import sys

_NUM = (int, float)


def _check_span(node, path: str, errors: list[str]) -> None:
    if not isinstance(node, dict):
        errors.append(f"{path}: span node is not an object")
        return
    if not isinstance(node.get("name"), str) or not node.get("name"):
        errors.append(f"{path}: span missing non-empty 'name'")
    for key in ("start_s", "wall_s"):
        v = node.get(key)
        if not isinstance(v, _NUM) or isinstance(v, bool) or v < 0:
            errors.append(f"{path}: span '{key}' must be a number >= 0")
    if "sync_s" in node and not isinstance(node["sync_s"], _NUM):
        errors.append(f"{path}: span 'sync_s' must be a number")
    if "attrs" in node and not isinstance(node["attrs"], dict):
        errors.append(f"{path}: span 'attrs' must be an object")
    children = node.get("children")
    if not isinstance(children, list):
        errors.append(f"{path}: span 'children' must be a list")
        return
    for i, c in enumerate(children):
        _check_span(c, f"{path}.children[{i}]", errors)


def _check_num_map(doc, key: str, errors: list[str]) -> None:
    m = doc.get(key)
    if not isinstance(m, dict):
        errors.append(f"'{key}' must be an object")
        return
    for k, v in m.items():
        if not isinstance(k, str):
            errors.append(f"'{key}' has a non-string key {k!r}")
        if key != "gauges" and (
            not isinstance(v, _NUM) or isinstance(v, bool)
        ):
            errors.append(f"'{key}[{k}]' must be a number, got {v!r}")


def validate(doc) -> list[str]:
    """All schema violations of one parsed telemetry document (empty
    list = valid). Single source of truth for the tool AND the tests.
    """
    from pluss_sampler_optimization_torch.runtime.telemetry import (
        SCHEMA_VERSION,
    )

    errors: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    if doc.get("schema_version") != SCHEMA_VERSION:
        errors.append(
            f"schema_version must be {SCHEMA_VERSION}, got "
            f"{doc.get('schema_version')!r}"
        )
    for key in ("schema_version", "enabled", "duration_s", "spans",
                "counters", "gauges", "events", "jax_monitoring",
                "device", "host"):
        if key not in doc:
            errors.append(f"missing required key '{key}'")
    spans = doc.get("spans")
    if not isinstance(spans, list):
        errors.append("'spans' must be a list")
    else:
        for i, s in enumerate(spans):
            _check_span(s, f"spans[{i}]", errors)
    _check_num_map(doc, "counters", errors)
    _check_num_map(doc, "gauges", errors)
    if not isinstance(doc.get("events"), list):
        errors.append("'events' must be a list")
    jm = doc.get("jax_monitoring")
    if not isinstance(jm, dict):
        errors.append("'jax_monitoring' must be an object")
    else:
        if not isinstance(jm.get("events"), dict):
            errors.append("'jax_monitoring.events' must be an object")
        durs = jm.get("durations")
        if not isinstance(durs, dict):
            errors.append("'jax_monitoring.durations' must be an object")
        else:
            for k, v in durs.items():
                if not (isinstance(v, dict) and "total_s" in v
                        and "count" in v):
                    errors.append(
                        f"'jax_monitoring.durations[{k}]' must carry "
                        "total_s and count"
                    )
    dev = doc.get("device")
    if not isinstance(dev, dict) or "platform" not in dev or (
        "device_count" not in dev
    ):
        errors.append(
            "'device' must be an object with platform and device_count"
        )
    host = doc.get("host")
    if not isinstance(host, dict) or "cpu_features_hash" not in host:
        errors.append(
            "'host' must be an object with at least cpu_features_hash"
        )
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="+", help="telemetry JSON file(s)")
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
        errors = validate(doc)
        if errors:
            rc = 1
            for err in errors:
                print(f"{path}: {err}", file=sys.stderr)
        else:
            print(f"{path}: OK (schema_version "
                  f"{doc['schema_version']})")
    return rc


if __name__ == "__main__":
    sys.exit(main())
