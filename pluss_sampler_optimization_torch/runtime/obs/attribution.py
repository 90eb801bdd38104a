"""Per-request utilization attribution: where did the wall-clock go?

The ledger records *that* a request took latency_s; the per-stage
timings record what we measured. This module turns those numbers into
a normalized accounting — per request, the wall time is partitioned
into executing / device-sync / queue+batch-wait / fetch /
unattributed fractions that sum to ~1.0 — so "the engine is busy",
"the device is idle", and "nobody knows" become three different,
scrapeable numbers instead of one opaque latency.

Three consumers:

- **schema-v2 ledger rows** gain an optional `utilization` block
  (built by `request_utilization`, validated by `validate_block` /
  ledger.validate_row, aggregated by `check_ledger --stats` into the
  `utilization:` line);
- **the live metrics registry** gets windowed gauges —
  `utilization_busy_fraction`, `utilization_device_idle_fraction`,
  `utilization_unattributed_fraction` — via `record_gauges` (written
  through `telemetry.gauge`, the one write path, so the per-run
  telemetry and the registry both see them). These feed the SLO
  sentinel and future autoscaling (ROADMAP item 4);
- **bench / the profiler gate** use `sample_breakdown` to map a
  profiler snapshot's span-attributed samples onto the same
  executing/sync/queue/unattributed partition (fractions over total
  samples, summing to 1.0 by construction).

The modeled bytes/FLOPs ride along when known (the kernel_roofline
accounting: bytes = samples * 25, flops = samples * (4*depth + 16)),
so a utilization block also answers "how much useful traffic did the
busy fraction move".
"""

from __future__ import annotations

_NUM = (int, float)

# Fraction keys of a utilization block, in partition order. They sum
# to ~1.0 (clamping + rounding leaves epsilon slack).
FRACTION_KEYS = (
    "executing_fraction", "sync_fraction", "queue_fraction",
    "fetch_fraction", "unattributed_fraction",
)

# Span-path fragments -> partition group for profiler samples. First
# match wins; a sample whose span path matches none of these (but is
# attributed) counts as executing — it was inside *some* known span.
_SAMPLE_GROUPS = (
    ("sync", ("fetch", "block", "gather")),
    ("queue", ("queue", "batch_wait", "admission")),
    ("executing", ()),  # any other attributed span
)


def _is_num(v) -> bool:
    return isinstance(v, _NUM) and not isinstance(v, bool)


def _frac(part, wall: float) -> float:
    if part is None or wall <= 0:
        return 0.0
    return min(1.0, max(0.0, float(part) / wall))


def request_utilization(wall_s, execute_s=None, queue_s=None,
                        batch_wait_s=None, fetch_s=None, sync_s=None,
                        compile_s=None, modeled_bytes=None,
                        modeled_flops=None) -> "dict | None":
    """Build one request's `utilization` ledger block from its stage
    seconds; None when wall_s is unusable (nothing to attribute).

    `sync_s` (device-sync time, recorded only under
    device_sync-enabled telemetry) is accounted as part of execute_s
    when both are present — the partition subtracts it from executing
    so the two fractions never double-count."""
    if not _is_num(wall_s) or wall_s <= 0:
        return None
    wall = float(wall_s)
    sync = float(sync_s) if _is_num(sync_s) else 0.0
    execute = float(execute_s) if _is_num(execute_s) else 0.0
    executing = max(0.0, execute - min(sync, execute))
    queue = (
        (float(queue_s) if _is_num(queue_s) else 0.0)
        + (float(batch_wait_s) if _is_num(batch_wait_s) else 0.0)
    )
    fetch = float(fetch_s) if _is_num(fetch_s) else 0.0
    block: dict = {"wall_s": round(wall, 6)}
    for key, v in (("execute_s", execute_s), ("queue_s", queue_s),
                   ("batch_wait_s", batch_wait_s),
                   ("fetch_s", fetch_s), ("sync_s", sync_s),
                   ("compile_s", compile_s)):
        if _is_num(v):
            block[key] = round(float(v), 6)
    fr_exec = _frac(executing, wall)
    fr_sync = _frac(sync, wall)
    fr_queue = _frac(queue, wall)
    fr_fetch = _frac(fetch, wall)
    # Stage timers can overlap slightly (each clock is read
    # independently); normalize so the partition is exact and the
    # fractions always sum to ~1.0 with unattributed >= 0.
    attributed = fr_exec + fr_sync + fr_queue + fr_fetch
    if attributed > 1.0:
        scale = 1.0 / attributed
        fr_exec *= scale
        fr_sync *= scale
        fr_queue *= scale
        fr_fetch *= scale
        attributed = 1.0
    block["executing_fraction"] = round(fr_exec, 6)
    block["sync_fraction"] = round(fr_sync, 6)
    block["queue_fraction"] = round(fr_queue, 6)
    block["fetch_fraction"] = round(fr_fetch, 6)
    block["unattributed_fraction"] = round(
        max(0.0, 1.0 - attributed), 6
    )
    # busy = the engine-execution share of the wall (sync included:
    # the device being waited on is still this request's work);
    # device-idle = everything that wasn't execution at all.
    block["busy_fraction"] = round(
        min(1.0, fr_exec + fr_sync), 6
    )
    block["device_idle_fraction"] = round(
        max(0.0, 1.0 - min(1.0, fr_exec + fr_sync)), 6
    )
    if _is_num(modeled_bytes):
        block["modeled_bytes"] = int(modeled_bytes)
    if _is_num(modeled_flops):
        block["modeled_flops"] = int(modeled_flops)
    return block


def validate_block(u) -> list[str]:
    """All schema violations of one `utilization` block (empty =
    valid); called from ledger.validate_row for rows that carry one,
    and by tools/check_profile.py on bench evidence."""
    errors: list[str] = []
    if not isinstance(u, dict):
        return ["'utilization' must be an object"]
    if not _is_num(u.get("wall_s")) or u.get("wall_s", -1) < 0:
        errors.append(
            "'utilization.wall_s' must be a non-negative number"
        )
    for key in ("execute_s", "queue_s", "batch_wait_s", "fetch_s",
                "sync_s", "compile_s"):
        if key in u and not _is_num(u[key]):
            errors.append(f"'utilization.{key}' must be a number")
    total = 0.0
    for key in FRACTION_KEYS + (
        "busy_fraction", "device_idle_fraction",
    ):
        v = u.get(key)
        if not _is_num(v) or not (0.0 <= v <= 1.0):
            errors.append(
                f"'utilization.{key}' must be a number in [0, 1]"
            )
        elif key in FRACTION_KEYS:
            total += v
    if not errors and not (0.98 <= total <= 1.02):
        errors.append(
            "utilization fractions must sum to ~1.0, got "
            f"{total:.4f}"
        )
    for key in ("modeled_bytes", "modeled_flops"):
        if key in u and (
            not isinstance(u[key], int) or isinstance(u[key], bool)
            or u[key] < 0
        ):
            errors.append(
                f"'utilization.{key}' must be a non-negative integer"
            )
    return errors


def record_gauges(block: "dict | None") -> None:
    """Mirror one request's utilization fractions into the telemetry
    write path (and so the live registry when metrics.enable() has
    run). Last-write gauges: the scrape sees the most recent
    request's attribution, the windows come from scrape cadence."""
    if not block:
        return
    from .. import telemetry

    telemetry.gauge(
        "utilization_busy_fraction", block["busy_fraction"]
    )
    telemetry.gauge(
        "utilization_device_idle_fraction",
        block["device_idle_fraction"],
    )
    telemetry.gauge(
        "utilization_unattributed_fraction",
        block["unattributed_fraction"],
    )


def _sample_group(span_path: str) -> str:
    from .profiler import UNATTRIBUTED

    if not span_path or span_path == UNATTRIBUTED:
        return "unattributed"
    leaf = span_path.rsplit("/", 1)[-1]
    for group, fragments in _SAMPLE_GROUPS:
        for frag in fragments:
            if frag in leaf:
                return group
    return "executing"


def sample_breakdown(snapshot: dict) -> dict:
    """Partition a profiler snapshot's samples into the
    executing/sync/queue/unattributed groups (fractions over total
    samples; they sum to 1.0 by construction since every sample lands
    in exactly one group). Grouping is by the span path's leaf stage
    name: fetch/block/gather -> sync, queue/batch_wait -> queue, any
    other known span -> executing, no span -> unattributed."""
    hz = float(snapshot.get("hz") or 1.0)
    groups = {"executing": 0, "sync": 0, "queue": 0,
              "unattributed": 0}
    for stack in snapshot.get("stacks", []):
        groups[_sample_group(stack.get("span", ""))] += int(
            stack.get("count", 0)
        )
    total = sum(groups.values())
    out = {
        "samples": total,
        "seconds": round(total / hz, 6) if hz > 0 else 0.0,
    }
    for name, c in groups.items():
        out[f"{name}_fraction"] = (
            round(c / total, 6) if total else 0.0
        )
        out[f"{name}_samples"] = c
    return out
