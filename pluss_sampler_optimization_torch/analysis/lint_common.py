"""Shared plumbing for the repo's source-level lint gates.

tools/lint_determinism.py (the bit-identity lint) and
tools/check_concurrency.py (the concurrency analyzer) are the same
kind of tool: an AST pass over the project's own source emitting
machine-readable diagnostics, suppressed one-by-one through a reviewed
allowlist file, wired into tier-1 with a `--fixtures` self-test that
proves the pass still catches the bug classes it exists for. This
module is the one copy of that scaffolding:

- `Violation`: the diagnostic record both tools emit. `id`
  (`relpath::qualname::rule`) is the allowlist key; `rule` is the
  machine-readable code (`wallclock`, `C_LOCK_CYCLE`, ...).
- `read_allowlist` / `split_allowed`: one-id-per-line allowlist files
  with '#' comments, applied after human review.
- `report_doc`: the shared `--json` report shape
  (tool/targets/violations/suppressed/ok) so downstream tooling can
  consume either gate without caring which one produced the report.
- `check_fixtures`: the self-test convention — every seeded
  bad-pattern fixture must produce its expected diagnostic code, so a
  refactor that silently blinds a rule fails the gate immediately.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str  # repo-relative
    qualname: str
    rule: str
    line: int
    detail: str

    @property
    def id(self) -> str:
        return f"{self.path}::{self.qualname}::{self.rule}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line} [{self.rule}] {self.detail}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["id"] = self.id
        return d


def read_allowlist(path: str) -> set[str]:
    """Violation ids from an allowlist file (one per line, '#'
    comments); missing file reads as empty."""
    if not os.path.exists(path):
        return set()
    out: set[str] = set()
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                out.add(line)
    return out


def split_allowed(
    violations: list[Violation], allow: set[str]
) -> tuple[list[Violation], int]:
    """(unallowed violations, suppressed count)."""
    kept = [v for v in violations if v.id not in allow]
    return kept, len(violations) - len(kept)


def report_doc(tool: str, targets: int, violations: list[Violation],
               suppressed: int = 0, extra: dict | None = None) -> dict:
    """The shared JSON report shape for every lint gate."""
    doc = {
        "tool": tool,
        "targets": targets,
        "violations": [v.to_dict() for v in violations],
        "suppressed": suppressed,
        "ok": not violations,
    }
    if extra:
        doc.update(extra)
    return doc


def print_report(doc: dict, as_json: bool, stream=None) -> None:
    """Human or `--json` output for a report_doc. Violations go to
    stderr in human mode (the summary line stays on stdout), so piped
    gate output is still one parseable line."""
    if as_json:
        print(json.dumps(doc, indent=2, sort_keys=True))
        return
    err = stream if stream is not None else sys.stderr
    for v in doc["violations"]:
        print(
            f"{v['path']}:{v['line']} [{v['rule']}] {v['detail']}",
            file=err,
        )
    print(
        f"{doc['tool']}: {doc['targets']} target(s), "
        f"{len(doc['violations'])} violation(s), "
        f"{doc['suppressed']} allowlisted"
    )


def check_fixtures(fixtures: dict, lint_fn) -> list[str]:
    """Self-test: every fixture must produce its expected code.

    `fixtures` maps name -> (source, expected_rule); `lint_fn(source,
    path)` returns the Violations for one synthetic source file.
    Returns problem strings (empty == the pass still catches every
    seeded bad pattern)."""
    problems: list[str] = []
    for name in sorted(fixtures):
        source, want = fixtures[name]
        try:
            got = {v.rule for v in lint_fn(source, f"<fixture:{name}>")}
        except Exception as e:
            problems.append(f"fixture {name}: lint raised {e!r}")
            continue
        if want not in got:
            problems.append(
                f"fixture {name}: expected {want}, got {sorted(got)}"
            )
    return problems
