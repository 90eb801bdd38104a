"""Shared-state and signal-handler lints over the scan results.

C_UNGUARDED_STATE — in a class whose instances cross threads, an
instance attribute written both inside a lock scope and outside any
lock scope. Half-guarded state is the tell of a data race: either the
lock is needed (the unguarded write races) or it is not (the guarded
write is noise hiding the real protocol). `__init__`-time writes are
construction, not sharing, and are excluded.

A class "crosses threads" when it owns a lock/condition attribute
(locks exist to be contended) or when one of its methods is the
target of `threading.Thread(target=self...)`.

Methods named `*_locked` are, by this codebase's convention, only
ever called with the class lock already held; their writes count as
guarded. The interprocedural stage still verifies the convention the
other way around — a `*_locked` method reached from a path that does
not hold the lock shows up as a missing edge in the lock graph, and
the runtime witness sees the real order.

C_SIGNAL_UNSAFE — a signal handler doing anything beyond the
async-signal-safe core: setting a flag, re-raising, calling signal.*
functions, or delegating to a local function that itself passes the
same audit. Handlers run on the main thread at arbitrary bytecode
boundaries — inside the executor's critical sections, halfway through
a recorder bundle write — so lock acquisition, I/O, or telemetry in a
handler is a reentrancy deadlock waiting for load to find it.
"""

from __future__ import annotations

import ast

from ..lint_common import Violation

#: methods where instance-attr writes are construction, not sharing
_CTOR_METHODS = {"__init__", "__new__", "__post_init__", "__del__",
                 "__enter__"}

#: attribute suffixes that are themselves synchronisation or
#: thread-handle objects — assigning them is setup, not shared state
_SYNC_ATTR_HINTS = ("_lock", "_cv", "_cond", "_thread", "_threads",
                    "_stop", "_event", "_pool", "_executor")


def shared_state_lint(scans: list) -> list[Violation]:
    out: list[Violation] = []
    for scan in scans:
        cross = set(scan.class_locks)
        cross |= set(scan.thread_targets)
        for cls in sorted(cross):
            # attr -> {"guarded": [(qual, line)], "bare": [...]}
            writes: dict = {}
            for qual, f in scan.functions.items():
                if f.cls != cls:
                    continue
                method = qual.split(".", 1)[1].split(".", 1)[0] \
                    if "." in qual else qual
                if method in _CTOR_METHODS:
                    continue
                assume_held = method.endswith("_locked")
                for attr, guarded, line in f.writes:
                    if attr.endswith(_SYNC_ATTR_HINTS):
                        continue
                    slot = writes.setdefault(
                        attr, {"guarded": [], "bare": []}
                    )
                    key = "guarded" if (guarded or assume_held) \
                        else "bare"
                    slot[key].append((qual, line))
            for attr in sorted(writes):
                slot = writes[attr]
                if slot["guarded"] and slot["bare"]:
                    gq, gl = slot["guarded"][0]
                    for bq, bl in slot["bare"]:
                        out.append(Violation(
                            path=scan.path, qualname=bq,
                            rule="C_UNGUARDED_STATE", line=bl,
                            detail=(
                                f"{cls}.{attr} written without a lock "
                                f"here but under a lock in {gq} "
                                f"(line {gl}); pick one protocol"
                            ),
                        ))
    return out


# -- signal-handler audit ---------------------------------------------

#: call targets a handler may make (beyond local delegation)
_SAFE_CALL_PREFIXES = ("signal.",)
_SAFE_CALL_NAMES = {"print"}  # write(2) on CPython; accepted for
# diagnostics-on-shutdown handlers


def signal_audit(scans: list) -> list[Violation]:
    out: list[Violation] = []
    for scan in scans:
        fn_nodes = _function_nodes(scan)
        for signame, handler, qual, line in scan.signal_handlers:
            problem = _audit_handler(handler, scan, fn_nodes,
                                     depth=0)
            if problem is not None:
                out.append(Violation(
                    path=scan.path, qualname=qual,
                    rule="C_SIGNAL_UNSAFE", line=line,
                    detail=(
                        f"{signame} handler is not async-signal-safe:"
                        f" {problem}; restrict handlers to flag-set +"
                        f" raise"
                    ),
                ))
    return out


def _function_nodes(scan) -> dict:
    """name -> FunctionDef AST for module-level functions (captured
    by the scan pass for exactly this audit)."""
    return scan.fn_nodes if scan.signal_handlers else {}


def _audit_handler(handler, scan, fn_nodes: dict, depth: int):
    """None when safe, else a human-readable problem string."""
    if depth > 2:
        return "delegation deeper than 2 calls"
    if isinstance(handler, ast.Lambda):
        return _audit_expr_body(handler.body, scan, fn_nodes, depth)
    if isinstance(handler, ast.Attribute):
        d = _dotted(handler)
        if d in ("signal.SIG_IGN", "signal.SIG_DFL"):
            return None
        return f"handler {d or '<expr>'} is not auditable"
    if isinstance(handler, ast.Name):
        node = fn_nodes.get(handler.id)
        if node is None:
            return f"handler {handler.id} not found for audit"
        return _audit_body(node.body, scan, fn_nodes, depth)
    return "handler expression is not auditable"


def _audit_body(body, scan, fn_nodes, depth):
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Raise, ast.Return,
                             ast.Global, ast.Nonlocal, ast.Break,
                             ast.Continue)):
            continue
        if isinstance(stmt, (ast.Assign, ast.AugAssign,
                             ast.AnnAssign)):
            # flag-set; the value must not itself call anything unsafe
            val = getattr(stmt, "value", None)
            if val is not None and _has_unsafe_call(val, scan,
                                                    fn_nodes, depth):
                return "assignment value performs an unsafe call"
            continue
        if isinstance(stmt, ast.If):
            p = _audit_body(stmt.body, scan, fn_nodes, depth) \
                or _audit_body(stmt.orelse, scan, fn_nodes, depth)
            if p:
                return p
            continue
        if isinstance(stmt, ast.Expr):
            p = _audit_expr_body(stmt.value, scan, fn_nodes, depth)
            if p:
                return p
            continue
        return f"{type(stmt).__name__} statement at line {stmt.lineno}"
    return None


def _audit_expr_body(expr, scan, fn_nodes, depth):
    if isinstance(expr, ast.Call):
        return _audit_call(expr, scan, fn_nodes, depth)
    if isinstance(expr, ast.Constant):
        return None
    if _has_unsafe_call(expr, scan, fn_nodes, depth):
        return "expression performs an unsafe call"
    return None


def _audit_call(call: ast.Call, scan, fn_nodes, depth):
    d = _dotted(call.func)
    if d is not None:
        if d.startswith(_SAFE_CALL_PREFIXES) or d in _SAFE_CALL_NAMES:
            return None
        if "." not in d and d in fn_nodes:
            return _audit_handler(ast.Name(id=d), scan, fn_nodes,
                                  depth + 1)
    return f"call to {d or '<expr>'} at line {call.lineno}"


def _has_unsafe_call(expr, scan, fn_nodes, depth) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            if _audit_call(node, scan, fn_nodes, depth) is not None:
                return True
    return False


def _dotted(node) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
