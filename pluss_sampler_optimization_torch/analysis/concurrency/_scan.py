"""Per-file AST scan: lock inventory + per-function summaries.

One parse per source file produces everything the interprocedural
stage (graph.py) and the lints (lints.py) need:

- the lock inventory: every `self.X = threading.Lock()` /
  `RLock` / `Condition` / `Event` (or the lockwitness factory
  equivalents `make_lock`/`make_rlock`/`make_condition`) and every
  module-level lock, with a stable lock id — `Class.attr` for
  instance locks, `modstem.name` for module locks. The runtime
  witness (runtime/lockwitness.py) names its wrapped locks with the
  same `Class.attr` strings, so the observed-order graph and this
  static graph share a node vocabulary.
- per-function summaries: lock acquisitions (`with`, `.acquire()`)
  with the held-stack at each point, calls (with the held-stack
  snapshot, for the interprocedural closure), blocking operations,
  telemetry sink calls, instance-attribute writes (guarded or not),
  thread/executor creation sites, and signal-handler registrations.

The walk is a deliberate approximation: statements are visited in
source order with a single held-lock stack (no path sensitivity), a
`.acquire()` without a matching `.release()` in the same function
holds to the end of the function, and lambda/nested-def bodies are
walked as separate functions with an empty held stack (they run
later, not at definition). That is the right fidelity for a lint:
every construct in this codebase's threaded modules is a `with`
block or a short acquire/release pair.
"""

from __future__ import annotations

import ast
import dataclasses

#: kinds a lock id can have; Event is tracked for wait-blocking only.
LOCK_KINDS = ("Lock", "RLock", "Condition", "Event")

#: threading constructors (and witness factories) -> lock kind
_LOCK_CTORS = {
    "threading.Lock": "Lock",
    "threading.RLock": "RLock",
    "threading.Condition": "Condition",
    "threading.Event": "Event",
    "lockwitness.make_lock": "Lock",
    "lockwitness.make_rlock": "RLock",
    "lockwitness.make_condition": "Condition",
}

#: telemetry entry points that fan out into the sink registries; the
#: virtual lock ids model the locks the sinks take so the lock-order
#: graph sees cross-module edges without dynamic dispatch. event()
#: reaches the flight recorder (runtime/obs/recorder.py) whose
#: ingest/trigger path takes its RLock; count()/gauge() reach the
#: metrics registry (runtime/obs/metrics.py).
SINK_CALLS = {
    "count": (("MetricsRegistry._lock", "Lock"),),
    "gauge": (("MetricsRegistry._lock", "Lock"),),
    "event": (("FlightRecorder._lock", "RLock"),
              ("MetricsRegistry._lock", "Lock")),
    "warn_once": (("FlightRecorder._lock", "RLock"),
                  ("MetricsRegistry._lock", "Lock")),
}

#: span() takes the telemetry module lock on enter (root spans append
#: under it) — an ordering edge, not a sink violation.
_SPAN_ACQUIRES = (("telemetry._lock", "Lock"),)

#: dotted-call names that block the calling thread
_BLOCK_EXACT = {
    "time.sleep": "time.sleep",
    "os.replace": "file I/O (os.replace)",
    "os.rename": "file I/O (os.rename)",
    "os.fsync": "file I/O (os.fsync)",
    "os.makedirs": "file I/O (os.makedirs)",
    "json.dump": "file I/O (json.dump)",
}
_BLOCK_PREFIX = ("socket.", "subprocess.", "shutil.", "urllib.",
                 "requests.", "http.")
#: bare-name calls that block: builtin file open, the repo's atomic
#: writer, and the engine entry points (an engine execution under a
#: lock is the PR 3 bug class)
_BLOCK_NAMES = {
    "open": "file I/O (open)",
    "atomic_write_json": "file I/O (atomic_write_json)",
    "run_sampled": "engine execution (run_sampled)",
    "run_exact": "engine execution (run_exact)",
    "run_serial": "engine execution (run_serial)",
    "run_numpy": "engine execution (run_numpy)",
    "run_sampled_multi": "engine execution (run_sampled_multi)",
    "run_sampled_sharded": "engine execution (run_sampled_sharded)",
    "run_dense": "engine execution (run_dense)",
    "run_periodic": "engine execution (run_periodic)",
}
#: attribute-call names that block regardless of receiver
_BLOCK_ATTRS = {
    "result": "Future.result()",
    "join": "join()",
    "communicate": "subprocess communicate()",
}

#: method names that mutate their receiver in place (shared-state lint
#: counts `self.attr.append(...)` as a write to `attr`)
_MUTATORS = {
    "append", "appendleft", "extend", "insert", "remove", "pop",
    "popleft", "popitem", "clear", "add", "discard", "update",
    "setdefault", "move_to_end",
}


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass
class FuncSummary:
    module: str          # module stem ("executor")
    path: str            # repo-relative path
    qualname: str        # "Class.method" / "func" / "Class.m.<nested>"
    cls: str | None      # enclosing class name
    acquires: list = dataclasses.field(default_factory=list)
    # [(lock_id, kind, line)] — locks this function itself takes
    edges: list = dataclasses.field(default_factory=list)
    # [(held_id, acquired_id, acquired_kind, line)] — direct nesting
    calls: list = dataclasses.field(default_factory=list)
    # [(held_tuple, callee_key, line)]; callee_key is
    # ("local", name) | ("self", name) | ("mod", stem, name)
    blocking: list = dataclasses.field(default_factory=list)
    # [(detail, line, held_tuple)] — held_tuple may be empty
    sink_calls: list = dataclasses.field(default_factory=list)
    # [(sink_name, line, held_tuple)]
    writes: list = dataclasses.field(default_factory=list)
    # [(attr, guarded: bool, line)]
    relocks: list = dataclasses.field(default_factory=list)
    # [(lock_id, line)] — non-reentrant lock taken while already held


@dataclasses.dataclass
class ModuleScan:
    path: str
    stem: str
    aliases: dict       # local alias -> imported module stem
    module_locks: dict  # name -> (kind, line)
    class_locks: dict   # class -> {attr: (kind, line)}
    functions: dict     # qualname -> FuncSummary
    threads: list       # [(target_repr, qualname, line)]
    executors: list     # [(qualname, line)]
    thread_targets: dict  # class -> set of method names run on threads
    signal_handlers: list
    # [(signame, handler_node | func_name, qualname, line)]
    sink_installs: list   # [(fn, qualname, line)]
    fn_nodes: dict = dataclasses.field(default_factory=dict)
    # module-level function name -> FunctionDef AST (signal audit)


def _is_lock_ctor(node: ast.AST, aliases: dict) -> str | None:
    """Lock kind when `node` is a lock-constructor call."""
    if not isinstance(node, ast.Call):
        return None
    name = _dotted(node.func)
    if name is None:
        return None
    head = name.split(".", 1)[0]
    # resolve `from ..runtime import lockwitness as lw` style aliases
    resolved = aliases.get(head, head)
    name = ".".join([resolved] + name.split(".")[1:])
    return _LOCK_CTORS.get(name)


def scan_module(source: str, relpath: str) -> ModuleScan:
    tree = ast.parse(source, filename=relpath)
    stem = relpath.rsplit("/", 1)[-1].rsplit(".", 1)[0]

    aliases: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name.split(".")[-1]
                    if a.asname
                    else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                aliases[a.asname or a.name] = a.name

    # pass 1: module-level locks + per-class lock attributes
    module_locks: dict = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            kind = _is_lock_ctor(node.value, aliases)
            if isinstance(t, ast.Name) and kind:
                module_locks[t.id] = (kind, node.lineno)

    class_locks: dict = {}
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        attrs: dict = {}
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                kind = _is_lock_ctor(node.value, aliases)
                if (
                    kind
                    and isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    attrs[t.attr] = (kind, node.lineno)
        if attrs:
            class_locks[cls.name] = attrs

    scan = ModuleScan(
        path=relpath, stem=stem, aliases=aliases,
        module_locks=module_locks, class_locks=class_locks,
        functions={}, threads=[], executors=[], thread_targets={},
        signal_handlers=[], sink_installs=[],
        fn_nodes={
            n.name: n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        },  # all defs incl. nested: handlers are often closures
    )

    # pass 2: walk every function (methods, module funcs, nested defs)
    def walk_func(node, qual: str, cls: str | None):
        f = FuncSummary(module=stem, path=relpath, qualname=qual,
                        cls=cls)
        scan.functions[qual] = f
        _FuncWalker(scan, f).run(node)
        for sub in ast.walk(node):
            if sub is node:
                continue
            if isinstance(sub, (ast.FunctionDef,
                                ast.AsyncFunctionDef)):
                # nested defs run later (callbacks): walk each as its
                # own function with an empty held stack, once (only
                # direct children of this body — deeper nesting
                # recurses naturally)
                if _encloses_directly(node, sub):
                    walk_func(sub, f"{qual}.{sub.name}", cls)

    def _encloses_directly(outer, inner) -> bool:
        for sub in ast.walk(outer):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)) and sub is not outer:
                if inner is sub:
                    return True
                if any(inner is x for x in ast.walk(sub)
                       if x is not sub):
                    return False
        return False

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            walk_func(node, node.name, None)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    walk_func(sub, f"{node.name}.{sub.name}",
                              node.name)
    return scan


class _FuncWalker(ast.NodeVisitor):
    """Source-order walk of one function body with a held-lock
    stack."""

    def __init__(self, scan: ModuleScan, f: FuncSummary):
        self.scan = scan
        self.f = f
        self.held: list[tuple[str, str]] = []  # (lock_id, kind)

    def run(self, node) -> None:
        for stmt in node.body:
            self.visit(stmt)

    # -- lock identity -------------------------------------------------

    def _resolve_lock(self, node: ast.AST):
        """(lock_id, kind) for a lock-valued expression, else None."""
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
        ):
            base = node.value.id
            if base == "self" and self.f.cls:
                attrs = self.scan.class_locks.get(self.f.cls, {})
                if node.attr in attrs:
                    return (f"{self.f.cls}.{node.attr}",
                            attrs[node.attr][0])
            # module-qualified lock (telemetry._lock style)
            mod = self.scan.aliases.get(base)
            if mod is not None and mod == base:
                mod = base
            if mod is not None:
                # cross-module lock references resolve in graph.py
                # (we only know stems here); emit the id optimistically
                return (f"{mod}.{node.attr}", None)
        elif isinstance(node, ast.Name):
            if node.id in self.scan.module_locks:
                return (f"{self.scan.stem}.{node.id}",
                        self.scan.module_locks[node.id][0])
        return None

    def _held_ids(self) -> tuple:
        return tuple(h for h, _k in self.held)

    # -- acquisition ---------------------------------------------------

    def _acquire(self, lid: str, kind: str | None, line: int) -> None:
        if kind == "Lock" and any(h == lid for h, _ in self.held):
            self.f.relocks.append((lid, line))
        for h, _k in self.held:
            if h != lid:
                self.f.edges.append((h, lid, kind, line))
        self.f.acquires.append((lid, kind, line))
        self.held.append((lid, kind or "Lock"))

    def _release(self, lid: str) -> None:
        for i in range(len(self.held) - 1, -1, -1):
            if self.held[i][0] == lid:
                del self.held[i]
                return

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            got = self._resolve_lock(item.context_expr)
            if got is not None and got[1] != "Event":
                self._acquire(got[0], got[1], node.lineno)
                acquired.append(got[0])
            else:
                self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for lid in reversed(acquired):
            self._release(lid)

    visit_AsyncWith = visit_With

    # -- calls ---------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        line = node.lineno
        held = self._held_ids()

        # X.acquire() / X.release()
        if isinstance(func, ast.Attribute) and func.attr in (
            "acquire", "release"
        ):
            got = self._resolve_lock(func.value)
            if got is not None and got[1] != "Event":
                if func.attr == "acquire":
                    self._acquire(got[0], got[1], line)
                else:
                    self._release(got[0])
                return

        dotted = _dotted(func)

        # telemetry sinks + spans (virtual lock acquisitions)
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
        ):
            base_mod = self.scan.aliases.get(func.value.id,
                                             func.value.id)
            if base_mod == "telemetry" or (
                self.scan.stem == "telemetry"
                and func.value.id == "telemetry"
            ):
                if func.attr in SINK_CALLS:
                    self.f.sink_calls.append((func.attr, line, held))
                    for lid, kind in SINK_CALLS[func.attr]:
                        for h in held:
                            if h != lid:
                                self.f.edges.append((h, lid, kind,
                                                     line))
                        self.f.acquires.append((lid, kind, line))
                    self.generic_visit(node)
                    return
                if func.attr == "span":
                    for lid, kind in _SPAN_ACQUIRES:
                        for h in held:
                            if h != lid:
                                self.f.edges.append((h, lid, kind,
                                                     line))
                        self.f.acquires.append((lid, kind, line))
                    self.generic_visit(node)
                    return

        # threading.Thread(target=...) / ThreadPoolExecutor(...)
        if dotted in ("threading.Thread", "Thread"):
            target = None
            for kw in node.keywords:
                if kw.arg == "target":
                    target = _dotted(kw.value) or "<expr>"
            self.scan.threads.append((target or "<none>",
                                      self.f.qualname, line))
            if (
                target
                and target.startswith("self.")
                and self.f.cls
            ):
                self.scan.thread_targets.setdefault(
                    self.f.cls, set()
                ).add(target.split(".", 1)[1])
            self.generic_visit(node)
            return
        if dotted and dotted.split(".")[-1] == "ThreadPoolExecutor":
            self.scan.executors.append((self.f.qualname, line))
        if dotted and dotted.split(".")[-1] in (
            "set_metrics_sink", "set_record_sink"
        ):
            self.scan.sink_installs.append(
                (dotted, self.f.qualname, line)
            )

        # signal.signal(SIG, handler)
        if dotted == "signal.signal" and len(node.args) >= 2:
            signame = _dotted(node.args[0]) or "<sig>"
            self.scan.signal_handlers.append(
                (signame, node.args[1], self.f.qualname, line)
            )

        # blocking operations
        blocked = None
        if dotted is not None:
            if dotted in _BLOCK_EXACT:
                blocked = _BLOCK_EXACT[dotted]
            elif dotted.startswith(_BLOCK_PREFIX):
                blocked = f"blocking call ({dotted})"
            elif "." not in dotted and dotted in _BLOCK_NAMES:
                blocked = _BLOCK_NAMES[dotted]
        if (
            blocked is None
            and isinstance(func, ast.Attribute)
            and func.attr in _BLOCK_ATTRS
        ):
            blocked = _BLOCK_ATTRS[func.attr]
        if blocked is None and isinstance(func, ast.Attribute) \
                and func.attr == "wait":
            got = self._resolve_lock(func.value)
            waited = got[0] if got else None
            others = [h for h in held if h != waited]
            if others:
                blocked = (
                    f"wait() on "
                    f"{waited or 'a foreign object'} with other "
                    f"locks held"
                )
        if blocked is not None:
            self.f.blocking.append((blocked, line, held))
            self.generic_visit(node)
            return

        # mutator method on a self attribute -> shared-state write
        if (
            isinstance(func, ast.Attribute)
            and func.attr in _MUTATORS
            and isinstance(func.value, ast.Attribute)
            and isinstance(func.value.value, ast.Name)
            and func.value.value.id == "self"
        ):
            self.f.writes.append(
                (func.value.attr, bool(held), line)
            )

        # interprocedural call record
        key = None
        if isinstance(func, ast.Name):
            key = ("local", func.id)
        elif (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
        ):
            if func.value.id == "self":
                key = ("self", func.attr)
            else:
                mod = self.scan.aliases.get(func.value.id)
                if mod is not None:
                    key = ("mod", mod, func.attr)
        if key is not None:
            self.f.calls.append((held, key, line))
        self.generic_visit(node)

    # -- writes --------------------------------------------------------

    def _note_write_target(self, t: ast.AST, line: int) -> None:
        if (
            isinstance(t, ast.Attribute)
            and isinstance(t.value, ast.Name)
            and t.value.id == "self"
        ):
            self.f.writes.append((t.attr, bool(self.held), line))
        elif isinstance(t, ast.Subscript):
            v = t.value
            if (
                isinstance(v, ast.Attribute)
                and isinstance(v.value, ast.Name)
                and v.value.id == "self"
            ):
                self.f.writes.append((v.attr, bool(self.held), line))
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._note_write_target(el, line)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._note_write_target(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._note_write_target(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._note_write_target(node.target, node.lineno)
        self.generic_visit(node)

    # -- scope boundaries ---------------------------------------------

    def visit_FunctionDef(self, node) -> None:
        pass  # nested defs run later; scanned separately

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node) -> None:
        pass  # ditto

    def visit_ClassDef(self, node) -> None:
        pass
