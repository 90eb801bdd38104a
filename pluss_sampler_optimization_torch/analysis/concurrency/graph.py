"""Interprocedural lock-order graph + blocking/sink/relock rules.

Consumes the per-function summaries from `_scan` and produces:

- the global lock-acquisition graph: a directed edge `A -> B` means
  some code path acquires lock B while holding lock A. Direct edges
  come from nested `with` scopes; interprocedural edges come from a
  call made under a held lock to a function whose transitive closure
  acquires other locks.
- C_LOCK_CYCLE: a cycle in that graph (two code paths acquire the
  same locks in opposite orders — the classic deadlock recipe).
- C_RELOCK: a non-reentrant `threading.Lock` acquired while already
  held on the same path (self-deadlock).
- C_BLOCKING_UNDER_LOCK: a blocking operation (Future.result, join,
  time.sleep, file/socket I/O, engine execution, wait on a foreign
  object) reached — directly or through calls — while a lock is held.
- C_SINK_UNDER_LOCK: a telemetry sink call (count/gauge/event)
  reached while a lock is held. Sinks take their own registry locks
  and the flight-recorder path does real work, so emitting from
  inside a critical section both extends hold times and creates
  cross-module lock edges; the fix is always "snapshot under the
  lock, emit after release".

Call resolution is name-based and deliberately modest: `self.m()` to
a method of the same class, `f()` to a function of the same module,
`alias.f()` to a function of another scanned module (resolved by
stem). Unresolved calls contribute nothing — the analyzer trades
recall at dynamic-dispatch sites for zero-noise diagnostics
everywhere else, and the runtime lockwitness covers the dynamic
remainder.
"""

from __future__ import annotations

from ..lint_common import Violation

# cycle-path cap purely for readable diagnostics
_MAX_CYCLE = 12


class Program:
    """All scanned modules, indexed for call resolution."""

    def __init__(self, scans: list):
        self.scans = scans
        self.functions: dict = {}   # "path::qualname" -> FuncSummary
        self._by_stem: dict = {}    # module stem -> scan (unambiguous)
        stems_seen: dict = {}
        for s in scans:
            stems_seen.setdefault(s.stem, []).append(s)
            for qual, f in s.functions.items():
                self.functions[f"{s.path}::{qual}"] = f
        for stem, group in stems_seen.items():
            if len(group) == 1:
                self._by_stem[stem] = group[0]
        self._scan_of = {s.path: s for s in scans}
        # closure memos
        self._acq: dict = {}
        self._blk: dict = {}
        self._snk: dict = {}

    # -- call resolution ----------------------------------------------

    def resolve(self, caller_key: str, callee) -> str | None:
        f = self.functions[caller_key]
        scan = self._scan_of[f.path]
        kind = callee[0]
        if kind == "self" and f.cls:
            k = f"{f.path}::{f.cls}.{callee[1]}"
            return k if k in self.functions else None
        if kind == "local":
            k = f"{f.path}::{callee[1]}"
            return k if k in self.functions else None
        if kind == "mod":
            target = self._by_stem.get(callee[1])
            if target is not None:
                k = f"{target.path}::{callee[2]}"
                return k if k in self.functions else None
        return None

    # -- transitive closures (memoised DFS, cycle-safe) ---------------

    def acquires_all(self, key: str, _stack=None) -> frozenset:
        """Lock ids (with kinds) transitively acquired by `key`."""
        if key in self._acq:
            return self._acq[key]
        stack = _stack if _stack is not None else set()
        if key in stack:
            return frozenset()
        stack.add(key)
        f = self.functions[key]
        out = {(lid, kind) for lid, kind, _ln in f.acquires}
        for _held, callee, _ln in f.calls:
            ck = self.resolve(key, callee)
            if ck is not None:
                out |= self.acquires_all(ck, stack)
        stack.discard(key)
        if _stack is None or not stack:
            self._acq[key] = frozenset(out)
        return frozenset(out)

    def _reaches(self, key: str, field: str, memo: dict, _stack=None):
        """First (detail, chain) where `field` is nonempty on the
        transitive call graph from `key`, else None."""
        if key in memo:
            return memo[key]
        stack = _stack if _stack is not None else set()
        if key in stack:
            return None
        stack.add(key)
        f = self.functions[key]
        own = getattr(f, field)
        result = None
        if own:
            detail = own[0][0]
            result = (detail, [f.qualname])
        else:
            for _held, callee, _ln in f.calls:
                ck = self.resolve(key, callee)
                if ck is None:
                    continue
                sub = self._reaches(ck, field, memo, stack)
                if sub is not None:
                    result = (sub[0], [f.qualname] + sub[1])
                    break
        stack.discard(key)
        if _stack is None or not stack:
            memo[key] = result
        return result

    def may_block(self, key: str):
        return self._reaches(key, "blocking", self._blk)

    def may_sink(self, key: str):
        return self._reaches(key, "sink_calls", self._snk)


def analyze(program: Program):
    """(violations, edges) for the whole program.

    edges: {(src_lock, dst_lock): [(path, qualname, line), ...]}
    """
    violations: list[Violation] = []
    edges: dict = {}

    def edge(a: str, b: str, site) -> None:
        edges.setdefault((a, b), []).append(site)

    for key, f in program.functions.items():
        site_base = (f.path, f.qualname)

        # direct nesting edges
        for held, acquired, _kind, line in f.edges:
            edge(held, acquired, (*site_base, line))

        # direct relocks
        for lid, line in f.relocks:
            violations.append(Violation(
                path=f.path, qualname=f.qualname, rule="C_RELOCK",
                line=line,
                detail=(
                    f"non-reentrant lock {lid} acquired while already "
                    f"held on the same path (self-deadlock)"
                ),
            ))

        # direct blocking under a held lock
        for detail, line, held in f.blocking:
            if held:
                violations.append(Violation(
                    path=f.path, qualname=f.qualname,
                    rule="C_BLOCKING_UNDER_LOCK", line=line,
                    detail=(
                        f"{detail} while holding "
                        f"{', '.join(held)}"
                    ),
                ))

        # direct sink calls under a held lock
        for sink, line, held in f.sink_calls:
            if held:
                violations.append(Violation(
                    path=f.path, qualname=f.qualname,
                    rule="C_SINK_UNDER_LOCK", line=line,
                    detail=(
                        f"telemetry.{sink}() while holding "
                        f"{', '.join(held)}; snapshot under the lock "
                        f"and emit after release"
                    ),
                ))

        # interprocedural: calls made while holding locks
        for held, callee, line in f.calls:
            ck = program.resolve(key, callee)
            if ck is None:
                continue
            if held:
                blk = program.may_block(ck)
                if blk is not None:
                    chain = " -> ".join(blk[1])
                    violations.append(Violation(
                        path=f.path, qualname=f.qualname,
                        rule="C_BLOCKING_UNDER_LOCK", line=line,
                        detail=(
                            f"call chain {chain} reaches {blk[0]} "
                            f"while holding {', '.join(held)}"
                        ),
                    ))
                snk = program.may_sink(ck)
                if snk is not None:
                    chain = " -> ".join(snk[1])
                    violations.append(Violation(
                        path=f.path, qualname=f.qualname,
                        rule="C_SINK_UNDER_LOCK", line=line,
                        detail=(
                            f"call chain {chain} reaches a telemetry "
                            f"sink while holding {', '.join(held)}"
                        ),
                    ))
            # lock-order edges through the callee's closure (recorded
            # whether or not it also blocks: edges feed the cycle
            # check, violations are separate)
            if held:
                for lid, kind in program.acquires_all(ck):
                    for h in held:
                        if h == lid:
                            if kind == "Lock":
                                violations.append(Violation(
                                    path=f.path, qualname=f.qualname,
                                    rule="C_RELOCK", line=line,
                                    detail=(
                                        f"call into "
                                        f"{'.'.join(callee[1:])} "
                                        f"re-acquires non-reentrant "
                                        f"{lid} already held here"
                                    ),
                                ))
                        else:
                            edge(h, lid, (*site_base, line))

    # cycle detection over the final edge set
    violations.extend(_find_cycles(edges))

    # stable order + dedup (same function can hit a rule repeatedly)
    seen = set()
    out = []
    for v in sorted(violations, key=lambda v: (v.path, v.line,
                                               v.rule, v.detail)):
        k = (v.path, v.qualname, v.rule, v.line)
        if k not in seen:
            seen.add(k)
            out.append(v)
    return out, edges


def _find_cycles(edges: dict) -> list[Violation]:
    """One C_LOCK_CYCLE per strongly connected component with >1 node
    (self-edges never enter `edges`; relocks are reported
    separately)."""
    adj: dict = {}
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())

    # Tarjan SCC, iterative
    index: dict = {}
    low: dict = {}
    onstack: set = set()
    stack: list = []
    sccs: list = []
    counter = [0]

    def strongconnect(root: str) -> None:
        work = [(root, iter(sorted(adj[root])))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        onstack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    onstack.add(w)
                    work.append((w, iter(sorted(adj[w]))))
                    advanced = True
                    break
                if w in onstack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    onstack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])

    for node in sorted(adj):
        if node not in index:
            strongconnect(node)

    out = []
    for comp in sccs:
        cycle = _cycle_path(comp, adj)
        # anchor the diagnostic at a real site on the first edge
        sites = edges.get((cycle[0], cycle[1]), [("<lock-graph>",
                                                  "<cycle>", 0)])
        path, qual, line = sites[0]
        out.append(Violation(
            path=path, qualname="<lock-graph>", rule="C_LOCK_CYCLE",
            line=line,
            detail=(
                "lock-order inversion: "
                + " -> ".join(cycle[:_MAX_CYCLE])
                + f" -> {cycle[0]} (acquired in opposite orders; "
                f"first edge at {path}:{line} in {qual})"
            ),
        ))
    return out


def _cycle_path(comp: list, adj: dict) -> list:
    """A concrete cycle through an SCC (DFS restricted to the
    component)."""
    comp_set = set(comp)
    start = comp[0]
    stack = [(start, [start])]
    seen = set()
    while stack:
        node, path = stack.pop()
        for nxt in sorted(adj.get(node, ())):
            if nxt == start and len(path) > 1:
                return path
            if nxt in comp_set and nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return comp  # fallback: list the component itself
