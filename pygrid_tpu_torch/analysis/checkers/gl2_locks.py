"""GL2 — thread/lock discipline.

The stack runs real threads: each serving engine owns a device-loop
thread, the cycle manager aggregates on the background task pool, the
telemetry bus is hit from every thread at once, and WS handlers run on
a dedicated executor. The classic hazards:

- **GL201** lock-order cycles: function F acquires lock B while holding
  lock A, function G acquires A while holding B — a deadlock waiting
  for the right interleaving. Locks are identified per ``(file, class,
  attr)``; the acquisition graph is global across the run.
- **GL202** unlocked mutation of lock-protected state: a class that
  constructs a ``threading.Lock``/``RLock``/``Condition`` in
  ``__init__`` and touches ``self._x`` under ``with self._lock`` in one
  method must not mutate the same ``self._x`` lock-free in another.
  The "touched under the lock somewhere" filter is the precision knob:
  attributes a class never guards are treated as thread-confined by
  design (suppress with a justification comment where a single-writer
  thread owns them). Two caller-holds-the-lock conventions this repo
  already uses are recognized: methods named ``*_locked`` and methods
  whose docstring opens with ``"Under the lock"`` are exempt — their
  contract is that the caller acquired the lock.
- **GL203** aliased-lock self-deadlock: ``with self._work:`` nested
  inside ``with self._lock:`` when ``self._work =
  threading.Condition(self._lock)`` — the same non-reentrant lock
  acquired twice on one thread.
"""

from __future__ import annotations

import ast
from typing import Iterable

from pygrid_tpu_torch.analysis.core import Checker, Finding, ModuleContext
from pygrid_tpu_torch.analysis.checkers.gl1_trace import _dotted

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
#: RLock/Semaphore may be re-acquired by design — GL203 exempts them
_REENTRANT_CTORS = {"RLock", "Semaphore", "BoundedSemaphore"}

#: method names that mutate common containers in place
_MUTATING_METHODS = {
    "append", "extend", "insert", "remove", "pop", "popleft", "appendleft",
    "clear", "add", "discard", "update", "setdefault", "put", "put_nowait",
}


def _lock_ctor_name(value: ast.AST) -> str | None:
    """``threading.Lock()`` / ``Condition(x)`` → the ctor name."""
    if isinstance(value, ast.Call):
        dotted = _dotted(value.func)
        if dotted:
            short = dotted.split(".")[-1]
            if short in _LOCK_CTORS:
                return short
    return None


class _ClassInfo:
    def __init__(self, mod: ModuleContext, node: ast.ClassDef) -> None:
        self.mod = mod
        self.node = node
        self.name = node.name
        self.locks: dict[str, str] = {}  # attr -> ctor name
        self.aliases: dict[str, str] = {}  # attr -> attr it wraps
        # attr -> mutation sites [(node, holding_locks)]
        self.mutations: dict[str, list[tuple[ast.AST, frozenset[str]]]] = {}
        # attr -> read sites under a lock
        self.guarded_touch: set[str] = set()

    def lock_id(self, attr: str) -> tuple[str, str, str]:
        return (self.mod.rel_path, self.name, attr)


def _self_attr(node: ast.AST) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id in ("self", "cls")
    ):
        return node.attr
    return None


class _MethodScan(ast.NodeVisitor):
    """One method body: mutations/touches of self attrs vs held locks,
    plus lock-acquisition nesting edges."""

    def __init__(self, info: _ClassInfo) -> None:
        self.info = info
        self.held: list[str] = []  # stack of held lock attrs (canonical)
        self.edges: list[tuple[str, str, ast.AST]] = []
        self.self_deadlocks: list[tuple[ast.AST, str, str]] = []
        #: ``lock = self._lock`` aliases seen so far — ``with lock:``
        #: then resolves to the canonical attr (scan is source-ordered,
        #: so the assignment precedes the with that uses it)
        self.local_locks: dict[str, str] = {}

    def _canonical(self, attr: str) -> str:
        return self.info.aliases.get(attr, attr)

    def _with_lock_attr(self, expr: ast.AST) -> str | None:
        attr = _self_attr(expr)
        if attr is None and isinstance(expr, ast.Name):
            attr = self.local_locks.get(expr.id)
        return attr

    def _discard_aliases(self, target: ast.AST | None) -> None:
        """ANY binding construct rebinding an aliased name — tuple
        unpack, for target, with-as — kills the alias: stale aliases
        guard regions with a lock that is not held."""
        if target is None:
            return
        for node in ast.walk(target):
            if isinstance(node, ast.Name):
                self.local_locks.pop(node.id, None)

    def visit_With(self, node: ast.With) -> None:
        acquired: list[str] = []
        for item in node.items:
            attr = self._with_lock_attr(item.context_expr)
            self._discard_aliases(item.optional_vars)
            if attr is not None and attr in self.info.locks:
                canon = self._canonical(attr)
                for held in self.held:
                    self.edges.append((held, canon, item.context_expr))
                    if held == canon and (
                        self.info.locks.get(canon) not in _REENTRANT_CTORS
                    ):
                        self.self_deadlocks.append(
                            (item.context_expr, attr, held)
                        )
                self.held.append(canon)
                acquired.append(canon)
        self.generic_visit(node)
        for _ in acquired:
            self.held.pop()

    visit_AsyncWith = visit_With

    def _record_mutation(self, attr: str, node: ast.AST) -> None:
        if attr in self.info.locks:
            return
        self.info.mutations.setdefault(attr, []).append(
            (node, frozenset(self.held))
        )
        if self.held:
            self.info.guarded_touch.add(attr)

    def visit_Assign(self, node: ast.Assign) -> None:
        # local lock alias: ``lock = self._lock``; rebinding the name
        # by ANY other construct (plain assign, tuple unpack) DISCARDS
        # the alias (a stale alias would mark unguarded regions as
        # guarded)
        if len(node.targets) == 1 and isinstance(
            node.targets[0], ast.Name
        ):
            value_attr = _self_attr(node.value)
            if value_attr is not None and value_attr in self.info.locks:
                self.local_locks[node.targets[0].id] = value_attr
            else:
                self.local_locks.pop(node.targets[0].id, None)
        else:
            for target in node.targets:
                self._discard_aliases(target)
        for target in node.targets:
            for el in (
                target.elts if isinstance(target, ast.Tuple) else [target]
            ):
                attr = _self_attr(el)
                if attr is not None:
                    self._record_mutation(attr, node)
                # self._x[...] = ...
                if isinstance(el, ast.Subscript):
                    attr = _self_attr(el.value)
                    if attr is not None:
                        self._record_mutation(attr, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = _self_attr(node.target)
        if attr is None and isinstance(node.target, ast.Subscript):
            attr = _self_attr(node.target.value)
        if attr is not None:
            self._record_mutation(attr, node)
        if isinstance(node.target, ast.Name):
            self._discard_aliases(node.target)
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        self._discard_aliases(node.target)
        self.generic_visit(node)

    visit_AsyncFor = visit_For

    def visit_Delete(self, node: ast.Delete) -> None:
        for target in node.targets:
            attr = _self_attr(target)
            if attr is None and isinstance(target, ast.Subscript):
                attr = _self_attr(target.value)
            if attr is not None:
                self._record_mutation(attr, node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        # self._x.append(...) and friends
        if isinstance(node.func, ast.Attribute):
            attr = _self_attr(node.func.value)
            if attr is not None and node.func.attr in _MUTATING_METHODS:
                self._record_mutation(attr, node)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        # reads under a lock mark the attr as lock-protected
        attr = _self_attr(node)
        if (
            attr is not None
            and attr not in self.info.locks
            and self.held
            and isinstance(node.ctx, ast.Load)
        ):
            self.info.guarded_touch.add(attr)
        self.generic_visit(node)


class LockDisciplineChecker(Checker):
    name = "GL2"
    description = "lock ordering + unlocked mutation of shared state"
    codes = {
        "GL201": "lock-acquisition-order cycle (potential deadlock)",
        "GL202": "lock-protected self._ state mutated outside the lock",
        "GL203": "non-reentrant lock re-acquired while held (self-deadlock)",
    }

    def __init__(self) -> None:
        # global acquisition graph: lock_id -> {lock_id: witness finding site}
        self._edges: dict[tuple, dict[tuple, tuple[ModuleContext, ast.AST]]] = {}

    def check_module(self, mod: ModuleContext) -> Iterable[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            info = _ClassInfo(mod, node)
            # pass 1: find lock attrs + aliases from __init__ (and class
            # body), e.g. self._work = threading.Condition(self._lock)
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    attr = _self_attr(sub.targets[0])
                    if attr is None:
                        continue
                    ctor = _lock_ctor_name(sub.value)
                    if ctor is not None:
                        info.locks[attr] = ctor
                        if (
                            ctor == "Condition"
                            and isinstance(sub.value, ast.Call)
                            and sub.value.args
                        ):
                            wrapped = _self_attr(sub.value.args[0])
                            if wrapped is not None:
                                info.aliases[attr] = wrapped
            if not info.locks:
                continue
            # Condition aliased over a Lock: both names are one lock; the
            # alias target inherits the wrapped ctor's reentrancy
            for alias, wrapped in info.aliases.items():
                if wrapped in info.locks:
                    info.locks[alias] = info.locks[wrapped]
            # pass 2: scan every method except __init__ (construction is
            # single-threaded by definition)
            for item in node.body:
                if not isinstance(
                    item, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                if item.name == "__init__":
                    continue
                caller_holds_lock = item.name.endswith("_locked") or (
                    (ast.get_docstring(item) or "")
                    .lstrip()
                    .lower()
                    .startswith("under the lock")
                )
                scan = _MethodScan(info)
                if caller_holds_lock:
                    # the method's contract: callers acquired the lock —
                    # treat the whole body as guarded. The sentinel never
                    # matches a real lock attr, so it cannot fabricate
                    # GL201 ordering edges or GL203 re-acquisitions.
                    scan.held.append("<caller-held>")
                for stmt in item.body:
                    scan.visit(stmt)
                for held, acquired, site in scan.edges:
                    if held != acquired and held != "<caller-held>":
                        self._edges.setdefault(
                            info.lock_id(held), {}
                        ).setdefault(info.lock_id(acquired), (mod, site))
                for site, attr, _held in scan.self_deadlocks:
                    canon = info.aliases.get(attr, attr)
                    alias_note = (
                        f" ('{attr}' wraps '{canon}')"
                        if attr != canon
                        else ""
                    )
                    findings.append(
                        mod.finding(
                            "GL203",
                            site,
                            f"'{info.name}.{item.name}' re-acquires "
                            f"non-reentrant lock 'self.{canon}' it already "
                            f"holds{alias_note} — self-deadlock",
                        )
                    )
            # pass 3: unlocked mutations of attrs the class guards
            for attr, sites in info.mutations.items():
                if attr not in info.guarded_touch:
                    continue  # never guarded → treated as thread-confined
                for site, held in sites:
                    if not held:
                        findings.append(
                            mod.finding(
                                "GL202",
                                site,
                                f"'{info.name}' mutates lock-protected "
                                f"'self.{attr}' outside any 'with "
                                "self.<lock>' block",
                            )
                        )
        return findings

    def finalize(self, run) -> Iterable[Finding]:
        # cycle detection over the global acquisition graph
        findings: list[Finding] = []
        color: dict[tuple, int] = {}
        stack: list[tuple] = []
        reported: set[frozenset] = set()

        def _dfs(lock: tuple) -> None:
            color[lock] = 1
            stack.append(lock)
            for nxt, (mod, site) in self._edges.get(lock, {}).items():
                if color.get(nxt, 0) == 1:
                    cycle = stack[stack.index(nxt):] + [nxt]
                    key = frozenset(cycle)
                    if key not in reported:
                        reported.add(key)
                        pretty = " -> ".join(
                            f"{c[1]}.{c[2]}" for c in cycle
                        )
                        findings.append(
                            mod.finding(
                                "GL201",
                                site,
                                "lock-acquisition-order cycle: "
                                f"{pretty} (deadlock under contention)",
                            )
                        )
                elif color.get(nxt, 0) == 0:
                    _dfs(nxt)
            stack.pop()
            color[lock] = 2

        for lock in list(self._edges):
            if color.get(lock, 0) == 0:
                _dfs(lock)
        return findings
