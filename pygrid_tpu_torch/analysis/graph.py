"""The whole-program analysis core: run-wide symbol table, call graph,
lock tracking, and execution-domain inference.

gridlint's first four PRs were per-file AST checks with two narrow
cross-file extensions (GL1's program closure, GL201's acquisition graph).
This module generalizes that machinery into ONE shared artifact — built
once per :class:`~pygrid_tpu_torch.analysis.core.Runner` and shared by every
checker (``Runner.graph()``), which is what keeps the tier-1 gate under
its 10 s budget as checkers multiply:

- **Symbol table** — per module: a :class:`FunctionIndex` (module
  functions AND class methods, ``C.f``-qualified), an
  :class:`ImportIndex` (aliases + from-import symbols, any scope),
  per-class lock attributes (with ``Condition(self._lock)`` alias
  canonicalization), and typed ``self._x`` collaborators. Module-level
  singletons (``BUS = TelemetryBus()``) and bound-method re-exports
  (``incr = BUS.incr``) resolve too, so ``telemetry.incr(...)`` in the
  cycle manager lands on ``TelemetryBus.incr`` three hops away.
- **Call graph** — every function body is scanned once (nested
  ``def``/``lambda`` subtrees excluded: they run wherever their caller
  ships them) for outgoing calls, resolved through: bare names (module
  defs, from-imports), ``self.``/``cls.`` methods, attribute calls on
  known-typed ``self._x`` collaborators (``CycleManager → telemetry
  bus``, ``GenerationEngine → BlockPool``), typed locals, and dotted
  module paths through import bindings.
- **Lock tracking** — canonical lock identity is ``(file, owner,
  attr)`` where owner is the constructing class (or ``<module>`` for
  module-level locks). ``with`` nesting is tracked per body; every
  call site and blocking/mutation site records the lock set held at
  that point. The repo's caller-holds-the-lock conventions
  (``*_locked`` names, docstrings opening "Under the lock") scan with
  a sentinel lock held — it counts as "a lock is held" but never
  fabricates ordering edges.
- **Execution domains** — each function is tagged with the domains it
  is reachable from, walking from entry points: every ``async def``
  body runs on the **event loop** (``loop``); ``threading.Thread(
  target=…)`` targets run on a worker **thread** (``daemon`` when
  ``daemon=True`` — the telemetry/snapshot/webhook cadence threads);
  references handed to ``run_in_executor`` / ``.submit`` /
  ``_off_loop`` / ``tasks.run_task_once`` run on the **executor**
  pool. Domains propagate along call edges into sync callees only
  (calling an ``async def`` from a thread schedules it, it does not
  run it there).

The GL2 concurrency checkers (GL204/GL205/GL206) and GL1's cross-module
trace-safety closure both ride this graph; ``--changed`` uses its
import table to compute dependents.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Any, Iterable, Sequence

# ── shared AST helpers ───────────────────────────────────────────────────


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` → "a.b.c" for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def module_dotted(rel_path: str) -> str:
    """``pygrid_tpu/models/decode.py`` → ``pygrid_tpu.models.decode``;
    ``pkg/__init__.py`` → ``pkg``."""
    parts = rel_path[:-3].split("/") if rel_path.endswith(".py") else (
        rel_path.split("/")
    )
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


#: call spellings whose first argument becomes a program: a traced,
#: exported or compiled body (the port's counterparts of ``jax.jit``;
#: gl1_trace.PROGRAMS pairs each with the reference's jit site)
PROGRAM_CALLS = {
    "torch.compile", "torch.export.export", "torch.jit.script",
    "torch.jit.trace", "torch.cuda.make_graphed_callables",
}
#: ``with <this>(...)``: the statements of the block are captured once
PROGRAM_CONTEXTS = {"torch.cuda.graph"}
#: (class, method): ``self.<method>(fn, ...)`` inside ``class`` builds a
#: program from ``fn`` (the serving engine's bucketed programs)
PROGRAM_METHODS = {("ProgramSet", "_build")}
#: builders whose returned closure is a program (the FedAvg rounds)
ROUND_BUILDERS = {
    "make_round", "make_sharded_round", "make_scanned_rounds",
    "make_fused_round", "make_fused_rounds", "make_sharded_fused_round",
}
#: methods of a ``torch.autograd.Function`` subclass that are programs
AUTOGRAD_METHODS = {"forward", "backward"}


def is_program_call(node: ast.AST) -> bool:
    """Is ``node`` (a call's func) a program-building spelling?"""
    d = dotted(node)
    return d is not None and d in PROGRAM_CALLS


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    return any(
        (dotted(b) or "").endswith("autograd.Function") for b in cls.bases
    )


class FunctionIndex(ast.NodeVisitor):
    """Module-level defs, class methods, and which are programs.

    Qualified names: module functions ``f``, methods ``C.f``. Nested
    defs are indexed under their bare name (last definition wins) —
    the same looseness GL1's closure has always had. ``programs`` holds
    ``(fn node | with node | dotted name, how)``: a dotted name is
    resolved against ``defs`` by the checker."""

    def __init__(self) -> None:
        self.defs: dict[str, ast.AST] = {}
        self.programs: list[tuple[ast.AST | str, str]] = []
        self._class_stack: list[str] = []
        #: per open class: is it an autograd.Function, and the def depth
        #: its methods sit at
        self._autograd: list[bool] = []
        self._class_depth: list[int] = []
        self._depth = 0

    def _qual(self, name: str) -> str:
        return (
            f"{self._class_stack[-1]}.{name}" if self._class_stack else name
        )

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self._autograd.append(_is_autograd_function(node))
        self._class_depth.append(self._depth)
        self.generic_visit(node)
        self._class_depth.pop()
        self._autograd.pop()
        self._class_stack.pop()

    def _visit_def(self, node: ast.FunctionDef | ast.AsyncFunctionDef) -> None:
        self.defs[self._qual(node.name)] = node
        if (
            self._autograd
            and self._autograd[-1]
            and self._depth == self._class_depth[-1]
            and node.name in AUTOGRAD_METHODS
        ):
            self.programs.append((node, f"autograd.Function.{node.name}"))
        for deco in node.decorator_list:
            target = deco.func if isinstance(deco, ast.Call) else deco
            if is_program_call(target):
                self.programs.append((node, "decorator"))
                break
        if not self._class_stack and node.name in ROUND_BUILDERS:
            nested = {
                s.name: s
                for s in node.body
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            for sub in ast.walk(node):
                if (
                    isinstance(sub, ast.Return)
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id in nested
                ):
                    self.programs.append(
                        (nested[sub.value.id], f"{node.name} closure")
                    )
        self._depth += 1
        self.generic_visit(node)
        self._depth -= 1

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def _program_arg(self, target: ast.AST, how: str) -> None:
        if isinstance(target, ast.Lambda):
            self.programs.append((target, f"{how}(lambda)"))
        else:
            d = dotted(target)
            if d is not None:
                self.programs.append((d, f"{how}(name)"))  # resolve later

    def visit_Call(self, node: ast.Call) -> None:
        if node.args:
            d = dotted(node.func)
            if is_program_call(node.func):
                self._program_arg(node.args[0], d)
            elif (
                d is not None
                and d.startswith("self.")
                and self._class_stack
                and (self._class_stack[-1], d[5:]) in PROGRAM_METHODS
            ):
                self._program_arg(node.args[0], d)
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Call) and dotted(ctx.func) in (
                PROGRAM_CONTEXTS
            ):
                self.programs.append((node, f"with {dotted(ctx.func)}"))
                break
        self.generic_visit(node)


class ImportIndex(ast.NodeVisitor):
    """Every import binding in one file (any scope — this repo imports
    lazily inside function bodies): ``aliases`` maps a local name to the
    dotted module it stands for, ``symbols`` maps a local name to
    ``(dotted_module, original_name)`` for from-imports."""

    def __init__(self, package: str) -> None:
        self.package = package  # dotted package of the current module
        self.aliases: dict[str, str] = {}
        self.symbols: dict[str, tuple[str, str]] = {}

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            local = alias.asname or alias.name.split(".")[0]
            # ``import a.b`` binds ``a``; ``import a.b as c`` binds c→a.b
            self.aliases[local] = (
                alias.name if alias.asname else alias.name.split(".")[0]
            )

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        base = node.module or ""
        if node.level:
            # relative import: walk up from the current package
            parts = self.package.split(".") if self.package else []
            parts = parts[: len(parts) - (node.level - 1)]
            base = ".".join(parts + ([node.module] if node.module else []))
        for alias in node.names:
            local = alias.asname or alias.name
            # ``from pkg import mod`` may bind a MODULE — record it both
            # ways; resolution tries the module table first
            self.aliases.setdefault(local, f"{base}.{alias.name}")
            self.symbols[local] = (base, alias.name)


def package_of(rel_path: str) -> str:
    d = module_dotted(rel_path)
    if rel_path.endswith("__init__.py"):
        return d
    return d.rsplit(".", 1)[0] if "." in d else ""


# ── the GL3 blocking/heavy pattern set (shared with GL205) ───────────────

#: (receiver, method) → GL301
BLOCKING_ATTRS = {
    ("time", "sleep"): "time.sleep() parks the event loop",
    ("requests", "get"): "sync HTTP on the event loop",
    ("requests", "post"): "sync HTTP on the event loop",
    ("requests", "put"): "sync HTTP on the event loop",
    ("requests", "delete"): "sync HTTP on the event loop",
    ("requests", "request"): "sync HTTP on the event loop",
    ("requests", "head"): "sync HTTP on the event loop",
    ("urllib.request", "urlopen"): "sync HTTP on the event loop",
    ("socket", "create_connection"): "sync socket I/O on the event loop",
    ("subprocess", "run"): "subprocess wait on the event loop",
    ("subprocess", "call"): "subprocess wait on the event loop",
    ("subprocess", "check_call"): "subprocess wait on the event loop",
    ("subprocess", "check_output"): "subprocess wait on the event loop",
    ("os", "system"): "subprocess wait on the event loop",
}

#: socket-object methods — flagged on any receiver named like a socket
SOCKET_METHODS = {"recv", "recv_into", "accept", "connect", "sendall"}

#: queue-ish receiver names for the GL302 ``.get()`` rule
QUEUEISH = ("queue", "_q")

#: repo-known heavy callables (GL303/GL205): bare-name or attr spellings
REPO_BLOCKING = {
    "serialize": "serde serialize() of model-scale payloads",
    "deserialize": "serde deserialize() of model-scale payloads",
    "to_hex": "serde hex encode of model-scale payloads",
    "from_hex": "serde hex decode of model-scale payloads",
    "b64decode": "base64 decode of model-scale payloads",
    "b64encode": "base64 encode of model-scale payloads",
    "b64_decode": "native base64 decode of model-scale payloads",
    "encode_frame": "wire-v2 frame compression",
    "decode_frame": "wire-v2 frame decompression",
    "decode_frame_traced": "wire-v2 frame decompression",
    # the partial-envelope codec msgpacks a model-scale diff — serde by
    # any other name (it is the GL205 finding this rule first caught)
    "encode_partial_envelope": "partial-envelope serde of a model-scale "
    "diff",
    "decode_partial_envelope": "partial-envelope serde of a model-scale "
    "diff",
    # sync WS event handlers bridged into async HTTP routes: these
    # decode/aggregate megabyte FL payloads synchronously
    "ws_report": "sync WS report handler (megabyte diff decode)",
    "ws_cycle_request": "sync WS cycle-request handler (DB + assign)",
    "ws_authenticate": "sync WS authenticate handler (DB + JWT verify)",
}


def classify_blocking_call(node: ast.Call) -> tuple[str, str] | None:
    """The GL301–303 pattern set as one classifier: ``(code, message)``
    when ``node`` is a known blocking/heavy call, else None. Shared by
    GL3 (async bodies) and GL205 (lock-held regions in any domain)."""
    fn = node.func
    if isinstance(fn, ast.Name):
        reason = REPO_BLOCKING.get(fn.id)
        if reason is not None:
            return ("GL303", f"'{fn.id}()' — {reason}")
        return None
    if not isinstance(fn, ast.Attribute):
        return None
    d = dotted(fn) or f"?.{fn.attr}"
    recv = d.rsplit(".", 1)[0]
    hit = BLOCKING_ATTRS.get((recv, fn.attr))
    if hit is not None:
        return ("GL301", f"'{d}()' — {hit}")
    if fn.attr in SOCKET_METHODS and "sock" in recv.lower():
        return ("GL301", f"'{d}()' — sync socket I/O on the event loop")
    if fn.attr == "result":
        return (
            "GL302",
            f"'{d}()' — Future.result() parks the loop; "
            "await asyncio.wrap_future(...) instead",
        )
    if fn.attr == "join" and "thread" in recv.lower():
        return ("GL302", f"'{d}()' — thread join parks the loop")
    if (
        fn.attr == "get"
        and any(q in recv.lower().split(".")[-1] for q in QUEUEISH)
        # any argument bounds or unblocks it: get(timeout),
        # get(block=False), get_nowait — only the bare call waits forever
        and not node.args
        and not node.keywords
    ):
        return ("GL302", f"'{d}()' — unbounded queue.get() parks the loop")
    reason = REPO_BLOCKING.get(fn.attr)
    if reason is not None:
        return ("GL303", f"'{d}()' — {reason}")
    return None


# ── lock identity ────────────────────────────────────────────────────────

LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
REENTRANT_CTORS = {"RLock", "Semaphore", "BoundedSemaphore"}

#: method names that mutate common containers in place
MUTATING_METHODS = {
    "append", "extend", "insert", "remove", "pop", "popleft", "appendleft",
    "clear", "add", "discard", "update", "setdefault", "put", "put_nowait",
}

#: LockId = (rel_path, owner, attr); owner is the constructing class
#: name or "<module>". The caller-holds-the-lock conventions scan with
#: this sentinel attr held: it counts as "locked" but never edges.
SENTINEL_HELD = "<caller-held>"

LockId = tuple  # (rel_path, owner, attr)


def lock_ctor_name(value: ast.AST) -> str | None:
    """``threading.Lock()`` / ``Condition(x)`` → the ctor name."""
    if isinstance(value, ast.Call):
        d = dotted(value.func)
        if d and d.split(".")[-1] in LOCK_CTORS:
            return d.split(".")[-1]
    return None


def pretty_lock(lock: LockId) -> str:
    rel, owner, attr = lock
    if owner == "<module>":
        return f"{rel.rsplit('/', 1)[-1]}:{attr}"
    return f"{owner}.{attr}"


# ── graph nodes ──────────────────────────────────────────────────────────


@dataclass
class CallSite:
    node: ast.AST
    dotted: str
    held: frozenset  # LockIds (sentinel included)
    targets: tuple = ()  # FunctionNode keys


@dataclass
class AcquireSite:
    lock: LockId
    node: ast.AST
    held_before: frozenset
    reentrant: bool = False


@dataclass
class BlockingSite:
    node: ast.AST
    code: str
    msg: str
    held: frozenset


@dataclass
class MutationSite:
    attr: str
    node: ast.AST
    held: frozenset


@dataclass
class SpawnSite:
    target: tuple | None  # FunctionNode key
    domain: str  # thread | daemon | executor
    node: ast.AST = None


@dataclass
class FunctionNode:
    key: tuple  # (rel_path, qualname) — last definition wins on collision
    node: ast.AST
    rel_path: str
    qualname: str
    class_name: str | None
    is_async: bool
    caller_holds_lock: bool = False
    calls: list = field(default_factory=list)
    acquires: list = field(default_factory=list)
    blocking: list = field(default_factory=list)
    mutations: list = field(default_factory=list)
    spawns: list = field(default_factory=list)

    @property
    def pretty(self) -> str:
        return f"{self.rel_path.rsplit('/', 1)[-1]}:{self.qualname}"


class ClassSymbol:
    """One class's concurrency-relevant surface."""

    def __init__(self, rel_path: str, node: ast.ClassDef) -> None:
        self.rel_path = rel_path
        self.name = node.name
        self.node = node
        self.locks: dict[str, str] = {}  # attr -> ctor name
        self.aliases: dict[str, str] = {}  # attr -> attr it wraps
        #: base-class dotted names as written; resolved to class keys in
        #: the graph's cross-module pass — ``self.method()`` and lock/
        #: collaborator lookups walk the MRO these induce
        self.base_exprs: list[str] = [
            d for d in (dotted(b) for b in node.bases) if d is not None
        ]
        self.bases: list[tuple] = []  # resolved (rel_path, class) keys
        #: attr -> unresolved type expression (a dotted ctor string, or
        #: ("param", name) for annotated __init__ params) — resolved to
        #: class keys in the graph's cross-module pass
        self.attr_exprs: dict[str, Any] = {}
        #: attr -> resolved (rel_path, class name)
        self.attr_types: dict[str, tuple] = {}

    def canonical(self, attr: str) -> str:
        return self.aliases.get(attr, attr)

    def lock_id(self, attr: str) -> LockId:
        return (self.rel_path, self.name, self.canonical(attr))


class ModuleSymbols:
    """Everything the graph knows about one parsed file."""

    def __init__(self, rel_path: str, tree: ast.Module) -> None:
        self.rel_path = rel_path
        self.tree = tree
        self.index = FunctionIndex()
        self.index.visit(tree)
        self.imports = ImportIndex(package_of(rel_path))
        self.imports.visit(tree)
        self.classes: dict[str, ClassSymbol] = {}
        #: module-level name -> unresolved ctor dotted (X = ClassName())
        self.var_exprs: dict[str, str] = {}
        self.var_types: dict[str, tuple] = {}  # resolved class keys
        #: module-level ``f = X.m`` bound-method re-exports (unresolved:
        #: name -> (var name, method)); resolved: name -> function key
        self.bound_exprs: dict[str, tuple[str, str]] = {}
        self.bound_methods: dict[str, tuple] = {}
        #: module-level lock variables (name -> ctor)
        self.module_locks: dict[str, str] = {}
        self._scan()

    def _scan(self) -> None:
        for stmt in self.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target = stmt.targets[0]
                if not isinstance(target, ast.Name):
                    continue
                ctor = lock_ctor_name(stmt.value)
                if ctor is not None:
                    self.module_locks[target.id] = ctor
                    continue
                if isinstance(stmt.value, ast.Call):
                    d = dotted(stmt.value.func)
                    if d is not None:
                        self.var_exprs[target.id] = d
                elif isinstance(stmt.value, ast.Attribute):
                    recv = stmt.value.value
                    if isinstance(recv, ast.Name):
                        self.bound_exprs[target.id] = (
                            recv.id, stmt.value.attr
                        )
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = self._scan_class(node)

    def _scan_class(self, node: ast.ClassDef) -> ClassSymbol:
        sym = ClassSymbol(self.rel_path, node)
        #: __init__ param annotations (for ``self._x = bus`` typing)
        param_ann: dict[str, str] = {}
        for item in node.body:
            if (
                isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                and item.name == "__init__"
            ):
                for a in (
                    list(item.args.posonlyargs)
                    + list(item.args.args)
                    + list(item.args.kwonlyargs)
                ):
                    ann = a.annotation
                    if isinstance(ann, ast.Constant) and isinstance(
                        ann.value, str
                    ):
                        param_ann[a.arg] = ann.value
                    else:
                        d = dotted(ann) if ann is not None else None
                        if d is not None:
                            param_ann[a.arg] = d
        for sub in ast.walk(node):
            if not (isinstance(sub, ast.Assign) and len(sub.targets) == 1):
                continue
            target = sub.targets[0]
            if not (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id in ("self", "cls")
            ):
                continue
            attr = target.attr
            ctor = lock_ctor_name(sub.value)
            if ctor is not None:
                sym.locks[attr] = ctor
                if (
                    ctor == "Condition"
                    and isinstance(sub.value, ast.Call)
                    and sub.value.args
                ):
                    wrapped = sub.value.args[0]
                    if (
                        isinstance(wrapped, ast.Attribute)
                        and isinstance(wrapped.value, ast.Name)
                        and wrapped.value.id in ("self", "cls")
                    ):
                        sym.aliases[attr] = wrapped.attr
                continue
            if isinstance(sub.value, ast.Call):
                d = dotted(sub.value.func)
                if d is not None:
                    sym.attr_exprs.setdefault(attr, d)
            elif isinstance(sub.value, ast.Name):
                ann = param_ann.get(sub.value.id)
                if ann is not None:
                    # Optional["pkg.Class"] | "Class | None" → first name
                    ann = (
                        ann.replace("Optional[", "").rstrip("]")
                        .split("|")[0].strip().strip('"').strip("'")
                    )
                    sym.attr_exprs.setdefault(attr, ann)
        # a Condition aliased over a Lock: both names are one lock; the
        # alias inherits the wrapped ctor's reentrancy
        for alias, wrapped in sym.aliases.items():
            if wrapped in sym.locks:
                sym.locks[alias] = sym.locks[wrapped]
        return sym


# ── the body scan ────────────────────────────────────────────────────────

#: dotted-call tails whose positional argument is RUN, not called, on
#: another domain: name -> (arg index, domain)
_EXECUTOR_CALLS = {
    "run_in_executor": (1, "executor"),
    "submit": (0, "executor"),
    "_off_loop": (0, "executor"),
    "run_task_once": (1, "executor"),
}


class _BodyScan(ast.NodeVisitor):
    """One function body: held-lock tracking + call/blocking/mutation/
    spawn sites. Nested def/lambda subtrees are skipped (they run
    wherever the caller ships them — the call graph indexes them as
    their own functions)."""

    def __init__(
        self, graph: "ProgramGraph", fn: FunctionNode,
        syms: ModuleSymbols, cls: ClassSymbol | None,
    ) -> None:
        self.graph = graph
        self.fn = fn
        self.syms = syms
        self.cls = cls
        self.held: list[LockId] = []
        if fn.caller_holds_lock:
            self.held.append(
                (fn.rel_path, cls.name if cls else "<module>", SENTINEL_HELD)
            )
        self.local_types: dict[str, tuple] = {}
        #: local lock aliases — ``lock = self._lock`` makes ``with
        #: lock:`` resolve to the CANONICAL lock identity
        self.local_locks: dict[str, tuple[LockId, bool]] = {}
        self._collect_local_types(fn.node)

    def _collect_local_types(self, fn_node: ast.AST) -> None:
        """``x = ClassName(...)`` → x's class key; ``x = self._lock`` →
        x aliases that lock (one pass up front: with-statements may
        precede the scan order). A name EVER bound to anything that is
        not one single lock is poisoned — the flow-insensitive alias
        must err unaliased, never guard a region with a stale lock."""
        bindings: dict[str, tuple[LockId, bool]] = {}
        poisoned: set[str] = set()

        def _poison_target(target: ast.AST | None) -> None:
            if target is None:
                return
            for sub in ast.walk(target):
                if isinstance(sub, ast.Name):
                    poisoned.add(sub.id)

        for node in _walk_skipping_defs(fn_node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if not isinstance(t, ast.Name):
                    _poison_target(t)  # tuple unpack rebinds every elt
                    continue
                if isinstance(node.value, ast.Call):
                    d = dotted(node.value.func)
                    if d is not None:
                        key = self.graph.resolve_class(
                            self.syms.rel_path, d
                        )
                        if key is not None:
                            self.local_types[t.id] = key
                    poisoned.add(t.id)
                    continue
                resolved = self._lock_of(node.value)
                if resolved is None:
                    poisoned.add(t.id)
                elif t.id in bindings and bindings[t.id] != resolved:
                    poisoned.add(t.id)
                else:
                    bindings[t.id] = resolved
            elif isinstance(node, ast.Assign):
                for t in node.targets:  # multi-target chains rebind
                    _poison_target(t)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                _poison_target(node.target)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    _poison_target(item.optional_vars)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                _poison_target(node.target)
            elif isinstance(node, ast.NamedExpr):
                _poison_target(node.target)
            elif isinstance(node, ast.comprehension):
                _poison_target(node.target)
        for name, resolved in bindings.items():
            if name not in poisoned:
                self.local_locks[name] = resolved

    # nested bodies are their own FunctionNodes
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        return

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        return

    def _lock_of(self, expr: ast.AST) -> tuple[LockId, bool] | None:
        """Resolve a with-item context expression to a lock identity,
        with reentrancy: ``(LockId, reentrant)`` or None."""
        # self._lock / cls._lock
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
        ):
            recv, attr = expr.value.id, expr.attr
            if recv in ("self", "cls") and self.cls is not None:
                # through the MRO: a base-class lock acquired from a
                # subclass method canonicalizes to the defining class
                return self.graph.class_lock(
                    (self.cls.rel_path, self.cls.name), attr
                )
            # x.lock where x has a known local type
            key = self.local_types.get(recv)
            if key is not None:
                return self.graph.class_lock(key, attr)
            # mod._lock through an import binding
            mod = self.syms.imports.aliases.get(recv)
            rel = self.graph.dotted_to_rel.get(mod or "")
            if rel is not None:
                other = self.graph.modules.get(rel)
                if other is not None and attr in other.module_locks:
                    return (
                        (rel, "<module>", attr),
                        other.module_locks[attr] in REENTRANT_CTORS,
                    )
            return None
        # self._attr.lock: a typed collaborator's lock
        if isinstance(expr, ast.Attribute):
            inner = expr.value
            if (
                isinstance(inner, ast.Attribute)
                and isinstance(inner.value, ast.Name)
                and inner.value.id in ("self", "cls")
                and self.cls is not None
            ):
                key = self.graph.class_attr_type(
                    (self.cls.rel_path, self.cls.name), inner.attr
                )
                if key is not None:
                    return self.graph.class_lock(key, expr.attr)
            return None
        # local alias (``lock = self._lock; with lock:``) first, then
        # bare module-level lock
        if isinstance(expr, ast.Name):
            alias = self.local_locks.get(expr.id)
            if alias is not None:
                return alias
            if expr.id in self.syms.module_locks:
                return (
                    (self.syms.rel_path, "<module>", expr.id),
                    self.syms.module_locks[expr.id] in REENTRANT_CTORS,
                )
        return None

    def visit_With(self, node: ast.With) -> None:
        acquired: list[LockId] = []
        for item in node.items:
            resolved = self._lock_of(item.context_expr)
            if resolved is None:
                continue
            lock, reentrant = resolved
            self.fn.acquires.append(
                AcquireSite(
                    lock=lock,
                    node=item.context_expr,
                    held_before=frozenset(self.held),
                    reentrant=reentrant,
                )
            )
            self.held.append(lock)
            acquired.append(lock)
        self.generic_visit(node)
        for _ in acquired:
            self.held.pop()

    visit_AsyncWith = visit_With

    def _record_mutation(self, attr: str, node: ast.AST) -> None:
        if self.cls is None or attr in self.cls.locks:
            return
        self.fn.mutations.append(
            MutationSite(attr=attr, node=node, held=frozenset(self.held))
        )

    @staticmethod
    def _self_attr(node: ast.AST) -> str | None:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in ("self", "cls")
        ):
            return node.attr
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            for el in (
                target.elts if isinstance(target, ast.Tuple) else [target]
            ):
                attr = self._self_attr(el)
                if attr is not None:
                    self._record_mutation(attr, node)
                if isinstance(el, ast.Subscript):
                    attr = self._self_attr(el.value)
                    if attr is not None:
                        self._record_mutation(attr, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = self._self_attr(node.target)
        if attr is None and isinstance(node.target, ast.Subscript):
            attr = self._self_attr(node.target.value)
        if attr is not None:
            self._record_mutation(attr, node)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for target in node.targets:
            attr = self._self_attr(target)
            if attr is None and isinstance(target, ast.Subscript):
                attr = self._self_attr(target.value)
            if attr is not None:
                self._record_mutation(attr, node)
        self.generic_visit(node)

    def _spawn_target(self, expr: ast.AST) -> tuple | None:
        """Resolve a function REFERENCE (not a call) to a graph key."""
        if isinstance(expr, ast.Name):
            hits = self.graph.resolve_call(
                self.syms.rel_path,
                self.cls.name if self.cls else None,
                expr.id,
                self.local_types,
            )
            return hits[0] if hits else None
        d = dotted(expr)
        if d is None:
            return None
        hits = self.graph.resolve_call(
            self.syms.rel_path,
            self.cls.name if self.cls else None,
            d,
            self.local_types,
        )
        return hits[0] if hits else None

    def visit_Call(self, node: ast.Call) -> None:
        d = dotted(node.func)
        # container mutations: self._x.append(...) and friends
        if isinstance(node.func, ast.Attribute):
            attr = self._self_attr(node.func.value)
            if attr is not None and node.func.attr in MUTATING_METHODS:
                self._record_mutation(attr, node)
        # blocking/heavy pattern
        hit = classify_blocking_call(node)
        if hit is not None:
            self.fn.blocking.append(
                BlockingSite(
                    node=node, code=hit[0], msg=hit[1],
                    held=frozenset(self.held),
                )
            )
        # thread spawns: Thread(target=..., daemon=...)
        if d is not None and d.split(".")[-1] == "Thread":
            target = None
            daemon = False
            for kw in node.keywords:
                if kw.arg == "target":
                    target = self._spawn_target(kw.value)
                elif kw.arg == "daemon" and isinstance(
                    kw.value, ast.Constant
                ):
                    daemon = bool(kw.value.value)
            if target is not None:
                self.fn.spawns.append(
                    SpawnSite(
                        target=target,
                        domain="daemon" if daemon else "thread",
                        node=node,
                    )
                )
        # executor handoffs: the referenced function runs on the pool
        if d is not None:
            tail = d.split(".")[-1]
            spec = _EXECUTOR_CALLS.get(tail)
            if spec is not None:
                idx, domain = spec
                if idx < len(node.args):
                    target = self._spawn_target(node.args[idx])
                    if target is not None:
                        self.fn.spawns.append(
                            SpawnSite(
                                target=target, domain=domain, node=node
                            )
                        )
        # ordinary call edge
        if d is not None:
            targets = self.graph.resolve_call(
                self.syms.rel_path,
                self.cls.name if self.cls else None,
                d,
                self.local_types,
            )
            self.fn.calls.append(
                CallSite(
                    node=node,
                    dotted=d,
                    held=frozenset(self.held),
                    targets=tuple(targets),
                )
            )
        self.generic_visit(node)


def _walk_skipping_defs(fn_node: ast.AST):
    """``ast.walk`` over a function body minus nested def/lambda
    subtrees."""
    body = getattr(fn_node, "body", [])
    stack: list[ast.AST] = list(body) if isinstance(body, list) else [body]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            stack.append(child)


# ── the graph ────────────────────────────────────────────────────────────


class ProgramGraph:
    """The run-wide artifact. Built ONCE per Runner (``Runner.graph()``
    caches it); the tier-1 perf guard asserts the build count."""

    #: total builds this process — the build-once perf guard reads it
    builds = 0

    def __init__(self, modules: Sequence[Any]) -> None:
        ProgramGraph.builds += 1
        #: rel_path -> ModuleSymbols
        self.modules: dict[str, ModuleSymbols] = {}
        for mod in modules:
            self.modules[mod.rel_path] = ModuleSymbols(
                mod.rel_path, mod.tree
            )
        self.dotted_to_rel = {
            module_dotted(rel): rel for rel in self.modules
        }
        #: (rel_path, class name) -> ClassSymbol
        self.classes: dict[tuple, ClassSymbol] = {}
        for rel, syms in self.modules.items():
            for name, cls in syms.classes.items():
                self.classes[(rel, name)] = cls
        self._resolve_types()
        #: (rel_path, qualname) -> FunctionNode
        self.functions: dict[tuple, FunctionNode] = {}
        self._index_functions()
        self._scan_bodies()
        #: function key -> {"loop", "thread", "daemon", "executor"}
        self.domains: dict[tuple, set[str]] = {}
        #: function key -> {domain: entry description} (messages)
        self.domain_why: dict[tuple, dict[str, str]] = {}
        self._infer_domains()

    # ── symbol resolution ───────────────────────────────────────────────

    def resolve_class(self, rel: str, name: str) -> tuple | None:
        """A class NAME as written in ``rel`` (bare, from-imported, or
        ``mod.Class`` dotted) → its (rel_path, class) key, or None."""
        syms = self.modules.get(rel)
        if syms is None:
            return None
        if "." not in name:
            if name in syms.classes:
                return (rel, name)
            sym = syms.imports.symbols.get(name)
            if sym is not None:
                target_rel = self.dotted_to_rel.get(sym[0])
                if target_rel is not None and target_rel != rel:
                    return self.resolve_class(target_rel, sym[1])
            return None
        head, _, restname = name.partition(".")
        mod = syms.imports.aliases.get(head)
        if mod is None:
            return None
        # longest module prefix of mod + rest
        full = f"{mod}.{restname}"
        parts = full.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            target_rel = self.dotted_to_rel.get(".".join(parts[:cut]))
            if target_rel is not None:
                remainder = ".".join(parts[cut:])
                if "." not in remainder:
                    return self.resolve_class(target_rel, remainder)
                return None
        return None

    # ── inheritance: method/lock/collaborator lookup through bases ──────

    def mro(self, cls_key: tuple) -> list[tuple]:
        """Linearized base-class order (BFS, cycle-safe) starting at
        ``cls_key`` — only classes the run actually parsed appear, so
        stdlib/third-party bases simply end the walk."""
        out: list[tuple] = []
        seen: set[tuple] = set()
        frontier = [cls_key]
        while frontier:
            key = frontier.pop(0)
            if key in seen or key not in self.classes:
                continue
            seen.add(key)
            out.append(key)
            frontier.extend(self.classes[key].bases)
        return out

    def resolve_method(self, cls_key: tuple, method: str) -> tuple | None:
        """``self.method()`` resolution THROUGH base classes: the first
        MRO class defining ``method`` wins — so a subclass handler
        inherits the base implementation's lock/domain/flow facts."""
        for key in self.mro(cls_key):
            qual = f"{key[1]}.{method}"
            target = self.modules.get(key[0])
            if target is not None and qual in target.index.defs:
                return (key[0], qual)
        return None

    def class_lock(
        self, cls_key: tuple, attr: str
    ) -> tuple[LockId, bool] | None:
        """A lock attr through the MRO: ``(LockId, reentrant)``. The
        canonical identity is the DEFINING class, so a base-class lock
        acquired from a subclass method is ONE lock, not two."""
        for key in self.mro(cls_key):
            cls = self.classes[key]
            if attr in cls.locks:
                return (
                    cls.lock_id(attr),
                    cls.locks[attr] in REENTRANT_CTORS,
                )
        return None

    def class_attr_type(self, cls_key: tuple, attr: str) -> tuple | None:
        """A typed ``self._x`` collaborator through the MRO."""
        for key in self.mro(cls_key):
            t = self.classes[key].attr_types.get(attr)
            if t is not None:
                return t
        return None

    def is_subclass_of(self, cls_key: tuple, base_name: str) -> bool:
        """True when any MRO entry — or any of its UNRESOLVED written
        bases — is named ``base_name`` (hierarchy-membership test for
        GL604's typed-error contract)."""
        for key in self.mro(cls_key):
            if key[1] == base_name:
                return True
            for expr in self.classes[key].base_exprs:
                if expr.split(".")[-1] == base_name:
                    return True
        return False

    def _resolve_types(self) -> None:
        for rel, syms in self.modules.items():
            for name, expr in syms.var_exprs.items():
                key = self.resolve_class(rel, expr)
                if key is not None:
                    syms.var_types[name] = key
            for cls in syms.classes.values():
                for base in cls.base_exprs:
                    key = self.resolve_class(rel, base)
                    if key is not None and key != (rel, cls.name):
                        cls.bases.append(key)
                for attr, expr in cls.attr_exprs.items():
                    if isinstance(expr, str):
                        key = self.resolve_class(rel, expr)
                        if key is not None:
                            cls.attr_types[attr] = key
        # bound-method re-exports need var_types resolved first
        for rel, syms in self.modules.items():
            for name, (var, meth) in syms.bound_exprs.items():
                cls_key = syms.var_types.get(var)
                if cls_key is None:
                    continue
                fn_key = (cls_key[0], f"{cls_key[1]}.{meth}")
                syms.bound_methods[name] = fn_key

    def _resolve_symbol(
        self, rel: str, name: str, depth: int = 0
    ) -> list[tuple]:
        """A callable NAME in module ``rel`` → function keys, chasing
        from-import re-export chains (``telemetry/__init__`` →
        ``bus.incr`` → ``BUS.incr`` bound method)."""
        if depth > 6:
            return []
        syms = self.modules.get(rel)
        if syms is None:
            return []
        if name in syms.index.defs:
            return [(rel, name)]
        bound = syms.bound_methods.get(name)
        if bound is not None:
            return [bound]
        sym = syms.imports.symbols.get(name)
        if sym is not None:
            target_rel = self.dotted_to_rel.get(sym[0])
            if target_rel is not None and (target_rel, sym[1]) != (
                rel, name,
            ):
                return self._resolve_symbol(target_rel, sym[1], depth + 1)
        return []

    def resolve_call(
        self,
        rel: str,
        class_name: str | None,
        dotted_name: str,
        local_types: dict | None = None,
    ) -> list[tuple]:
        """Where a dotted call string seen in ``rel`` (inside
        ``class_name``, with ``local_types`` for this body) may be
        defined, across the whole run. Conservative: unresolvable
        receivers return []."""
        syms = self.modules.get(rel)
        if syms is None:
            return []
        parts = dotted_name.split(".")
        # bare name
        if len(parts) == 1:
            return self._resolve_symbol(rel, dotted_name)
        head, rest = parts[0], parts[1:]
        # self.m / cls.m (+ self._attr.m through a typed collaborator);
        # methods resolve through the MRO so subclass handlers land on
        # inherited implementations
        if head in ("self", "cls"):
            if len(rest) == 1 and class_name is not None:
                hit = self.resolve_method((rel, class_name), rest[0])
                return [hit] if hit is not None else []
            if len(rest) == 2 and class_name is not None:
                key = self.class_attr_type((rel, class_name), rest[0])
                if key is not None:
                    hit = self.resolve_method(key, rest[1])
                    return [hit] if hit is not None else []
                return []
            return []
        # x.m where x is a typed local
        if local_types and head in local_types and len(rest) == 1:
            hit = self.resolve_method(local_types[head], rest[0])
            return [hit] if hit is not None else []
        # X.m where X is a module-level typed singleton
        if head in syms.var_types and len(rest) == 1:
            hit = self.resolve_method(syms.var_types[head], rest[0])
            return [hit] if hit is not None else []
        # Class.m of a local (or imported) class
        cls_key = self.resolve_class(rel, head)
        if cls_key is not None and len(rest) == 1:
            hit = self.resolve_method(cls_key, rest[0])
            return [hit] if hit is not None else []
        # module path through an import binding
        mod = syms.imports.aliases.get(head)
        if mod is None:
            return []
        full = mod + "." + ".".join(rest)
        parts = full.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            target_rel = self.dotted_to_rel.get(".".join(parts[:cut]))
            if target_rel is None:
                continue
            remainder = parts[cut:]
            target = self.modules[target_rel]
            if len(remainder) == 1:
                return self._resolve_symbol(target_rel, remainder[0])
            if len(remainder) == 2:
                first, meth = remainder
                # Class.m (through the MRO)
                if first in target.classes:
                    hit = self.resolve_method((target_rel, first), meth)
                    if hit is not None:
                        return [hit]
                # singleton.m (BUS.incr spelled from outside)
                key = target.var_types.get(first)
                if key is not None:
                    hit = self.resolve_method(key, meth)
                    if hit is not None:
                        return [hit]
            return []
        return []

    # ── function nodes + body scans ─────────────────────────────────────

    @staticmethod
    def _caller_holds_lock(qualname: str, node: ast.AST) -> bool:
        name = qualname.rsplit(".", 1)[-1]
        if name.endswith("_locked"):
            return True
        doc = ast.get_docstring(node) or ""
        return doc.lstrip().lower().startswith("under the lock")

    def _index_functions(self) -> None:
        for rel, syms in self.modules.items():
            for qual, node in syms.index.defs.items():
                class_name = (
                    qual.rsplit(".", 1)[0] if "." in qual else None
                )
                self.functions[(rel, qual)] = FunctionNode(
                    key=(rel, qual),
                    node=node,
                    rel_path=rel,
                    qualname=qual,
                    class_name=class_name,
                    is_async=isinstance(node, ast.AsyncFunctionDef),
                    caller_holds_lock=self._caller_holds_lock(qual, node),
                )

    def _scan_bodies(self) -> None:
        for fn in self.functions.values():
            syms = self.modules[fn.rel_path]
            cls = (
                syms.classes.get(fn.class_name)
                if fn.class_name is not None
                else None
            )
            scan = _BodyScan(self, fn, syms, cls)
            body = getattr(fn.node, "body", [])
            for stmt in body if isinstance(body, list) else [body]:
                scan.visit(stmt)

    # ── execution domains ───────────────────────────────────────────────

    def _infer_domains(self) -> None:
        roots: list[tuple[tuple, str, str]] = []  # (key, domain, why)
        for key, fn in self.functions.items():
            if fn.is_async:
                roots.append((key, "loop", f"async def {fn.qualname}"))
            for spawn in fn.spawns:
                if spawn.target is not None and (
                    spawn.target in self.functions
                ):
                    roots.append(
                        (
                            spawn.target,
                            spawn.domain,
                            f"spawned by {fn.pretty}",
                        )
                    )
        seen: set[tuple] = set()
        frontier = list(roots)
        while frontier:
            key, domain, why = frontier.pop()
            if (key, domain) in seen:
                continue
            seen.add((key, domain))
            self.domains.setdefault(key, set()).add(domain)
            self.domain_why.setdefault(key, {}).setdefault(domain, why)
            fn = self.functions.get(key)
            if fn is None:
                continue
            for call in fn.calls:
                for target in call.targets:
                    callee = self.functions.get(target)
                    # a sync callee runs in its caller's domain; an
                    # async callee is merely scheduled — it stays loop
                    if callee is not None and not callee.is_async:
                        frontier.append(
                            (target, domain, f"called from {fn.pretty}")
                        )

    def domains_of(self, key: tuple) -> set[str]:
        return self.domains.get(key, set())


# ── --changed support: the reverse import closure ────────────────────────


def import_dependents(
    files: Iterable[str],
    rel_of,
    changed: set[str],
) -> tuple[set[str], set[str]]:
    """The ``--changed`` analysis set: the changed files (rel paths),
    everything that imports them transitively (a changed callee can
    flip a caller's findings), AND the transitive forward imports of
    that whole set — without the dependencies the graph cannot resolve
    calls INTO them, so a finding sited in an unchanged callee (the
    GL204/GL205 shape: the blocking line lives where the code blocks,
    not where the lock was taken) would be silently missed. ``rel_of``
    maps an abs path to its repo-relative POSIX path. Files that fail
    to parse are kept (the full run will report them).

    Returns ``(analysis set, stale scope)``. The stale scope is the
    changed + reverse-dependent subset — the files whose OWN findings
    this run can reproduce (their dependencies all ride along via the
    forward pass). Files pulled in ONLY as forward dependencies are
    call-resolution context: their cross-module findings may originate
    in files outside the set (a GL602 sink whose taint source lives in
    an unchanged caller), so their baseline allowances must not be
    marked stale by a subset run."""
    rels: dict[str, str] = {}
    deps: dict[str, set[str]] = {}
    dotted_to_rel: dict[str, str] = {}
    for path in files:
        rel = rel_of(path)
        rels[path] = rel
        dotted_to_rel[module_dotted(rel)] = rel
    for path, rel in rels.items():
        try:
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
        except (OSError, SyntaxError):
            deps[rel] = set()
            changed.add(rel)  # unparseable: always re-analyze
            continue
        idx = ImportIndex(package_of(rel))
        idx.visit(tree)
        imported: set[str] = set()
        for mod in idx.aliases.values():
            parts = mod.split(".")
            for cut in range(len(parts), 0, -1):
                hit = dotted_to_rel.get(".".join(parts[:cut]))
                if hit is not None:
                    imported.add(hit)
                    break
        for base, _name in idx.symbols.values():
            parts = base.split(".")
            for cut in range(len(parts), 0, -1):
                hit = dotted_to_rel.get(".".join(parts[:cut]))
                if hit is not None:
                    imported.add(hit)
                    break
        deps[rel] = imported
    reverse: dict[str, set[str]] = {}
    for rel, imported in deps.items():
        for dep in imported:
            reverse.setdefault(dep, set()).add(rel)
    out = set(changed) & set(deps)
    frontier = list(out)
    while frontier:
        rel = frontier.pop()
        for dependent in reverse.get(rel, ()):
            if dependent not in out:
                out.add(dependent)
                frontier.append(dependent)
    stale_scope = set(out)
    # forward closure: pull in what the analysis set imports, so calls
    # out of changed/dependent files resolve and their findings land
    frontier = list(out)
    while frontier:
        rel = frontier.pop()
        for dep in deps.get(rel, ()):
            if dep not in out:
                out.add(dep)
                frontier.append(dep)
    return out, stale_scope
