"""GL3 — async hygiene for the aiohttp event loop.

The node and network apps are single-event-loop aiohttp servers; one
blocking call inside an ``async def`` handler stalls every socket the
process serves (heartbeats included — the network marks nodes offline
for it). Three grades:

- **GL301** stdlib blocking primitives: ``time.sleep``, sync HTTP
  (``requests.*``, ``urllib.request.urlopen``), raw socket I/O,
  ``subprocess.run``/``os.system``.
- **GL302** concurrency-primitive waits: ``Future.result()``, thread
  ``.join()``, blocking ``queue.get()`` — each parks the loop thread
  until another thread produces, which may itself need the loop.
- **GL303** repo-known heavy calls: the serde hot loop
  (``serialize``/``deserialize``/``to_hex``/``from_hex``), base64 of
  model-scale blobs, frame compression, and the sync WS-handler bridges
  (``ws_report`` and friends decode megabyte diffs) — all measured in
  milliseconds-to-seconds at checkpoint scale (docs/WIRE.md §1,
  ``bench.bench_wire``), i.e. event-loop poison. Ship them to an
  executor: ``await loop.run_in_executor(None, fn, ...)``.

- **GL304** one-hop transitive blocking: a sync helper defined at
  module/class level in the SAME module and *called directly* from an
  ``async def`` body runs on the loop too — a ``time.sleep`` or serde
  call hiding one hop down blocks every socket just as surely. The
  closure is deliberately one hop (like GL1's module-local closure):
  helpers merely *referenced* (handed to ``run_in_executor`` /
  ``_off_loop``) are not calls and stay exempt. A sync helper defined
  INSIDE the async body rides the executor-fodder exemption only while
  it is merely referenced — if the body ALSO calls it directly, it
  runs on the loop and is scanned like any other one-hop helper.

Only code that executes ON the loop is flagged: nested sync ``def``s
and ``lambda``s inside an async handler are exempt (they are what you
hand to ``run_in_executor``) — unless the same body calls them
directly, see GL304.

The blocking/heavy pattern tables (GL301–303) and their classifier
live in :mod:`pygrid_tpu_torch.analysis.graph` — GL205 applies the SAME set
to lock-held regions in any execution domain.
"""

from __future__ import annotations

import ast
from typing import Iterable

from pygrid_tpu_torch.analysis.core import Checker, Finding, ModuleContext
from pygrid_tpu_torch.analysis.graph import classify_blocking_call

class _AsyncBodyScan(ast.NodeVisitor):
    """Walk one async function body WITHOUT descending into nested sync
    defs/lambdas (those run wherever the caller ships them)."""

    def __init__(self) -> None:
        self.hits: list[tuple[ast.AST, str, str]] = []
        #: names this body CALLS directly, kept in separate namespaces
        #: so GL304 cannot resolve a bare call to an unrelated
        #: same-named class method (or vice versa) — references passed
        #: as arguments are not calls and land in neither set
        self.called_names: set[str] = set()       # bare ``helper(...)``
        self.called_methods: set[str] = set()     # ``self/cls.m(...)``
        #: sync defs nested in THIS body — executor fodder unless the
        #: same body also calls them directly (the GL304 nested-def hop)
        self.nested_defs: dict[str, ast.FunctionDef] = {}

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # sync helper: runs off-loop (executor fodder) — but remember
        # it; a direct call in this same body puts it ON the loop
        self.nested_defs.setdefault(node.name, node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        return

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        return  # nested async def has its own scan

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Name):
            self.called_names.add(fn.id)
        elif isinstance(fn, ast.Attribute):
            if isinstance(fn.value, ast.Name) and fn.value.id in (
                "self", "cls",
            ):
                self.called_methods.add(fn.attr)
        hit = classify_blocking_call(node)
        if hit is not None:
            self.hits.append((node, hit[0], hit[1]))
        self.generic_visit(node)


class _HelperIndex(ast.NodeVisitor):
    """Module-level and class-level SYNC defs in SEPARATE namespaces —
    the one-hop closure's resolution table (bare calls resolve only to
    module functions, ``self.``/``cls.`` calls only to methods, so an
    imported name shadowed by an unrelated method cannot misresolve).
    Nested defs are skipped on purpose: they are executor fodder by
    this checker's own convention."""

    def __init__(self) -> None:
        self.module_defs: dict[str, ast.FunctionDef] = {}
        #: (enclosing class name, method name) -> def — keyed per class
        #: so a handler's ``self.x()`` can never misresolve to another
        #: class's same-named method
        self.method_defs: dict[tuple[str, str], ast.FunctionDef] = {}
        self._class_stack: list[str] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if self._class_stack:
            self.method_defs.setdefault(
                (self._class_stack[-1], node.name), node
            )
        else:
            self.module_defs.setdefault(node.name, node)
        # do NOT descend: nested defs run wherever their caller ships them

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        return

    def visit_Lambda(self, node: ast.Lambda) -> None:
        return


class AsyncHygieneChecker(Checker):
    name = "GL3"
    description = "blocking calls inside async def handlers"
    codes = {
        "GL301": "stdlib blocking call on the event loop",
        "GL302": "Future/thread/queue wait on the event loop",
        "GL303": "repo-known heavy call (serde/base64/compression) on the "
        "event loop",
        "GL304": "blocking call one hop down: a sync same-module helper "
        "called from an async handler",
    }

    def check_module(self, mod: ModuleContext) -> Iterable[Finding]:
        helpers = _HelperIndex()
        helpers.visit(mod.tree)
        findings: list[Finding] = []
        #: (helper id, blocking-node id) already reported — two async
        #: callers of one bad helper yield ONE finding at the bad line
        reported: set[tuple[int, int]] = set()

        def _check_async(node: ast.AsyncFunctionDef, class_name):
            scan = _AsyncBodyScan()
            for stmt in node.body:
                scan.visit(stmt)
            for site, code, msg in scan.hits:
                findings.append(
                    mod.finding(
                        code,
                        site,
                        f"async def '{node.name}': {msg}",
                    )
                )
            # one-hop closure: direct calls to same-module sync helpers
            # (bare names → module functions; self./cls. → this class's
            # own methods, never another class's same-named one). A
            # nested def SHADOWS a same-named module helper and — when
            # called directly in this body — loses its executor-fodder
            # exemption: it runs on the loop (ROADMAP "GL304 nested-def
            # hop").
            resolved = [
                scan.nested_defs.get(n) or helpers.module_defs.get(n)
                for n in sorted(scan.called_names)
            ]
            if class_name is not None:
                resolved += [
                    helpers.method_defs.get((class_name, n))
                    for n in sorted(scan.called_methods)
                ]
            for helper in resolved:
                if helper is None:
                    continue
                inner = _AsyncBodyScan()
                for stmt in helper.body:
                    inner.visit(stmt)
                for site, _code, msg in inner.hits:
                    key = (id(helper), id(site))
                    if key in reported:
                        continue
                    reported.add(key)
                    findings.append(
                        mod.finding(
                            "GL304",
                            site,
                            f"sync helper '{helper.name}()' called from "
                            f"async def '{node.name}': {msg}",
                        )
                    )

        def _walk(node: ast.AST, class_name):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    _walk(child, child.name)
                    continue
                if isinstance(child, ast.AsyncFunctionDef):
                    _check_async(child, class_name)
                _walk(child, class_name)

        _walk(mod.tree, None)
        return findings
