"""GL1 — program safety for the port.

The port has no ``jit``. Its counterpart of a jitted body is a
*program*: a function the port builds once and calls many times with the
device doing the work, or hands to a capture (``torch.export``, CUDA
graphs) that records it once. :data:`PROGRAMS` names every spelling,
each beside the reference's ``jax.jit`` site it stands for. The contract
(``serving/programs.py``): a program is a Python loop over launches with
no host sync inside — the host fetches results once per call.

- **GL101** — a host side effect in a program (telemetry, logging,
  locks, ``time.perf_counter()``, ``print``). In an eager program it runs
  on the host between launches; under ``torch.export`` or graph capture
  it fires once at capture, not per call, as under ``jax.jit``.
- **GL102** — a host sync in a program: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``int``/``float``/``bool`` of a tensor
  expression, an ``if``/``while``/``assert`` on a tensor expression,
  an op whose output shape depends on the data (``nonzero``, ``unique``,
  ``masked_select``, one-argument ``where``), and a blocking copy of
  host data to the device (``torch.as_tensor``/``torch.tensor``/
  ``torch.from_numpy`` with ``device=`` or ``.to(...)``, or a host scalar
  assigned into an element, ``x[i] = int(n)``): the copy waits for the
  stream.
- **GL103** — a program (``torch.compile``, ``torch.export.export``…)
  built per call: invoked where it is built, or built inside a loop.
- **GL105** — a request-derived host scalar baked into a program's
  construction (a lambda default or closure of the function handed to a
  program builder): one program per distinct client value.

GL104 (donation after use) has no counterpart: torch has no buffer
donation, and the engine's in-place cache update keeps the names live.

Detection is deliberately conservative, as the reference's: a tensor is
recognised by the expression that makes it (a ``torch.*`` call or a
tensor method), never by a name's type. Reachability closes over
module-local calls and, in ``finalize``, over calls through import
bindings into other modules; findings land in the file that holds them.
After a run, :attr:`TraceSafetyChecker.closure` maps each file to the
``(first line, last line, name)`` of every function body a program
reaches, and :attr:`TraceSafetyChecker.roots` to those of the program
bodies themselves — what ``chip_smoke.py`` holds the card's observed
syncs against.
"""

from __future__ import annotations

import ast
from typing import Iterable, NamedTuple

from pygrid_tpu_torch.analysis.core import Checker, Finding, ModuleContext
from pygrid_tpu_torch.analysis.graph import (
    PROGRAM_METHODS,
    FunctionIndex as _FunctionIndex,
    ImportIndex as _ImportIndexBase,
    dotted as _dotted,
    is_program_call as _is_program_call,
    module_dotted as _module_dotted,
    package_of as _package_of,
)


class ProgramEntry(NamedTuple):
    port: str  # the spelling in the port
    example: str  # a site of the port that uses it
    reference: str  # the jax.jit site it stands for


#: every way the port builds a program, beside the reference's jit site
PROGRAMS = (
    ProgramEntry(
        "ProgramSet._build(fn, kind, bucket)",
        "serving/programs.py:152",
        "jax.jit(_prefill, donate_argnums=...), "
        "pygrid_tpu/serving/programs.py:143,172,213,271,300,354,481",
    ),
    ProgramEntry(
        "torch.export.export(graph, example)",
        "plans/plan.py:139",
        "jax.jit(fn) under jax_export.export, pygrid_tpu/plans/plan.py:47",
    ),
    ProgramEntry(
        "torch.compile(fn) / torch.cuda.graph() / "
        "torch.cuda.make_graphed_callables(fn)",
        "(not used by the port yet)",
        "jax.jit(fn)",
    ),
    ProgramEntry(
        "torch.autograd.Function.forward/backward",
        "parallel/flash_attention.py:335, models/lm.py:141, "
        "models/moe.py:428, parallel/collectives.py",
        "jax.custom_vjp, pygrid_tpu/parallel/pallas_attention.py:222, "
        "pygrid_tpu/models/transformer.py:224; the lax collectives' "
        "transposes under jax.jit(sharded), pygrid_tpu/parallel/"
        "fedavg.py:135",
    ),
    ProgramEntry(
        "the closure make_round / make_scanned_rounds / "
        "make_sharded_round return",
        "parallel/fedavg.py",
        "@jax.jit round_fn / rounds_fn, pygrid_tpu/parallel/fedavg.py:"
        "63,135,172",
    ),
    ProgramEntry(
        "the closure make_fused_rounds / make_fused_round / "
        "make_sharded_fused_round return",
        "parallel/fedavg_fused.py",
        "@jax.jit rounds_fn, pygrid_tpu/parallel/fedavg_fused.py:161,276",
    ),
)

#: ``module.attr`` calls that are host side-effects (GL101)
_SIDE_EFFECT_ATTRS = {
    ("telemetry", "record"), ("telemetry", "incr"), ("telemetry", "observe"),
    ("time", "time"), ("time", "sleep"), ("time", "perf_counter"),
    ("time", "monotonic"), ("time", "process_time"),
    ("os", "urandom"), ("random", "random"), ("random", "randint"),
}
#: bare-name calls that are host side-effects when run in a program
_SIDE_EFFECT_NAMES = {"print", "record", "incr", "observe"}
#: logger-ish receivers: ``logger.info(...)`` etc.
_LOGGER_RECEIVERS = {"logger", "logging", "log"}
_LOGGER_METHODS = {
    "debug", "info", "warning", "error", "exception", "critical", "log",
}

#: no-argument tensor methods that copy to the host and wait (GL102)
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: ops whose output shape depends on the data: the host waits for it
_DATA_SHAPE_OPS = {"nonzero", "unique", "masked_select", "argwhere"}
#: tensor methods whose result is a tensor (a reduction or test) — an
#: expression ending in one is a tensor, whatever its receiver
_TENSOR_METHODS = {
    "any", "all", "sum", "mean", "max", "min", "amax", "amin", "argmax",
    "argmin", "norm", "prod", "count_nonzero", "isfinite", "isnan",
    "eq", "ne", "gt", "lt", "ge", "le", "equal", "allclose",
}
#: module names whose functions of those names run on the host (np.any)
_HOST_MODULES = {"np", "numpy", "math", "statistics", "operator", "builtins"}
#: host-data constructors: with ``device=`` or ``.to(...)`` they copy
_HOST_TO_DEVICE = {"torch.as_tensor", "torch.tensor", "torch.from_numpy"}


def _is_tensor_expr(node: ast.AST) -> bool:
    """Does ``node`` evaluate to a tensor by its own spelling: a
    ``torch.*`` call (not a dtype or device constructor), a tensor
    method from :data:`_TENSOR_METHODS`, or arithmetic/comparison over
    one?"""
    if isinstance(node, ast.Call):
        d = _dotted(node.func) or ""
        if d.startswith("torch.") and d not in (
            "torch.device", "torch.dtype", "torch.Size",
            "torch.is_tensor", "torch.is_floating_point",
            "torch.autograd._profiler_enabled",
            "torch._C._current_graph_task_id",  # an int: -1 outside a backward
        ):
            return True
        return (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _TENSOR_METHODS
            and (_dotted(node.func.value) or "").split(".")[0]
            not in _HOST_MODULES
        )
    if isinstance(node, ast.Compare):
        return _is_tensor_expr(node.left) or any(
            _is_tensor_expr(c) for c in node.comparators
        )
    if isinstance(node, ast.BinOp):
        return _is_tensor_expr(node.left) or _is_tensor_expr(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_tensor_expr(node.operand)
    if isinstance(node, ast.BoolOp):
        return any(_is_tensor_expr(v) for v in node.values)
    return False


def _host_copy(node: ast.Call) -> str | None:
    """The spelling of a blocking host-to-device copy, else None."""
    d = _dotted(node.func)
    if d in _HOST_TO_DEVICE and any(kw.arg == "device" for kw in node.keywords):
        return f"{d}(..., device=...)"
    if (
        isinstance(node.func, ast.Attribute)
        and node.func.attr == "to"
        and isinstance(node.func.value, ast.Call)
        and _dotted(node.func.value.func) in _HOST_TO_DEVICE
    ):
        return f"{_dotted(node.func.value.func)}(...).to(...)"
    return None


class _TraceBodyScan(ast.NodeVisitor):
    """Walk one program body collecting effects, syncs and outgoing
    calls."""

    def __init__(self) -> None:
        self.effects: list[tuple[ast.AST, str, str]] = []  # node, code, msg
        self.calls: set[str] = set()

    def _sync(self, node: ast.AST, what: str) -> None:
        self.effects.append(
            (node, "GL102", f"{what} forces a host sync inside a program")
        )

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        copy = _host_copy(node)
        if copy is not None:
            self._sync(node, f"a blocking host-to-device copy '{copy}'")
        if isinstance(fn, ast.Name):
            if fn.id in _SIDE_EFFECT_NAMES:
                self.effects.append(
                    (node, "GL101", f"host side-effect call '{fn.id}()'")
                )
            elif (
                fn.id in ("int", "float", "bool")
                and len(node.args) == 1
                and _is_tensor_expr(node.args[0])
            ):
                self._sync(node, f"'{fn.id}()' of a tensor")
            self.calls.add(fn.id)
        elif isinstance(fn, ast.Attribute):
            dotted = _dotted(fn)
            recv = dotted.split(".")[0] if dotted else ""
            if (recv, fn.attr) in _SIDE_EFFECT_ATTRS:
                self.effects.append(
                    (node, "GL101", f"host side-effect call '{recv}.{fn.attr}()'")
                )
            elif recv in _LOGGER_RECEIVERS and fn.attr in _LOGGER_METHODS:
                self.effects.append(
                    (node, "GL101", f"logging call '{recv}.{fn.attr}()'")
                )
            elif fn.attr == "acquire":
                self.effects.append(
                    (node, "GL101", f"lock acquisition '{dotted}()'")
                )
            elif fn.attr in _SYNC_METHODS and not node.args:
                self._sync(node, f"'.{fn.attr}()'")
            elif fn.attr in _DATA_SHAPE_OPS or (
                dotted == "torch.where" and len(node.args) == 1
            ):
                self._sync(node, f"'{fn.attr}' (a data-dependent shape)")
            if dotted:
                self.calls.add(dotted)
                if dotted.startswith(("self.", "cls.")):
                    self.calls.add(dotted.split(".", 1)[1])
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        value = node.value
        if isinstance(value, ast.UnaryOp):
            value = value.operand
        host = (
            isinstance(value, ast.Call)
            and isinstance(value.func, ast.Name)
            and value.func.id in ("int", "float", "bool")
        ) or (
            isinstance(value, ast.Constant)
            and isinstance(value.value, (int, float))
            and not isinstance(value.value, bool)
        )
        if host and any(isinstance(t, ast.Subscript) for t in node.targets):
            self._sync(
                node,
                "a host scalar written into a tensor element "
                "('x[i] = int(...)', a blocking copy)",
            )
        self.generic_visit(node)

    def _test(self, test: ast.AST, kind: str) -> None:
        if _is_tensor_expr(test):
            self._sync(test, f"a tensor as the condition of '{kind}'")

    def visit_If(self, node: ast.If) -> None:
        self._test(node.test, "if")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._test(node.test, "while")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._test(node.test, "x if c else y")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._test(node.test, "assert")
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            dotted = _dotted(item.context_expr)
            if dotted and "lock" in dotted.rsplit(".", 1)[-1].lower():
                self.effects.append(
                    (
                        item.context_expr,
                        "GL101",
                        f"lock acquisition 'with {dotted}' inside a "
                        "program",
                    )
                )
        self.generic_visit(node)


#: receivers whose subscripts / ``.get()`` reads carry PER-REQUEST data
#: (wire frames, JSON bodies, HTTP requests) — the taint sources GL105
#: follows into program constructions
_REQUEST_NAMES = {
    "msg", "message", "payload", "request", "req", "body", "data",
    "query",
}
#: ``request.<attr>`` reads that ARE the request payload
_REQUEST_ATTRS = {"json", "query", "match_info", "rel_url", "post"}


def _is_builder(node: ast.Call) -> bool:
    """A program-building call: a PROGRAM_CALLS spelling, or a builder
    method of PROGRAM_METHODS (``self._build``)."""
    if _is_program_call(node.func):
        return True
    d = _dotted(node.func) or ""
    return d.startswith("self.") and d[5:] in {m for _, m in PROGRAM_METHODS}


class _ScalarTaintChecker:
    """GL105 — a request-derived host scalar baked into a program.

    Light per-scope dataflow, as the reference's: names assigned from
    request/JSON reads (subscripts or ``.get()`` of request-ish
    receivers, ``request.json``, ``json.loads``, arithmetic or
    ``int()``/``float()`` over those) are tainted; a finding fires when a
    tainted name

    1. appears anywhere inside a program CONSTRUCTION expression (lambda
       default, ``partial`` binding — the closure-bake idiom), or
    2. is a free variable of a same-scope ``def`` handed to a builder by
       name.

    Passing the scalar as an argument at call time stays quiet. (The
    reference's third sink, ``static_argnums``, has no counterpart.)"""

    def __init__(self, mod: ModuleContext) -> None:
        self.mod = mod
        self.findings: list[Finding] = []
        self._seen_sinks: set[int] = set()

    def run(self) -> list[Finding]:
        self._body(self.mod.tree.body, set(), {})
        for node in ast.walk(self.mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._body(node.body, set(), {})
        return self.findings

    @staticmethod
    def _root(node: ast.AST) -> str | None:
        while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
            node = node.func if isinstance(node, ast.Call) else node.value
        return node.id if isinstance(node, ast.Name) else None

    def _is_source(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Subscript):
            return self._root(node.value) in _REQUEST_NAMES
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "get":
                return self._root(f.value) in _REQUEST_NAMES
            if _dotted(f) == "json.loads":
                return True
        if isinstance(node, ast.Attribute):
            return (
                self._root(node.value) in ("request", "req")
                and node.attr in _REQUEST_ATTRS
            )
        return False

    def _tainted(self, expr: ast.AST, taint: set[str]) -> bool:
        for node in ast.walk(expr):
            if (
                isinstance(node, ast.Name)
                and isinstance(node.ctx, ast.Load)
                and node.id in taint
            ):
                return True
            if self._is_source(node):
                return True
        return False

    @staticmethod
    def _walk_same_scope(node: ast.AST):
        """``ast.walk`` minus nested def/lambda subtrees: their assigns
        bind THEIR scope, not this one."""
        stack: list[ast.AST] = [node]
        while stack:
            cur = stack.pop()
            yield cur
            for child in ast.iter_child_nodes(cur):
                if isinstance(
                    child,
                    (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef),
                ):
                    continue
                stack.append(child)

    def _assigns(self, stmt: ast.stmt, taint: set[str]) -> None:
        for node in self._walk_same_scope(stmt):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
                if not isinstance(target, ast.Name):
                    continue
                if self._tainted(node.value, taint):
                    taint.add(target.id)
                else:
                    taint.discard(target.id)

    def _body(
        self,
        stmts: list[ast.stmt],
        taint: set[str],
        local_defs: dict[str, ast.AST],
    ) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                local_defs[stmt.name] = stmt
                continue  # nested scopes get their own walk
            nested = [
                sub
                for attr in ("body", "orelse", "finalbody")
                for sub in (getattr(stmt, attr, None) or [])
                if isinstance(sub, ast.stmt)
            ] or list(getattr(stmt, "handlers", []) or [])
            if nested:
                # compound statement: only the HEADER runs here; bodies
                # are walked in their own order
                for attr in ("test", "iter", "items"):
                    header = getattr(stmt, attr, None)
                    for part in header if isinstance(header, list) else (
                        [header] if header is not None else []
                    ):
                        self._sinks(part, taint, local_defs)
                for attr in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, attr, None)
                    if isinstance(sub, list) and sub and isinstance(
                        sub[0], ast.stmt
                    ):
                        self._body(sub, taint, local_defs)
                for handler in getattr(stmt, "handlers", []) or []:
                    self._body(handler.body, taint, local_defs)
                continue
            self._sinks(stmt, taint, local_defs)
            self._assigns(stmt, taint)

    @staticmethod
    def _free_reads(fn: ast.AST, taint: set[str]) -> bool:
        """Does ``fn``'s body read a tainted name that is neither a
        parameter nor assigned locally?"""
        bound: set[str] = set()
        args = getattr(fn, "args", None)
        if args is not None:
            for a in (
                list(args.args)
                + list(getattr(args, "posonlyargs", []))
                + list(args.kwonlyargs)
            ):
                bound.add(a.arg)
            for extra in (args.vararg, args.kwarg):
                if extra is not None:
                    bound.add(extra.arg)
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                bound.add(node.id)
        return any(
            isinstance(node, ast.Name)
            and isinstance(node.ctx, ast.Load)
            and node.id in taint
            and node.id not in bound
            for node in ast.walk(fn)
        )

    def _sinks(
        self, stmt: ast.AST, taint: set[str], local_defs: dict[str, ast.AST]
    ) -> None:
        for node in ast.walk(stmt):
            if (
                not isinstance(node, ast.Call)
                or id(node) in self._seen_sinks
                or not _is_builder(node)
            ):
                continue
            hit = any(
                self._tainted(arg, taint)
                for arg in list(node.args) + [kw.value for kw in node.keywords]
            )
            if not hit and node.args and isinstance(node.args[0], ast.Name):
                fn = local_defs.get(node.args[0].id)
                hit = fn is not None and self._free_reads(fn, taint)
            if hit:
                self._seen_sinks.add(id(node))
                self.findings.append(
                    self.mod.finding(
                        "GL105",
                        node,
                        "request-derived host scalar baked into a program's "
                        "construction — one program per distinct client "
                        "value; pass it as an argument or keep it a "
                        "host-side loop bound",
                    )
                )


class TraceSafetyChecker(Checker):
    name = "GL1"
    description = "host side-effects / syncs / rebuilds in the port's programs"
    codes = {
        "GL101": "host side-effect reachable inside a program",
        "GL102": "host sync reachable inside a program",
        "GL103": "program built per call / inside a loop",
        "GL105": "per-request host scalar baked into a program's "
        "construction (one program per distinct value)",
    }

    def __init__(self) -> None:
        # per-file state feeding the whole-run (cross-module) second
        # pass in finalize; keyed by rel_path
        self._indexes: dict[str, _FunctionIndex] = {}
        self._imports: dict[str, _ImportIndexBase] = {}
        self._mods: dict[str, ModuleContext] = {}
        self._roots: dict[str, list[ast.AST]] = {}
        self._reported: set[tuple[str, int, str]] = set()
        self._dotted_to_rel: dict[str, str] = {}
        self._scans: dict[int, _TraceBodyScan] = {}
        #: rel_path -> {(first line, last line, name)} of every body a
        #: program reaches (roots included), and of the roots alone
        self.closure: dict[str, set[tuple[int, int, str]]] = {}
        self.roots: dict[str, set[tuple[int, int, str]]] = {}

    def _scan(self, fn_node: ast.AST) -> _TraceBodyScan:
        key = id(fn_node)
        if key not in self._scans:
            scan = _TraceBodyScan()
            body = getattr(fn_node, "body", [])
            for stmt in body if isinstance(body, list) else [body]:
                scan.visit(stmt)
            self._scans[key] = scan
        return self._scans[key]

    @staticmethod
    def _span(fn_node: ast.AST) -> tuple[int, int, str]:
        line = getattr(fn_node, "lineno", 1)
        return (
            line,
            getattr(fn_node, "end_lineno", None) or line,
            getattr(fn_node, "name", type(fn_node).__name__.lower()),
        )

    def _reach(self, rel: str, fn_node: ast.AST) -> None:
        self.closure.setdefault(rel, set()).add(self._span(fn_node))

    def check_module(self, mod: ModuleContext) -> Iterable[Finding]:
        syms = (
            mod.runner.graph().modules.get(mod.rel_path)
            if mod.runner is not None
            else None
        )
        if syms is not None:
            index = syms.index
            imports = syms.imports
        else:
            index = _FunctionIndex()
            index.visit(mod.tree)
            imports = _ImportIndexBase(_package_of(mod.rel_path))
            imports.visit(mod.tree)
        self._indexes[mod.rel_path] = index
        self._imports[mod.rel_path] = imports
        self._mods[mod.rel_path] = mod

        # resolve "builder(name)" entries to def nodes where possible
        roots: list[ast.AST] = []
        for entry, _how in index.programs:
            if isinstance(entry, str):
                short = entry.split(".")[-1]
                node = index.defs.get(entry)
                if node is None:
                    for name, cand in index.defs.items():
                        if name.split(".")[-1] == short:
                            node = cand
                            break
                if node is not None:
                    roots.append(node)
            else:
                roots.append(entry)
        self._roots[mod.rel_path] = roots
        if roots:
            self.roots[mod.rel_path] = {self._span(r) for r in roots}

        findings: list[Finding] = []
        # reachability closure over module/class-local callees
        seen: set[int] = set()
        frontier = list(roots)
        while frontier:
            fn_node = frontier.pop()
            if id(fn_node) in seen:
                continue
            seen.add(id(fn_node))
            self._reach(mod.rel_path, fn_node)
            scan = self._scan(fn_node)
            for node, code, msg in scan.effects:
                finding = mod.finding(code, node, f"{msg} (reachable in a program)")
                findings.append(finding)
                self._reported.add((finding.path, finding.line, finding.code))
            for callee in scan.calls:
                short = callee.split(".")[-1]
                for target_name, target in index.defs.items():
                    if target_name == callee or target_name.split(".")[
                        -1
                    ] in (callee, short):
                        if id(target) not in seen:
                            frontier.append(target)

        # GL103: a program invoked where it is built, or built in a loop
        class _BuildUse(ast.NodeVisitor):
            def __init__(self) -> None:
                self.loops = 0
                self.out: list[tuple[ast.AST, str]] = []

            def visit_Call(self, node: ast.Call) -> None:
                if isinstance(node.func, ast.Call) and _is_program_call(
                    node.func.func
                ):
                    self.out.append(
                        (
                            node,
                            f"{_dotted(node.func.func)}(...) called where it "
                            "is built — one build per invocation",
                        )
                    )
                elif _is_program_call(node.func) and self.loops:
                    self.out.append(
                        (
                            node,
                            f"{_dotted(node.func)}(...) built inside a loop "
                            "— rebuilt every iteration",
                        )
                    )
                self.generic_visit(node)

            def _loop(self, node: ast.For | ast.While) -> None:
                self.loops += 1
                self.generic_visit(node)
                self.loops -= 1

            visit_For = _loop
            visit_While = _loop

        build_use = _BuildUse()
        build_use.visit(mod.tree)
        for node, msg in build_use.out:
            findings.append(mod.finding("GL103", node, msg))
        findings.extend(_ScalarTaintChecker(mod).run())
        return findings

    # ── pass 2: whole-run cross-module reachability ──────────────────────

    def _resolve_callee(
        self, rel_path: str, callee: str
    ) -> list[tuple[str, ast.AST]]:
        """Where ``callee`` (a dotted call string seen in ``rel_path``)
        might be defined ACROSS the run's modules: loose within the
        module, through import bindings only across modules."""
        out: list[tuple[str, ast.AST]] = []
        index = self._indexes.get(rel_path)
        imports = self._imports.get(rel_path)
        if index is None or imports is None:
            return out
        short = callee.split(".")[-1]
        for target_name, target in index.defs.items():
            if target_name == callee or target_name.split(".")[-1] in (
                callee, short,
            ):
                out.append((rel_path, target))
        head, _, rest = callee.partition(".")
        if rest:
            target_rel = self._dotted_to_rel.get(imports.aliases.get(head) or "")
            target_index = self._indexes.get(target_rel or "")
            if target_index is not None:
                node = target_index.defs.get(rest) or target_index.defs.get(
                    rest.split(".")[-1]
                )
                if node is not None:
                    out.append((target_rel, node))
        else:
            sym = imports.symbols.get(callee)
            if sym is not None:
                target_rel = self._dotted_to_rel.get(sym[0])
                target_index = self._indexes.get(target_rel or "")
                if target_index is not None:
                    node = target_index.defs.get(sym[1])
                    if node is not None:
                        out.append((target_rel, node))
        return out

    def finalize(self, run) -> Iterable[Finding]:
        """Re-walk every program root following calls THROUGH import
        bindings into other scanned modules (and onward). Effects land in
        the file that contains them; what pass 1 reported is folded."""
        self._dotted_to_rel = {_module_dotted(rel): rel for rel in self._indexes}
        findings: list[Finding] = []
        for root_rel, roots in self._roots.items():
            seen: set[tuple[str, int]] = set()
            frontier: list[tuple[str, ast.AST]] = [(root_rel, fn) for fn in roots]
            while frontier:
                fn_rel, fn_node = frontier.pop()
                if (fn_rel, id(fn_node)) in seen:
                    continue
                seen.add((fn_rel, id(fn_node)))
                self._reach(fn_rel, fn_node)
                scan = self._scan(fn_node)
                fn_mod = self._mods.get(fn_rel)
                if fn_mod is not None and fn_rel != root_rel:
                    for node, code, msg in scan.effects:
                        finding = fn_mod.finding(
                            code,
                            node,
                            f"{msg} (reachable in a program via a "
                            f"cross-module call from {root_rel})",
                        )
                        key = (finding.path, finding.line, finding.code)
                        if key in self._reported:
                            continue
                        self._reported.add(key)
                        findings.append(finding)
                for callee in scan.calls:
                    for hop in self._resolve_callee(fn_rel, callee):
                        if (hop[0], id(hop[1])) not in seen:
                            frontier.append(hop)
        return findings
