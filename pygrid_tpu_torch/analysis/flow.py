"""gridflow: interprocedural, flow-sensitive dataflow & taint analysis
over the whole-program graph.

PyGrid's value proposition is that private material — worker report and
diff payloads, model checkpoint bytes, ``request_key``/auth tokens —
stays private while flowing through a coordination plane that is now
wrapped in telemetry, flight dumps, SLO webhooks, and a wire protocol.
Every one of those is a potential exfiltration sink, and before this
module the redaction discipline was enforced by convention at exactly
one choke point (the flight recorder's key-based redactor). This engine
proves the discipline statically, FlowDroid/Pysa-style, riding the same
:class:`~pygrid_tpu_torch.analysis.graph.ProgramGraph` the GL2 concurrency
rules use (one build per run — the tier-1 perf guard covers it too).

Three analyses share the graph:

- **Taint** (:class:`FlowEngine`) — forward propagation from declared
  *sources* (``request.json``, credential-keyed subscripts/``.get``,
  credential-named parameters, checkpoint loads) through assignments,
  calls/returns (per-function summaries, fixed point over the call
  graph), f-strings/``%``/``.format``, container literals, and
  ``self._x`` attribute stores, into declared *sinks* (logging,
  telemetry events/labels, flight-recorder ``note()``, webhook/HTTP
  bodies, outbound wire frames, WS/HTTP responses, exception messages)
  unless a *sanitizer* (the recorder's :func:`redact`, length markers
  via ``len``, hashing, numeric casts) kills the flow. Every finding
  carries the full witness chain — source, each call hop, sink.
- **Resources** (:func:`resource_findings`) — acquire/release pairing
  for the paged-KV :class:`BlockPool`, sockets, temp files, and
  non-``with`` lock acquires: every path out of the acquiring function
  (returns, explicit raises, fall-through) must release, store, or
  hand off the resource; ``try/finally`` and the repo's cleanup idioms
  (``close``/``release``/``retire``/``free``/``unlink``) are
  recognized, and ``x is None`` guards refine the path (a failed alloc
  is not a leak).
- **Exception escape** (:class:`ExceptionFlow`) — whole-program
  reachability of untyped raises: a ``raise ValueError`` (or any
  non-``PyGridError`` class) reachable from a route/WS handler entry
  point with no intervening catch on the call chain escapes the
  protocol boundary as an untyped 500. Catch coverage is computed per
  call site and per raise site from the enclosing ``try`` blocks
  (``except Exception`` covers everything; named handlers cover the
  name, its written bases, and the builtin hierarchy).

The GL6 checker family (``checkers/gl6_flow.py``) turns these into
GL601–GL604; ``--explain GL601`` prints the witness chains.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterable

from pygrid_tpu_torch.analysis.graph import FunctionNode, ProgramGraph, dotted

#: fixed-point passes over the whole program — summaries are monotone
#: and settle in 2–3 passes on this repo; the cap is a safety net
_MAX_PASSES = 5

#: witness chains are capped so cyclic call graphs cannot grow them
_MAX_CHAIN = 16

# ── the declared source/sink/sanitizer surface ───────────────────────────

#: lowercase substrings marking a mapping KEY as credential-bearing.
#: Kept in lockstep with ``telemetry/recorder.py``'s ``_REDACT_KEYS``
#: (asserted by test_gridflow) — the redactor and the static analysis
#: must agree on what "credential-like" means.
CREDENTIAL_KEYS = (
    "token", "password", "secret", "request_key", "authorization",
    "auth", "jwt", "api_key", "private_key",
)

#: parameter names that ARE credentials wherever they appear — the
#: auth material this repo threads by name through worker/cycle code
CREDENTIAL_PARAMS = {
    "request_key", "auth_token", "api_key", "password", "jwt",
}

#: EXACT mapping keys whose values are model-scale private payloads
#: (worker reports/diffs, checkpoint blobs, dataset tensors)
PAYLOAD_KEYS = {
    "data", "diff", "diffs", "report", "params", "tensors",
    "checkpoint", "weights", "model_bytes",
}

#: callables whose RESULT is checkpoint/model bytes
CHECKPOINT_CALLS = {
    "load_encoded", "serialize_model_params", "serialize_plan",
}

#: receivers whose ``.json`` read is the request payload
REQUESTISH = {"request", "req", "message", "msg", "payload", "body"}

#: sanitizer callables: the value that comes out carries no private
#: content (redaction, length markers, hashes, numeric casts)
SANITIZER_NAMES = {
    "redact", "len", "int", "float", "bool", "hash", "abs", "round",
    "id", "type", "ord",
}
#: dotted heads whose whole namespace sanitizes (hashlib.sha256(x))
SANITIZER_MODULES = {"hashlib", "hmac"}

#: method names on UNRESOLVED receivers whose result derives from the
#: arguments (string formatting, codecs) — everything else unknown
#: keeps only the receiver's taint, so "the response of a call that
#: took a credential argument" does not become a credential
ARG_PROPAGATOR_METHODS = {
    "format", "join", "replace", "encode", "decode", "extend", "append",
    "update", "setdefault", "write", "writelines", "union", "fromhex",
}
#: bare builtins whose result derives from the arguments
ARG_PROPAGATOR_NAMES = {
    "str", "bytes", "bytearray", "repr", "list", "tuple", "set", "dict",
    "sorted", "reversed", "map", "filter", "zip", "enumerate", "next",
    "iter", "min", "max", "sum", "format", "vars", "print",
}
#: dotted heads whose namespace transforms-but-keeps content
ARG_PROPAGATOR_MODULES = {
    "json", "msgpack", "base64", "binascii", "pickle", "copy",
    "np", "numpy", "torch",
}

_LOG_RECEIVERS = {"logger", "logging", "log"}
_LOG_METHODS = {
    "debug", "info", "warning", "warn", "error", "exception", "critical",
}
_BUS_RECEIVERS = {"telemetry", "bus", "BUS"}
_BUS_METHODS = {"incr", "observe", "record"}
_WS_SEND = {"send_str", "send_bytes", "send_json", "sendall"}
_HTTP_OUT = {"post", "put", "patch", "request"}

#: tags the GL601 privacy rule considers sensitive (credential flows
#: are GL602's everywhere, so they are classified there)
SENSITIVE_TAGS = {"payload", "checkpoint", "credential"}


@dataclass(frozen=True)
class Taint:
    """One tracked fact about a value: either a concrete source taint
    (``tag`` set — payload/credential/checkpoint) or a symbolic
    parameter taint (``param`` set) used to build function summaries.
    ``chain`` is the witness: human-readable steps from the origin."""

    tag: str | None
    origin: str
    chain: tuple = ()
    param: str | None = None

    @property
    def key(self) -> tuple:
        return (self.tag, self.param, self.origin)

    def extend(self, step: str) -> "Taint":
        if len(self.chain) >= _MAX_CHAIN:
            return self
        return Taint(self.tag, self.origin, self.chain + (step,), self.param)


#: env/taint-set representation: {taint.key: Taint} — one witness per
#: distinct (tag/param, origin), so sets stay small and monotone
TaintSet = dict


def _merge(*sets: TaintSet) -> TaintSet:
    out: TaintSet = {}
    for s in sets:
        for k, t in s.items():
            out.setdefault(k, t)
    return out


@dataclass(frozen=True)
class SinkSpec:
    kind: str  # logging | metric | note | http_out | wire | response
    category: str  # "obs" (observability) | "egress"
    desc: str


@dataclass
class SinkFlow:
    """Summary entry: this function passes ``param`` into a sink (its
    own, or transitively through a callee)."""

    param: str
    sink: SinkSpec
    site: tuple  # (rel_path, line) — dedupe/site identity
    node: ast.AST
    rel_path: str
    chain: tuple  # steps from the param to the sink


@dataclass
class FlowHit:
    """A concrete source→sink flow (a GL601/GL602 finding candidate)."""

    tag: str
    origin: str
    sink: SinkSpec
    node: ast.AST
    rel_path: str
    chain: tuple

    @property
    def site(self) -> tuple:
        return (self.rel_path, getattr(self.node, "lineno", 0))


@dataclass
class Summary:
    """One function's interprocedural surface, grown monotonically to a
    fixed point."""

    param_to_return: set = field(default_factory=set)
    #: tag -> Taint introduced inside that reaches the return value
    source_returns: dict = field(default_factory=dict)
    #: (param, sink site, kind) -> SinkFlow
    param_sinks: dict = field(default_factory=dict)
    #: param -> {((rel, class), attr)} — fields the param is stored to
    #: (``self._x = param``); callers replay their concrete taints onto
    #: the class-attr map (field-sensitive param summaries)
    param_to_fields: dict = field(default_factory=dict)

    def shape(self) -> tuple:
        return (
            frozenset(self.param_to_return),
            frozenset(self.source_returns),
            frozenset(self.param_sinks),
            frozenset(
                (p, f)
                for p, fields in self.param_to_fields.items()
                for f in fields
            ),
        )


def _fn_loc(fn: FunctionNode) -> str:
    return f"{fn.rel_path}:{getattr(fn.node, 'lineno', 0)}"


def _params_of(fn: FunctionNode) -> list[str]:
    args = fn.node.args
    names = [
        a.arg
        for a in (
            list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        )
    ]
    return names


def _is_credential_key(key: str) -> bool:
    low = key.lower()
    return any(m in low for m in CREDENTIAL_KEYS)


# ── the per-function taint interpreter ───────────────────────────────────


class _FnFlow:
    """One statement-ordered pass over one function body, against the
    current summaries. Flow-sensitive for locals, flow-insensitive for
    ``self._x`` attribute stores (class-attr taint map shared across
    methods)."""

    def __init__(self, engine: "FlowEngine", fn: FunctionNode) -> None:
        self.engine = engine
        self.graph = engine.graph
        self.fn = fn
        self.summary = Summary()
        self.hits: list[FlowHit] = []
        params = _params_of(fn)
        self.params = set(params)
        self.env: dict[str, TaintSet] = {}
        for p in params:
            t = Taint(None, f"parameter '{p}' of {fn.pretty}", param=p)
            self.env[p] = {t.key: t}
            if p in CREDENTIAL_PARAMS:
                s = Taint(
                    "credential",
                    f"credential parameter '{p}' of {fn.pretty}",
                )
                self.env[p][s.key] = s

    # ── driving ─────────────────────────────────────────────────────────

    def run(self) -> None:
        body = getattr(self.fn.node, "body", [])
        # two passes over the body: loop-carried and later-defined
        # taint (a helper assigned below its use site) settles on the
        # second — cheap, and enough for lint-grade precision
        self._exec(body)
        self._exec(body)

    def _exec(self, stmts: list) -> None:
        for stmt in stmts:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs are their own FunctionNodes
        if isinstance(stmt, ast.Assign):
            taints = self._eval(stmt.value)
            for target in stmt.targets:
                self._bind(target, taints)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._bind(stmt.target, self._eval(stmt.value))
        elif isinstance(stmt, ast.AugAssign):
            taints = self._eval(stmt.value)
            if isinstance(stmt.target, ast.Name):
                self.env[stmt.target.id] = _merge(
                    self.env.get(stmt.target.id, {}), taints
                )
            else:
                self._bind(stmt.target, taints)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._record_return(self._eval(stmt.value))
        elif isinstance(stmt, ast.Raise):
            self._raise_sink(stmt)
        elif isinstance(stmt, ast.Expr):
            self._eval(stmt.value)
        elif isinstance(stmt, (ast.If,)):
            self._eval(stmt.test)
            self._exec(stmt.body)
            self._exec(stmt.orelse)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            iter_taints = self._eval(stmt.iter)
            self._bind(stmt.target, iter_taints)
            self._exec(stmt.body)
            self._exec(stmt.orelse)
        elif isinstance(stmt, ast.While):
            self._eval(stmt.test)
            self._exec(stmt.body)
            self._exec(stmt.orelse)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                t = self._eval(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, t)
            self._exec(stmt.body)
        elif isinstance(stmt, ast.Try):
            self._exec(stmt.body)
            for handler in stmt.handlers:
                self._exec(handler.body)
            self._exec(stmt.orelse)
            self._exec(stmt.finalbody)
        elif isinstance(stmt, (ast.Delete, ast.Assert)):
            pass
        # remaining statement kinds carry no dataflow we model

    def _bind(self, target: ast.AST, taints: TaintSet) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = dict(taints)
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind(el, taints)  # container-insensitive
            return
        if isinstance(target, ast.Starred):
            self._bind(target.value, taints)
            return
        if isinstance(target, ast.Subscript):
            # d[k] = tainted taints the container name too
            if isinstance(target.value, ast.Name):
                self.env[target.value.id] = _merge(
                    self.env.get(target.value.id, {}), taints
                )
            elif isinstance(target.value, ast.Attribute):
                self._store_attr(target.value, taints)
            return
        if isinstance(target, ast.Attribute):
            self._store_attr(target, taints)

    def _store_attr(self, target: ast.Attribute, taints: TaintSet) -> None:
        """``self._x = tainted``: record on the class-attr map so every
        method's reads observe it (flow-insensitive field taint).
        Symbolic param taints become ``param_to_fields`` summary entries
        — each caller replays its own concrete argument taints onto the
        field (field-sensitive param summaries)."""
        if not (
            isinstance(target.value, ast.Name)
            and target.value.id in ("self", "cls")
            and self.fn.class_name is not None
        ):
            return
        key = ((self.fn.rel_path, self.fn.class_name), target.attr)
        for t in taints.values():
            if t.param is not None:
                self.summary.param_to_fields.setdefault(
                    t.param, set()
                ).add(key)
        concrete = {
            k: t.extend(
                f"stored to self.{target.attr} in {self.fn.pretty}"
            )
            for k, t in taints.items()
            if t.tag is not None
        }
        if not concrete:
            return
        store = self.engine.attr_taints.setdefault(key, {})
        before = len(store)
        for k, t in concrete.items():
            store.setdefault(k, t)
        if len(store) != before:
            self.engine.attrs_changed = True

    def _record_return(self, taints: TaintSet) -> None:
        for t in taints.values():
            if t.param is not None:
                self.summary.param_to_return.add(t.param)
            elif t.tag is not None:
                self.summary.source_returns.setdefault(
                    t.key,
                    t.extend(f"returned by {self.fn.pretty}"),
                )

    # ── expression evaluation ───────────────────────────────────────────

    def _eval(self, expr: ast.AST) -> TaintSet:
        if isinstance(expr, ast.Name):
            return self.env.get(expr.id, {})
        if isinstance(expr, ast.Await):
            return self._eval(expr.value)
        if isinstance(expr, ast.Call):
            return self._call(expr)
        if isinstance(expr, ast.Attribute):
            return self._attribute(expr)
        if isinstance(expr, ast.Subscript):
            return self._subscript(expr)
        if isinstance(expr, ast.BinOp):
            return _merge(self._eval(expr.left), self._eval(expr.right))
        if isinstance(expr, ast.JoinedStr):
            out: TaintSet = {}
            for v in expr.values:
                if isinstance(v, ast.FormattedValue):
                    out = _merge(out, self._eval(v.value))
            return out
        if isinstance(expr, ast.FormattedValue):
            return self._eval(expr.value)
        if isinstance(expr, (ast.List, ast.Tuple, ast.Set)):
            out = {}
            for el in expr.elts:
                out = _merge(out, self._eval(el))
            return out
        if isinstance(expr, ast.Dict):
            out = {}
            for k, v in zip(expr.keys, expr.values):
                if k is not None:
                    out = _merge(out, self._eval(k))
                out = _merge(out, self._eval(v))
            return out
        if isinstance(expr, ast.IfExp):
            self._eval(expr.test)
            return _merge(self._eval(expr.body), self._eval(expr.orelse))
        if isinstance(expr, ast.BoolOp):
            out = {}
            for v in expr.values:
                out = _merge(out, self._eval(v))
            return out
        if isinstance(expr, ast.Compare):
            self._eval(expr.left)
            for c in expr.comparators:
                self._eval(c)
            return {}  # a bool comparison result carries no content
        if isinstance(expr, ast.UnaryOp):
            inner = self._eval(expr.operand)
            return {} if isinstance(expr.op, ast.Not) else inner
        if isinstance(expr, ast.Starred):
            return self._eval(expr.value)
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            for gen in expr.generators:
                self._bind(gen.target, self._eval(gen.iter))
            return self._eval(expr.elt)
        if isinstance(expr, ast.DictComp):
            for gen in expr.generators:
                self._bind(gen.target, self._eval(gen.iter))
            return _merge(self._eval(expr.key), self._eval(expr.value))
        if isinstance(expr, ast.NamedExpr):
            t = self._eval(expr.value)
            self._bind(expr.target, t)
            return t
        if isinstance(expr, ast.Slice):
            return {}
        return {}

    def _attribute(self, expr: ast.Attribute) -> TaintSet:
        # source: request.json (aiohttp's awaited read or a cached prop)
        if (
            expr.attr == "json"
            and isinstance(expr.value, ast.Name)
            and expr.value.id in REQUESTISH
        ):
            t = Taint(
                "payload",
                f"{expr.value.id}.json at "
                f"{self.fn.rel_path}:{expr.lineno}",
            )
            return {t.key: t}
        # self._x reads observe the class-attr taint map (via the MRO)
        if (
            isinstance(expr.value, ast.Name)
            and expr.value.id in ("self", "cls")
            and self.fn.class_name is not None
        ):
            out: TaintSet = {}
            for cls_key in self.graph.mro(
                (self.fn.rel_path, self.fn.class_name)
            ):
                stored = self.engine.attr_taints.get((cls_key, expr.attr))
                if stored:
                    out = _merge(out, stored)
            return out
        return self._eval(expr.value)

    def _subscript(self, expr: ast.Subscript) -> TaintSet:
        base = self._eval(expr.value)
        key = expr.slice
        if isinstance(key, ast.Constant) and isinstance(key.value, str):
            src = self._keyed_source(key.value, expr)
            if src is not None:
                return _merge(base, src)
        else:
            self._eval(key)
        return base

    def _keyed_source(self, key: str, node: ast.AST) -> TaintSet | None:
        loc = f"{self.fn.rel_path}:{getattr(node, 'lineno', 0)}"
        if _is_credential_key(key):
            t = Taint("credential", f"credential field {key!r} at {loc}")
            return {t.key: t}
        if key in PAYLOAD_KEYS:
            t = Taint("payload", f"payload field {key!r} at {loc}")
            return {t.key: t}
        return None

    # ── calls: sanitizers, sources, sinks, summaries ────────────────────

    def _call(self, call: ast.Call) -> TaintSet:
        d = dotted(call.func)
        tail = d.split(".")[-1] if d else None
        head = d.split(".")[0] if d else None

        arg_taints = [self._eval(a) for a in call.args]
        kw_taints = {
            (kw.arg or "**"): self._eval(kw.value) for kw in call.keywords
        }

        # ``.get("key", ...)`` keyed source on any receiver
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "get"
            and call.args
            and isinstance(call.args[0], ast.Constant)
            and isinstance(call.args[0].value, str)
        ):
            src = self._keyed_source(call.args[0].value, call)
            if src is not None:
                recv = self._eval(call.func.value)
                return _merge(recv, src)

        # request.json() spelled as a call
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "json"
            and isinstance(call.func.value, ast.Name)
            and call.func.value.id in REQUESTISH
        ):
            t = Taint(
                "payload",
                f"{call.func.value.id}.json() at "
                f"{self.fn.rel_path}:{call.lineno}",
            )
            return {t.key: t}

        # sanitizers kill the flow
        if tail in SANITIZER_NAMES or head in SANITIZER_MODULES:
            return {}

        # declared sinks observe the argument taints
        sink = self._sink_of(call, tail)
        if sink is not None:
            self._check_sink(call, sink, arg_taints, kw_taints)

        # checkpoint-bytes sources
        if tail in CHECKPOINT_CALLS:
            t = Taint(
                "checkpoint",
                f"{tail}() checkpoint bytes at "
                f"{self.fn.rel_path}:{call.lineno}",
            )
            return {t.key: t}

        # resolved callee: apply interprocedural summaries
        targets = ()
        if d is not None:
            targets = self.graph.resolve_call(
                self.fn.rel_path,
                self.fn.class_name,
                d,
                None,
            )
        if targets:
            return self._apply_summaries(call, d, targets, arg_taints,
                                         kw_taints)

        # unresolved call: a method on a tainted object derives from it
        # (receiver taint always flows); argument taint flows only
        # through known string/codec propagators — an unknown callee's
        # RESULT does not inherit its arguments' secrets
        out: TaintSet = {}
        args_flow = False
        if isinstance(call.func, ast.Attribute):
            out = _merge(out, self._eval(call.func.value))
            args_flow = call.func.attr in ARG_PROPAGATOR_METHODS
        elif isinstance(call.func, ast.Name):
            args_flow = call.func.id in ARG_PROPAGATOR_NAMES
        if head in ARG_PROPAGATOR_MODULES:
            args_flow = True
        if args_flow:
            for t in arg_taints:
                out = _merge(out, t)
            for t in kw_taints.values():
                out = _merge(out, t)
        return out

    def _apply_summaries(
        self,
        call: ast.Call,
        d: str,
        targets: tuple,
        arg_taints: list,
        kw_taints: dict,
    ) -> TaintSet:
        result: TaintSet = {}
        loc = f"{self.fn.rel_path}:{call.lineno}"
        for key in targets:
            callee = self.graph.functions.get(key)
            summary = self.engine.summaries.get(key)
            if callee is None or summary is None:
                continue
            params = _params_of(callee)
            # a method called through a receiver maps args after self
            offset = 0
            if (
                callee.class_name is not None
                and isinstance(call.func, ast.Attribute)
                and params
                and params[0] in ("self", "cls")
            ):
                offset = 1
            bound: list[tuple[str, TaintSet]] = []
            for i, taints in enumerate(arg_taints):
                idx = i + offset
                if idx < len(params):
                    bound.append((params[idx], taints))
            for name, taints in kw_taints.items():
                if name in params:
                    bound.append((name, taints))
            step = f"passed to {callee.pretty}() at {loc}"
            for pname, taints in bound:
                if not taints:
                    continue
                if pname in summary.param_to_return:
                    for t in taints.values():
                        e = t.extend(
                            f"through {callee.pretty}() at {loc}"
                        )
                        result.setdefault(e.key, e)
                for flow in summary.param_sinks.values():
                    if flow.param != pname:
                        continue
                    for t in taints.values():
                        if t.param is not None:
                            # transitive: OUR param reaches a sink
                            skey = (t.param, flow.site, flow.sink.kind)
                            self.summary.param_sinks.setdefault(
                                skey,
                                SinkFlow(
                                    param=t.param,
                                    sink=flow.sink,
                                    site=flow.site,
                                    node=flow.node,
                                    rel_path=flow.rel_path,
                                    chain=t.chain + (step,) + flow.chain,
                                ),
                            )
                        elif t.tag is not None:
                            self.hits.append(
                                FlowHit(
                                    tag=t.tag,
                                    origin=t.origin,
                                    sink=flow.sink,
                                    node=flow.node,
                                    rel_path=flow.rel_path,
                                    chain=t.chain + (step,) + flow.chain,
                                )
                            )
                for fkey in summary.param_to_fields.get(pname, ()):
                    # the callee stores this param to a field: replay
                    # OUR concrete taints onto the class-attr map, and
                    # carry symbolic ones up as our own field summary
                    for t in taints.values():
                        if t.param is not None:
                            self.summary.param_to_fields.setdefault(
                                t.param, set()
                            ).add(fkey)
                        elif t.tag is not None:
                            e = t.extend(
                                f"stored to {fkey[0][1]}.{fkey[1]} "
                                f"via {callee.pretty}() at {loc}"
                            )
                            store = self.engine.attr_taints.setdefault(
                                fkey, {}
                            )
                            if e.key not in store:
                                store[e.key] = e
                                self.engine.attrs_changed = True
            for t in summary.source_returns.values():
                e = t.extend(f"returned to {self.fn.pretty} at {loc}")
                result.setdefault(e.key, e)
        return result

    # ── sink recognition ────────────────────────────────────────────────

    def _sink_of(self, call: ast.Call, tail: str | None) -> SinkSpec | None:
        fn = call.func
        if isinstance(fn, ast.Attribute):
            recv = dotted(fn.value) or ""
            recv_tail = recv.split(".")[-1]
            if recv_tail in _LOG_RECEIVERS and fn.attr in _LOG_METHODS:
                return SinkSpec("logging", "obs", f"{recv}.{fn.attr}()")
            if recv_tail in _BUS_RECEIVERS and fn.attr in _BUS_METHODS:
                return SinkSpec(
                    "metric", "obs", f"telemetry {fn.attr}() label/field"
                )
            if fn.attr == "note":
                return SinkSpec(
                    "note", "obs", "flight-recorder note() field"
                )
            if recv_tail == "requests" and fn.attr in _HTTP_OUT:
                return SinkSpec(
                    "http_out", "obs", f"outbound HTTP {recv}.{fn.attr}()"
                )
            if fn.attr == "urlopen":
                return SinkSpec("http_out", "obs", "outbound urlopen()")
            if fn.attr in _WS_SEND:
                return SinkSpec(
                    "wire", "egress", f"outbound WS {fn.attr}()"
                )
            if fn.attr == "json_response":
                return SinkSpec(
                    "response", "egress", "HTTP json_response() body"
                )
        elif isinstance(fn, ast.Name):
            if fn.id in ("incr", "observe", "record"):
                return SinkSpec(
                    "metric", "obs", f"telemetry {fn.id}() label/field"
                )
            if fn.id == "json_response":
                return SinkSpec(
                    "response", "egress", "HTTP json_response() body"
                )
        if tail == "encode_frame":
            return SinkSpec("wire", "egress", "outbound wire frame")
        return None

    def _check_sink(
        self,
        call: ast.Call,
        sink: SinkSpec,
        arg_taints: list,
        kw_taints: dict,
    ) -> None:
        # the metric-family literal (arg 0 of incr/observe/record) is a
        # name, not a value — skip it
        args = arg_taints[1:] if sink.kind == "metric" else arg_taints
        flows: list[TaintSet] = list(args)
        for name, taints in kw_taints.items():
            if sink.kind == "note" and name != "**" and _is_credential_key(
                name
            ):
                # the dump-time key redactor covers this field — that
                # is precisely the sanctioned way to note a credential
                continue
            flows.append(taints)
        for taints in flows:
            for t in taints.values():
                self._observe_at_sink(t, sink, call)

    def _raise_sink(self, stmt: ast.Raise) -> None:
        if stmt.exc is None:
            return
        exc = stmt.exc
        sink = SinkSpec("exception", "egress", "exception message")
        if isinstance(exc, ast.Call):
            for a in exc.args:
                for t in self._eval(a).values():
                    self._observe_at_sink(t, sink, stmt)
            for kw in exc.keywords:
                for t in self._eval(kw.value).values():
                    self._observe_at_sink(t, sink, stmt)

    def _observe_at_sink(
        self, t: Taint, sink: SinkSpec, node: ast.AST
    ) -> None:
        site = (self.fn.rel_path, getattr(node, "lineno", 0))
        if t.param is not None:
            skey = (t.param, site, sink.kind)
            self.summary.param_sinks.setdefault(
                skey,
                SinkFlow(
                    param=t.param,
                    sink=sink,
                    site=site,
                    node=node,
                    rel_path=self.fn.rel_path,
                    chain=(
                        f"reaches {sink.desc} in {self.fn.pretty} at "
                        f"{self.fn.rel_path}:{getattr(node, 'lineno', 0)}",
                    ),
                ),
            )
        elif t.tag is not None:
            self.hits.append(
                FlowHit(
                    tag=t.tag,
                    origin=t.origin,
                    sink=sink,
                    node=node,
                    rel_path=self.fn.rel_path,
                    chain=t.chain
                    + (
                        f"reaches {sink.desc} in {self.fn.pretty} at "
                        f"{self.fn.rel_path}:{getattr(node, 'lineno', 0)}",
                    ),
                )
            )


# ── the engine: fixed point over the call graph ──────────────────────────


class FlowEngine:
    """Builds per-function taint summaries to a fixed point and collects
    concrete source→sink flows with witness chains."""

    def __init__(self, graph: ProgramGraph) -> None:
        self.graph = graph
        self.summaries: dict[tuple, Summary] = {
            key: Summary() for key in graph.functions
        }
        #: (class key, attr) -> TaintSet — the attribute-store channel
        self.attr_taints: dict[tuple, TaintSet] = {}
        self.attrs_changed = False
        self.hits: list[FlowHit] = []
        self._run()

    def _run(self) -> None:
        for _ in range(_MAX_PASSES):
            changed = False
            self.attrs_changed = False
            hits: list[FlowHit] = []
            for key, fn in self.graph.functions.items():
                ff = _FnFlow(self, fn)
                ff.run()
                if ff.summary.shape() != self.summaries[key].shape():
                    changed = True
                self.summaries[key] = ff.summary
                hits.extend(ff.hits)
            self.hits = hits
            if not changed and not self.attrs_changed:
                break
        # dedupe: ONE finding per (sink site, tag) — the shortest-chain
        # witness represents however many origins reach the line (the
        # fix is the same), so baseline counts stay stable as code
        # grows new callers
        seen: set[tuple] = set()
        unique: list[FlowHit] = []
        for h in sorted(
            self.hits, key=lambda h: (h.rel_path, h.site[1], len(h.chain))
        ):
            k = (h.site, h.tag)
            if k not in seen:
                seen.add(k)
                unique.append(h)
        self.hits = unique


# ── GL603: resource acquire/release pairing ──────────────────────────────


@dataclass
class _Resource:
    kind: str
    node: ast.AST
    names: tuple  # local names bound to it
    open: bool = True
    escaped: bool = False


_RELEASE_METHODS = {
    "release", "close", "retire", "free", "shutdown", "unlink",
    "remove", "replace", "_fail_all", "cleanup",
}


def _acquire_of(value: ast.AST) -> str | None:
    """The resource KIND if ``value`` is an acquire expression."""
    if not isinstance(value, ast.Call):
        return None
    d = dotted(value.func)
    if d is None:
        return None
    tail = d.split(".")[-1]
    recv = d.rsplit(".", 1)[0] if "." in d else ""
    if tail == "alloc" and "pool" in recv.lower():
        return "pool blocks"
    if d in ("socket.socket", "socket.create_connection"):
        return "socket"
    if d == "tempfile.mkstemp":
        return "temp file"
    if d == "tempfile.NamedTemporaryFile":
        for kw in value.keywords:
            if (
                kw.arg == "delete"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is False
            ):
                return "temp file"
        return None
    return None


class _ResourceWalk:
    """Intra-procedural path walk for acquire/release pairing. Exits
    modeled: returns, explicit raises, fall-through — and, when an
    :class:`ExceptionFlow` is supplied, IMPLICIT raises: a statement
    calling a resolved callee whose untyped-exception escape set is not
    covered by an enclosing ``try`` can blow through the frame, so an
    open unprotected resource leaks there too. Unresolvable callees err
    quiet rather than flooding."""

    def __init__(
        self, fn: FunctionNode, exc_flow: "ExceptionFlow | None" = None
    ) -> None:
        self.fn = fn
        self.exc_flow = exc_flow
        #: (lineno, col) -> resolved callee keys, from the graph's call
        #: edges — drives the implicit-raise check
        self._call_targets = {
            (c.node.lineno, c.node.col_offset): c.targets
            for c in fn.calls
        }
        self.findings: list[tuple[ast.AST, str, str]] = []  # node, kind, why
        self._counter = 0
        #: resource keys already reported — clones share keys, so a
        #: leak reported in one branch is never re-reported when the
        #: join's merge re-opens the resource for the OTHER path (one
        #: report per acquire keeps baseline allowances stable)
        self._reported: set[int] = set()

    # ── implicit exception propagation ──────────────────────────────────

    def _implicit_raise_via(self, stmt: ast.stmt) -> str | None:
        """A callee in ``stmt`` whose uncovered untyped escape can blow
        through this frame, or None. Catch coverage at the call site is
        the same enclosing-try model GL604 uses."""
        if self.exc_flow is None:
            return None
        graph = self.exc_flow.graph
        covers = self.exc_flow._covers.get(self.fn.key, {})
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            targets = self._call_targets.get(
                (node.lineno, node.col_offset)
            )
            if not targets:
                continue
            active = covers.get((node.lineno, node.col_offset), [])
            for target in targets:
                callee = graph.functions.get(target)
                if callee is None:
                    continue
                if callee.is_async and not self.fn.is_async:
                    continue  # only scheduled here, raises at the await
                for exc in self.exc_flow.escapes.get(target, ()):
                    if not self.exc_flow._covered(
                        exc, active, self.fn.rel_path
                    ):
                        return f"{callee.qualname}() (raises {exc})"
        return None

    def _implicit_leaks(
        self, stmt: ast.stmt, state: dict, protected: frozenset
    ) -> None:
        via = self._implicit_raise_via(stmt)
        if via is None:
            return
        for key, res in state.items():
            if res.open and not res.escaped and not (
                set(res.names) & protected
            ) and key not in self._reported:
                self._reported.add(key)
                self.findings.append(
                    (
                        res.node,
                        res.kind,
                        f"leaks when {via} propagates through this "
                        "frame (implicit exception path, no try/finally "
                        "release)",
                    )
                )
                res.open = False

    def run(self) -> list[tuple[ast.AST, str, str]]:
        state: dict[int, _Resource] = {}
        self._walk(getattr(self.fn.node, "body", []), state, frozenset())
        self._leaks(state, "falls off the end of the function")
        return self.findings

    # ── helpers ─────────────────────────────────────────────────────────

    def _leaks(self, state: dict, why: str) -> None:
        for key, res in state.items():
            if res.open and not res.escaped and key not in self._reported:
                self._reported.add(key)
                self.findings.append((res.node, res.kind, why))
                res.open = False

    def _names_in(self, expr: ast.AST) -> set[str]:
        return {
            n.id for n in ast.walk(expr) if isinstance(n, ast.Name)
        }

    def _release_names(self, stmts: list) -> set[str]:
        """Names released anywhere in ``stmts`` (a finally body): a
        shallow scan — finally is the cleanup idiom, it is small."""
        out: set[str] = set()
        for stmt in stmts:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    out |= self._release_in_call(node)
        return out

    def _release_in_call(self, call: ast.Call) -> set[str]:
        """Local names this call releases: ``name.close()`` /
        ``pool.release(name)`` / ``self._lock.release()`` /
        ``os.unlink(path)`` — the receiver (a name OR a dotted chain,
        matching the acquire spelling) and every name argument."""
        out: set[str] = set()
        if not isinstance(call.func, ast.Attribute):
            return out
        if call.func.attr not in _RELEASE_METHODS:
            return out
        recv = dotted(call.func.value)
        if recv is not None:
            out.add(recv)
        for a in call.args:
            if isinstance(a, ast.Name):
                out.add(a.id)
            elif isinstance(a, ast.Starred) and isinstance(
                a.value, ast.Name
            ):
                out.add(a.value.id)
        return out

    def _apply_release(self, state: dict, names: set[str]) -> None:
        for res in state.values():
            if res.open and any(n in names for n in res.names):
                res.open = False

    def _apply_escapes(self, state: dict, names: set[str]) -> None:
        for res in state.values():
            if res.open and any(n in names for n in res.names):
                res.escaped = True

    def _none_guard(self, test: ast.AST) -> tuple[str, bool] | None:
        """``x is None``/``not x`` → (name, True): x is ABSENT on the
        then-branch. ``x is not None``/``x`` → (name, False)."""
        if isinstance(test, ast.Compare) and isinstance(
            test.left, ast.Name
        ) and len(test.ops) == 1 and len(test.comparators) == 1:
            comp = test.comparators[0]
            if isinstance(comp, ast.Constant) and comp.value is None:
                if isinstance(test.ops[0], ast.Is):
                    return (test.left.id, True)
                if isinstance(test.ops[0], ast.IsNot):
                    return (test.left.id, False)
        if isinstance(test, ast.UnaryOp) and isinstance(
            test.op, ast.Not
        ) and isinstance(test.operand, ast.Name):
            return (test.operand.id, True)
        if isinstance(test, ast.Name):
            return (test.id, False)
        return None

    def _drop_name(self, state: dict, name: str) -> dict:
        out = {}
        for k, res in state.items():
            if name in res.names:
                continue  # the guard proved the acquire failed
            out[k] = res
        return out

    @staticmethod
    def _clone(state: dict) -> dict:
        return {
            k: _Resource(
                r.kind, r.node, r.names, r.open, r.escaped
            )
            for k, r in state.items()
        }

    def _merge_into(self, state: dict, branches: list[dict]) -> None:
        """After control-flow joins: a resource is closed/escaped only
        when EVERY branch that still tracks it agrees."""
        state.clear()
        all_keys: set[int] = set()
        for b in branches:
            all_keys |= set(b)
        for k in all_keys:
            versions = [b[k] for b in branches if k in b]
            state[k] = _Resource(
                versions[0].kind,
                versions[0].node,
                versions[0].names,
                open=any(v.open for v in versions),
                escaped=all(
                    v.escaped or not v.open for v in versions
                )
                and any(v.escaped for v in versions),
            )

    # ── the walk ────────────────────────────────────────────────────────

    def _walk(
        self, stmts: list, state: dict, protected: frozenset
    ) -> None:
        for stmt in stmts:
            self._stmt(stmt, state, protected)

    def _stmt(
        self, stmt: ast.stmt, state: dict, protected: frozenset
    ) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if isinstance(stmt, ast.Assign):
            kind = _acquire_of(stmt.value)
            names: tuple = ()
            target = stmt.targets[0] if len(stmt.targets) == 1 else None
            if isinstance(target, ast.Name):
                names = (target.id,)
            elif isinstance(target, ast.Tuple):
                names = tuple(
                    el.id for el in target.elts
                    if isinstance(el, ast.Name)
                )
            if kind is not None and names:
                # reassignment replaces the binding (the retry-alloc
                # idiom); the PREVIOUS resource was None or reported
                for res in state.values():
                    if res.open and set(res.names) & set(names):
                        res.open = False
                self._counter += 1
                state[self._counter] = _Resource(kind, stmt.value, names)
                return
            # a plain assignment whose RHS mentions a resource name
            # transfers ownership (``row.pages = shared + priv``)
            self._apply_escapes(state, self._names_in(stmt.value))
            # rebinding a tracked name to something else drops it
            if isinstance(target, ast.Name):
                for res in state.values():
                    if res.open and target.id in res.names and (
                        len(res.names) == 1
                    ):
                        res.escaped = True  # err quiet: aliased away
            self._implicit_leaks(stmt, state, protected)
            return
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            released = self._release_in_call(call)
            if released:
                self._apply_release(state, released)
                return
            # non-release call consuming the resource = handoff
            names: set[str] = set()
            for a in list(call.args) + [kw.value for kw in call.keywords]:
                names |= self._names_in(a)
            self._apply_escapes(state, names)
            self._implicit_leaks(stmt, state, protected)
            # bare ``x.acquire()`` statement: a non-with lock acquire
            d = dotted(call.func)
            if (
                d is not None
                and d.endswith(".acquire")
                and "lock" in d.lower()
            ):
                self._counter += 1
                state[self._counter] = _Resource(
                    "lock (non-with acquire)",
                    call,
                    (d.rsplit(".", 1)[0],),
                )
            return
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                # ``return sock`` / ``return (fd, path)`` / ``return
                # wrap(priv)`` transfer ownership; ``return sock.recv()``
                # USES the resource without transferring it — only
                # top-level names and call ARGUMENTS escape, receivers
                # do not
                escaped: set[str] = set()
                top = stmt.value
                for el in (
                    top.elts if isinstance(top, (ast.Tuple, ast.List))
                    else [top]
                ):
                    if isinstance(el, ast.Name):
                        escaped.add(el.id)
                for node in ast.walk(stmt.value):
                    if isinstance(node, ast.Call):
                        for a in list(node.args) + [
                            kw.value for kw in node.keywords
                        ]:
                            escaped |= self._names_in(a)
                self._apply_escapes(state, escaped)
            self._leaks(state, "leaks on this return path")
            return
        if isinstance(stmt, ast.Raise):
            for key, res in state.items():
                if res.open and not res.escaped and not (
                    set(res.names) & protected
                ) and key not in self._reported:
                    self._reported.add(key)
                    self.findings.append(
                        (
                            res.node,
                            res.kind,
                            "leaks on the exception path (raise with no "
                            "try/finally release)",
                        )
                    )
                    res.open = False
            return
        if isinstance(stmt, ast.If):
            guard = self._none_guard(stmt.test)
            then_state = self._clone(state)
            else_state = self._clone(state)
            if guard is not None:
                name, absent_on_then = guard
                if absent_on_then:
                    then_state = self._drop_name(then_state, name)
                else:
                    else_state = self._drop_name(else_state, name)
            self._walk(stmt.body, then_state, protected)
            self._walk(stmt.orelse, else_state, protected)
            self._merge_into(state, [then_state, else_state])
            return
        if isinstance(stmt, ast.Try):
            finally_released = frozenset(
                self._release_names(stmt.finalbody)
            )
            inner = protected | finally_released
            self._walk(stmt.body, state, inner)
            branches = [state]
            for handler in stmt.handlers:
                h_state = self._clone(state)
                self._walk(handler.body, h_state, inner)
                branches.append(h_state)
            self._merge_into(state, branches)
            self._walk(stmt.orelse, state, protected)
            self._walk(stmt.finalbody, state, protected)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            body_state = self._clone(state)
            self._walk(stmt.body, body_state, protected)
            self._walk(stmt.orelse, body_state, protected)
            self._merge_into(state, [state, body_state])
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            self._walk(stmt.body, state, protected)
            return
        # anything else: expressions inside may consume names
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                names: set[str] = set()
                for a in list(node.args) + [
                    kw.value for kw in node.keywords
                ]:
                    names |= self._names_in(a)
                self._apply_escapes(state, names)


def resource_findings(
    graph: ProgramGraph,
    exception_flow: "ExceptionFlow | None" = None,
) -> Iterable[tuple[FunctionNode, ast.AST, str, str]]:
    """GL603 raw findings: ``(fn, node, kind, why)`` per unbalanced
    acquire. With ``exception_flow``, implicit raises out of resolved
    callees are modeled as exits too."""
    for fn in graph.functions.values():
        # cheap pre-filter: only walk bodies that acquire at all
        has_acquire = False
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call) and (
                _acquire_of(node) is not None
                or (
                    (d := dotted(node.func)) is not None
                    and d.endswith(".acquire")
                    and "lock" in d.lower()
                )
            ):
                has_acquire = True
                break
        if not has_acquire:
            continue
        for node, kind, why in _ResourceWalk(fn, exception_flow).run():
            yield fn, node, kind, why


# ── GL604: whole-program untyped-exception escape ────────────────────────

#: builtin exception classes an untyped raise may spell
BUILTIN_ERRORS = {
    "ValueError", "KeyError", "TypeError", "RuntimeError",
    "IndexError", "OverflowError", "ZeroDivisionError",
}

#: builtin hierarchy for catch matching (child -> parents)
_BUILTIN_PARENTS = {
    "KeyError": ("LookupError",),
    "IndexError": ("LookupError",),
    "ZeroDivisionError": ("ArithmeticError",),
    "OverflowError": ("ArithmeticError",),
}

_CATCH_ALL = {"Exception", "BaseException"}


def _handler_names(handler: ast.ExceptHandler) -> set[str] | None:
    """Caught class names; None = bare ``except:`` (catches all)."""
    if handler.type is None:
        return None
    out: set[str] = set()
    types = (
        handler.type.elts
        if isinstance(handler.type, ast.Tuple)
        else [handler.type]
    )
    for t in types:
        d = dotted(t)
        if d is not None:
            out.add(d.split(".")[-1])
    return out


@dataclass
class _Escape:
    exc: str
    node: ast.AST
    rel_path: str
    chain: tuple


class ExceptionFlow:
    """Escape sets per function: which untyped exception classes an
    explicit ``raise`` lets out, with catch coverage computed per raise
    site and per call site from the enclosing ``try`` blocks."""

    def __init__(self, graph: ProgramGraph) -> None:
        self.graph = graph
        #: fn key -> {exc name: _Escape}
        self.escapes: dict[tuple, dict[str, _Escape]] = {}
        self._covers: dict[tuple, dict[tuple, list]] = {}
        self._raises: dict[tuple, list] = {}
        self._prescan()
        self._fixpoint()

    # ── structure scan: catch coverage at every raise/call site ────────

    def _prescan(self) -> None:
        for key, fn in self.graph.functions.items():
            raises: list = []
            covers: dict[tuple, list] = {}

            def visit(stmts, active, fn=fn, raises=raises, covers=covers):
                for stmt in stmts:
                    if isinstance(
                        stmt, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        continue
                    if isinstance(stmt, ast.Raise):
                        exc = self._raised_class(fn, stmt)
                        if exc is not None:
                            raises.append((exc, stmt, list(active)))
                    for node in self._shallow_calls(stmt):
                        covers[
                            (node.lineno, node.col_offset)
                        ] = list(active)
                    if isinstance(stmt, ast.Try):
                        handler_sets = [
                            _handler_names(h) for h in stmt.handlers
                        ]
                        visit(stmt.body, active + [handler_sets])
                        for h in stmt.handlers:
                            visit(h.body, active)
                        visit(stmt.orelse, active)
                        visit(stmt.finalbody, active)
                    else:
                        for child in self._child_blocks(stmt):
                            visit(child, active)

            visit(getattr(fn.node, "body", []), [])
            self._raises[key] = raises
            self._covers[key] = covers

    @staticmethod
    def _child_blocks(stmt: ast.stmt):
        for name in ("body", "orelse", "finalbody"):
            block = getattr(stmt, name, None)
            if isinstance(block, list) and block and isinstance(
                block[0], ast.stmt
            ):
                yield block

    @staticmethod
    def _shallow_calls(stmt: ast.stmt):
        """Calls in ``stmt``'s own expressions — not in nested statement
        blocks (those get their own, deeper, coverage context) and not
        in nested defs."""
        nested: set = set()
        for name in ("body", "orelse", "finalbody", "handlers"):
            block = getattr(stmt, name, None)
            if isinstance(block, list):
                for sub in block:
                    if isinstance(sub, ast.AST):
                        nested.add(sub)
        stack = [
            c
            for c in ast.iter_child_nodes(stmt)
            if c not in nested
        ]
        while stack:
            node = stack.pop()
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if isinstance(node, ast.Call):
                yield node
            stack.extend(ast.iter_child_nodes(node))

    def _raised_class(
        self, fn: FunctionNode, stmt: ast.Raise
    ) -> str | None:
        """The raised class name when it is UNTYPED (a builtin error or
        a parsed class that does not inherit ``PyGridError``)."""
        exc = stmt.exc
        if exc is None:
            return None  # bare re-raise: the original catch governs
        name = None
        if isinstance(exc, ast.Call):
            name = dotted(exc.func)
        else:
            name = dotted(exc)
        if name is None:
            return None
        short = name.split(".")[-1]
        cls_key = self.graph.resolve_class(fn.rel_path, name)
        if cls_key is None and "." in name:
            cls_key = self.graph.resolve_class(fn.rel_path, short)
        if cls_key is not None:
            if self.graph.is_subclass_of(cls_key, "PyGridError"):
                return None
            return short
        if short in BUILTIN_ERRORS:
            return short
        return None  # unresolvable: err quiet, not wrong

    # ── catch matching ─────────────────────────────────────────────────

    def _covered(
        self, exc: str, active: list, rel: str
    ) -> bool:
        """Does any enclosing try's handler set catch ``exc``?"""
        for handler_sets in active:
            for names in handler_sets:
                if names is None:
                    return True  # bare except
                if names & _CATCH_ALL:
                    return True
                if exc in names:
                    return True
                for parent in _BUILTIN_PARENTS.get(exc, ()):
                    if parent in names:
                        return True
                cls_key = self.graph.resolve_class(rel, exc)
                if cls_key is not None:
                    for base in self.graph.mro(cls_key):
                        if base[1] in names:
                            return True
        return False

    # ── escape propagation ─────────────────────────────────────────────

    def _fixpoint(self) -> None:
        for key in self.graph.functions:
            self.escapes[key] = {}
        for _ in range(_MAX_PASSES * 2):
            changed = False
            for key, fn in self.graph.functions.items():
                out = self.escapes[key]
                for exc, node, active in self._raises[key]:
                    if exc in out:
                        continue
                    if not self._covered(exc, active, fn.rel_path):
                        out[exc] = _Escape(
                            exc,
                            node,
                            fn.rel_path,
                            (
                                f"raise {exc} in {fn.pretty} at "
                                f"{fn.rel_path}:{node.lineno}",
                            ),
                        )
                        changed = True
                for call in fn.calls:
                    active = self._covers.get(key, {}).get(
                        (call.node.lineno, call.node.col_offset)
                    )
                    if active is None:
                        continue
                    for target in call.targets:
                        callee = self.graph.functions.get(target)
                        if callee is None:
                            continue
                        if callee.is_async and not fn.is_async:
                            # calling an async def from sync code only
                            # schedules it — its raises surface at the
                            # await, not on this stack
                            continue
                        for exc, esc in self.escapes.get(
                            target, {}
                        ).items():
                            if exc in out:
                                continue
                            if self._covered(exc, active, fn.rel_path):
                                continue
                            step = (
                                f"called from {fn.pretty} at "
                                f"{fn.rel_path}:{call.node.lineno}"
                            )
                            out[exc] = _Escape(
                                exc,
                                esc.node,
                                esc.rel_path,
                                esc.chain + (step,),
                            )
                            changed = True
            if not changed:
                break


def boundary_entry_points(graph: ProgramGraph) -> dict[tuple, str]:
    """Protocol-boundary entry functions: HTTP handlers registered via
    ``r.add_*`` in the route modules, and WS handlers dispatched
    through a ``ROUTES`` table. Returns ``{fn key: description}``."""
    import fnmatch

    patterns = (
        "*/node/routes.py", "*/network/routes.py", "*/node/events.py",
        "*/node/ws.py", "*/network/ws.py", "*/users/events.py",
        "*/users/routes.py",
    )
    add_methods = {
        "add_get", "add_post", "add_put", "add_delete", "add_patch",
        "add_head", "add_route",
    }
    out: dict[tuple, str] = {}
    for rel, syms in graph.modules.items():
        if not any(fnmatch.fnmatch(rel, p) for p in patterns):
            continue
        for node in ast.walk(syms.tree):
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ) and node.func.attr in add_methods:
                idx = 1 if node.func.attr == "add_route" else 0
                args = node.args[idx + 1:idx + 2]
                for arg in args:
                    # wrapped registrations — ``add_post("/x",
                    # _ws_twin(EVENT))`` — enter through the factory
                    if isinstance(arg, ast.Call):
                        arg = arg.func
                    d = dotted(arg)
                    if d is None:
                        continue
                    hits = graph.resolve_call(rel, None, d, None)
                    for hit in hits:
                        out.setdefault(hit, f"HTTP route handler ({rel})")
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                # every dispatch table in a handler module is an entry
                # surface: ROUTES itself AND the *_HANDLERS dicts that
                # get **-merged into it (the merge spells key=None in
                # the AST, so the source dict must be collected where
                # it is defined — users/events.py's USER_HANDLERS)
                named_routes = any(
                    isinstance(t, ast.Name)
                    and (t.id == "ROUTES" or "HANDLERS" in t.id)
                    for t in targets
                )
                if named_routes and isinstance(node.value, ast.Dict):
                    for v in node.value.values:
                        # factory-built handlers (``_user_op(lambda…)``)
                        # dispatch through a closure static analysis
                        # cannot index — the FACTORY body is the
                        # reachable raising surface, so it enters
                        if isinstance(v, ast.Call):
                            v = v.func
                        d = dotted(v)
                        if d is None:
                            continue
                        hits = graph.resolve_call(rel, None, d, None)
                        for hit in hits:
                            out.setdefault(
                                hit, f"WS event handler ({rel})"
                            )
    # explicit annotations: any module (not just the pattern-listed
    # route modules) may declare a module-level GRIDLINT_ENTRY_POINTS
    # tuple/list of function names — protocol boundaries the heuristics
    # can't see, like the sub-aggregator's raw-WS server. Names are
    # either qualnames in the same module ("Cls.method", "fn") or
    # call-style dotted names resolved through the graph.
    for rel, syms in graph.modules.items():
        for stmt in syms.tree.body:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, ast.AnnAssign):
                targets = [stmt.target]
            if not any(
                isinstance(t, ast.Name) and t.id == "GRIDLINT_ENTRY_POINTS"
                for t in targets
            ):
                continue
            value = stmt.value
            if not isinstance(value, (ast.Tuple, ast.List)):
                continue
            for elt in value.elts:
                if not (
                    isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)
                ):
                    continue
                name = elt.value
                hits = []
                if (rel, name) in graph.functions:
                    hits = [(rel, name)]
                else:
                    hits = graph.resolve_call(rel, None, name, None)
                for hit in hits:
                    out.setdefault(hit, f"annotated entry point ({rel})")
    return out
