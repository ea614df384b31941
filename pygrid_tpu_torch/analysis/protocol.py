"""Wire & lifecycle protocol model extraction (gridproto, GL7).

Both halves of every grid conversation live in this repo: clients,
workers, sub-aggregators and the storm loadgen *send* WS events; the
node, network and sub-aggregator apps *register handlers* for them.
The contract between the two sides — which events exist, which payload
keys each side writes/reads, which frames are legal under which
subprotocol negotiation, and which lifecycle transitions the cycle
machinery performs — is pure convention. This module extracts that
convention from the ProgramGraph as a :class:`ProtocolModel`;
``checkers/gl7_proto.py`` checks it against itself (sender↔handler,
producer↔consumer) and against the committed machine-readable spec
``docs/wire_protocol.yaml``.

Extraction is deliberately conservative: anything it cannot resolve
(an event passed as a wrapper parameter, a payload forwarded whole to
an unresolvable callee, a ``**spread`` of a non-literal dict) is marked
OPEN rather than guessed, and the checker only fires on CLOSED facts.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from pygrid_tpu_torch.analysis.graph import ProgramGraph, dotted

#: envelope-level keys the transport itself owns (``GridWSClient
#: ._request`` / ``node/events.route_requests``) — never payload keys,
#: excluded symmetrically from producer and consumer key sets
ENVELOPE_KEYS = {"type", "request_id", "data", "trace"}

#: parameter names that mean "this is the decoded event payload" — the
#: repo-wide handler convention (node handlers take ``message``, secagg
#: / user-op lambdas take ``d``, subagg handlers take ``data``)
PAYLOAD_PARAM_NAMES = {"message", "msg", "data", "d", "payload", "body"}

#: client-side transport methods whose first argument is the event
SEND_METHODS = {
    "send_json",
    "send_msg_binary",
    "send_json_spliced",
    "_send_event",
    "_send",
}

#: transport-internal kwargs of the send methods — not payload keys
_TRANSPORT_KWARGS = {"raw_key", "raw_value", "timeout"}

#: builtins through which a payload var may pass without "escaping" the
#: key analysis (they cannot read event keys)
_BENIGN_CALLEES = {
    "len", "isinstance", "str", "bytes", "bool", "int", "float",
    "list", "tuple", "set", "dict", "sorted", "repr", "type", "id",
}

#: dict-warehouse receiver attrs that anchor a lifecycle machine —
#: ``self._cycles.register(is_completed=False)`` opens, a ``modify``
#: whose UPDATE dict (second positional arg, never the filter) sets
#: ``is_completed=True`` completes
_LIFECYCLE_ATTR = "cycles"


def _is_event_class(name: str) -> bool:
    """Classes whose string constants name wire events (``utils/codes``
    idiom) — the reverse value→constant map for the literal-spelling
    rule is restricted to these."""
    return name == "REQUEST_MSG" or name.endswith("_EVENTS")


@dataclass
class KeySet:
    """Payload keys one side of a conversation writes or reads."""

    required: set = field(default_factory=set)
    optional: set = field(default_factory=set)  # producer: conditional
    #: reads with a ``.get`` default — absence is tolerated
    defaulted: set = field(default_factory=set)
    open: bool = False
    open_why: str = ""

    def mark_open(self, why: str) -> None:
        if not self.open:
            self.open = True
            self.open_why = why

    def merge(self, other: "KeySet") -> None:
        self.required |= other.required
        self.optional |= other.optional
        self.defaulted |= other.defaulted
        if other.open:
            self.mark_open(other.open_why)

    def all_keys(self) -> set:
        return self.required | self.optional | self.defaulted


@dataclass
class SendSite:
    event: str
    node: ast.AST
    rel_path: str
    literal: bool  # event spelled as a raw string at the call
    keys: KeySet
    via: str  # method name used (send_json / send_msg_binary / …)


@dataclass
class HandlerReg:
    event: str
    node: ast.AST
    rel_path: str  # where the DISPATCH happens (table / if-chain)
    table: str
    literal: bool  # dispatch key/comparison spelled as a raw string
    plane: str | None  # node / subagg / network (by dispatch module)
    reads: KeySet


@dataclass
class FrameIssue:
    kind: str  # "trace" | "codec"
    node: ast.AST
    rel_path: str
    message: str


@dataclass
class Transition:
    machine: str
    to_state: str
    via: str
    node: ast.AST
    rel_path: str


@dataclass
class ProtocolModel:
    send_sites: list = field(default_factory=list)
    handlers: list = field(default_factory=list)
    #: events driven in-repo through an HTTP twin route registration
    #: (``_ws_twin(USER_EVENTS.X)`` and friends) — a sender for GL702
    http_driven: set = field(default_factory=set)
    frame_issues: list = field(default_factory=list)
    transitions: list = field(default_factory=list)
    #: a handler table had a ``**spread`` we could not resolve — the
    #: registered-event set is not closed
    tables_open: bool = False
    #: event string value → constant spellings ("CLS.NAME") that exist
    event_constants: dict = field(default_factory=dict)

    def registered_events(self) -> set:
        return {h.event for h in self.handlers}

    def sent_events(self) -> set:
        return {s.event for s in self.send_sites}


class ProtocolExtractor:
    """One pass over a built :class:`ProgramGraph` → ProtocolModel."""

    def __init__(self, graph: ProgramGraph) -> None:
        self.graph = graph
        self.model = ProtocolModel()
        #: (rel, NAME) → str value, module-level constants
        self._mod_consts: dict[tuple, str] = {}
        #: "CLS.NAME" → str value, class-level constants (repo-wide)
        self._cls_consts: dict[str, str] = {}
        #: (rel, table_name) → list[(key_expr, value_expr, spread_expr)]
        self._tables: dict[tuple, ast.Dict] = {}
        self._seen_sends: set = set()
        self._consumer_cache: dict = {}
        #: rel → (classdefs, assigns, calls) from ONE walk per module
        self._mod_index: dict = {}
        #: [(fn, calls, assigns, ifs)] from ONE walk per function —
        #: the collection passes below iterate these instead of each
        #: re-walking every tree (the walks dominated extraction time)
        self._fn_index: list = []

    def _build_indexes(self) -> None:
        for rel, syms in self.graph.modules.items():
            classdefs, assigns, calls = [], [], []
            for node in ast.walk(syms.tree):
                if isinstance(node, ast.ClassDef):
                    classdefs.append(node)
                elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                    assigns.append(node)
                elif isinstance(node, ast.Call):
                    calls.append(node)
            self._mod_index[rel] = (classdefs, assigns, calls)
        for fn in self.graph.functions.values():
            f_calls, f_assigns, f_ifs = [], [], []
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Call):
                    f_calls.append(node)
                elif isinstance(node, ast.Assign):
                    f_assigns.append(node)
                elif isinstance(node, ast.If):
                    f_ifs.append(node)
            self._fn_index.append((fn, f_calls, f_assigns, f_ifs))

    def extract(self) -> ProtocolModel:
        self._build_indexes()
        self._collect_constants()
        self._collect_tables()
        self._collect_handlers()
        self._collect_if_chains()
        self._collect_send_sites()
        self._collect_http_twins()
        self._collect_frame_issues()
        self._collect_transitions()
        self._analyze_consumers()
        return self.model

    # ── constants ───────────────────────────────────────────────────────

    def _collect_constants(self) -> None:
        for rel, syms in self.graph.modules.items():
            for node in syms.tree.body:
                if not isinstance(node, ast.Assign):
                    continue
                if (
                    len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)
                ):
                    self._mod_consts[(rel, node.targets[0].id)] = (
                        node.value.value
                    )
                # tuple-unpack module constants (secagg phase names)
                if (
                    len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Tuple)
                    and isinstance(node.value, ast.Tuple)
                    and len(node.targets[0].elts) == len(node.value.elts)
                ):
                    for t, v in zip(node.targets[0].elts, node.value.elts):
                        if (
                            isinstance(t, ast.Name)
                            and isinstance(v, ast.Constant)
                            and isinstance(v.value, str)
                        ):
                            self._mod_consts[(rel, t.id)] = v.value
            for node in self._mod_index[rel][0]:
                for stmt in node.body:
                    if (
                        isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                        and isinstance(stmt.value, ast.Constant)
                        and isinstance(stmt.value.value, str)
                    ):
                        spelled = f"{node.name}.{stmt.targets[0].id}"
                        self._cls_consts[spelled] = stmt.value.value
                        if _is_event_class(node.name):
                            self.model.event_constants.setdefault(
                                stmt.value.value, []
                            ).append(spelled)

    def resolve_event_expr(
        self, expr: ast.AST, rel: str
    ) -> tuple[str, bool] | None:
        """An expression in event position → (value, spelled_literal),
        or None when it cannot be resolved (wrapper params stay quiet)."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return (expr.value, True)
        if isinstance(expr, ast.Attribute):
            path = dotted(expr)
            if path is not None and "." in path:
                spelled = ".".join(path.split(".")[-2:])
                value = self._cls_consts.get(spelled)
                if value is not None:
                    return (value, False)
            return None
        if isinstance(expr, ast.Name):
            value = self._mod_consts.get((rel, expr.id))
            if value is not None:
                return (value, False)
            syms = self.graph.modules.get(rel)
            if syms is not None:
                sym = syms.imports.symbols.get(expr.id)
                if sym is not None:
                    target = self.graph.dotted_to_rel.get(sym[0])
                    if target is not None:
                        value = self._mod_consts.get((target, sym[1]))
                        if value is not None:
                            return (value, False)
            return None
        return None

    # ── receiver tables ─────────────────────────────────────────────────

    def _collect_tables(self) -> None:
        for rel in self.graph.modules:
            for node in self._mod_index[rel][1]:
                target = None
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                ):
                    target = node.targets[0]
                elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name
                ):
                    target = node.target
                if target is None or not isinstance(
                    node.value, ast.Dict
                ):
                    continue
                if target.id == "ROUTES" or "HANDLERS" in target.id:
                    self._tables[(rel, target.id)] = node.value

    def _plane_of(self, rel: str) -> str | None:
        if "/node/" in rel or rel.startswith("node/"):
            return "node"
        if "/worker/" in rel or rel.startswith("worker/"):
            return "subagg"
        if "/network/" in rel or rel.startswith("network/"):
            return "network"
        return None

    def _resolve_table_ref(
        self, rel: str, name: str, depth: int = 0
    ) -> tuple | None:
        """A NAME that should denote a handler table: the table in this
        module, a module-level alias of one, or a from-import of one."""
        if depth > 4:
            return None
        if (rel, name) in self._tables:
            return (rel, name)
        syms = self.graph.modules.get(rel)
        if syms is None:
            return None
        for node in syms.tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name
                and isinstance(node.value, ast.Name)
            ):
                return self._resolve_table_ref(
                    rel, node.value.id, depth + 1
                )
        sym = syms.imports.symbols.get(name)
        if sym is not None:
            target = self.graph.dotted_to_rel.get(sym[0])
            if target is not None:
                return self._resolve_table_ref(target, sym[1], depth + 1)
        return None

    def _collect_handlers(self) -> None:
        for (rel, name), table in self._tables.items():
            plane = self._plane_of(rel)
            self._flatten_table(rel, name, table, rel, plane)

    def _flatten_table(
        self,
        rel: str,
        name: str,
        table: ast.Dict,
        dispatch_rel: str,
        plane: str | None,
        depth: int = 0,
    ) -> None:
        if depth > 3:
            return
        for key, value in zip(table.keys, table.values):
            if key is None:  # **spread
                ref = None
                if isinstance(value, ast.Name):
                    ref = self._resolve_table_ref(rel, value.id)
                if ref is None:
                    self.model.tables_open = True
                    continue
                self._flatten_table(
                    ref[0], ref[1], self._tables[ref], dispatch_rel,
                    plane, depth + 1,
                )
                continue
            resolved = self.resolve_event_expr(key, rel)
            if resolved is None:
                self.model.tables_open = True
                continue
            event, literal = resolved
            self.model.handlers.append(
                HandlerReg(
                    event=event,
                    node=key,
                    rel_path=dispatch_rel,
                    table=f"{rel}:{name}",
                    literal=literal,
                    plane=plane,
                    reads=self._consumer_of_expr(rel, value),
                )
            )

    # ── if-chain receivers (legacy JSON dispatch) ───────────────────────

    def _collect_if_chains(self) -> None:
        seen: set = set()
        for fn, _calls, assigns, ifs in self._fn_index:
            dispatch_vars = set()
            for node in assigns:
                if (
                    len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                ):
                    for call in ast.walk(node.value):
                        if (
                            isinstance(call, ast.Call)
                            and isinstance(call.func, ast.Attribute)
                            and call.func.attr == "get"
                            and call.args
                        ):
                            got = self.resolve_event_expr(
                                call.args[0], fn.rel_path
                            )
                            if got is not None and got[0] == "type":
                                dispatch_vars.add(node.targets[0].id)
            if not dispatch_vars:
                continue
            plane = self._plane_of(fn.rel_path)
            for node in ifs:
                test = node.test
                if not (
                    isinstance(test, ast.Compare)
                    and isinstance(test.left, ast.Name)
                    and test.left.id in dispatch_vars
                    and len(test.ops) == 1
                ):
                    continue
                loc = (fn.rel_path, test.lineno, test.col_offset)
                if loc in seen:
                    continue
                seen.add(loc)
                comparator = test.comparators[0]
                if isinstance(test.ops[0], ast.Eq):
                    resolved = self.resolve_event_expr(
                        comparator, fn.rel_path
                    )
                    if resolved is None:
                        continue
                    event, literal = resolved
                    reads = KeySet()
                    payload_vars = self._payload_vars_of(fn.node)
                    self._read_keys(
                        node.body, fn.rel_path, fn.class_name,
                        payload_vars, reads, 0, set(),
                    )
                    self.model.handlers.append(
                        HandlerReg(
                            event=event,
                            node=test,
                            rel_path=fn.rel_path,
                            table=f"{fn.rel_path}:{fn.qualname} if-chain",
                            literal=literal,
                            plane=plane,
                            reads=reads,
                        )
                    )
                elif isinstance(test.ops[0], ast.In) and isinstance(
                    comparator, ast.Name
                ):
                    # `msg_type in USER_HANDLERS` — this dispatch site
                    # serves that whole table on this plane too
                    ref = self._resolve_table_ref(
                        fn.rel_path, comparator.id
                    )
                    if ref is None:
                        self.model.tables_open = True
                        continue
                    self._flatten_table(
                        ref[0], ref[1], self._tables[ref],
                        fn.rel_path, plane, 1,
                    )

    # ── send sites ──────────────────────────────────────────────────────

    def _collect_send_sites(self) -> None:
        for fn, calls, _assigns, _ifs in self._fn_index:
            for node in calls:
                loc = (fn.rel_path, node.lineno, node.col_offset)
                if loc in self._seen_sends:
                    continue
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in SEND_METHODS
                    and node.args
                ):
                    self._seen_sends.add(loc)
                    self._record_send(fn, node)
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "send_str"
                ):
                    self._seen_sends.add(loc)
                    self._record_raw_send(fn, node)

    def _record_send(self, fn, call: ast.Call) -> None:
        resolved = self.resolve_event_expr(call.args[0], fn.rel_path)
        if resolved is None:
            return  # wrapper parameter — the wrapper's callers resolve
        event, literal = resolved
        keys = KeySet()
        if len(call.args) > 1:
            keys.merge(self._dict_keys(call.args[1], fn))
        for kw in call.keywords:
            if kw.arg == "data":
                keys.merge(self._dict_keys(kw.value, fn))
            elif kw.arg is None:
                keys.merge(self._dict_keys(kw.value, fn))
            elif kw.arg == "raw_key":
                raw = self.resolve_event_expr(kw.value, fn.rel_path)
                if raw is not None:
                    keys.required.add(raw[0])
                else:
                    keys.mark_open("unresolvable raw_key")
            elif kw.arg in _TRANSPORT_KWARGS:
                continue
            else:
                keys.required.add(kw.arg)
        keys.required -= ENVELOPE_KEYS
        keys.optional -= ENVELOPE_KEYS
        self.model.send_sites.append(
            SendSite(
                event=event,
                node=call,
                rel_path=fn.rel_path,
                literal=literal,
                keys=keys,
                via=call.func.attr,
            )
        )

    def _record_raw_send(self, fn, call: ast.Call) -> None:
        """``ws.send_str(json.dumps({...TYPE...}))`` — a raw-envelope
        send outside the client transport (network→node monitor)."""
        if len(call.args) != 1 or not isinstance(call.args[0], ast.Call):
            return
        dumps = call.args[0]
        name = dotted(dumps.func) or ""
        if name.split(".")[-1] != "dumps" or not dumps.args:
            return
        payload = dumps.args[0]
        if not isinstance(payload, ast.Dict):
            return
        event = None
        literal = False
        keys = KeySet()
        for key, value in zip(payload.keys, payload.values):
            if key is None:
                keys.mark_open("**spread in raw envelope")
                continue
            got = self.resolve_event_expr(key, fn.rel_path)
            if got is None:
                keys.mark_open("unresolvable raw envelope key")
                continue
            if got[0] == "type":
                resolved = self.resolve_event_expr(value, fn.rel_path)
                if resolved is None:
                    return
                event, literal = resolved
            elif got[0] not in ENVELOPE_KEYS:
                keys.required.add(got[0])
        if event is None:
            return
        self.model.send_sites.append(
            SendSite(
                event=event,
                node=call,
                rel_path=fn.rel_path,
                literal=literal,
                keys=keys,
                via="send_str",
            )
        )

    def _dict_keys(self, expr: ast.AST, fn) -> KeySet:
        out = KeySet()
        rel = fn.rel_path
        if isinstance(expr, ast.Dict):
            for key, value in zip(expr.keys, expr.values):
                if key is None:  # **spread
                    if isinstance(value, ast.Dict):
                        out.merge(self._dict_keys(value, fn))
                    elif isinstance(value, ast.IfExp):
                        for branch in (value.body, value.orelse):
                            if isinstance(branch, ast.Dict):
                                sub = self._dict_keys(branch, fn)
                                out.optional |= sub.all_keys()
                                if sub.open:
                                    out.mark_open(sub.open_why)
                            else:
                                out.mark_open(
                                    "conditional spread of a non-dict"
                                )
                    else:
                        out.mark_open("**spread of a non-literal dict")
                    continue
                got = self.resolve_event_expr(key, rel)
                if got is None:
                    out.mark_open("unresolvable payload key")
                else:
                    out.required.add(got[0])
            return out
        if isinstance(expr, ast.IfExp):
            for branch in (expr.body, expr.orelse):
                sub = self._dict_keys(branch, fn)
                out.optional |= sub.all_keys()
                if sub.open:
                    out.mark_open(sub.open_why)
            return out
        if isinstance(expr, ast.Name):
            base = None
            for node in ast.walk(fn.node):
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == expr.id
                    and isinstance(node.value, ast.Dict)
                ):
                    base = self._dict_keys(node.value, fn)
            if base is None:
                out.mark_open(f"payload is local '{expr.id}' with no "
                              "dict-literal assignment")
                return out
            out.merge(base)
            # later `name[key] = …` stores may be conditional — optional
            for node in ast.walk(fn.node):
                if (
                    isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, ast.Store)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == expr.id
                ):
                    got = self.resolve_event_expr(node.slice, fn.rel_path)
                    if got is None:
                        out.mark_open("dynamic payload key store")
                    else:
                        out.optional.add(got[0])
            return out
        out.mark_open("payload expression not a dict literal")
        return out

    # ── HTTP twin drivers ───────────────────────────────────────────────

    def _collect_http_twins(self) -> None:
        """Route registrations whose arguments name an event constant
        (``r.add_post(path, _ws_twin(USER_EVENTS.X))``) drive that event
        in-repo over HTTP — it is not a dead handler."""
        known = {
            v for v in self.model.event_constants
        } | self.model.registered_events()
        for rel in self.graph.modules:
            for node in self._mod_index[rel][2]:
                if not (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in (
                        "add_post", "add_get", "add_put",
                        "add_delete", "add_route",
                    )
                ):
                    continue
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Attribute):
                        path = dotted(sub)
                        if path is None or "." not in path:
                            continue
                        spelled = ".".join(path.split(".")[-2:])
                        value = self._cls_consts.get(spelled)
                        if value is not None and value in known:
                            self.model.http_driven.add(value)

    # ── frame gating ────────────────────────────────────────────────────

    def _collect_frame_issues(self) -> None:
        for fn, calls, _assigns, _ifs in self._fn_index:
            for node in calls:
                name = dotted(node.func) or ""
                if name.split(".")[-1] != "encode_frame":
                    continue
                self._check_frame_call(fn, node)

    def _trace_gated(self, fn, expr: ast.AST) -> bool:
        """True when the trace arg is provably absent off-negotiation:
        None, an IfExp whose orelse is None, or a local assigned one."""
        if isinstance(expr, ast.Constant) and expr.value is None:
            return True
        if isinstance(expr, ast.IfExp):
            orelse = expr.orelse
            return isinstance(orelse, ast.Constant) and orelse.value is None
        if isinstance(expr, ast.Name):
            for node in ast.walk(fn.node):
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == expr.id
                    and self._trace_gated(fn, node.value)
                ):
                    return True
        return False

    def _check_frame_call(self, fn, call: ast.Call) -> None:
        for kw in call.keywords:
            if kw.arg == "trace" and not self._trace_gated(fn, kw.value):
                self.model.frame_issues.append(
                    FrameIssue(
                        kind="trace",
                        node=call,
                        rel_path=fn.rel_path,
                        message=(
                            "encode_frame(trace=…) not gated on trace "
                            "negotiation — a plain-v2 peer's decoder "
                            "predates the tag bit and rejects the frame"
                        ),
                    )
                )
        codec = None
        if len(call.args) > 1:
            codec = call.args[1]
        for kw in call.keywords:
            if kw.arg == "codec":
                codec = kw.value
        if (
            isinstance(codec, ast.Constant)
            and isinstance(codec.value, str)
        ):
            self.model.frame_issues.append(
                FrameIssue(
                    kind="codec",
                    node=call,
                    rel_path=fn.rel_path,
                    message=(
                        f"encode_frame codec hardcoded to "
                        f"{codec.value!r} — the codec must come from "
                        "subprotocol negotiation, not a literal"
                    ),
                )
            )

    # ── lifecycle transitions ───────────────────────────────────────────

    def _machine_of_module(self, rel: str) -> str:
        stem = rel.rsplit("/", 1)[-1].removesuffix(".py")
        return stem.removesuffix("_service")

    def _collect_transitions(self) -> None:
        seen: set = set()
        for fn, calls, assigns, _ifs in self._fn_index:
            via = fn.qualname.split(".")[-1]
            for node in calls:
                loc = (fn.rel_path, getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0))
                # warehouse machines: register/modify on a *cycles attr
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("register", "modify")
                    and isinstance(node.func.value, ast.Attribute)
                    and node.func.value.attr.lstrip("_").endswith(
                        _LIFECYCLE_ATTR
                    )
                ):
                    if loc in seen:
                        continue
                    attr = node.func.value.attr.lstrip("_")
                    machine = attr.removesuffix("s")
                    if node.func.attr == "register":
                        for kw in node.keywords:
                            if (
                                kw.arg == "is_completed"
                                and isinstance(kw.value, ast.Constant)
                                and kw.value.value is False
                            ):
                                seen.add(loc)
                                self.model.transitions.append(
                                    Transition(
                                        machine, "open", via, node,
                                        fn.rel_path,
                                    )
                                )
                    else:  # modify(filter, update) — the UPDATE dict
                        # decides; `modify({"is_completed": True}, …)`
                        # merely FILTERS on completed rows
                        if len(node.args) < 2 or not isinstance(
                            node.args[1], ast.Dict
                        ):
                            continue
                        update = node.args[1]
                        for key, value in zip(update.keys, update.values):
                            if (
                                isinstance(key, ast.Constant)
                                and key.value == "is_completed"
                                and isinstance(value, ast.Constant)
                                and value.value is True
                            ):
                                seen.add(loc)
                                self.model.transitions.append(
                                    Transition(
                                        machine, "completed", via, node,
                                        fn.rel_path,
                                    )
                                )
            # phase machines: `st.phase = CONSTANT`
            for node in assigns:
                loc = (fn.rel_path, getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0))
                if (
                    len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Attribute)
                    and node.targets[0].attr == "phase"
                ):
                    if loc in seen:
                        continue
                    got = self.resolve_event_expr(node.value, fn.rel_path)
                    if got is None:
                        continue
                    seen.add(loc)
                    self.model.transitions.append(
                        Transition(
                            self._machine_of_module(fn.rel_path),
                            got[0], via, node, fn.rel_path,
                        )
                    )

    # ── consumer payload reads ──────────────────────────────────────────

    def _payload_vars_of(self, fn_node: ast.AST) -> set:
        """Names that hold the event payload inside ``fn_node``:
        conventionally-named params of the function, its nested defs
        and lambdas, plus locals assigned from ``<pv>.get(<data key>)``."""
        out: set = set()
        for node in ast.walk(fn_node):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                args = node.args
                for a in (
                    args.posonlyargs + args.args + args.kwonlyargs
                ):
                    if a.arg in PAYLOAD_PARAM_NAMES:
                        out.add(a.arg)
        changed = True
        while changed:
            changed = False
            for node in ast.walk(fn_node):
                if not (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id not in out
                ):
                    continue
                for call in ast.walk(node.value):
                    if (
                        isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and call.func.attr == "get"
                        and isinstance(call.func.value, ast.Name)
                        and call.func.value.id in out
                        and call.args
                        and isinstance(call.args[0], ast.Constant)
                        and call.args[0].value == "data"
                    ):
                        out.add(node.targets[0].id)
                        changed = True
                # `data = message.get(MSG_FIELD.DATA) or {}` — constant
                for call in ast.walk(node.value):
                    if (
                        isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and call.func.attr == "get"
                        and isinstance(call.func.value, ast.Name)
                        and call.func.value.id in out
                        and call.args
                        and isinstance(call.args[0], ast.Attribute)
                        and dotted(call.args[0]) is not None
                        and self._cls_consts.get(
                            ".".join(
                                dotted(call.args[0]).split(".")[-2:]
                            )
                        ) == "data"
                    ):
                        out.add(node.targets[0].id)
                        changed = True
        return out

    def _consumer_of_expr(self, rel: str, value: ast.AST) -> KeySet:
        """The key set a handler-table VALUE expression reads."""
        out = KeySet()
        if isinstance(value, ast.Lambda):
            self._read_callable(value, rel, None, out, 0, set())
            return out
        if isinstance(value, (ast.Name, ast.Attribute)):
            path = dotted(value)
            if path is None:
                out.mark_open("unresolvable handler expression")
                return out
            local_types = self._local_types_near(rel, value)
            targets = self.graph.resolve_call(
                rel, None, path, local_types
            )
            if not targets:
                # module-level factory product: `h = _make(…, lambda d: …)`
                factory = self._module_level_call(rel, path)
                if factory is not None:
                    return self._consumer_of_expr(rel, factory)
                out.mark_open(f"handler '{path}' not resolvable")
                return out
            for key in targets:
                fn = self.graph.functions.get(key)
                if fn is None:
                    out.mark_open(f"handler '{path}' has no body")
                    continue
                self._read_callable(fn.node, fn.rel_path,
                                    fn.class_name, out, 0, set())
            return out
        if isinstance(value, ast.Call):
            # factory registration: when lambda arguments are passed,
            # they ARE the consumer body — the factory is an envelope
            # wrapper that forwards the payload into them (analyzing it
            # too would spuriously mark the set open at the `fn(…)`
            # forwarding call); without lambdas, fall back to the
            # factory body itself
            analyzed = False
            for arg in list(value.args) + [
                kw.value for kw in value.keywords
            ]:
                if isinstance(arg, ast.Lambda):
                    self._read_callable(arg, rel, None, out, 0, set())
                    analyzed = True
            if not analyzed:
                path = dotted(value.func)
                if path is not None:
                    for key in self.graph.resolve_call(
                        rel, None, path, None
                    ):
                        fn = self.graph.functions.get(key)
                        if fn is not None:
                            self._read_callable(
                                fn.node, fn.rel_path,
                                fn.class_name, out, 0, set(),
                            )
                            analyzed = True
            if not analyzed:
                out.mark_open("factory handler not resolvable")
            return out
        out.mark_open("handler expression shape not modeled")
        return out

    def _module_level_call(self, rel: str, name: str) -> ast.Call | None:
        """A module-level ``name = SomeFactory(…)`` assignment's value."""
        if "." in name:
            return None
        syms = self.graph.modules.get(rel)
        if syms is None:
            return None
        for node in syms.tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name
                and isinstance(node.value, ast.Call)
            ):
                return node.value
        return None

    def _local_types_near(self, rel: str, node: ast.AST) -> dict | None:
        """Constructor-typed locals of the function enclosing ``node``
        (``agg = SubAggregator(...)`` → ``agg.handle_report`` resolves)."""
        best = None
        for fn in self.graph.functions.values():
            if fn.rel_path != rel:
                continue
            for sub in ast.walk(fn.node):
                if sub is node:
                    if best is None or fn.node.lineno > best.node.lineno:
                        best = fn
                    break
        if best is None:
            return None
        out: dict = {}
        for sub in ast.walk(best.node):
            if (
                isinstance(sub, ast.Assign)
                and len(sub.targets) == 1
                and isinstance(sub.targets[0], ast.Name)
                and isinstance(sub.value, ast.Call)
            ):
                path = dotted(sub.value.func)
                if path is None:
                    continue
                cls = self.graph.resolve_class(rel, path)
                if cls is not None:
                    out[sub.targets[0].id] = cls
        return out or None

    def _read_callable(
        self, fn_node, rel, class_name, out: KeySet, depth, visited
    ) -> None:
        payload_vars = self._payload_vars_of(fn_node)
        if not payload_vars:
            return
        body = (
            [fn_node.body]
            if isinstance(fn_node, ast.Lambda)
            else fn_node.body
        )
        self._read_keys(
            body, rel, class_name, payload_vars, out, depth, visited
        )

    def _read_keys(
        self, body, rel, class_name, payload_vars, out: KeySet,
        depth, visited,
    ) -> None:
        """Key reads on any payload var across ``body`` (statements)."""
        for stmt in body:
            for node in ast.walk(stmt):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in payload_vars
                ):
                    attr = node.func.attr
                    if attr == "get" and node.args:
                        got = self.resolve_event_expr(node.args[0], rel)
                        if got is None:
                            out.mark_open(
                                "dynamic payload key read (.get of a "
                                "non-constant)"
                            )
                        elif got[0] not in ENVELOPE_KEYS:
                            out.defaulted.add(got[0])
                    elif attr in ("items", "keys", "values", "update",
                                  "pop", "copy"):
                        out.mark_open(f"whole-payload .{attr}()")
                elif (
                    isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, ast.Load)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in payload_vars
                ):
                    got = self.resolve_event_expr(node.slice, rel)
                    if got is None:
                        out.mark_open("dynamic payload subscript")
                    elif got[0] not in ENVELOPE_KEYS:
                        out.required.add(got[0])
                elif isinstance(node, ast.Call):
                    self._follow_whole_payload(
                        node, rel, class_name, payload_vars, out,
                        depth, visited,
                    )

    def _follow_whole_payload(
        self, call: ast.Call, rel, class_name, payload_vars,
        out: KeySet, depth, visited,
    ) -> None:
        """A payload var passed whole to a callee: recurse when the
        callee resolves, mark OPEN when it escapes analysis."""
        hit_positions = [
            i for i, a in enumerate(call.args)
            if isinstance(a, ast.Name) and a.id in payload_vars
        ]
        kw_hits = [
            kw.arg for kw in call.keywords
            if isinstance(kw.value, ast.Name)
            and kw.value.id in payload_vars
            and kw.arg is not None
        ]
        if not hit_positions and not kw_hits:
            return
        path = dotted(call.func)
        if path is not None and path.split(".")[-1] in _BENIGN_CALLEES:
            return
        if depth >= 3 or path is None:
            out.mark_open(
                f"payload passed whole to "
                f"'{path or '<expr>'}'"
            )
            return
        targets = self.graph.resolve_call(rel, class_name, path, None)
        if not targets:
            out.mark_open(f"payload passed whole to '{path}'")
            return
        for key in targets:
            if key in visited:
                continue
            visited = visited | {key}
            fn = self.graph.functions.get(key)
            if fn is None:
                out.mark_open(f"payload passed whole to '{path}'")
                continue
            args = fn.node.args
            params = [
                a.arg for a in args.posonlyargs + args.args
            ]
            if params and params[0] in ("self", "cls"):
                params = params[1:]
            callee_vars = set()
            for i in hit_positions:
                # positional offset: best-effort, ignores *args
                pos = i if not isinstance(call.func, ast.Attribute) \
                    else i
                if pos < len(params):
                    callee_vars.add(params[pos])
            callee_vars |= {a for a in kw_hits if a in set(params)}
            if not callee_vars:
                out.mark_open(f"payload position lost into '{path}'")
                continue
            self._read_keys(
                fn.node.body, fn.rel_path, fn.class_name,
                callee_vars | self._payload_vars_of(fn.node),
                out, depth + 1, visited,
            )

    def _analyze_consumers(self) -> None:
        # if-chain and table handlers were analyzed inline; nothing to
        # do here yet — kept as a hook for cross-handler merging.
        return
