"""GL4 — wire/telemetry contract drift.

The wire format and the metric surface are *published contracts*
(docs/WIRE.md is written for foreign-client implementors;
docs/OBSERVABILITY.md for operators wiring dashboards). Code drifting
from them is a silent break for consumers this repo never tests:

- **GL401** every metric family passed to the telemetry bus
  (``telemetry.incr``/``observe`` first-arg string literal) must appear
  in ``docs/OBSERVABILITY.md`` (bare or ``pygrid_``-prefixed — the
  exporter prefixes on render).
- **GL402** the same family must be registered in the exporter HELP
  registry (the ``_FAMILY_HELP`` dict in ``telemetry/bus.py``) so
  ``/metrics`` ships a real description, not a fallback.
- **GL403** wire constants: ``EXT_*`` codes, ``FRAME_*`` tags and
  ``WS_SUBPROTOCOL*`` strings must be unique within their group, every
  tag byte documented in ``docs/WIRE.md`` (as ``0xNN``), every
  subprotocol string quoted there verbatim.
- GL404 (typed errors in handler modules) is SUPERSEDED by GL604:
  the dataflow checker proves untyped raises unreachable from the
  protocol boundary instead of guessing by module path.
- **GL405** every HTTP route path registered in ``node/routes.py`` /
  ``network/routes.py`` (``r.add_get("/path", …)`` and friends) must
  appear in README.md or a ``docs/*.md`` file — an endpoint nobody can
  discover is an endpoint nobody can operate. ``{param}`` placeholders
  match their ``<param>`` doc spelling too.
- **GL406** every WS event key in the node's ``ROUTES`` dispatch table
  must appear in ``docs/WIRE.md`` — constant references
  (``MODEL_CENTRIC_FL_EVENTS.REPORT``) are resolved through the string
  constants collected from ``utils/codes.py`` in the same run.

Docs are resolved against the run root (``docs/OBSERVABILITY.md``,
``docs/WIRE.md``); with no docs present the doc-membership rules stay
quiet (fixture trees opt in by shipping a ``docs/`` dir).
"""

from __future__ import annotations

import ast
import os
from typing import Iterable

from pygrid_tpu_torch.analysis.core import Checker, Finding, ModuleContext

#: route-registration modules (GL405); fnmatch vs repo-relative paths
_ROUTE_MODULE_PATTERNS = ("*/node/routes.py", "*/network/routes.py")

#: aiohttp router methods whose first string arg is the path
_ADD_ROUTE_METHODS = {
    "add_get", "add_post", "add_put", "add_delete", "add_patch",
    "add_head", "add_route",
}


def _is_bus_metric_call(node: ast.Call) -> str | None:
    """The family-name literal if ``node`` is ``telemetry.incr/observe``
    (or a bus-bound ``incr``/``observe``/``BUS.incr``...)."""
    fn = node.func
    attr = None
    if isinstance(fn, ast.Attribute):
        attr = fn.attr
        recv_ok = (
            isinstance(fn.value, ast.Name)
            and fn.value.id in ("telemetry", "BUS", "bus")
        )
        if not recv_ok:
            return None
    elif isinstance(fn, ast.Name) and fn.id in ("incr", "observe"):
        attr = fn.id
    if attr not in ("incr", "observe"):
        return None
    if node.args and isinstance(node.args[0], ast.Constant) and isinstance(
        node.args[0].value, str
    ):
        return node.args[0].value
    return None


def _added_route_path(node: ast.Call) -> str | None:
    """The path literal if ``node`` is an ``r.add_*`` registration —
    first string arg (``add_route`` carries method first, path second)."""
    fn = node.func
    if not isinstance(fn, ast.Attribute) or fn.attr not in _ADD_ROUTE_METHODS:
        return None
    index = 1 if fn.attr == "add_route" else 0
    if len(node.args) <= index:
        return None
    arg = node.args[index]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    return None


class ContractDriftChecker(Checker):
    name = "GL4"
    description = "wire/telemetry surface vs docs + typed-error contract"
    codes = {
        "GL401": "bus metric family missing from docs/OBSERVABILITY.md",
        "GL402": "bus metric family missing from the _FAMILY_HELP registry",
        "GL403": "wire constant duplicated or missing from docs/WIRE.md",
        "GL405": "registered HTTP route path missing from README/docs",
        "GL406": "ROUTES WS event key missing from docs/WIRE.md",
    }

    def __init__(self) -> None:
        # family -> EVERY call site (mod, node): findings anchor per
        # site, so suppressing one site cannot swallow another file's
        # use of the same undocumented family
        self._metric_sites: dict[
            str, list[tuple[ModuleContext, ast.Call]]
        ] = {}
        self._family_help: set[str] | None = None
        # group name -> [(const name, value, mod, node)]
        self._wire_consts: dict[str, list] = {}
        self._wire_protocols: list[tuple[str, str, ModuleContext, ast.AST]] = []
        # GL405: [(path, mod, node)] from route-registration modules
        self._route_paths: list[tuple[str, ModuleContext, ast.AST]] = []
        # GL406: ROUTES keys — ("literal", value) or ("attr", "CLS.NAME")
        self._route_events: list[
            tuple[str, str, ModuleContext, ast.AST]
        ] = []
        # "CLS.NAME" -> string value, from utils/codes.py class bodies
        self._const_table: dict[str, str] = {}

    # ── per-module collection ───────────────────────────────────────────

    def check_module(self, mod: ModuleContext) -> Iterable[Finding]:
        import fnmatch

        findings: list[Finding] = []
        is_bus_module = mod.rel_path.endswith("telemetry/bus.py")
        is_wire_module = mod.rel_path.endswith("serde/wire.py")
        is_route_module = any(
            fnmatch.fnmatch(mod.rel_path, pat)
            for pat in _ROUTE_MODULE_PATTERNS
        )
        is_events_module = fnmatch.fnmatch(mod.rel_path, "*/node/events.py")
        if mod.rel_path.endswith("utils/codes.py"):
            self._collect_constants(mod)
        for node in ast.walk(mod.tree):
            if is_route_module and isinstance(node, ast.Call):
                path = _added_route_path(node)
                if path is not None:
                    self._route_paths.append((path, mod, node))
            if is_events_module and isinstance(node, ast.Assign):
                targets = [
                    t.id for t in node.targets if isinstance(t, ast.Name)
                ]
                if "ROUTES" in targets and isinstance(node.value, ast.Dict):
                    self._collect_route_events(mod, node.value)
            if is_events_module and isinstance(node, ast.AnnAssign):
                if (
                    isinstance(node.target, ast.Name)
                    and node.target.id == "ROUTES"
                    and isinstance(node.value, ast.Dict)
                ):
                    self._collect_route_events(mod, node.value)
            if isinstance(node, ast.Call):
                family = _is_bus_metric_call(node)
                if family is not None:
                    self._metric_sites.setdefault(family, []).append(
                        (mod, node)
                    )
            if is_bus_module and isinstance(node, ast.Assign):
                targets = [
                    t.id for t in node.targets if isinstance(t, ast.Name)
                ]
                if "_FAMILY_HELP" in targets and isinstance(
                    node.value, ast.Dict
                ):
                    self._family_help = {
                        k.value
                        for k in node.value.keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str)
                    }
            if is_wire_module and isinstance(node, ast.Assign):
                for t in node.targets:
                    if not isinstance(t, ast.Name):
                        continue
                    if not isinstance(node.value, ast.Constant):
                        continue
                    value = node.value.value
                    if t.id.startswith(("EXT_", "FRAME_")) and isinstance(
                        value, int
                    ):
                        group = t.id.split("_", 1)[0]
                        self._wire_consts.setdefault(group, []).append(
                            (t.id, value, mod, node)
                        )
                    elif t.id.startswith("WS_SUBPROTOCOL") and isinstance(
                        value, str
                    ):
                        self._wire_protocols.append((t.id, value, mod, node))

        return findings

    def _collect_constants(self, mod: ModuleContext) -> None:
        """``CLS.NAME -> "value"`` for every class-level string constant
        in utils/codes.py — the resolution table for ROUTES keys."""
        for cls in mod.tree.body:
            if not isinstance(cls, ast.ClassDef):
                continue
            for stmt in cls.body:
                if not isinstance(stmt, ast.Assign):
                    continue
                if not (
                    isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, str)
                ):
                    continue
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        self._const_table[f"{cls.name}.{t.id}"] = (
                            stmt.value.value
                        )

    def _collect_route_events(
        self, mod: ModuleContext, table: ast.Dict
    ) -> None:
        for key in table.keys:
            if key is None:  # a ``**spread`` entry — unresolvable
                continue
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                self._route_events.append(("literal", key.value, mod, key))
            elif isinstance(key, ast.Attribute) and isinstance(
                key.value, ast.Name
            ):
                self._route_events.append(
                    ("attr", f"{key.value.id}.{key.attr}", mod, key)
                )

    # ── cross-file rules ────────────────────────────────────────────────

    @staticmethod
    def _read_doc(run, name: str) -> str | None:
        path = os.path.join(run.root, "docs", name)
        try:
            with open(path, encoding="utf-8") as fh:
                return fh.read()
        except OSError:
            return None

    def finalize(self, run) -> Iterable[Finding]:
        findings: list[Finding] = []

        obs_doc = self._read_doc(run, "OBSERVABILITY.md")
        for family in sorted(self._metric_sites):
            for mod, node in self._metric_sites[family]:
                if obs_doc is not None and (
                    family not in obs_doc
                    and f"pygrid_{family}" not in obs_doc
                ):
                    findings.append(
                        mod.finding(
                            "GL401",
                            node,
                            f"metric family '{family}' is not documented "
                            "in docs/OBSERVABILITY.md",
                        )
                    )
                if (
                    self._family_help is not None
                    and family not in self._family_help
                ):
                    findings.append(
                        mod.finding(
                            "GL402",
                            node,
                            f"metric family '{family}' has no entry in "
                            "telemetry.bus._FAMILY_HELP — /metrics ships "
                            "a fallback HELP line",
                        )
                    )

        wire_doc = self._read_doc(run, "WIRE.md")
        for group, consts in sorted(self._wire_consts.items()):
            seen: dict[int, str] = {}
            for name, value, mod, node in consts:
                if value in seen:
                    findings.append(
                        mod.finding(
                            "GL403",
                            node,
                            f"wire constant {name} duplicates the value of "
                            f"{seen[value]} ({value:#x})",
                        )
                    )
                else:
                    seen[value] = name
                if wire_doc is not None and f"{value:#04x}" not in wire_doc:
                    findings.append(
                        mod.finding(
                            "GL403",
                            node,
                            f"wire constant {name} ({value:#04x}) is not "
                            "documented in docs/WIRE.md",
                        )
                    )
        for name, value, mod, node in self._wire_protocols:
            if wire_doc is not None and value not in wire_doc:
                findings.append(
                    mod.finding(
                        "GL403",
                        node,
                        f"subprotocol {name} ({value!r}) is not documented "
                        "in docs/WIRE.md",
                    )
                )

        # GL405 — every registered route path documented in README/docs
        route_docs = self._route_doc_corpus(run)
        if route_docs is not None:
            for path, mod, node in self._route_paths:
                spelled = path.replace("{", "<").replace("}", ">")
                if path not in route_docs and spelled not in route_docs:
                    findings.append(
                        mod.finding(
                            "GL405",
                            node,
                            f"route path '{path}' is registered but "
                            "documented nowhere in README.md / docs/*.md",
                        )
                    )

        # GL406 — every ROUTES event key documented in docs/WIRE.md
        if wire_doc is not None:
            for kind, key, mod, node in self._route_events:
                value = (
                    key if kind == "literal"
                    else self._const_table.get(key)
                )
                if value is None:
                    continue  # constant defined outside the scanned tree
                if value not in wire_doc:
                    findings.append(
                        mod.finding(
                            "GL406",
                            node,
                            f"WS event key '{value}' is dispatched in "
                            "ROUTES but not documented in docs/WIRE.md",
                        )
                    )
        return findings

    @staticmethod
    def _route_doc_corpus(run) -> str | None:
        """README.md + every docs/*.md, concatenated; None when the
        tree ships neither (fixture trees opt in, like GL401)."""
        import glob

        chunks: list[str] = []
        for path in [os.path.join(run.root, "README.md")] + sorted(
            glob.glob(os.path.join(run.root, "docs", "*.md"))
        ):
            try:
                with open(path, encoding="utf-8") as fh:
                    chunks.append(fh.read())
            except OSError:
                continue
        return "\n".join(chunks) if chunks else None
