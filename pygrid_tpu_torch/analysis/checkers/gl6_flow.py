"""GL6 — whole-program dataflow & taint analysis (gridtaint).

Rides :mod:`pygrid_tpu_torch.analysis.flow` over the shared
:class:`~pygrid_tpu_torch.analysis.graph.ProgramGraph` (one build per run):

- **GL601** a sensitive source (worker report/diff payload fields,
  ``request.json`` bodies, checkpoint bytes) reaches an observability
  sink — logging, a telemetry event/label, a flight-recorder ``note()``
  field, an outbound webhook body — with no sanitizer (the recorder's
  :func:`redact`, ``len`` length markers, hashing, numeric casts) on
  the path. The finding carries the full witness chain: source, every
  interprocedural hop, sink.
- **GL602** a credential-like value (``request_key``/auth material, by
  key or by parameter name) reaches ANY egress or observability
  surface: outbound wire frames, WS sends, HTTP response bodies,
  exception messages (they become client-visible error strings),
  metric labels, logs. Passing a credential as a flight-recorder
  ``note()`` field under a redact-keyed NAME is sanctioned — the
  dump-time redactor covers it; baking it into an f-string under an
  innocent key is exactly the leak class this rule exists for.
- **GL603** resource acquire/release pairing: a ``BlockPool.alloc``,
  socket, temp file, or non-``with`` lock ``.acquire()`` must balance
  on every path out of the acquiring function — returns, explicit
  raises, fall-through, and implicit raises (a resolved callee whose
  untyped-exception escape set is uncovered at the call site, via the
  same ExceptionFlow model GL604 uses) — unless the resource escapes
  (stored, returned, handed to a callee: ownership transferred).
  ``try/finally`` and the repo's cleanup idioms (``close``/``release``
  /``retire``/``free``/``unlink``/``_fail_all``) are recognized;
  ``x is None`` guards refine the path so a failed alloc is not a
  leak.
- **GL604** whole-program untyped-exception escape: a ``raise`` of a
  non-``PyGridError`` class (builtin errors, or any parsed class not
  inheriting ``PyGridError``) reachable from a route/WS handler entry
  point with no intervening catch on the call chain answers the
  client an untyped 500. Supersedes GL404's per-module heuristic —
  reachability replaces "is in a handler file", so helpers three
  modules deep are covered and dead code stays quiet.
"""

from __future__ import annotations

from typing import Iterable

from pygrid_tpu_torch.analysis.core import Checker, Finding
from pygrid_tpu_torch.analysis.flow import (
    SENSITIVE_TAGS,
    ExceptionFlow,
    FlowEngine,
    boundary_entry_points,
    resource_findings,
)


class DataFlowChecker(Checker):
    name = "GL6"
    description = (
        "whole-program taint, resource-pairing, and exception-escape "
        "dataflow"
    )
    codes = {
        "GL601": "sensitive source reaches an observability sink with no "
        "sanitizer on the path",
        "GL602": "credential-like value reaches an egress/observability "
        "surface",
        "GL603": "resource acquire/release unbalanced on a path "
        "(return/raise/fall-through)",
        "GL604": "untyped exception escapes a protocol-boundary handler "
        "(supersedes GL404)",
    }

    def finalize(self, run) -> Iterable[Finding]:
        graph = run.graph()
        mods = {m.rel_path: m for m in run.modules}
        findings: list[Finding] = []

        # ── GL601 / GL602: taint flows ─────────────────────────────────
        engine = FlowEngine(graph)
        for hit in engine.hits:
            mod = mods.get(hit.rel_path)
            if mod is None:
                continue
            witness = (f"source: {hit.origin}",) + hit.chain
            if hit.tag == "credential":
                findings.append(
                    mod.finding(
                        "GL602",
                        hit.node,
                        f"credential-like value ({hit.origin}) reaches "
                        f"{hit.sink.desc} — credentials must never leave "
                        "the process unredacted; hash it, note() it "
                        "under a redact-keyed field, or drop it",
                        witness=witness,
                    )
                )
            elif hit.sink.category == "obs" and hit.tag in SENSITIVE_TAGS:
                findings.append(
                    mod.finding(
                        "GL601",
                        hit.node,
                        f"sensitive {hit.tag} ({hit.origin}) reaches "
                        f"{hit.sink.desc} with no sanitizer on the path "
                        "— redact(), convert to a length marker, or "
                        "hash before observing",
                        witness=witness,
                    )
                )
            # non-credential taint into egress (payload → wire frame)
            # is the protocol working as designed — quiet

        # ── GL603: resource pairing (shares GL604's exception-escape
        # model so implicit raises out of callees count as exits) ─────
        escapes = ExceptionFlow(graph)
        for fn, node, kind, why in resource_findings(graph, escapes):
            mod = mods.get(fn.rel_path)
            if mod is None:
                continue
            findings.append(
                mod.finding(
                    "GL603",
                    node,
                    f"{kind} acquired in '{fn.qualname}' {why} — release "
                    "it, hand it off, or wrap the region in try/finally",
                )
            )

        # ── GL604: untyped-exception escape ───────────────────────────
        entries = boundary_entry_points(graph)
        reported: set[tuple] = set()
        for entry_key, desc in sorted(entries.items()):
            entry = graph.functions.get(entry_key)
            if entry is None:
                continue
            for exc, esc in sorted(escapes.escapes[entry_key].items()):
                site = (esc.rel_path, getattr(esc.node, "lineno", 0), exc)
                if site in reported:
                    continue
                reported.add(site)
                mod = mods.get(esc.rel_path)
                if mod is None:
                    continue
                findings.append(
                    mod.finding(
                        "GL604",
                        esc.node,
                        f"'raise {exc}' escapes the protocol boundary "
                        f"untyped — reachable from {entry.qualname} "
                        f"({desc}) with no intervening catch; raise a "
                        "typed PyGridError subclass or catch and "
                        "convert on the way out",
                        witness=esc.chain
                        + (f"entry point: {entry.pretty} — {desc}",),
                    )
                )
        return findings
