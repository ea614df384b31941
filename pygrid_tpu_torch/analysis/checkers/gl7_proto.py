"""GL7 — gridproto: wire & lifecycle protocol conformance.

Checks both sides of every grid conversation against each other and
against the committed machine-readable spec ``docs/wire_protocol.yaml``
(rendered in docs/WIRE.md), read with the port's own YAML-subset reader
(:mod:`pygrid_tpu_torch.analysis.yaml_subset`: the card's machine has no
PyYAML):

- GL701: a sent WS event with no registered handler anywhere (and no
  spec sanction as send-only/foreign), or an event spelled as a raw
  string literal at a send/dispatch site when a ``utils/codes``
  constant for that exact value exists (legacy-JSON spelling drift).
- GL702: a registered handler no in-repo sender drives (dead handler —
  HTTP twin routes and spec ``foreign.receive_only`` count as
  drivers), and wire-v2 frame hygiene: a trace tag not gated on the
  ``.trace`` subprotocol negotiation, or a hardcoded codec literal.
- GL703: payload-key conformance per event — a key the consumer
  subscripts (required) that no producer ever writes, or a key
  producers write that no consumer reads. Only CLOSED key sets fire:
  a wrapper parameter, dynamic ``.get``, or whole-payload escape marks
  the side OPEN and suppresses its findings.
- GL704: lifecycle hygiene — every ``raise`` in a module that performs
  lifecycle transitions must be a typed ``PyGridError``, and every
  non-terminal spec state must have an exit transition.
- GL705: spec round-trip — every extracted (machine, to-state, via)
  transition appears in ``docs/wire_protocol.yaml`` and vice versa,
  every spec state is anchored by code, and each plane's handled-event
  list matches the registrations the extractor found.

Partial scans (``--changed``) stay quiet by construction: GL701/702's
cross-plane facts fall back to the committed spec, and GL705 only
round-trips machines/planes the scan actually extracted.
"""

from __future__ import annotations

import os
from typing import Iterable

from pygrid_tpu_torch.analysis.core import Checker, Finding
from pygrid_tpu_torch.analysis.protocol import ProtocolExtractor
from pygrid_tpu_torch.analysis.yaml_subset import safe_load

#: builtin exception names — raising one from lifecycle code answers a
#: protocol reject with an untyped error the client cannot dispatch on
_BUILTIN_ERRORS = {
    "Exception", "ValueError", "TypeError", "KeyError", "IndexError",
    "RuntimeError", "OSError", "IOError", "AttributeError",
    "ArithmeticError", "ZeroDivisionError", "AssertionError",
    "LookupError",
}

SPEC_REL_PATH = os.path.join("docs", "wire_protocol.yaml")


def load_spec(root: str) -> tuple[dict | None, str | None]:
    """(spec dict, error) — (None, None) when no spec file exists,
    (None, why) when one exists but cannot be parsed."""
    path = os.path.join(root, SPEC_REL_PATH)
    if not os.path.exists(path):
        return None, None
    try:
        with open(path, encoding="utf-8") as fh:
            spec = safe_load(fh.read())
    except Exception as err:  # noqa: BLE001 — any parse failure
        return None, f"unparseable spec: {err}"
    if not isinstance(spec, dict):
        return None, "spec root is not a mapping"
    return spec, None


def _spec_events(spec: dict | None) -> set:
    """Every event the committed spec knows about — the cross-plane
    authority partial scans fall back to."""
    if not spec:
        return set()
    out: set = set()
    for plane in (spec.get("planes") or {}).values():
        out |= set((plane or {}).get("handled") or ())
    foreign = spec.get("foreign") or {}
    out |= set(foreign.get("send_only") or ())
    out |= set(foreign.get("receive_only") or ())
    return out


class ProtocolChecker(Checker):
    name = "GL7"
    description = (
        "wire & lifecycle protocol conformance (sender↔handler, "
        "producer↔consumer keys, cycle state machine vs spec)"
    )
    codes = {
        "GL701": "WS event sent with no registered handler, or event "
        "spelled as a raw literal where a codes constant exists",
        "GL702": "dead handler (no in-repo sender/twin/foreign "
        "sanction), or a wire-v2 frame not gated on negotiation",
        "GL703": "payload key drift: consumer-required key no producer "
        "writes, or producer key no consumer reads",
        "GL704": "lifecycle hygiene: untyped raise in a transition "
        "module, or a non-terminal spec state with no exit",
        "GL705": "extracted lifecycle/plane model does not round-trip "
        "against docs/wire_protocol.yaml",
    }

    def finalize(self, run) -> Iterable[Finding]:
        graph = run.graph()
        mods = {m.rel_path: m for m in run.modules}
        model = ProtocolExtractor(graph).extract()
        spec, spec_err = load_spec(run.root)
        findings: list[Finding] = []

        def emit(rel, node, code, message, witness=()):
            mod = mods.get(rel)
            if mod is not None:
                findings.append(
                    mod.finding(code, node, message, witness=witness)
                )

        self._check_events(model, spec, emit)
        self._check_frames(model, emit)
        self._check_payload_keys(model, emit)
        self._check_lifecycle(graph, model, spec, mods, emit)
        self._check_spec_roundtrip(model, spec, spec_err, emit)
        return findings

    # ── GL701 / GL702: event conformance ────────────────────────────────

    def _check_events(self, model, spec, emit) -> None:
        registered = model.registered_events()
        known = registered | _spec_events(spec)
        foreign = (spec or {}).get("foreign") or {}
        send_only = set(foreign.get("send_only") or ())
        receive_only = set(foreign.get("receive_only") or ())
        spec_listed = _spec_events(spec)

        for site in model.send_sites:
            if site.event not in known and site.event not in send_only:
                emit(
                    site.rel_path, site.node, "GL701",
                    f"event {site.event!r} is sent here but no receiver "
                    "registers a handler for it (and the wire spec does "
                    "not sanction it as send-only)",
                    witness=(
                        f"send site via .{site.via}() at "
                        f"{site.rel_path}:{site.node.lineno}",
                        "no ROUTES/_HANDLERS entry, if-chain dispatch, "
                        "or docs/wire_protocol.yaml listing matches",
                    ),
                )
            if site.literal and site.event in model.event_constants:
                const = model.event_constants[site.event][0]
                emit(
                    site.rel_path, site.node, "GL701",
                    f"event {site.event!r} spelled as a raw string at a "
                    f"send site — use the codes constant {const} (raw "
                    "spellings drift silently from the dispatch tables)",
                    witness=(
                        f"literal send at "
                        f"{site.rel_path}:{site.node.lineno}",
                        f"constant {const} = {site.event!r} exists in "
                        "utils/codes.py",
                    ),
                )

        seen_dead: set = set()
        for reg in model.handlers:
            if reg.literal and reg.event in model.event_constants:
                const = model.event_constants[reg.event][0]
                emit(
                    reg.rel_path, reg.node, "GL701",
                    f"event {reg.event!r} spelled as a raw string at a "
                    f"dispatch site — use the codes constant {const}",
                    witness=(
                        f"literal dispatch in {reg.table} at "
                        f"{reg.rel_path}:{reg.node.lineno}",
                        f"constant {const} = {reg.event!r} exists in "
                        "utils/codes.py",
                    ),
                )
            dead_key = (reg.event, reg.table)
            if dead_key in seen_dead:
                continue
            seen_dead.add(dead_key)
            if (
                reg.event not in model.sent_events()
                and reg.event not in model.http_driven
                and reg.event not in receive_only
                and reg.event not in spec_listed
            ):
                emit(
                    reg.rel_path, reg.node, "GL702",
                    f"handler registered for {reg.event!r} but nothing "
                    "in the repo sends it (no WS send site, no HTTP twin "
                    "route, no foreign.receive_only sanction in the "
                    "wire spec) — dead protocol surface",
                    witness=(
                        f"registered in {reg.table} at "
                        f"{reg.rel_path}:{reg.node.lineno}",
                        "no send site resolves to this event",
                    ),
                )

    # ── GL702: frame gating ─────────────────────────────────────────────

    def _check_frames(self, model, emit) -> None:
        for issue in model.frame_issues:
            emit(
                issue.rel_path, issue.node, "GL702", issue.message,
                witness=(
                    f"encode_frame call at "
                    f"{issue.rel_path}:{issue.node.lineno}",
                ),
            )

    # ── GL703: payload keys ─────────────────────────────────────────────

    def _check_payload_keys(self, model, emit) -> None:
        by_event_sites: dict = {}
        for site in model.send_sites:
            by_event_sites.setdefault(site.event, []).append(site)
        by_event_regs: dict = {}
        for reg in model.handlers:
            by_event_regs.setdefault(reg.event, []).append(reg)

        for event, sites in sorted(by_event_sites.items()):
            regs = by_event_regs.get(event) or []
            if not regs:
                continue  # GL701 owns unknown events
            producer = set()
            producer_closed = True
            for site in sites:
                producer |= site.keys.all_keys()
                if site.keys.open:
                    producer_closed = False
            consumer_required = set()
            consumer_all = set()
            consumer_closed = True
            for reg in regs:
                consumer_required |= reg.reads.required
                consumer_all |= reg.reads.required | reg.reads.defaulted
                if reg.reads.open:
                    consumer_closed = False

            if producer_closed:
                for key in sorted(consumer_required - producer):
                    site = sites[0]
                    reg = regs[0]
                    emit(
                        site.rel_path, site.node, "GL703",
                        f"event {event!r}: the handler requires payload "
                        f"key {key!r} (subscript read) but no producer "
                        "ever writes it — every send of this event will "
                        "fail at the consumer",
                        witness=(
                            f"producer key set "
                            f"{sorted(producer) or '∅'} at "
                            f"{site.rel_path}:{site.node.lineno}",
                            f"required read of {key!r} by handler in "
                            f"{reg.table} at "
                            f"{reg.rel_path}:{reg.node.lineno}",
                        ),
                    )
            if consumer_closed:
                for site in sites:
                    for key in sorted(
                        site.keys.all_keys() - consumer_all
                    ):
                        reg = regs[0]
                        emit(
                            site.rel_path, site.node, "GL703",
                            f"event {event!r}: payload key {key!r} is "
                            "written here but no handler ever reads it "
                            "— dead weight on every frame (or a "
                            "misspelled key the consumer misses)",
                            witness=(
                                f"producer writes {key!r} at "
                                f"{site.rel_path}:{site.node.lineno}",
                                f"consumer key set "
                                f"{sorted(consumer_all) or '∅'} in "
                                f"{reg.table} at "
                                f"{reg.rel_path}:{reg.node.lineno}",
                            ),
                        )

    # ── GL704: lifecycle hygiene ────────────────────────────────────────

    def _check_lifecycle(self, graph, model, spec, mods, emit) -> None:
        import ast

        lifecycle_rels = {t.rel_path for t in model.transitions}
        for rel in sorted(lifecycle_rels):
            mod = mods.get(rel)
            if mod is None:
                continue
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Raise) or node.exc is None:
                    continue
                exc = node.exc
                target = exc.func if isinstance(exc, ast.Call) else exc
                from pygrid_tpu_torch.analysis.graph import dotted

                path = dotted(target)
                if path is None:
                    continue
                cls = graph.resolve_class(rel, path)
                if cls is not None:
                    if graph.is_subclass_of(cls, "PyGridError"):
                        continue
                    why = f"{path} does not subclass PyGridError"
                elif path.split(".")[-1] in _BUILTIN_ERRORS:
                    why = f"{path} is a builtin exception"
                else:
                    continue  # unresolvable — stay conservative
                emit(
                    rel, node, "GL704",
                    f"lifecycle module raises untyped {path} — every "
                    "reject path must answer a typed PyGridError the "
                    "peer can dispatch on",
                    witness=(
                        f"raise {path} at {rel}:{node.lineno}",
                        why,
                    ),
                )

        # every non-terminal spec state needs an exit (spec-internal,
        # but only judged for machines this scan anchored in code)
        machines = {t.machine for t in model.transitions}
        lifecycle = (spec or {}).get("lifecycle") or {}
        for machine in sorted(machines & set(lifecycle)):
            mspec = lifecycle.get(machine) or {}
            states = mspec.get("states") or {}
            outgoing = {
                t.get("from")
                for t in (mspec.get("transitions") or ())
            }
            anchor = next(
                t for t in model.transitions if t.machine == machine
            )
            for state, meta in sorted(states.items()):
                if (meta or {}).get("terminal"):
                    continue
                if state not in outgoing:
                    emit(
                        anchor.rel_path, anchor.node, "GL704",
                        f"lifecycle machine {machine!r}: non-terminal "
                        f"state {state!r} has no exit transition in "
                        "docs/wire_protocol.yaml — cycles entering it "
                        "would wedge forever",
                        witness=(
                            f"machine anchored at "
                            f"{anchor.rel_path}:{anchor.node.lineno}",
                            f"spec states: {sorted(states)}",
                        ),
                    )

    # ── GL705: spec round-trip ──────────────────────────────────────────

    def _check_spec_roundtrip(self, model, spec, spec_err, emit) -> None:
        if not model.transitions:
            return  # no lifecycle code in this scan — nothing to pin
        anchor = model.transitions[0]
        if spec_err is not None:
            emit(
                anchor.rel_path, anchor.node, "GL705",
                f"docs/wire_protocol.yaml exists but cannot be used: "
                f"{spec_err}",
                witness=(
                    f"lifecycle code at "
                    f"{anchor.rel_path}:{anchor.node.lineno}",
                ),
            )
            return
        if spec is None:
            emit(
                anchor.rel_path, anchor.node, "GL705",
                "lifecycle transitions exist in code but no "
                "docs/wire_protocol.yaml spec is committed — the "
                "protocol has no regression anchor",
                witness=(
                    f"first transition at "
                    f"{anchor.rel_path}:{anchor.node.lineno}",
                ),
            )
            return

        lifecycle = spec.get("lifecycle") or {}
        machines = {t.machine for t in model.transitions}
        for machine in sorted(machines):
            mspec = lifecycle.get(machine)
            first = next(
                t for t in model.transitions if t.machine == machine
            )
            if mspec is None:
                emit(
                    first.rel_path, first.node, "GL705",
                    f"lifecycle machine {machine!r} extracted from code "
                    "but missing from docs/wire_protocol.yaml",
                    witness=(
                        f"transition to {first.to_state!r} via "
                        f"{first.via}() at "
                        f"{first.rel_path}:{first.node.lineno}",
                    ),
                )
                continue
            spec_pairs = {
                (t.get("to"), t.get("via"))
                for t in (mspec.get("transitions") or ())
            }
            code_pairs = set()
            for t in model.transitions:
                if t.machine != machine:
                    continue
                code_pairs.add((t.to_state, t.via))
                if (t.to_state, t.via) not in spec_pairs:
                    emit(
                        t.rel_path, t.node, "GL705",
                        f"machine {machine!r}: code transition to "
                        f"{t.to_state!r} via {t.via}() is not in "
                        "docs/wire_protocol.yaml — update the spec or "
                        "revert the drift",
                        witness=(
                            f"transition at {t.rel_path}:{t.node.lineno}",
                            f"spec transitions: {sorted(spec_pairs)}",
                        ),
                    )
            for to_state, via in sorted(
                spec_pairs - code_pairs, key=str
            ):
                emit(
                    first.rel_path, first.node, "GL705",
                    f"machine {machine!r}: spec transition to "
                    f"{to_state!r} via {via}() has no code performing "
                    "it — the spec documents a lifecycle the "
                    "implementation lost",
                    witness=(
                        f"machine anchored at "
                        f"{first.rel_path}:{first.node.lineno}",
                        f"code transitions: {sorted(code_pairs)}",
                    ),
                )
            to_states = {t[0] for t in code_pairs}
            for state in sorted((mspec.get("states") or {})):
                if state not in to_states:
                    emit(
                        first.rel_path, first.node, "GL705",
                        f"machine {machine!r}: spec state {state!r} is "
                        "never entered by any extracted transition — "
                        "unanchored documentation",
                        witness=(
                            f"machine anchored at "
                            f"{first.rel_path}:{first.node.lineno}",
                            f"entered states: {sorted(to_states)}",
                        ),
                    )

        # plane handled-event round-trip — only planes this scan saw
        planes = spec.get("planes") or {}
        extracted_planes: dict = {}
        for reg in model.handlers:
            if reg.plane is not None:
                extracted_planes.setdefault(reg.plane, set()).add(
                    reg.event
                )
        for plane, events in sorted(extracted_planes.items()):
            pspec = planes.get(plane)
            if pspec is None:
                continue
            listed = set(pspec.get("handled") or ())
            sample = next(
                r for r in model.handlers
                if r.plane == plane
            )
            for event in sorted(events - listed):
                reg = next(
                    r for r in model.handlers
                    if r.plane == plane and r.event == event
                )
                emit(
                    reg.rel_path, reg.node, "GL705",
                    f"plane {plane!r} handles {event!r} but "
                    "docs/wire_protocol.yaml does not list it — update "
                    "the spec's handled list",
                    witness=(
                        f"registered in {reg.table} at "
                        f"{reg.rel_path}:{reg.node.lineno}",
                    ),
                )
            if not model.tables_open:
                for event in sorted(listed - events):
                    emit(
                        sample.rel_path, sample.node, "GL705",
                        f"docs/wire_protocol.yaml lists {event!r} on "
                        f"plane {plane!r} but no handler registers it "
                        "— the spec documents a handler the "
                        "implementation lost",
                        witness=(
                            f"plane dispatch at "
                            f"{sample.rel_path}:{sample.node.lineno}",
                            f"extracted events: {sorted(events)}",
                        ),
                    )
