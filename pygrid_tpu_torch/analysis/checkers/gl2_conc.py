"""GL2 whole-program concurrency analysis — gridconc.

The per-class GL2 rules (gl2_locks.py) see one class at a time; this
checker rides the shared whole-program graph
(:mod:`pygrid_tpu_torch.analysis.graph`) to see the process: per-engine
device worker threads, the bounded WS handler pool, the daemon
telemetry/SLO/webhook threads, sub-aggregator fold locks, and the
aiohttp event loop all share state across module boundaries.

- **GL204** cross-module lock-order cycles. Lock identity is canonical
  ``(owner class, attr)`` (module-level locks: ``(file, <module>,
  name)``) and HELD SETS PROPAGATE THROUGH THE CALL GRAPH: a
  CycleManager method that calls ``telemetry.incr`` while holding
  ``_accum_lock`` creates the edge ``CycleManager._accum_lock →
  TelemetryBus._lock`` even though the acquisition is three modules
  away. A cycle in the resulting graph is a deadlock waiting for the
  right interleaving. Cycles entirely inside one class with no call
  hop are GL201's (reported there, not twice).
- **GL205** blocking/heavy work while a lock is held — the GL301–303
  pattern set plus the serde/frame-codec family, weighted by inferred
  execution domain: a lock-held blocking call reachable from the
  EVENT LOOP stalls every socket the process serves (error wording);
  on a worker/daemon/executor domain it stalls every thread that
  wants the lock (lock-hold latency). Condition ``wait()`` is not in
  the set (it releases the lock); the caller-holds-the-lock
  conventions (``*_locked``, "Under the lock" docstrings) count as
  held.
- **GL206** cross-domain mutation: a ``self._x`` written from ≥ 2
  inferred execution domains (loop / thread / daemon / executor) with
  no common lock across the write sites. Functions with no inferred
  domain contribute nothing (unreached code must not fabricate
  races); ``__init__`` is construction and exempt. When every write
  site holds *some* lock the rule still fires if the concrete held
  sets share no common lock (two locks guarding one attr is not
  protection); sites holding only the caller-held sentinel err quiet.
"""

from __future__ import annotations

import ast
from typing import Iterable

from pygrid_tpu_torch.analysis.core import Checker, Finding
from pygrid_tpu_torch.analysis.graph import (
    SENTINEL_HELD,
    FunctionNode,
    ProgramGraph,
    pretty_lock,
)

#: propagation fuel: (function, heldset) pairs visited per run — a
#: backstop far above anything a real repo produces, so pathological
#: fixtures cannot hang the gate
_MAX_VISITS = 200_000


def _concrete(held: frozenset) -> frozenset:
    return frozenset(l for l in held if l[2] != SENTINEL_HELD)


class ConcurrencyGraphChecker(Checker):
    name = "GL2"
    description = (
        "whole-program lock graph + domain-weighted lock-hold analysis"
    )
    codes = {
        "GL204": "cross-module lock-acquisition-order cycle (potential "
        "deadlock)",
        "GL205": "blocking/heavy call while a lock is held (lock-hold "
        "latency; event-loop stall when loop-reachable)",
        "GL206": "state written from ≥2 execution domains with no common "
        "lock",
    }

    def finalize(self, run) -> Iterable[Finding]:
        graph: ProgramGraph = run.graph()
        mods = {m.rel_path: m for m in run.modules}
        findings: list[Finding] = []
        findings.extend(self._lock_graph(graph, mods))
        findings.extend(self._cross_domain(graph, mods))
        return findings

    # ── GL204 + GL205: propagate held sets through the call graph ──────

    def _lock_graph(self, graph: ProgramGraph, mods) -> list[Finding]:
        findings: list[Finding] = []
        #: held lock -> {acquired lock: (mod, site node, provenance)}
        edges: dict[tuple, dict[tuple, tuple]] = {}
        #: (path, line, lock) GL205 sites already reported
        blocked_seen: set[tuple] = set()

        def _mod(rel):
            return mods.get(rel)

        def _note_blocking(
            fn: FunctionNode, site, held: frozenset, root: FunctionNode,
            chain: tuple = (),
        ) -> None:
            mod = _mod(fn.rel_path)
            if mod is None or not held:
                return
            locks = sorted(pretty_lock(l) for l in _concrete(held))
            if not locks:
                # only the caller-held sentinel: still a held lock
                locks = ["<caller-held lock>"]
            # one finding per blocking line, however many holders reach
            # it — the fix (move the work out / executor) is the same
            key = (fn.rel_path, site.node.lineno)
            if key in blocked_seen:
                return
            blocked_seen.add(key)
            domains = sorted(graph.domains_of(root.key))
            if "loop" in domains:
                weight = (
                    "EVENT-LOOP STALL — the holder is reachable from the "
                    "event loop"
                )
            elif domains:
                weight = (
                    f"lock-hold latency on the {'/'.join(domains)} domain"
                )
            else:
                weight = "lock-hold latency"
            via = (
                ""
                if root is fn
                else f" (held by '{root.pretty}' through the call graph)"
            )
            findings.append(
                mod.finding(
                    "GL205",
                    site.node,
                    f"{site.msg} while holding {', '.join(locks)}"
                    f"{via} — {weight}; move the heavy work outside "
                    "the lock or hand it to an executor",
                    witness=chain
                    + (
                        f"blocking call in {fn.pretty} at "
                        f"{fn.rel_path}:{site.node.lineno}",
                    ),
                )
            )

        def _note_edges(
            fn: FunctionNode, acq, held: frozenset, provenance: str
        ) -> None:
            mod = _mod(fn.rel_path)
            if mod is None:
                return
            for h in _concrete(held):
                if h == acq.lock and not acq.reentrant:
                    continue  # GL203's self-deadlock, owned there
                if h != acq.lock:
                    edges.setdefault(h, {}).setdefault(
                        acq.lock, (mod, acq.node, provenance)
                    )

        # direct (single-body) edges + direct blocking-under-lock
        for fn in graph.functions.values():
            for acq in fn.acquires:
                _note_edges(fn, acq, acq.held_before, "direct")
            for site in fn.blocking:
                if site.held:
                    _note_blocking(
                        fn, site, site.held, fn,
                        chain=(
                            "lock held in "
                            f"{fn.pretty} ({fn.rel_path})",
                        ),
                    )

        # call-propagated: BFS carrying (callee, held, root holder) plus
        # the witness call chain --explain renders
        seen: set[tuple] = set()
        frontier: list[tuple[tuple, frozenset, FunctionNode, tuple]] = []
        for fn in graph.functions.values():
            for call in fn.calls:
                if not call.held:
                    continue
                locks = sorted(
                    pretty_lock(l) for l in _concrete(call.held)
                ) or ["<caller-held lock>"]
                step = (
                    f"{fn.pretty} holds {', '.join(locks)} and calls "
                    f"into it at {fn.rel_path}:{call.node.lineno}"
                )
                for target in call.targets:
                    frontier.append((target, call.held, fn, (step,)))
        while frontier and len(seen) < _MAX_VISITS:
            key, held, root, chain = frontier.pop()
            state = (key, held)
            if state in seen:
                continue
            seen.add(state)
            fn = graph.functions.get(key)
            if fn is None:
                continue
            for acq in fn.acquires:
                _note_edges(
                    fn, acq, held, "call",
                )
            for site in fn.blocking:
                _note_blocking(fn, site, held | site.held, root, chain)
            for call in fn.calls:
                new_held = held | call.held
                step = (
                    f"which calls {call.dotted}() at "
                    f"{fn.rel_path}:{call.node.lineno}"
                )
                next_chain = (
                    chain + (step,) if len(chain) < 12 else chain
                )
                for target in call.targets:
                    frontier.append(
                        (target, frozenset(new_held), root, next_chain)
                    )

        # cycle detection over the merged edge graph; single-class
        # all-direct cycles belong to GL201
        color: dict[tuple, int] = {}
        stack: list[tuple] = []
        reported: set[frozenset] = set()

        def _dfs(lock: tuple) -> None:
            color[lock] = 1
            stack.append(lock)
            for nxt, (mod, site, provenance) in edges.get(
                lock, {}
            ).items():
                if color.get(nxt, 0) == 1:
                    cycle = stack[stack.index(nxt):] + [nxt]
                    key = frozenset(cycle)
                    if key not in reported:
                        reported.add(key)
                        owners = {(c[0], c[1]) for c in cycle}
                        provenances = {
                            edges[a][b][2]
                            for a, b in zip(cycle, cycle[1:])
                            if b in edges.get(a, {})
                        }
                        # one owner + no call hop = GL201 territory
                        if len(owners) > 1 or "call" in provenances:
                            pretty = " -> ".join(
                                pretty_lock(c) for c in cycle
                            )
                            witness = tuple(
                                f"{pretty_lock(a)} -> {pretty_lock(b)} "
                                f"acquired at "
                                f"{edges[a][b][0].rel_path}:"
                                f"{edges[a][b][1].lineno} "
                                f"({edges[a][b][2]} edge)"
                                for a, b in zip(cycle, cycle[1:])
                                if b in edges.get(a, {})
                            )
                            findings.append(
                                mod.finding(
                                    "GL204",
                                    site,
                                    "cross-module lock-order cycle: "
                                    f"{pretty} (deadlock under "
                                    "contention; edges follow the "
                                    "whole-program call graph)",
                                    witness=witness,
                                )
                            )
                elif color.get(nxt, 0) == 0:
                    _dfs(nxt)
            stack.pop()
            color[lock] = 2

        for lock in list(edges):
            if color.get(lock, 0) == 0:
                _dfs(lock)
        return findings

    # ── GL206: cross-domain unlocked mutation ──────────────────────────

    def _cross_domain(self, graph: ProgramGraph, mods) -> list[Finding]:
        findings: list[Finding] = []
        #: (class key, attr) -> list[(fn, site, domains)]
        writes: dict[tuple, list] = {}
        for fn in graph.functions.values():
            if fn.class_name is None or not fn.mutations:
                continue
            method = fn.qualname.rsplit(".", 1)[-1]
            if method in ("__init__", "__post_init__", "__new__"):
                continue  # construction is single-threaded by definition
            domains = graph.domains_of(fn.key)
            if not domains:
                continue  # unreached code must not fabricate races
            cls_key = (fn.rel_path, fn.class_name)
            if cls_key not in graph.classes:
                continue
            for site in fn.mutations:
                writes.setdefault((cls_key, site.attr), []).append(
                    (fn, site, domains)
                )
        for (cls_key, attr), sites in sorted(
            writes.items(), key=lambda kv: (kv[0][0][0], kv[0][1], kv[0][0][1])
        ):
            domains_union = set()
            for _fn, _site, domains in sites:
                domains_union |= domains
            if len(domains_union) < 2:
                continue
            unlocked = [
                (fn, site) for fn, site, _d in sites if not site.held
            ]
            if not unlocked:
                # every write holds SOME lock (possibly the caller-held
                # sentinel): common-lock analysis only over concrete
                # held sets; sentinel sites err quiet
                concrete_sites = [
                    (fn, site, _concrete(site.held))
                    for fn, site, _d in sites
                    if _concrete(site.held)
                ]
                if len(concrete_sites) < 2:
                    continue
                common = frozenset.intersection(
                    *(held for _fn, _site, held in concrete_sites)
                )
                if common:
                    continue
                witness_fn, witness, _held = concrete_sites[0]
            else:
                witness_fn, witness = unlocked[0]
            mod = mods.get(witness_fn.rel_path)
            if mod is None:
                continue
            by_domain = []
            for d in sorted(domains_union):
                holders = sorted(
                    {
                        fn.qualname
                        for fn, _site, doms in sites
                        if d in doms
                    }
                )[:2]
                by_domain.append(f"{d} via {', '.join(holders)}")
            findings.append(
                mod.finding(
                    "GL206",
                    witness.node,
                    f"'{cls_key[1]}.{attr}' is written from "
                    f"{len(domains_union)} execution domains "
                    f"({'; '.join(by_domain)}) with no common lock — "
                    "cross-domain race; guard every writer with one "
                    "lock or confine the state to one domain",
                )
            )
        return findings
