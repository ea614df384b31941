"""Open-loop load generation against a real in-process grid — the port's
counterpart of :mod:`pygrid_tpu.storm.loadgen`.

The topology is the integration harness's fake-cluster strategy promoted
to a subsystem: every server is a real app of the port's own web layer on
its own event-loop thread (:class:`pygrid_tpu_torch.web.BackgroundServer`,
bound to a free port), joined over real localhost sockets — node(s), one
network (with its monitor loop at scenario cadence), and sub-aggregator(s)
registered for placement. The nodes hold their tensors on the harness's
``device`` (default ``"cuda"``); the network and the sub-aggregators hold
theirs on the host, as they do everywhere in the port. Traffic is OPEN
loop: each leg's arrival times are a Poisson process derived from the
scenario seed (``random.Random`` seeded with a string — deterministic
across processes, unlike ``hash``), so a replay regenerates the identical
schedule, and the schedule equals the reference's for every (seed, leg).

Legs
----
- ``fl``: a full worker round — authenticate, cycle-request, placement
  lookup, report through the sub-aggregator tree (or direct fallback).
  Executed serially per leg: cycle completion racing is real protocol
  behavior and shows up as typed ``stale`` outcomes, never errors.
- ``generation``: remote autoregressive generation with a shared prompt
  prefix (exercises admission, the paged pool, and the prefix cache).
- ``datacentric``: pointer round trip — send a tensor, search its tag,
  fetch-and-delete.
- ``smpc``: fixed-precision secret sharing across two nodes, one linear
  op, reconstruct.

The harness (:class:`StormHarness`) runs scenario → faults → assertions
and captures a replayable flight-recorder dump (storm/replay.py).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import os
import random
import threading
import time
from typing import Any

import numpy as np
import torch

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.telemetry import recorder
from pygrid_tpu_torch.telemetry import slo as slo_mod

logger = logging.getLogger(__name__)

#: generation model hosted by the topology
GEN_MODEL_ID = "storm-gen"

#: FL model geometry (tiny: the storm measures the protocol plane, not
#: the device plane)
_D, _H, _C, _B = 8, 4, 3, 4


def arrival_times(
    seed: int, leg_index: int, rate_hz: float, start_s: float, stop_s: float
) -> list[float]:
    """Poisson arrival times on the scenario clock. Seeded by a STRING
    (CPython hashes str seeds deterministically, no PYTHONHASHSEED
    dependence) so the schedule is identical in a replay."""
    rng = random.Random(f"storm:{seed}:leg:{leg_index}")
    t = float(start_s)
    out: list[float] = []
    while True:
        t += rng.expovariate(rate_hz)
        if t >= stop_s:
            return out
        out.append(t)


def _host(x: Any) -> np.ndarray:
    """A fetched value as numpy (a pointer's value may come back as a
    tensor on the client's device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class OpRecord:
    leg: str
    index: int
    start_s: float      # scenario clock
    end_s: float
    outcome: str        # ok | busy | stale | rejected | error
    detail: str = ""


class StormTopology:
    """A real grid built to scenario sizes: network + monitor loop,
    node(s) on ``device``, sub-aggregator(s), one hosted FL process per fl
    leg, one served generation bundle. All handles stay in-process so the
    fault plane and the assertions can reach contexts directly.

    The models are the reference's widths: the 8-4-3 MLP at batch 4 and
    the ``TransformerConfig(vocab=37, d_model=16, n_heads=2, n_layers=1,
    d_ff=32, max_len=64)`` transformer. The port draws them from seeded
    ``torch.Generator``s (5 for the MLP, ``scenario.seed`` for the
    transformer), so their values differ from the reference's
    ``jax.random`` draws; no verdict reads them (a generation op checks
    only that tokens came back)."""

    def __init__(self, scenario, device: str | torch.device = "cuda") -> None:
        self.scenario = scenario
        self.device = resolve(device)
        self.network = None
        self.nodes: list = []
        self.subaggs: list = []
        self.fl_names: list[str] = []
        self.fl_blob: bytes | None = None
        self._prev_sync = None

    # ── build ───────────────────────────────────────────────────────────

    def build(self) -> "StormTopology":
        from pygrid_tpu_torch import web
        from pygrid_tpu_torch.federated import tasks
        from pygrid_tpu_torch.network import create_app as create_network_app
        from pygrid_tpu_torch.node import create_app as create_node_app
        from pygrid_tpu_torch.web import client as http
        from pygrid_tpu_torch.worker.subagg import create_subagg_app

        spec = self.scenario
        self._prev_sync = tasks._sync
        tasks.set_sync(True)  # deterministic aggregation inside reports
        self.network = web.BackgroundServer(
            create_network_app(
                "storm-network", monitor_interval=spec.monitor_interval_s
            )
        ).start()
        self.network_ctx.aggregation.ttl_s = spec.agg_ttl_s
        for i in range(spec.nodes):
            server = web.BackgroundServer(
                create_node_app(f"storm-n{i}", device=self.device)
            ).start()
            self.nodes.append(server)
            server.app["node"].address = server.url
            resp = http.post(
                self.network.url + "/join",
                json={
                    "node-id": f"storm-n{i}",
                    "node-address": server.url,
                },
                timeout=10,
            )
            if resp.status_code != 200:
                raise RuntimeError(f"node join failed: {resp.text}")
        # every sub-aggregator fronts node 0 — the FL node — so killing
        # one forces placement onto the survivor (or direct fallback)
        for _ in range(spec.subaggs):
            app = create_subagg_app(
                self.nodes[0].url,
                fanout=8,
                flush_interval=0.2,
                network_url=self.network.url,
                register_interval=0.2,
            )
            server = web.BackgroundServer(app).start()
            self.subaggs.append(server)
            app["subagg"].address = server.url
        self._host_fl()
        self._host_generation()
        return self

    def _host_fl(self) -> None:
        from pygrid_tpu_torch.client import ModelCentricFLClient
        from pygrid_tpu_torch.models import mlp
        from pygrid_tpu_torch.plans import Plan
        from pygrid_tpu_torch.plans.state import serialize_model_params

        params = mlp.init(
            (_D, _H, _C), generator=torch.Generator().manual_seed(5),
            device="cpu",
        )
        plan = Plan(name="training_plan", fn=mlp.training_step)
        plan.build(
            torch.zeros((_B, _D)),
            torch.zeros((_B, _C)),
            torch.tensor(0.1),
            *params,
        )
        rng = np.random.default_rng(self.scenario.seed)
        diff = [
            rng.integers(-3, 4, size=tuple(p.shape)).astype(np.float32)
            for p in params
        ]
        self.fl_blob = serialize_model_params(diff)
        fl_legs = [t for t in self.scenario.traffic if t.leg == "fl"]
        mc = ModelCentricFLClient(self.nodes[0].url, device=self.device)
        try:
            for i, _leg in enumerate(fl_legs):
                name = f"storm-fl-{i}"
                resp = mc.host_federated_training(
                    model=params,
                    client_plans={"training_plan": plan},
                    client_config={
                        "name": name, "version": "1.0",
                        "batch_size": _B, "lr": 0.1, "max_updates": 1,
                    },
                    server_config={
                        "min_workers": 1,
                        "max_workers": 100_000,
                        "min_diffs": 8,
                        "max_diffs": 8,
                        "num_cycles": 10_000,
                        "do_not_reuse_workers_until_cycle": 0,
                        "pool_selection": "random",
                    },
                )
                if resp.get("status") != "success":
                    raise RuntimeError(f"FL hosting failed: {resp}")
                self.fl_names.append(name)
        finally:
            mc.close()

    def _prompt_lens(self) -> tuple[int, ...]:
        """Every prompt length the scenario sends: the generation legs'
        prefix + suffix, the saturate_queue burst's 4 tokens, and the
        longest a request may bring."""
        lens = {self.gen_cfg.max_len, 3, 4}
        for t in self.scenario.traffic:
            if t.leg == "generation":
                lens.add(int(t.params.get("prefix_len", 8))
                         + int(t.params.get("suffix_len", 3)))
        return tuple(sorted(lens))

    def _host_generation(self) -> None:
        from pygrid_tpu_torch.client import DataCentricFLClient
        from pygrid_tpu_torch.models import decode
        from pygrid_tpu_torch.models import transformer as T

        cfg = T.TransformerConfig(
            vocab=37, d_model=16, n_heads=2, n_layers=1, d_ff=32,
            max_len=64,
        )
        self.gen_cfg = cfg
        params = T.init(
            cfg, generator=torch.Generator().manual_seed(self.scenario.seed),
            device="cpu",
        )
        client = DataCentricFLClient(self.nodes[0].url, device=self.device)
        try:
            out = client.serve_model(
                decode.bundle(cfg, params), GEN_MODEL_ID,
                allow_remote_inference=True,
            )
            if not out.get("success"):
                raise RuntimeError(f"serve_model failed: {out}")
            # warm the engine OUTSIDE the scenario clock: admission, the
            # engine build, the first launches (on the card: the cuBLAS
            # handle, the caching allocator's first segments) land here,
            # not in the TTFT window
            client.run_remote_generation(
                GEN_MODEL_ID, np.array([[1, 2, 3]], np.int32), n_new=2
            )
        finally:
            client.close()
        # one remote generation only exercises decode width 1 and one
        # prompt bucket; run every width bucket and the prompt bucket of
        # every length the scenario sends in-process, so the first
        # CONCURRENT ops don't pay first launches inside their TTFT window
        engine = self.nodes[0].app["node"].serving.engines().get(
            GEN_MODEL_ID
        )
        if engine is not None:
            engine.warmup(self._prompt_lens())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ── handles ─────────────────────────────────────────────────────────

    @property
    def network_ctx(self):
        return self.network.app["network"]

    def node_ctx(self, i: int = 0):
        return self.nodes[i].app["node"]

    def subagg_handle(self, i: int = 0):
        return self.subaggs[i].app["subagg"]

    def live_subaggs(self) -> list:
        return [s for s in self.subaggs if s.alive()]

    def close(self) -> None:
        from pygrid_tpu_torch.federated import tasks

        for server in self.subaggs:
            if server.alive():
                try:
                    server.stop()
                except Exception:  # noqa: BLE001 — best-effort teardown
                    logger.exception("subagg stop failed")
        for server in self.nodes:
            try:
                server.stop()
            except Exception:  # noqa: BLE001 — best-effort teardown
                logger.exception("node stop failed")
        if self.network is not None:
            try:
                self.network.stop()
            except Exception:  # noqa: BLE001 — best-effort teardown
                logger.exception("network stop failed")
        if self._prev_sync is not None:
            tasks.set_sync(self._prev_sync)


# ── traffic legs ────────────────────────────────────────────────────────


class TrafficEngine:
    """Executes each leg's precomputed arrival schedule against the
    topology. FL runs serially in its leg thread (protocol ordering);
    the other legs dispatch into a small pool, so arrivals stay open
    loop even when an op stalls on a fault."""

    def __init__(self, topology: StormTopology, t0: float) -> None:
        self.topology = topology
        self.t0 = t0
        self.ops: list[OpRecord] = []
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="storm-op"
        )

    def start(self) -> None:
        spec = self.topology.scenario
        stop_default = spec.duration_s
        for i, leg in enumerate(spec.traffic):
            schedule = arrival_times(
                spec.seed, i, leg.rate_hz, leg.start_s,
                leg.stop_s if leg.stop_s is not None else stop_default,
            )
            thread = threading.Thread(
                target=self._run_leg, args=(i, leg, schedule),
                name=f"storm-leg-{leg.leg}", daemon=True,
            )
            self._threads.append(thread)
            thread.start()

    def join(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        self._pool.shutdown(wait=True)

    def _record(self, rec: OpRecord) -> None:
        with self._lock:
            self.ops.append(rec)
        recorder.note(
            "storm.request", leg=rec.leg, index=rec.index,
            outcome=rec.outcome,
        )

    def _run_leg(self, leg_index: int, leg, schedule: list[float]) -> None:
        op = {
            "fl": self._fl_op,
            "generation": self._generation_op,
            "datacentric": self._datacentric_op,
            "smpc": self._smpc_op,
        }[leg.leg]
        serial = leg.leg == "fl"
        for k, at in enumerate(schedule):
            delay = self.t0 + at - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            if serial:
                self._execute(op, leg, k)
            else:
                self._pool.submit(self._execute, op, leg, k)

    def _execute(self, op, leg, k: int) -> None:
        start = time.monotonic() - self.t0
        try:
            outcome, detail = op(leg, k)
        except Exception as err:  # noqa: BLE001 — classified below
            outcome, detail = _classify_error(err)
        self._record(
            OpRecord(
                leg=leg.leg, index=k, start_s=start,
                end_s=time.monotonic() - self.t0,
                outcome=outcome, detail=detail,
            )
        )

    # ── the ops ─────────────────────────────────────────────────────────

    def _fl_op(self, leg, k: int) -> tuple[str, str]:
        from pygrid_tpu_torch.client import FLClient
        from pygrid_tpu_torch.worker import lookup_aggregator

        topo = self.topology
        name = topo.fl_names[0]
        node_url = topo.nodes[0].url
        client = FLClient(node_url, timeout=20.0, device=topo.device)
        try:
            auth = client.authenticate(name, "1.0")
            if auth.get("error"):
                return "error", str(auth["error"])
            wid = auth["worker_id"]
            cyc = client.cycle_request(
                wid, name, "1.0", ping=1.0, download=1000.0, upload=1000.0
            )
            if cyc.get("status") != "accepted":
                return "rejected", str(cyc.get("status"))
            # placement may name a sub-aggregator that died an instant
            # ago — the report falls back to direct, which is exactly
            # the resilience path under test
            client.aggregator_url = lookup_aggregator(
                topo.network.url, node_url, wid
            )
            out = client.report(
                wid, cyc["request_key"], topo.fl_blob, model_name=name
            )
            if out.get("error"):
                return _classify_fl_error(str(out["error"]))
            return "ok", ""
        finally:
            client.close()

    def _gen_prompt(self, leg, k: int) -> np.ndarray:
        """Shared prefix + per-op suffix: op k's prompt is deterministic
        (replay), and every prompt shares ``prefix_len`` leading tokens
        so the prefix cache sees real hits."""
        prefix_len = int(leg.params.get("prefix_len", 8))
        suffix_len = int(leg.params.get("suffix_len", 3))
        rng = random.Random(f"storm:gen:{self.topology.scenario.seed}:{k}")
        vocab = self.topology.gen_cfg.vocab
        prefix = [(3 * i + 1) % vocab for i in range(prefix_len)]
        suffix = [rng.randrange(vocab) for _ in range(suffix_len)]
        return np.array([prefix + suffix], np.int32)

    def _generation_op(self, leg, k: int) -> tuple[str, str]:
        from pygrid_tpu_torch.client import DataCentricFLClient

        client = DataCentricFLClient(
            self.topology.nodes[0].url, device=self.topology.device
        )
        try:
            tokens = client.run_remote_generation(
                GEN_MODEL_ID, self._gen_prompt(leg, k),
                n_new=int(leg.params.get("n_new", 4)),
            )
            if tokens.size == 0:
                return "error", "empty generation"
            return "ok", ""
        finally:
            client.close()

    def _datacentric_op(self, leg, k: int) -> tuple[str, str]:
        from pygrid_tpu_torch.client import DataCentricFLClient

        node = self.topology.nodes[k % len(self.topology.nodes)]
        tag = f"#storm-{k % 5}"
        client = DataCentricFLClient(node.url, device=self.topology.device)
        try:
            ptr = client.send(
                np.arange(4, dtype=np.float32) + k, tags=(tag,)
            )
            found = client.search(tag)
            if not found:
                return "error", "sent tensor not discoverable"
            got = _host(ptr.get())  # fetch-and-delete round trip
            if got.shape != (4,):
                return "error", f"bad pointer round trip: {got.shape}"
            return "ok", ""
        finally:
            client.close()

    def _smpc_op(self, leg, k: int) -> tuple[str, str]:
        from pygrid_tpu_torch.client import DataCentricFLClient
        from pygrid_tpu_torch.smpc import fix_prec_share_to_nodes

        topo = self.topology
        if len(topo.nodes) < 2:
            return "rejected", "smpc leg needs >= 2 nodes"
        clients = [
            DataCentricFLClient(n.url, device=topo.device)
            for n in topo.nodes[:2]
        ]
        try:
            x = np.array([float(k), 2.5])
            y = np.array([1.0, -0.5])
            sx = fix_prec_share_to_nodes(x, clients, device=topo.device)
            sy = fix_prec_share_to_nodes(y, clients, device=topo.device)
            got = _host((sx + sy).get())
            if not np.allclose(got, x + y, atol=1e-3):
                return "error", f"smpc reconstruction off: {got}"
            return "ok", ""
        finally:
            for c in clients:
                c.close()


def _classify_error(err: Exception) -> tuple[str, str]:
    msg = str(err)
    low = msg.lower()
    if "busy" in low or "queue full" in low or "exhausted" in low:
        return "busy", msg
    return "error", f"{type(err).__name__}: {msg}"


def _classify_fl_error(msg: str) -> tuple[str, str]:
    """Typed cycle-protocol rejections are expected open-loop outcomes
    (a report can always race cycle completion); anything else is a
    real failure."""
    low = msg.lower()
    if (
        "request key" in low
        or "cycle not found" in low
        or "already reported" in low
        or "no process" in low
    ):
        return "stale", msg
    return "error", msg


# ── watcher ─────────────────────────────────────────────────────────────


class ReactionWatcher:
    """Samples the system's *reaction surface* at monitor cadence: node
    SLO statuses (driving ``evaluate`` so transitions are detected even
    when nobody scrapes), network proxy statuses, and live placement.
    The timeline is what the reaction assertions read."""

    def __init__(self, topology: StormTopology, t0: float,
                 interval_s: float) -> None:
        self.topology = topology
        self.t0 = t0
        self.interval_s = interval_s
        self.timeline: list[dict] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="storm-watcher", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)

    def samples(self) -> list[dict]:
        with self._lock:
            return list(self.timeline)

    def _run(self) -> None:
        while not self._stop.is_set():
            sample: dict[str, Any] = {
                "t_s": time.monotonic() - self.t0,
            }
            try:
                rows = self.topology.node_ctx(0).slo.evaluate()
                sample["slo"] = {r["name"]: r["status"] for r in rows}
            except Exception as err:  # noqa: BLE001 — sampled surface
                sample["slo_error"] = repr(err)
            try:
                ctx = self.topology.network_ctx
                sample["proxies"] = {
                    node_id: {
                        "status": proxy.status,
                        "degraded": proxy.degraded,
                    }
                    for node_id, proxy in dict(ctx.proxies).items()
                }
                sample["placement"] = [
                    e.subagg_id for e in ctx.aggregation.live()
                ]
            except Exception as err:  # noqa: BLE001 — sampled surface
                sample["network_error"] = repr(err)
            with self._lock:
                self.timeline.append(sample)
            self._stop.wait(self.interval_s)


# ── the harness ─────────────────────────────────────────────────────────


@dataclasses.dataclass
class StormReport:
    scenario: dict
    verdicts: list
    metrics: dict
    dump_path: str | None

    @property
    def ok(self) -> bool:
        return all(v.ok for v in self.verdicts)


class StormHarness:
    """One scenario end to end: env → topology → traffic + faults →
    reaction assertions → replayable flight dump → teardown. The env
    and module-level fault state are restored even on failure, so a
    storm can run inside the tier-1 pytest process without leaking
    knobs into later tests. The nodes run on ``device`` (default
    ``"cuda"``; without a GPU that raises unless ``device="cpu"``)."""

    def __init__(self, scenario, device: str | torch.device = "cuda") -> None:
        self.scenario = scenario.validate()
        self.device = resolve(device)

    def run(self) -> StormReport:
        from pygrid_tpu_torch.client import ws_transport
        from pygrid_tpu_torch.storm.assertions import run_checks
        from pygrid_tpu_torch.storm.faults import FaultInjector

        spec = self.scenario
        saved_env = {
            k: os.environ.get(k) for k in spec.env
        }
        os.environ.update({k: str(v) for k, v in spec.env.items()})
        topology = None
        try:
            topology = StormTopology(spec, self.device)
            topology.build()
            recorder.note(
                "storm.start", scenario=spec.name, seed=spec.seed
            )
            t0 = time.monotonic()
            watcher = ReactionWatcher(
                topology, t0, interval_s=spec.monitor_interval_s
            )
            injector = FaultInjector(topology, spec, t0)
            traffic = TrafficEngine(topology, t0)
            watcher.start()
            injector.start()
            traffic.start()
            traffic.join(timeout=spec.duration_s + 60.0)
            injector.join(timeout=spec.duration_s + 30.0)
            remaining = t0 + spec.duration_s - time.monotonic()
            if remaining > 0:
                time.sleep(remaining)
            time.sleep(spec.settle_s)  # drain + recovery transitions
            watcher.stop()
            verdicts = run_checks(
                spec, topology, traffic.ops, injector,
                watcher.samples(),
            )
            metrics = self._metrics(traffic.ops, injector, topology)
            dump_path = recorder.dump(
                f"storm-{spec.name}",
                snapshot={
                    "storm": {
                        "scenario": spec.to_dict(),
                        "verdicts": [
                            dataclasses.asdict(v) for v in verdicts
                        ],
                        "metrics": metrics,
                    }
                },
                force=True,
            )
            return StormReport(
                scenario=spec.to_dict(),
                verdicts=verdicts,
                metrics=metrics,
                dump_path=dump_path,
            )
        finally:
            slo_mod.clear_fault()
            ws_transport.CHAOS_HOOK = None
            if topology is not None:
                topology.close()
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    @staticmethod
    def _metrics(ops, injector, topology) -> dict:
        by_leg: dict[str, dict[str, int]] = {}
        for rec in ops:
            leg = by_leg.setdefault(rec.leg, {})
            leg[rec.outcome] = leg.get(rec.outcome, 0) + 1
        return {
            "ops": by_leg,
            "faults": [
                {k: v for k, v in ev.items() if k != "applied_mono"}
                for ev in injector.events
            ],
            "ledger": topology.node_ctx(0).serving.ledger(),
            "transitions": topology.node_ctx(0).slo.transitions(),
        }
