"""The port's worker app (pygrid_tpu_torch.worker): the placement policy's
cooldown (the cases of ``tests/unit/test_worker_routing.py``),
``run_worker(device="cpu")`` completing cycles against a port node — with
half of the reports riding a sub-aggregator that the network placed — and
the sub-aggregator tree (``worker/subagg.py``): a tree checkpoint equal to
flat FedAvg bit for bit on integer-valued diffs (those of
``tests/integration/test_hier_aggregation.py``), the tail flush driven by
an injected clock, registration and heartbeat loss on a port network, and
both crossings of the stacks (a port sub-aggregator in front of a JAX node,
a JAX one in front of a port node). Nothing waits out a timer: flushes run
on fanout or on an advanced clock, registration is an event, and a dead
registration expires on an advanced clock."""

from __future__ import annotations

import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from pygrid_tpu.client import ModelCentricFLClient as JModelCentricFLClient
from pygrid_tpu.federated import tasks as jtasks
from pygrid_tpu.node import create_app as j_create_node
from pygrid_tpu.worker.subagg import create_subagg_app as j_create_subagg
from pygrid_tpu_torch import web
from pygrid_tpu_torch import worker as W
from pygrid_tpu_torch.client import FLClient, ModelCentricFLClient
from pygrid_tpu_torch.client.fl_client import FLJob
from pygrid_tpu_torch.federated import tasks
from pygrid_tpu_torch.network import create_app as create_network
from pygrid_tpu_torch.node import create_app as create_node
from pygrid_tpu_torch.plans.state import serialize_model_params
from pygrid_tpu_torch.worker import AggregatorSelector, lookup_aggregator, run_worker
from pygrid_tpu_torch.worker.subagg import create_subagg_app
from test_torch_network import restore_process_state  # noqa: F401 (an autouse fixture)
from test_torch_web import AioServer

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent.parent / "pygrid_tpu_torch" / "plans" / "fixtures"
PLAN = (FIXTURES / "mlp_training_plan.bin").read_bytes()  # JAX-built, 784-392-10, batch 64
SHAPES = ((784, 392), (392,), (392, 10), (10,))
B = 64


# --------------------------------------------------------------------------
# the placement policy (tests/unit/test_worker_routing.py's cases)
# --------------------------------------------------------------------------


def test_choose_passes_fresh_address_through():
    sel = AggregatorSelector(cooldown_s=30.0)
    assert sel.choose("http://subagg-1", now=100.0) == "http://subagg-1"
    assert sel.choose(None, now=100.0) is None


def test_failed_address_cools_down_then_recovers():
    sel = AggregatorSelector(cooldown_s=30.0)
    sel.mark_failed("http://subagg-1", now=100.0)
    assert sel.choose("http://subagg-1", now=110.0) is None
    assert sel.choose("http://subagg-1", now=129.9) is None
    assert sel.choose("http://subagg-2", now=110.0) == "http://subagg-2"
    assert sel.choose("http://subagg-1", now=130.1) == "http://subagg-1"
    assert sel.choose("http://subagg-1", now=131.0) == "http://subagg-1"


def test_cooldown_env_knob_fallback(monkeypatch):
    monkeypatch.setenv("PYGRID_AGG_RETRY_COOLDOWN_S", "5")
    assert AggregatorSelector().cooldown_s == 5.0
    monkeypatch.setenv("PYGRID_AGG_RETRY_COOLDOWN_S", "not-a-number")
    assert AggregatorSelector().cooldown_s == 30.0


def test_report_redials_when_placement_changes(monkeypatch):
    dialed, closed = [], []

    class _FakeWS:
        def __init__(self, url, **kw):
            self.url = url
            dialed.append(url)

        def send_msg_binary(self, *a, **kw):
            return {"data": {"status": "ok", "via": self.url}}

        def close(self):
            closed.append(self.url)

    monkeypatch.setattr("pygrid_tpu_torch.client.fl_client.GridWSClient", _FakeWS)
    client = FLClient.__new__(FLClient)
    client.aggregator_url = "ws://subagg-a"
    client._agg_ws = None
    client._agg_ws_url = None
    client._timeout = 5
    assert client._report_via_aggregator("w1", "key", b"diff", "m")["via"] == "ws://subagg-a"
    client._report_via_aggregator("w1", "key", b"diff", "m")
    assert dialed == ["ws://subagg-a"]
    client.aggregator_url = "ws://subagg-b"
    assert client._report_via_aggregator("w1", "key", b"diff", "m")["via"] == "ws://subagg-b"
    assert dialed == ["ws://subagg-a", "ws://subagg-b"] and closed == ["ws://subagg-a"]


def test_run_worker_resets_aggregator_url_each_cycle(monkeypatch):
    events = []

    class _FakeJob:
        EVENT_ACCEPTED, EVENT_REJECTED, EVENT_ERROR = "accepted", "rejected", "error"

        def __init__(self):
            self.diff_precision = self.diff_compression = None

        def add_listener(self, name, fn):
            pass

        def start(self):
            events.append("start")

    class _FakeClient:
        def __init__(self, *a, **kw):
            self.aggregator_url = "http://stale-subagg"
            events.append(("device", str(kw["device"])))

        def new_job(self, *a, **kw):
            events.append(("url-at-new-job", self.aggregator_url))
            return _FakeJob()

        def close(self):
            pass

    monkeypatch.setattr("pygrid_tpu_torch.client.fl_client.FLClient", _FakeClient)
    W.run_worker("http://node", "model", cycles=2, device="cpu")
    assert events == [("device", "cpu"), ("url-at-new-job", None), "start",
                      ("url-at-new-job", None), "start"]


def test_default_data_fn_and_cli_flags():
    X, y = W.default_data_fn(8)
    assert X.shape == (8, 784) and X.dtype == np.float32
    assert y.shape == (8, 10) and (y.sum(axis=1) == 1).all()
    import pygrid_tpu_torch.worker.__main__ as cli

    seen = {}
    orig = W.run_worker

    def fake(*a, **kw):
        seen.update(kw, node=a[0])
        return W.WorkerResult(accepted=1)

    W.run_worker = fake
    try:
        assert cli.main(["--node", "http://n", "--device", "cpu", "--wire", "bf16",
                         "--compress", "topk:0.5"]) == 0
    finally:
        W.run_worker = orig
    assert seen["device"] == "cpu" and seen["wire"] == "binary"
    assert seen["diff_precision"] == "bf16"
    assert seen["diff_compression"] == {"name": "topk", "fraction": 0.5}
    with pytest.raises(SystemExit):
        cli.main(["--node", "http://n", "--compress", "gzip:1"])


# --------------------------------------------------------------------------
# grids
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sync_aggregation():
    prev = (jtasks._sync, tasks._sync)
    jtasks.set_sync(True)
    tasks.set_sync(True)
    yield
    jtasks.set_sync(prev[0])
    tasks.set_sync(prev[1])


@pytest.fixture(scope="module")
def nodes(sync_aggregation):
    """A port node and a JAX node."""
    port = web.BackgroundServer(create_node("port-node", device="cpu")).start()
    with AioServer(j_create_node("jax-node")) as jax_url:
        yield {"port": port.url, "jax": jax_url}
    port.stop()


def _params(seed=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.1, s).astype(np.float32) for s in SHAPES]


def _host(url, stack, name, n_workers, params=None):
    params = _params() if params is None else params
    mc = (ModelCentricFLClient(url, device="cpu") if stack == "port"
          else JModelCentricFLClient(url))
    resp = mc.host_federated_training(
        model=params, client_plans={"training_plan": PLAN},
        client_config={"name": name, "version": "1.0", "batch_size": B, "lr": 0.005,
                       "max_updates": 1},
        server_config={"min_workers": n_workers, "max_workers": n_workers,
                       "min_diffs": n_workers, "max_diffs": n_workers, "num_cycles": 1,
                       "do_not_reuse_workers_until_cycle": 0, "pool_selection": "random"})
    assert resp.get("status") == "success", resp
    mc.close()
    return params


def _integer_diffs(n):
    """Integer-valued f32 diffs: exact in any f64 fold order, so the tree's
    checkpoint must equal the flat one bit for bit."""
    rng = np.random.default_rng(11)
    return [[rng.integers(-3, 4, size=s).astype(np.float32) for s in SHAPES] for _ in range(n)]


def _report_round(url, name, diffs, aggregator_url=None):
    for i, diff in enumerate(diffs):
        client = FLClient(url, timeout=30.0, device="cpu")
        try:
            wid = client.authenticate(name, "1.0")["worker_id"]
            cyc = client.cycle_request(wid, name, "1.0", ping=1.0, download=1000.0,
                                       upload=1000.0)
            assert cyc.get("status") == "accepted", (i, cyc)
            client.aggregator_url = aggregator_url
            out = client.report(wid, cyc["request_key"], serialize_model_params(diff),
                                model_name=name)
            assert not out.get("error"), (i, out)
        finally:
            client.close()


def _latest(url, name):
    mc = ModelCentricFLClient(url, device="cpu")
    try:
        return [np.asarray(p.cpu()) for p in mc.retrieve_model(name, "1.0")]
    finally:
        mc.close()


def _port_subagg(node_url, **kw):
    server = web.BackgroundServer(create_subagg_app(node_url, **kw)).start()
    server.app["subagg"].address = server.url
    return server


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# --------------------------------------------------------------------------
# the sub-aggregator tree
# --------------------------------------------------------------------------


def test_tree_checkpoint_equals_flat_fedavg(nodes):
    """Six workers, fanout 3, on a port node: the count-1 eligibility probe,
    one fanout-triggered flush and a tail of two flushed when the injected
    clock says the fold is stale. The tree checkpoint equals the flat one
    bit for bit."""
    url, n = nodes["port"], 6
    params = _host(url, "port", "tree-flat", n)
    _host(url, "port", "tree-tree", n, params)
    diffs = _integer_diffs(n)
    _report_round(url, "tree-flat", diffs)
    flat = _latest(url, "tree-flat")

    clock = Clock()
    server = _port_subagg(url, fanout=3, flush_interval=0.5, clock=clock)
    agg = server.app["subagg"]
    try:
        _report_round(url, "tree-tree", diffs, aggregator_url=server.url)
        stats = agg.stats()
        assert stats["reports"] == n and stats["leaves_forwarded"] == 4, stats
        assert stats["buffered"] == {"tree-tree": 2}
        agg.flush_stale()  # the clock has not moved: the tail is not stale yet
        assert agg.stats()["leaves_forwarded"] == 4
        clock.t += 0.5
        agg.flush_stale()
        stats = agg.stats()
        assert stats["leaves_forwarded"] == n and stats["buffered"] == {}, stats
        assert stats["flushes"] == 3 and stats["flush_errors"] == 0, stats
        tree = _latest(url, "tree-tree")
    finally:
        server.stop()
    for a, b, p in zip(flat, tree, params):
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, p)  # the cycle moved the params


@pytest.mark.parametrize("node_stack, subagg_stack", [("jax", "port"), ("port", "jax")])
def test_subaggregator_across_the_stacks(nodes, node_stack, subagg_stack):
    """A port sub-aggregator in front of a JAX node, and a JAX one in front
    of a port node: probe + a fanout-3 fold, the checkpoint bit-identical
    to the same diffs reported flat to the same node."""
    url, n = nodes[node_stack], 4
    tag = f"x-{subagg_stack}-on-{node_stack}"
    params = _host(url, node_stack, tag + "-flat", n)
    _host(url, node_stack, tag + "-tree", n, params)
    diffs = _integer_diffs(n)
    _report_round(url, tag + "-flat", diffs)
    if subagg_stack == "port":
        server = _port_subagg(url, fanout=3, flush_interval=3600.0)
        agg_url, stop, agg = server.url, server.stop, server.app["subagg"]
    else:
        app = j_create_subagg(url, fanout=3, flush_interval=3600.0)
        aio = AioServer(app)
        agg_url, stop, agg = aio.__enter__(), (lambda: aio.__exit__(None, None, None)), \
            app["subagg"]
    try:
        _report_round(url, tag + "-tree", diffs, aggregator_url=agg_url)
        stats = agg.stats()
        assert stats["leaves_forwarded"] == n and stats["flushes"] == 2, stats
        assert stats["flush_errors"] == 0
    finally:
        stop()
    for a, b in zip(_latest(url, tag + "-flat"), _latest(url, tag + "-tree")):
        np.testing.assert_array_equal(a, b)


def test_placement_registration_and_heartbeat_loss(nodes):
    """The sub-aggregator registers with a port network (an event, not a
    poll); placement and ``lookup_aggregator`` name it; once it is stopped
    and the registry's injected clock passes the TTL it is no longer
    placed, and a client still holding its address completes the round by
    reporting direct."""
    url = nodes["port"]
    net_clock = Clock()
    network = web.BackgroundServer(create_network("hier-network", monitor_interval=3600)).start()
    registry = network.app["network"].aggregation
    registry.clock = net_clock
    server = _port_subagg(url, network_url=network.url, register_interval=0.05)
    agg = server.app["subagg"]
    try:
        assert agg.registered.wait(15), "the sub-aggregator never registered"
        placed = web.client.get(network.url + "/aggregation/placement",
                                params={"node-address": url, "worker-id": "w-1"},
                                timeout=10).json()
        assert placed == {"report-to": server.url, "subagg-id": agg.id}
        tree = web.client.get(network.url + "/aggregation/tree", timeout=10).json()
        assert [e["id"] for e in tree["nodes"][url]] == [agg.id]
        assert lookup_aggregator(network.url, url, "w-1") == server.url
        assert lookup_aggregator("http://127.0.0.1:1", url, "w-1") is None  # best-effort
        dead = server.url
        server.stop()
        net_clock.t += registry.ttl_s + 1.0
        assert lookup_aggregator(network.url, url, "w-1") is None
        assert registry.sweep() == [agg.id]
        params = _host(url, "port", "hier-fallback", 2)
        diffs = _integer_diffs(2)
        _report_round(url, "hier-fallback", diffs, aggregator_url=dead)
        for got, p, k in zip(_latest(url, "hier-fallback"), params, range(4)):
            mean = (diffs[0][k].astype(np.float64) + diffs[1][k]) / 2
            np.testing.assert_array_equal(got, p - mean.astype(np.float32))
    finally:
        network.stop()


# --------------------------------------------------------------------------
# run_worker against a port node
# --------------------------------------------------------------------------


def _recording_reports(monkeypatch):
    """Wrap FLJob.report to keep each diff (as the node will decode it) and
    the route the report took."""
    seen, lock = [], threading.Lock()
    orig = FLJob.report

    def report(job, diff):
        via = job.client.aggregator_url
        out = orig(job, diff)
        with lock:
            seen.append(([d.detach().cpu().numpy() for d in diff], via))
        return out

    monkeypatch.setattr(FLJob, "report", report)
    return seen


def test_run_worker_completes_cycles_on_a_port_node(nodes, monkeypatch):
    url = nodes["port"]
    params = _host(url, "port", "rw-cycles", 1)
    seen = _recording_reports(monkeypatch)
    old = [np.asarray(p) for p in params]
    result = run_worker(url, "rw-cycles", model_version="1.0", cycles=1, device="cpu")
    assert (result.accepted, result.rejected, result.errors) == (1, 0, [])
    (diff, via), = seen
    assert via is None
    for got, o, d in zip(_latest(url, "rw-cycles"), old, diff):
        np.testing.assert_array_equal(got, o - d)
    # the process ran its one cycle: a further cycle is rejected
    again = run_worker(url, "rw-cycles", model_version="1.0", cycles=1, device="cpu",
                       max_retry_wait=0.0)
    assert again.accepted == 0 and (again.rejected == 1 or again.errors)


def test_threaded_workers_half_through_a_placed_subaggregator(nodes, monkeypatch):
    """Four threaded run_workers on one cycle: two ask the network for
    placement and report through the sub-aggregator it names, two report
    direct. The checkpoint equals old - f32(f64 mean of the diffs)."""
    url, K = nodes["port"], 4
    params = _host(url, "port", "rw-tree", K)
    network = web.BackgroundServer(create_network("rw-network", monitor_interval=3600)).start()
    server = _port_subagg(url, network_url=network.url, fanout=1, register_interval=0.05)
    agg = server.app["subagg"]
    seen = _recording_reports(monkeypatch)
    try:
        assert agg.registered.wait(15)
        results = [None] * K

        def go(i):
            rng = np.random.default_rng(i)

            def data(batch):
                X = rng.uniform(0, 1, (batch, 784)).astype(np.float32)
                return X, np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]

            results[i] = run_worker(url, "rw-tree", model_version="1.0", data_fn=data,
                                    network_url=network.url if i % 2 else None, device="cpu")

        threads = [threading.Thread(target=go, args=(i,)) for i in range(K)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert all(r is not None and r.accepted == 1 and not r.errors for r in results), results
        assert sorted(v is not None for _, v in seen) == [False, False, True, True]
        assert agg.stats()["leaves_forwarded"] == 2
    finally:
        server.stop()
        network.stop()
    for k, (got, o) in enumerate(zip(_latest(url, "rw-tree"), params)):
        mean = sum(d[k].astype(np.float64) for d, _ in seen) / K
        np.testing.assert_array_equal(got, o - mean.astype(np.float32))
