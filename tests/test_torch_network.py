"""The port's Network app (pygrid_tpu_torch.network) over real sockets, with
four port nodes (alice..dan, ``device="cpu"``) joined to it through the
node's ``join_network``: the scenarios of the JAX package's
``tests/integration/test_network_grid.py`` (registry, host choice — the
encrypted one compared as a set, since it samples — the search fan-outs,
``PublicGridNetwork``, the monitor's sweep and the node location it carries,
the RBAC twins, network-driven hosting, ``/metrics``), plus the encrypted
model published over the grid and found by ``EncryptedModel.discover``,
the aggregation placement routes, the WS join/monitor/forward events, the
deep ``/healthz`` under the majority-offline rule, and 20 start/stop cycles
that leak no thread and no socket. Every wait is on a condition, never a
fixed sleep."""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pygrid_tpu import serde as jserde
from pygrid_tpu_torch import serde, web
from pygrid_tpu_torch.client import (
    DataCentricFLClient,
    FLClient,
    ModelCentricFLClient,
    PublicGridNetwork,
)
from pygrid_tpu_torch.client.ws_transport import RawWSClient
from pygrid_tpu_torch.federated import tasks
from pygrid_tpu_torch.models import mlp
from pygrid_tpu_torch.network import NetworkContext
from pygrid_tpu_torch.network import create_app as create_network
from pygrid_tpu_torch.node import create_app as create_node
from pygrid_tpu_torch.node.__main__ import join_network
from pygrid_tpu_torch.plans.state import serialize_model_params
from pygrid_tpu_torch.smpc import EncryptedModel, publish_encrypted_model
from pygrid_tpu_torch.telemetry import promtext
from pygrid_tpu_torch.web import client as http
from test_torch_plans import build_cryptonets_plan, cryptonets_forward
from test_torch_remote_smpc import SMALL, SMALL_ATOL, weights_for

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent.parent / "pygrid_tpu_torch" / "plans" / "fixtures"
NODES = ("alice", "bob", "charlie", "dan")


@pytest.fixture(scope="module", autouse=True)
def restore_process_state():
    """Two things both packages keep per process outlive a module's
    servers: the telemetry buses, which fold a family's 65th label set into
    ``other``, and the node's WebSocket executor pool (``node/ws.py``
    ``_WS_EXECUTOR``, threads named ``pygrid-ws``), which keeps every
    thread it grew. The grids of a module must use up neither for the tests
    that run after it in the same process, so once its servers have stopped
    (module-scoped and autouse, this fixture is set up before them and torn
    down after) each bus is put back as the module found it and each pool
    is replaced by a fresh one of the same size, the old one's threads
    joined."""
    import copy
    import sys
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from pygrid_tpu.telemetry import bus as jbus
    from pygrid_tpu_torch.telemetry import bus as pbus

    def state(b):
        with b._lock:
            return (deque(b._events, maxlen=b._events.maxlen), dict(b._counters),
                    copy.deepcopy(b._histograms), dict(b._labelsets))

    saved = [(b, state(b)) for b in (pbus.BUS, jbus.BUS)]
    yield
    for b, (events, counters, histograms, labelsets) in saved:
        with b._lock:
            b._events, b._counters, b._histograms, b._labelsets = (
                events, counters, histograms, labelsets)
    for name in ("pygrid_tpu.node.ws", "pygrid_tpu_torch.node.ws"):
        ws = sys.modules.get(name)
        if ws is not None:
            old = ws._WS_EXECUTOR
            ws._WS_EXECUTOR = ThreadPoolExecutor(max_workers=old._max_workers,
                                                 thread_name_prefix="pygrid-ws")
            old.shutdown(wait=True)


def wait_for(cond, timeout=15.0, what="condition"):
    """Poll ``cond()`` until it returns a truthy value (returned) or the
    timeout passes (fails)."""
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.02)


def join(server, network_url, node_id=None):
    """The node's own ``join_network``, run on the node's loop as the CLI
    runs it at startup."""
    coro = join_network(network_url, node_id or server.app["node"].id, server.url)
    asyncio.run_coroutine_threadsafe(coro, server.loop).result(30)


class Grid:
    def __init__(self, network, nodes):
        self.network, self.nodes = network, nodes

    @property
    def network_url(self):
        return self.network.url

    def node_url(self, name):
        return self.nodes[name].url


@pytest.fixture(scope="module")
def grid():
    prev = tasks._sync
    tasks.set_sync(True)
    network = web.BackgroundServer(create_network("test-network", monitor_interval=0.2)).start()
    nodes = {}
    for name in NODES:
        nodes[name] = web.BackgroundServer(create_node(name, device="cpu")).start()
        nodes[name].app["node"].address = nodes[name].url
        join(nodes[name], network.url)
    yield Grid(network, nodes)
    for server in nodes.values():
        server.stop()
    network.stop()
    tasks.set_sync(prev)


def _dc(grid, name):
    return DataCentricFLClient(grid.node_url(name), device="cpu")


# --------------------------------------------------------------------------
# the registry and host choice
# --------------------------------------------------------------------------


def test_connected_nodes(grid):
    resp = http.get(grid.network_url + "/connected-nodes", timeout=10)
    assert set(resp.json()["grid-nodes"]) == set(NODES)


def test_join_duplicate_id_conflict(grid):
    resp = http.post(grid.network_url + "/join",
                     json={"node-id": "alice", "node-address": "http://x"}, timeout=10)
    assert resp.status_code == 409


def test_join_invalid_json(grid):
    resp = http.post(grid.network_url + "/join", data="not json", timeout=10)
    assert resp.status_code == 400
    resp = http.post(grid.network_url + "/join", json={"node-id": "x"}, timeout=10)
    assert resp.status_code == 400


def test_delete_node_roundtrip(grid):
    body = {"node-id": "transient", "node-address": "http://127.0.0.1:1"}
    assert http.post(grid.network_url + "/join", json=body, timeout=10).status_code == 200
    assert http.request("DELETE", grid.network_url + "/delete-node", json=body,
                        timeout=10).status_code == 200
    again = http.request("DELETE", grid.network_url + "/delete-node", json=body, timeout=10)
    assert again.status_code == 409
    assert "transient" not in grid.network.app["network"].proxies


def test_choose_model_host(grid):
    hosts = http.get(grid.network_url + "/choose-model-host", timeout=10).json()
    assert len(hosts) == 1
    node_id, address = hosts[0]
    assert node_id in NODES and address == grid.node_url(node_id)


def test_choose_encrypted_model_host(grid):
    """n_replica(1) × SMPC_HOST_CHUNK(4) nodes, sampled: compared as a set."""
    hosts = http.get(grid.network_url + "/choose-encrypted-model-host", timeout=10).json()
    assert len(hosts) == 4
    assert {tuple(h) for h in hosts} == {(n, grid.node_url(n)) for n in NODES}


def test_choose_encrypted_model_host_needs_four_nodes():
    server = web.BackgroundServer(create_network("small", monitor_interval=60)).start()
    try:
        http.post(server.url + "/join", json={"node-id": "a", "node-address": "http://a"},
                  timeout=10)
        resp = http.get(server.url + "/choose-encrypted-model-host", timeout=10)
        assert resp.status_code == 400 and resp.json() == []
    finally:
        server.stop()


# --------------------------------------------------------------------------
# the search fan-outs and PublicGridNetwork
# --------------------------------------------------------------------------


def test_search_dataset_fanout(grid):
    charlie, dan = _dc(grid, "charlie"), _dc(grid, "dan")
    charlie.send(np.ones(4), tags={"#grid-search-x"})
    dan.send(np.zeros(4), tags={"#grid-search-x"})
    resp = http.post(grid.network_url + "/search", json={"query": ["#grid-search-x"]},
                     timeout=15)
    assert {m[0] for m in resp.json()["match-nodes"]} == {"charlie", "dan"}
    bad = http.post(grid.network_url + "/search", json={"q": 1}, timeout=15)
    assert bad.status_code == 400
    charlie.close()
    dan.close()


def test_search_available_tags(grid):
    bob = _dc(grid, "bob")
    bob.send(np.ones(2), tags={"#network-tag-test"})
    resp = http.get(grid.network_url + "/search-available-tags", timeout=15)
    assert "#network-tag-test" in resp.json()["tags"]
    bob.close()


def test_search_available_models_and_search_model(grid):
    bob = _dc(grid, "bob")
    assert bob.serve_model((FIXTURES / "mlp_training_plan.bin").read_bytes(),
                           "network-visible-model")["success"]
    resp = http.get(grid.network_url + "/search-available-models", timeout=15)
    assert "network-visible-model" in resp.json()["models"]
    resp = http.post(grid.network_url + "/search-model",
                     json={"model_id": "network-visible-model"}, timeout=15)
    assert [m[0] for m in resp.json()["match-nodes"]] == ["bob"]
    hosts = http.get(grid.network_url + "/choose-model-host",
                     params={"model_id": "network-visible-model"}, timeout=15).json()
    assert hosts == [["bob", grid.node_url("bob")]]
    bob.close()


def test_public_grid_network_search(grid):
    dan = _dc(grid, "dan")
    dan.send(np.arange(6.0).reshape(2, 3), tags={"#pgn", "#target"})
    network = PublicGridNetwork(grid.network_url, device="cpu")
    results = network.search("#pgn", "#target")
    assert list(results) == ["dan"]
    np.testing.assert_array_equal(results["dan"][0].get(delete=False),
                                  np.arange(6.0).reshape(2, 3))
    assert "#pgn" in network.search_available_tags()
    assert set(network.connected_nodes()) == set(NODES)
    assert len(network.choose_encrypted_model_host()) == 4
    network.close()
    dan.close()


# --------------------------------------------------------------------------
# encrypted inference: publish over the grid, discover through the network
# --------------------------------------------------------------------------


def test_search_encrypted_model_and_discover(grid):
    """The model owner publishes a JAX-built CryptoNets plan with its
    weights shared over alice, bob and charlie and dan dealing; the
    network's fan-out names the share-holders, the provider and their
    addresses, and ``EncryptedModel.discover`` wires them into a model
    whose prediction decodes to the float forward."""
    plan = serde.deserialize(jserde.serialize(build_cryptonets_plan(SMALL, plan_id="net-cn")),
                             device="cpu")
    x, *weights = weights_for(SMALL, seed=3)
    clients = {n: _dc(grid, n) for n in NODES}
    try:
        publish_encrypted_model(plan, "net-emodel", clients["alice"],
                                [clients[n] for n in ("alice", "bob", "charlie")],
                                clients["dan"], weights,
                                generator=torch.Generator().manual_seed(3), device="cpu")
        match = http.post(grid.network_url + "/search-encrypted-model",
                          json={"model_id": "net-emodel"}, timeout=15).json()["match-nodes"]
        assert list(match) == ["alice"]
        assert match["alice"]["address"] == grid.node_url("alice")
        assert set(match["alice"]["nodes"]["workers"]) == {"alice", "bob", "charlie"}
        assert match["alice"]["nodes"]["crypto_provider"] == ["dan"]
        assert match["alice"]["worker_addresses"] == {n: grid.node_url(n) for n in NODES}
        pgn = PublicGridNetwork(grid.network_url, device="cpu")
        assert pgn.search_encrypted_model("net-emodel") == match
        pgn.close()
        bad = http.post(grid.network_url + "/search-encrypted-model", data="{", timeout=15)
        assert bad.status_code == 400

        model = EncryptedModel.discover(grid.network_url, "net-emodel", device="cpu")
        assert [c.id for c in model.holder_clients] == ["alice", "bob", "charlie"]
        assert model.provider.id == "dan" and len(model.weights) == 4
        got = model.predict(x, generator=torch.Generator().manual_seed(4))
        want = cryptonets_forward(x.astype(np.float32).astype(np.float64), *weights)
        assert np.abs(got - want).max() <= SMALL_ATOL
        dialed = list(model._all_clients)
        assert {c.id for c in dialed} == set(NODES)
        model.close()
        for c in dialed:
            assert c.ws._ws is None  # every client discover dialed is closed
        from pygrid_tpu_torch.utils.exceptions import PyGridError

        with pytest.raises(PyGridError, match="no node hosts"):
            EncryptedModel.discover(grid.network_url, "absent-model", device="cpu")
    finally:
        for c in clients.values():
            c.close()


# --------------------------------------------------------------------------
# the monitor
# --------------------------------------------------------------------------


def _statuses(url):
    return http.get(url + "/nodes-status", timeout=10).json()


def test_monitor_marks_nodes_online(grid):
    statuses = wait_for(lambda: (lambda s: s if set(s) >= set(NODES) and all(
        s[n]["status"] == "online" for n in NODES) else None)(_statuses(grid.network_url)),
        what="every node online")
    for n in NODES:
        assert statuses[n]["address"] == grid.node_url(n)
        assert statuses[n]["ping_ms"] is not None and statuses[n]["ping_ms"] >= 0.0


def test_monitor_propagates_node_location(grid, monkeypatch):
    monkeypatch.setenv("NODE_LOCATION", "us-central1-a")
    st = http.get(grid.node_url("alice") + "/data-centric/status/", timeout=10).json()
    assert st["location"] == "us-central1-a"
    wait_for(lambda: any(s.get("location") == "us-central1-a"
                         for s in _statuses(grid.network_url).values()),
             what="the location to propagate")


def test_models_and_datasets_aggregates(grid):
    bob = _dc(grid, "bob")
    bob.send(np.ones(1), tags={"#agg-tag"})
    wait_for(lambda: any("#agg-tag" in d for d in http.get(
        grid.network_url + "/datasets", timeout=10).json()["datasets"]),
        what="the monitor to cache bob's tags")
    assert isinstance(http.get(grid.network_url + "/models", timeout=10).json()["models"], list)
    bob.close()


def test_network_metrics_slo_and_healthz(grid):
    wait_for(lambda: all(s["status"] == "online" for s in _statuses(grid.network_url).values()),
             what="every node online")
    r = http.get(grid.network_url + "/metrics", timeout=10)
    assert r.status_code == 200
    families = promtext.parse(r.text)  # strict: raises on a bad line
    assert "pygrid_grid_nodes_total" in families
    assert "pygrid_grid_nodes_total 4" in r.text
    assert 'pygrid_grid_nodes{status="online"} 4' in r.text
    slo = http.get(grid.network_url + "/telemetry/slo", timeout=10).json()["slo"]
    assert any(row["name"] == "heartbeat_rtt" for row in slo)
    assert http.get(grid.network_url + "/healthz", timeout=10).json() == {"status": "ok"}
    deep = http.get(grid.network_url + "/healthz", params={"deep": "1"}, timeout=10)
    assert deep.status_code == 200 and deep.json()["nodes_offline"] == []
    landing = http.get(grid.network_url + "/", timeout=10).json()
    assert landing == {"network_id": "test-network", "message": "pygrid-tpu network"}


def test_healthz_majority_offline_rule():
    """Deep /healthz answers 503 once more than half the known nodes are
    offline after a sweep, and 200 while at most half are."""
    node = web.BackgroundServer(create_node("live", device="cpu")).start()
    with_dead = {"dead-1": "http://127.0.0.1:1", "dead-2": "http://127.0.0.1:2"}
    network = web.BackgroundServer(create_network("hz", monitor_interval=0.05)).start()
    try:
        ctx = network.app["network"]
        join(node, network.url)
        for nid, addr in with_dead.items():
            assert http.post(network.url + "/join", json={"node-id": nid, "node-address": addr},
                             timeout=10).status_code == 200

        def deep():
            return http.get(network.url + "/healthz", params={"deep": "1"}, timeout=10)

        wait_for(lambda: ctx.proxies["live"].status == "online", what="live online")
        r = deep()
        assert r.status_code == 503 and r.json()["status"] == "breach"
        assert sorted(r.json()["nodes_offline"]) == ["dead-1", "dead-2"]
        assert r.json()["nodes_total"] == 3
        assert http.get(network.url + "/healthz", timeout=10).status_code == 200  # shallow
        # one dead of two known: not a majority
        http.request("DELETE", network.url + "/delete-node",
                     json={"node-id": "dead-2", "node-address": with_dead["dead-2"]}, timeout=10)
        r = wait_for(lambda: (lambda r: r if r.status_code == 200 else None)(deep()),
                     what="deep healthz to recover")
        assert r.json()["nodes_offline"] == ["dead-1"] and r.json()["nodes_total"] == 2
    finally:
        network.stop()
        node.stop()


# --------------------------------------------------------------------------
# the WebSocket events
# --------------------------------------------------------------------------


def test_ws_join_monitor_answer_and_forward(grid):
    """A node joining by socket is monitored by a WS ``monitor`` push and
    its ``monitor-answer`` sets its ping and hosted lists; ``forward``
    routes a payload to a joined socket; a closed socket marks it offline."""
    url = grid.network_url.replace("http://", "ws://") + "/"
    ws = RawWSClient(url)
    other = RawWSClient(url)
    try:
        ws.send(json.dumps({"type": "join", "data": {"node-id": "ws-node",
                                                      "node-address": "http://ws-node"},
                            "request_id": "r1"}))
        assert json.loads(ws.recv(timeout=10)) == {
            "status": "Successfully Connected!", "id": "ws-node", "request_id": "r1"}
        msg = json.loads(ws.recv(timeout=10))
        assert msg == {"type": "monitor"}
        ws.send(json.dumps({"type": "monitor-answer",
                            "data": {"id": "ws-node", "models": ["m1"], "datasets": ["#d"],
                                     "location": "eu"}}))
        proxy = grid.network.app["network"].proxies["ws-node"]
        wait_for(lambda: proxy.hosted_models == ["m1"], what="the monitor answer")
        assert proxy.status == "online" and proxy.location == "eu"
        other.send(json.dumps({"type": "forward", "data": {"destination": "ws-node",
                                                           "content": {"hello": 1}}}))
        assert json.loads(other.recv(timeout=10)) == {"status": "forwarded"}
        while True:  # skip any further monitor pushes
            got = json.loads(ws.recv(timeout=10))
            if got != {"type": "monitor"}:
                break
        assert got == {"hello": 1}
        other.send(json.dumps({"type": "forward", "data": {"destination": "nobody"}}))
        assert "not connected" in json.loads(other.recv(timeout=10))["error"]
        other.send(json.dumps({"type": "no-such-event"}))
        assert "unknown event" in json.loads(other.recv(timeout=10))["error"]
    finally:
        ws.close()
        other.close()
    wait_for(lambda: proxy.status == "offline", what="the closed socket to mark it offline")
    http.request("DELETE", grid.network_url + "/delete-node",
                 json={"node-id": "ws-node", "node-address": "http://ws-node"}, timeout=10)


# --------------------------------------------------------------------------
# users: the RBAC twins over http_twin
# --------------------------------------------------------------------------


def test_network_rbac_http_twins(grid):
    url = grid.network_url
    r = http.post(url + "/users/signup",
                  json={"email": "net-admin@example.com", "password": "pw123456"}, timeout=10)
    assert r.status_code == 200, r.text
    assert r.json()["user"]["email"] == "net-admin@example.com"
    token = http.post(url + "/users/login", json={"email": "net-admin@example.com",
                                                  "password": "pw123456"}, timeout=10).json()["token"]
    assert token
    r = http.get(url + "/users/", headers={"token": token}, timeout=10)
    assert r.status_code == 200
    users = r.json()["data"]
    assert "net-admin@example.com" in [u["email"] for u in users]
    assert http.get(url + "/roles/", headers={"token": token}, timeout=10).json()["data"]
    assert http.get(url + "/users/", headers={"token": "junk"}, timeout=10).status_code == 400
    # the path parameter wins over a body id
    me = users[0]["id"]
    r = http.request("GET", url + f"/users/{me}", headers={"token": token},
                     json={"id": 999}, timeout=10)
    assert r.status_code == 200 and r.json()["data"]["id"] == me
    # malformed input is a 400, never a 500
    for body in ("[1, 2]", "{not json", b"\xff\xfe"):
        r = http.post(url + "/users/login", data=body, timeout=10)
        assert r.status_code == 400, body
    r = http.request("PUT", url + "/users/not-a-number/email", headers={"token": token},
                     json={"email": "x@example.com"}, timeout=10)
    assert r.status_code == 400


# --------------------------------------------------------------------------
# hosting chosen by the network, and the aggregation placement routes
# --------------------------------------------------------------------------


def test_network_driven_model_centric_hosting_flow(grid):
    node_id, address = http.get(grid.network_url + "/choose-model-host", timeout=10).json()[0]
    assert node_id in NODES
    B = 64
    params = [p.numpy() for p in mlp.init((784, 392, 10),
                                          generator=torch.Generator().manual_seed(2),
                                          device="cpu")]
    mc = ModelCentricFLClient(address, device="cpu")
    resp = mc.host_federated_training(
        model=params,
        client_plans={"training_plan": (FIXTURES / "mlp_training_plan.bin").read_bytes()},
        client_config={"name": "net-chosen", "version": "1.0", "batch_size": B, "lr": 0.1,
                       "max_updates": 1},
        server_config={"min_workers": 1, "max_workers": 1, "min_diffs": 1, "max_diffs": 1,
                       "num_cycles": 1, "pool_selection": "random",
                       "do_not_reuse_workers_until_cycle": 0})
    assert resp.get("status") == "success", resp
    client = FLClient(address, device="cpu")
    wid = client.authenticate("net-chosen", "1.0")["worker_id"]
    cyc = client.cycle_request(wid, "net-chosen", "1.0", 1.0, 100.0, 100.0)
    assert cyc["status"] == "accepted", cyc
    got = client.get_model(wid, cyc["request_key"], cyc["model_id"])
    diff = [0.1 * p for p in got]
    assert client.report(wid, cyc["request_key"],
                         serialize_model_params(diff)).get("status") == "success"
    client.close()
    latest = mc.retrieve_model("net-chosen", "1.0")
    for new, orig, d in zip(latest, params, diff):
        np.testing.assert_allclose(np.asarray(new.cpu()), orig - d.numpy(), rtol=1e-5)
    mc.close()


def test_aggregation_routes():
    """register (idempotent heartbeat), placement (stable consistent
    hashing; null without a live sub-aggregator), tree, unregister, and
    expiry on heartbeat loss driven by an injected clock."""
    now = [1000.0]
    server = web.BackgroundServer(create_network("agg", monitor_interval=60)).start()
    try:
        reg = server.app["network"].aggregation
        reg.clock = lambda: now[0]
        url = server.url
        place = {"node-address": "http://node/", "worker-id": "w-1"}
        assert http.get(url + "/aggregation/placement", params=place,
                        timeout=10).json() == {"report-to": None, "subagg-id": None}
        assert http.get(url + "/aggregation/placement", params={"worker-id": "w"},
                        timeout=10).status_code == 400
        for sid in ("s1", "s2"):
            r = http.post(url + "/aggregation/register",
                          json={"subagg-id": sid, "subagg-address": f"http://{sid}/",
                                "node-address": "http://node"}, timeout=10)
            assert r.json() == {"message": "registered", "ttl_s": reg.ttl_s, "subagg-id": sid}
        assert http.post(url + "/aggregation/register", json={"subagg-id": "x"},
                         timeout=10).status_code == 400
        first = http.get(url + "/aggregation/placement", params=place, timeout=10).json()
        assert first["report-to"] in ("http://s1", "http://s2")
        for _ in range(3):  # stable while the live set is
            assert http.get(url + "/aggregation/placement", params=place,
                            timeout=10).json() == first
        tree = http.get(url + "/aggregation/tree", timeout=10).json()
        assert [e["id"] for e in tree["nodes"]["http://node"]] == ["s1", "s2"]
        assert "pygrid_grid_subaggregators_total 2" in http.get(url + "/metrics", timeout=10).text
        # s2 keeps heart-beating, s1 falls silent past the TTL
        now[0] += reg.ttl_s / 2
        http.post(url + "/aggregation/register", json={"subagg-id": "s2", "subagg-address":
                                                       "http://s2", "node-address":
                                                       "http://node"}, timeout=10)
        now[0] += reg.ttl_s / 2 + 1.0
        assert http.get(url + "/aggregation/placement", params=place,
                        timeout=10).json()["report-to"] == "http://s2"
        assert reg.sweep() == ["s1"]
        assert http.request("DELETE", url + "/aggregation/register", json={"subagg-id": "s2"},
                            timeout=10).status_code == 200
        assert http.request("DELETE", url + "/aggregation/register", json={"subagg-id": "s2"},
                            timeout=10).status_code == 404
        assert http.get(url + "/aggregation/placement", params=place,
                        timeout=10).json()["report-to"] is None
    finally:
        server.stop()


# --------------------------------------------------------------------------
# lifecycle
# --------------------------------------------------------------------------


def _fds() -> int:
    return len(os.listdir("/proc/self/fd"))


def test_start_stop_20_times_leaks_no_thread_or_socket():
    """20 networks started, joined by a node, swept and stopped: no thread
    and no file descriptor is left behind (the monitor task, its polls and
    the snapshotter all end with the app)."""
    node = web.BackgroundServer(create_node("cycled", device="cpu")).start()

    def cycle():
        server = web.BackgroundServer(create_network("cycler", monitor_interval=0.01)).start()
        ctx: NetworkContext = server.app["network"]
        join(node, server.url)
        wait_for(lambda: ctx.proxies["cycled"].status == "online", what="a sweep")
        assert http.get(server.url + "/nodes-status", timeout=10).status_code == 200
        server.stop()

    try:
        cycle()
        threads, fds = {t.ident for t in threading.enumerate()}, _fds()
        for _ in range(20):
            cycle()

        def clean():
            extra = [t.name for t in threading.enumerate()
                     if t.ident not in threads and not t.name.startswith("pygrid-ws")]
            return not extra and _fds() <= fds

        wait_for(clean, timeout=5.0, what="threads and sockets to be released")
    finally:
        node.stop()


def test_cli_flags():
    from pygrid_tpu_torch.network.__main__ import parse_args

    args = parse_args(["--id", "n1", "--port", "7010", "--num_replicas", "2",
                       "--start_local_db"])
    assert (args.id, args.port, args.num_replicas, args.start_local_db) == ("n1", 7010, 2, True)
    assert parse_args([]).port == 7000
