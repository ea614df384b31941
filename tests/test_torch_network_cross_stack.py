"""The grid's Network across the two stacks.

- **Joining both ways.** Two JAX nodes (aiohttp) and two port nodes join a
  port network and a JAX network, each through its own stack's
  ``join_network``. A model owner publishes an encrypted model over the
  mixed grid; both networks then answer ``/search-encrypted-model``,
  ``/connected-nodes`` and the tag fan-out with the same JSON, and both
  monitors see all four nodes online.
- **The encrypted-inference example, through a network of each stack.**
  The flow of ``examples/encrypted_inference.py --spawn`` on the CPU —
  publish, network ``discover``, cross-node Beaver, reconstruct — once on
  the JAX stack (network, nodes, clients) and once on the port's. Both
  stacks draw the same numpy shares for the weights and the input, and
  both dealers' strict stores hold the same numpy triples and truncation
  pairs (as ``tests/test_torch_grid_cross_stack.py`` injects them): every
  party's output share is bit-identical across the stacks.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import requests
import torch

from pygrid_tpu import serde as jserde
from pygrid_tpu.client import DataCentricFLClient as JDataCentricFLClient
from pygrid_tpu.network import create_app as j_create_network
from pygrid_tpu.node import create_app as j_create_node
from pygrid_tpu.node.__main__ import join_network as j_join_network
from pygrid_tpu.plans.plan import Plan as JPlan
from pygrid_tpu.runtime import pointers as JP
from pygrid_tpu.smpc import EncryptedModel as JEncryptedModel
from pygrid_tpu.smpc import publish_encrypted_model as j_publish
from pygrid_tpu.smpc import remote as JRemote
from pygrid_tpu.smpc import ring as JR
from pygrid_tpu_torch import serde, web
from pygrid_tpu_torch.client import DataCentricFLClient
from pygrid_tpu_torch.network import create_app as create_network
from pygrid_tpu_torch.node import create_app as create_node
from pygrid_tpu_torch.node.__main__ import join_network
from pygrid_tpu_torch.runtime.pointers import send as p_send
from pygrid_tpu_torch.smpc import EncryptedModel, publish_encrypted_model
from pygrid_tpu_torch.smpc import remote as PRemote
from test_torch_grid_cross_stack import _inject
from test_torch_network import restore_process_state, wait_for  # noqa: F401 (an autouse fixture)
from test_torch_remote_smpc import np_shares
from test_torch_web import AioServer

torch.set_num_threads(1)

NODES = ("alice", "bob", "charlie", "dan")


# --------------------------------------------------------------------------
# nodes of each stack on networks of each stack
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed_grid():
    """alice and charlie are JAX nodes, bob and dan port nodes; a port
    network and a JAX network, every node joined to both."""
    stops, nodes = [], {}
    try:
        port_net = web.BackgroundServer(create_network("port-net", monitor_interval=0.2)).start()
        stops.append(port_net.stop)
        jnet = AioServer(j_create_network("jax-net", monitor_interval=0.2))
        jnet_url = jnet.__enter__()
        stops.append(lambda: jnet.__exit__(None, None, None))
        for name in NODES:
            if name in ("alice", "charlie"):
                aio = AioServer(j_create_node(name))
                url = aio.__enter__()
                stops.append(lambda aio=aio: aio.__exit__(None, None, None))
                aio.app["node"].address = url
                nodes[name] = (url, aio.loop, j_join_network)
            else:
                srv = web.BackgroundServer(create_node(name, device="cpu")).start()
                stops.append(srv.stop)
                srv.app["node"].address = srv.url
                nodes[name] = (srv.url, srv.loop, join_network)
        for name, (url, loop, join) in nodes.items():
            for net in (port_net.url, jnet_url):  # each node's own stack's join
                asyncio.run_coroutine_threadsafe(join(net, name, url), loop).result(30)
        yield {"port": port_net.url, "jax": jnet_url}, {n: u for n, (u, _, _) in nodes.items()}
    finally:
        for stop in reversed(stops):
            stop()


def test_both_networks_answer_the_same_json(mixed_grid):
    nets, urls = mixed_grid
    for net in nets.values():
        assert set(requests.get(net + "/connected-nodes", timeout=10).json()["grid-nodes"]) \
            == set(NODES)
    # the owner publishes with the port's clients over the mixed grid
    plan = serde.deserialize(jserde.serialize(_example_plan()), device="cpu")
    clients = {n: DataCentricFLClient(urls[n], device="cpu") for n in NODES}
    try:
        publish_encrypted_model(plan, "mixed-emodel", clients["alice"],
                                [clients[n] for n in ("alice", "bob", "charlie")],
                                clients["dan"], _example_weights(),
                                generator=torch.Generator().manual_seed(0), device="cpu")
        clients["bob"].send(np.ones(3), tags={"#mixed-tag"})
        clients["charlie"].send(np.ones(3), tags={"#mixed-tag"})
        answers = {}
        for stack, net in nets.items():
            answers[stack] = (
                requests.post(net + "/search-encrypted-model", json={"model_id": "mixed-emodel"},
                              timeout=15).json(),
                requests.post(net + "/search", json={"query": ["#mixed-tag"]},
                              timeout=15).json(),
                requests.post(net + "/search-model", json={"model_id": "mixed-emodel"},
                              timeout=15).json(),
            )
    finally:
        for c in clients.values():
            c.close()
    port_ans, jax_ans = answers["port"], answers["jax"]
    assert port_ans[0] == jax_ans[0]
    match = port_ans[0]["match-nodes"]
    assert list(match) == ["alice"]
    assert match["alice"]["nodes"]["workers"] == ["alice", "bob", "charlie"]
    assert match["alice"]["nodes"]["crypto_provider"] == ["dan"]
    assert match["alice"]["worker_addresses"] == urls
    assert sorted(map(tuple, port_ans[1]["match-nodes"])) == \
        sorted(map(tuple, jax_ans[1]["match-nodes"])) == [("bob", urls["bob"]),
                                                         ("charlie", urls["charlie"])]
    assert port_ans[2] == jax_ans[2] == {"match-nodes": [["alice", urls["alice"]]]}


def test_both_monitors_see_every_node_online(mixed_grid):
    nets, urls = mixed_grid
    for net in nets.values():
        statuses = wait_for(lambda net=net: (lambda s: s if set(s) == set(NODES) and all(
            v["status"] == "online" for v in s.values()) else None)(
            requests.get(net + "/nodes-status", timeout=10).json()),
            what="every node online")
        assert {n: s["address"] for n, s in statuses.items()} == urls


# --------------------------------------------------------------------------
# examples/encrypted_inference.py --spawn, through a network of each stack
# --------------------------------------------------------------------------

SHAPES = ((2, 4), (4, 3), (3,), (3, 2), (2,))  # the example's x, w1, b1, w2, b2


def _forward(x, w1, b1, w2, b2):
    """The example's CryptoNets-style MLP: affine → square → affine."""
    h = x @ w1 + b1
    h = h * h
    return h @ w2 + b2


def _example_weights():
    rng = np.random.default_rng(0)
    return [rng.uniform(-0.5, 0.5, (4, 3)).astype(np.float32),
            rng.uniform(-0.2, 0.2, (3,)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (3, 2)).astype(np.float32),
            rng.uniform(-0.2, 0.2, (2,)).astype(np.float32)]


def _example_plan():
    plan = JPlan(name="encrypted_forward", id="encrypted-mlp-example", fn=_forward)
    plan.build(np.zeros((2, 4), np.float32), *_example_weights())
    return plan


def _numpy_sharing(stack, seed):
    """A ``share_to_nodes`` for ``stack`` that encodes with the stack's own
    encoder and splits with numpy shares drawn from ``seed`` — the same
    draws in both stacks."""
    rng = np.random.default_rng(seed)

    def share_to_nodes(x, clients, encoder=None, tags=(), crypto_provider=None, **_):
        if stack == "jax":
            encoded = JR.from_ring(encoder.encode(np.asarray(x)))
        else:
            encoded = encoder.encode(np.asarray(x), device="cpu").numpy().view(np.uint64)
        shares = np_shares(rng, encoded, len(clients)).view(np.int64)
        if stack == "jax":
            ptrs = [JP.send(shares[i], c, tags=set(tags)) for i, c in enumerate(clients)]
            provider = crypto_provider
            if provider is not None and not isinstance(provider, JRemote.RemoteCryptoProvider):
                provider = JRemote.RemoteCryptoProvider(provider)
            return JRemote.RemoteSharedTensor(ptrs, encoder, provider)
        ptrs = [p_send(torch.from_numpy(shares[i].copy()), c, tags=set(tags))
                for i, c in enumerate(clients)]
        provider = crypto_provider
        if provider is not None and not isinstance(provider, PRemote.RemoteCryptoProvider):
            provider = PRemote.RemoteCryptoProvider(provider)
        return PRemote.RemoteSharedTensor(ptrs, encoder, provider, "cpu")

    return share_to_nodes


def _example_run(stack, monkeypatch):
    """The example's flow on one stack: returns (each party's output share,
    the decoded prediction)."""
    monkeypatch.setattr(JRemote if stack == "jax" else PRemote, "share_to_nodes",
                        _numpy_sharing(stack, seed=9))
    stops = []
    try:
        if stack == "jax":
            net = AioServer(j_create_network("example-net", monitor_interval=60))
            net_url = net.__enter__()
            stops.append(lambda: net.__exit__(None, None, None))
        else:
            net = web.BackgroundServer(create_network("example-net", monitor_interval=60)).start()
            net_url = net.url
            stops.append(net.stop)
        nodes = {}
        for name in NODES:
            strict = name == "dan"
            if stack == "jax":
                app = j_create_node(name, strict_crypto_store=strict)
                aio = AioServer(app)
                url = aio.__enter__()
                stops.append(lambda aio=aio: aio.__exit__(None, None, None))
                nodes[name] = (url, app["node"])
            else:
                srv = web.BackgroundServer(create_node(name, device="cpu",
                                                       strict_crypto_store=strict)).start()
                stops.append(srv.stop)
                nodes[name] = (srv.url, srv.app["node"])
            nodes[name][1].address = nodes[name][0]
            requests.post(net_url + "/join", json={"node-id": name,
                                                   "node-address": nodes[name][0]},
                          timeout=10).raise_for_status()
        for seed in (5, 6):  # two forwards' worth
            _inject(nodes["dan"][1], stack, SHAPES, seed=seed)

        # the model owner: share, serve
        weights = _example_weights()
        if stack == "jax":
            clients = {n: JDataCentricFLClient(u) for n, (u, _) in nodes.items()}
            plan = _example_plan()
            j_publish(plan, "encrypted-mlp", host_client=clients["alice"],
                      holder_clients=[clients[n] for n in ("alice", "bob", "charlie")],
                      provider_client=clients["dan"], weights=weights)
            model = JEncryptedModel.discover(net_url, "encrypted-mlp")
        else:
            clients = {n: DataCentricFLClient(u, device="cpu") for n, (u, _) in nodes.items()}
            plan = serde.deserialize(jserde.serialize(_example_plan()), device="cpu")
            publish_encrypted_model(plan, "encrypted-mlp", host_client=clients["alice"],
                                    holder_clients=[clients[n] for n in
                                                    ("alice", "bob", "charlie")],
                                    provider_client=clients["dan"], weights=weights,
                                    device="cpu")
            model = EncryptedModel.discover(net_url, "encrypted-mlp", device="cpu")
        # the data scientist: discovered through the network, predict
        x = np.random.default_rng(1).uniform(-1, 1, (2, 4)).astype(np.float32)
        if stack == "jax":
            sx = JRemote.fix_prec_share_to_nodes(x, model.holder_clients,
                                                 crypto_provider=model.provider)
            from pygrid_tpu.smpc.encrypted_model import run_encrypted_oplist
        else:
            sx = PRemote.fix_prec_share_to_nodes(x, model.holder_clients,
                                                 crypto_provider=model.provider, device="cpu")
            from pygrid_tpu_torch.smpc.encrypted_model import run_encrypted_oplist
        out = run_encrypted_oplist(model.plan.oplist, [sx] + list(model.weights))
        party = [np.asarray(p.get(delete=False)) for p in out.pointers]
        pred = np.asarray(model.predict(x))  # the example's own call, a second forward
        decoded = out.get()
        model.close()
        for c in clients.values():
            c.close()
        return party, decoded, pred, x, weights
    finally:
        for stop in reversed(stops):
            stop()


def test_encrypted_inference_example_bit_identical_across_the_stacks(monkeypatch):
    with monkeypatch.context() as m:
        port_party, port_out, port_pred, x, weights = _example_run("port", m)
    with monkeypatch.context() as m:
        jax_party, jax_out, jax_pred, _, _ = _example_run("jax", m)
    assert len(port_party) == 3
    for p, j in zip(port_party, jax_party):
        assert p.dtype == j.dtype == np.int64
        np.testing.assert_array_equal(p, j)
    np.testing.assert_array_equal(port_out, jax_out)
    np.testing.assert_array_equal(port_pred, jax_pred)
    expected = _forward(x.astype(np.float64), *[w.astype(np.float64) for w in weights])
    assert np.abs(port_out - expected).max() < 5e-2  # the example's own bound
