"""The grid across the two stacks, over real sockets and wire-v2: JAX
clients against port nodes and port clients against JAX nodes (aiohttp).

- **FL.** A JAX-built plan hosted on a node of one stack; two workers of
  the other stack (the legacy JSON contract and the negotiated wire-v2
  binary framing) download the model and the plan, train and report. The
  checkpoint equals the same-stack run's within the tolerance the
  controller-level cross-stack tests hold (``tests/test_torch_federated.py``),
  and the wire-v2 negotiation settles on the same subprotocol as it does
  within one stack.
- **Encrypted inference.** The JAX package's ``DataCentricFLClient``s share
  a small JAX-built CryptoNets plan's inputs over alice, bob and charlie with
  dan dealing — once over port nodes, once over JAX nodes, with the same
  shares sent and the same triples and truncation pairs injected into the
  dealer's strict store — and every party's output share is bit-identical.
- **Pointers, inference, generation.** Each stack's ``DataCentricFLClient``
  on the other stack's nodes: send/get, search, arithmetic, a move, a
  JAX-built plan's remote inference and a bundle's greedy generation give
  what the same calls give within one stack.
"""

import numpy as np
import pytest
import torch

from pygrid_tpu import serde as jserde
from pygrid_tpu.client import DataCentricFLClient as JDataCentricFLClient
from pygrid_tpu.client import FLClient as JFLClient
from pygrid_tpu.client import ModelCentricFLClient as JModelCentricFLClient
from pygrid_tpu.federated import tasks as jtasks
from pygrid_tpu.federated.auth import jwt_encode
from pygrid_tpu.models import mlp as jmlp
from pygrid_tpu.node import create_app as j_create_app
from pygrid_tpu.plans.plan import Plan as JPlan
from pygrid_tpu.plans.state import serialize_model_params as j_serialize_params
from pygrid_tpu.runtime import pointers as JP
from pygrid_tpu.smpc import remote as JRemote
from pygrid_tpu.smpc import ring as JR
from pygrid_tpu.smpc.encrypted_model import run_encrypted_oplist as j_run_encrypted
from pygrid_tpu.smpc.fixed import FixedPointEncoder as JEncoder
from pygrid_tpu.smpc.provider import CryptoStore as JStore
from pygrid_tpu_torch import convert, web
from pygrid_tpu_torch.client import FLClient, ModelCentricFLClient
from pygrid_tpu_torch.federated import tasks
from pygrid_tpu_torch.node import create_app
from pygrid_tpu_torch.plans.state import serialize_model_params
from pygrid_tpu_torch.plans.translators import run_oplist
from test_torch_plans import build_cryptonets_plan, cryptonets_forward
from test_torch_remote_smpc import SMALL, np_shares, np_trunc_pair, np_triple, steps, weights_for
from test_torch_web import AioServer

torch.set_num_threads(1)

SECRET = "cross-stack-secret"
VERSION = "1.0"
D, H, C, B = 784, 32, 10, 8
RTOL, ATOL = 2e-4, 2e-5  # tests/test_torch_federated.py's controller-level tolerance
WIRES = ("json", "auto")


@pytest.fixture(scope="module")
def sync_aggregation():
    prev = (jtasks._sync, tasks._sync)
    jtasks.set_sync(True)
    tasks.set_sync(True)
    yield
    jtasks.set_sync(prev[0])
    tasks.set_sync(prev[1])


@pytest.fixture(scope="module")
def jax_plan():
    import jax

    params = [np.asarray(p) for p in jmlp.init(jax.random.PRNGKey(7), (D, H, C))]
    plan = JPlan(name="training_plan", fn=jmlp.training_step)
    plan.build(np.zeros((B, D), np.float32), np.zeros((B, C), np.float32), np.float32(0.1),
               *params)
    return params, jserde.serialize(plan)


@pytest.fixture(scope="module")
def nodes(sync_aggregation):
    """One node of each stack for the FL runs."""
    port = web.BackgroundServer(create_app("port-node", device="cpu")).start()
    with AioServer(j_create_app("jax-node")) as jax_url:
        yield {"port": port.url, "jax": jax_url}
    port.stop()


def _batch(k):
    rng = np.random.default_rng(k)
    X = rng.normal(size=(B, D)).astype(np.float32)
    return X, np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]


def _fl_run(url, name, client_stack, jax_plan):
    """Host ``jax_plan`` at ``url`` (with the client stack's own
    ModelCentricFLClient), then one worker per wire mode trains and
    reports. Returns (the new checkpoint as numpy, each worker's
    negotiated (wire_v2, codec))."""
    params, blob = jax_plan
    port = client_stack == "port"
    mc = (ModelCentricFLClient(url, device="cpu") if port else JModelCentricFLClient(url))
    assert mc.host_federated_training(
        model=params, client_plans={"training_plan": blob},
        client_config={"name": name, "version": VERSION, "lr": 0.1},
        server_config={"min_workers": 2, "max_workers": 2, "min_diffs": 2, "max_diffs": 2,
                       "num_cycles": 2, "authentication": {"secret": SECRET}},
    )["status"] == "success"
    token = jwt_encode({"sub": "w"}, secret=SECRET)
    negotiated = []
    for k, wire in enumerate(WIRES):
        client = (FLClient(url, auth_token=token, wire=wire, codec="auto", device="cpu") if port
                  else JFLClient(url, auth_token=token, wire=wire, codec="auto"))
        auth = client.authenticate(name, VERSION)
        assert auth.get("status") == "success", auth
        wid = auth["worker_id"]
        cyc = client.cycle_request(wid, name, VERSION, 1.0, 1000.0, 1000.0)
        assert cyc["status"] == "accepted", cyc
        key = cyc["request_key"]
        got = client.get_model(wid, key, cyc["model_id"])
        X, y = _batch(k)
        if port:
            oplist = client.get_plan(wid, key, cyc["plans"]["training_plan"],
                                     receive_operations_as="list")
            out = run_oplist(oplist, torch.from_numpy(X), torch.from_numpy(y),
                             torch.tensor(0.1), *got, device="cpu")
            diff = [p - n for p, n in zip(got, out[2:])]
            blob_diff = serialize_model_params(diff)
        else:
            plan = client.get_plan(wid, key, cyc["plans"]["training_plan"])
            out = plan(X, y, np.float32(0.1), *got)
            diff = [np.asarray(p) - np.asarray(n) for p, n in zip(got, out[2:])]
            blob_diff = j_serialize_params(diff)
        assert not client.report(wid, key, blob_diff).get("error")
        negotiated.append((client.ws.wire_v2, client.ws.wire_codec))
        client.close()
    latest = mc.retrieve_model(name, VERSION)
    mc.close()
    return [np.asarray(t) for t in latest], negotiated


@pytest.mark.parametrize("client_stack, node_stack", [("jax", "port"), ("port", "jax")])
def test_fl_cycle_across_the_stacks(nodes, jax_plan, client_stack, node_stack):
    """Clients of one stack against a node of the other: the checkpoint
    equals the same-stack run's, and negotiation picks the same framing
    (JSON for the pinned client, wire-v2 with the client's first codec
    for the auto one)."""
    mixed, mixed_wire = _fl_run(nodes[node_stack], f"mnist-{client_stack}-on-{node_stack}",
                                client_stack, jax_plan)
    same, same_wire = _fl_run(nodes[client_stack], f"mnist-{client_stack}-on-{client_stack}",
                              client_stack, jax_plan)
    assert mixed_wire == same_wire
    assert mixed_wire[0] == (False, None) and mixed_wire[1][0] is True
    assert mixed_wire[1][1] == ("zstd" if "zstd" in jserde.available_codecs() else "zlib")
    assert not np.allclose(same[0], jax_plan[0][0])  # the cycle moved the params
    for a, b in zip(same, mixed):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# encrypted inference over port nodes, driven by the JAX package's clients
# --------------------------------------------------------------------------

NAMES = ("alice", "bob", "charlie")


def _inject(app_node, stack, shapes, seed):
    """The same Beaver triples and truncation pairs (numpy, from ``seed``)
    into the dealer node's strict store, as each stack holds them."""
    rng = np.random.default_rng(seed)
    scale = JEncoder().scale
    store = app_node.crypto_provider.store
    for op, sx, sy, ts in steps(shapes):
        for key, arrays in ((JStore.key(op, sx, sy, 3), np_triple(rng, op, sx, sy, 3)),
                            (JStore.key("trunc", ts, (scale,), 3),
                             np_trunc_pair(rng, ts, scale, 3))):
            jitem = tuple(JR.to_ring(a) for a in arrays)
            if stack == "jax":
                store.put(key, jitem)
            else:
                store.put(key, convert.ring_from_numpy(
                    tuple((np.asarray(r.lo), np.asarray(r.hi)) for r in jitem), "cpu"))


def _encrypted_run(stack, plan_blob):
    """JAX clients drive four nodes of ``stack``; returns each party's
    output share and the decoded output."""
    servers, stops = {}, []
    try:
        for name in NAMES + ("dan",):
            if stack == "port":
                srv = web.BackgroundServer(create_app(name, device="cpu",
                                                      strict_crypto_store=name == "dan")).start()
                servers[name] = (srv.url, srv.app["node"])
                stops.append(srv.stop)
            else:
                app = j_create_app(name, strict_crypto_store=name == "dan")
                aio = AioServer(app)
                servers[name] = (aio.__enter__(), app["node"])
                stops.append(lambda aio=aio: aio.__exit__(None, None, None))
        _inject(servers["dan"][1], stack, SMALL, seed=5)
        holders = [JDataCentricFLClient(servers[n][0]) for n in NAMES]
        dan = JDataCentricFLClient(servers["dan"][0])
        for h in holders:
            dan.connect_nodes(h)
        provider = JRemote.RemoteCryptoProvider(dan)
        rng = np.random.default_rng(9)
        shared = []
        for v in weights_for(SMALL):
            shares = np_shares(rng, JR.from_ring(JEncoder().encode(v)), 3).view(np.int64)
            ptrs = [JP.send(shares[i], h) for i, h in enumerate(holders)]
            shared.append(JRemote.RemoteSharedTensor(ptrs, JEncoder(), provider))
        out = j_run_encrypted(jserde.deserialize(plan_blob).oplist, shared)
        party = [np.asarray(p.get(delete=False)) for p in out.pointers]
        decoded = out.get()
        for c in holders + [dan]:
            c.close()
        return party, decoded
    finally:
        for stop in stops:
            stop()


def test_encrypted_inference_over_port_nodes_bit_identical_to_jax_nodes():
    plan_blob = jserde.serialize(build_cryptonets_plan(SMALL, plan_id="cryptonets-16-8-4-b4"))
    port_shares, port_out = _encrypted_run("port", plan_blob)
    jax_shares, jax_out = _encrypted_run("jax", plan_blob)
    assert len(port_shares) == 3
    for p, j in zip(port_shares, jax_shares):
        assert p.dtype == j.dtype == np.int64
        np.testing.assert_array_equal(p, j)
    np.testing.assert_array_equal(port_out, jax_out)
    x, w1, b1, w2, b2 = weights_for(SMALL)
    want = cryptonets_forward(x.astype(np.float32).astype(np.float64), w1, b1, w2, b2)
    assert np.abs(port_out - want).max() <= 2e-2


# --------------------------------------------------------------------------
# the data-centric plane and serving, each stack's client on the other's node
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dc_nodes():
    """Two nodes of each stack (the second is a move's target)."""
    servers = [web.BackgroundServer(create_app(n, device="cpu")).start()
               for n in ("p-alice", "p-bob")]
    aios = [AioServer(j_create_app(n)) for n in ("j-alice", "j-bob")]
    urls = {"port": [s.url for s in servers], "jax": [a.__enter__() for a in aios]}
    yield urls
    for s in servers:
        s.stop()
    for a in aios:
        a.__exit__(None, None, None)


def _dc_client(stack, url):
    from pygrid_tpu_torch.client import DataCentricFLClient

    return DataCentricFLClient(url, device="cpu") if stack == "port" else JDataCentricFLClient(url)


@pytest.mark.parametrize("client_stack, node_stack", [("jax", "port"), ("port", "jax")])
def test_pointer_ops_inference_and_generation_across_the_stacks(dc_nodes, client_stack,
                                                                node_stack):
    """A client of one stack on nodes of the other: send/get, tags, remote
    arithmetic, a move between two nodes, a JAX-built plan's remote
    inference and a hosted transformer bundle's greedy generation — the
    results equal the same calls within one stack."""
    import jax

    from pygrid_tpu.models import decode as jdecode
    from pygrid_tpu.models import transformer as jtransformer

    cfg = jtransformer.TransformerConfig(vocab=29, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                                         max_len=24)
    bundle = jdecode.bundle(cfg, jtransformer.init(jax.random.PRNGKey(4), cfg))
    plan = JPlan(name="affine", fn=lambda x: x * 3.0 + 1.0)
    plan.build(np.zeros((2, 4), np.float32))
    prompt = np.array([[3, 1, 4], [1, 5, 9]], np.int32)
    x = np.arange(8.0).reshape(2, 4).astype(np.float32)
    results = {}
    for stack in (node_stack, client_stack):  # the crossed run, then the same-stack one
        a, b = (_dc_client(client_stack, u) for u in dc_nodes[stack])
        tag = f"#{client_stack}-{stack}"
        p = a.send(np.array([2.0, 4.0]), tags={tag})
        q = a.send(np.array([10.0, 20.0]))
        found = a.search(tag)
        a.connect_nodes(b)
        moved = a.send(np.array([7.0]), tags={tag + "-mv"}).move(b)
        assert a.serve_model(jserde.serialize(plan), f"affine{tag}",
                             allow_remote_inference=True)["success"]
        assert a.serve_model(bundle, f"gen{tag}", allow_remote_inference=True)["success"]
        results[stack] = (
            np.asarray((p + q).get()), np.asarray((q - p).get(delete=False)), len(found),
            np.asarray(moved.get()), a.search(tag + "-mv"),
            np.asarray(a.run_remote_inference(f"affine{tag}", x)),
            np.asarray(a.run_remote_generation(f"gen{tag}", prompt, n_new=6)),
        )
        a.close()
        b.close()
    crossed, same = results[node_stack], results[client_stack]
    assert crossed[2] == same[2] == 1 and crossed[4] == same[4] == []
    for c, s in zip(crossed, same):
        if isinstance(c, np.ndarray):
            np.testing.assert_array_equal(c, s)
    np.testing.assert_allclose(crossed[5], x * 3.0 + 1.0)
