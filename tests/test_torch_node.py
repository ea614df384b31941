"""The port's Node app (pygrid_tpu_torch.node) over real sockets, driven by
the port's clients: the flows of the JAX package's
``tests/integration/test_fl_process.py``, ``test_data_centric_ops.py`` and
``test_serving_grid.py`` against port nodes on ``device="cpu"`` — hosting
conflicts, JWT rejection, a FedAvg round over sockets, req-join, the speed
test's exact bytes, the binary wire and the CNN plan's cycle; send/get,
remote arithmetic, moves between nodes, remote inference and permissions;
remote generation equal to ``generate()`` with its validation errors;
``/metrics`` strictly valid; and start/stop cycles that leak no thread and
no socket."""

from __future__ import annotations

import base64
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pygrid_tpu_torch import serde, web
from pygrid_tpu_torch.client import DataCentricFLClient, FLClient, ModelCentricFLClient
from pygrid_tpu_torch.federated import tasks
from pygrid_tpu_torch.federated.auth import jwt_encode
from pygrid_tpu_torch.models import cnn, decode, mlp, transformer
from pygrid_tpu_torch.node import NodeContext, create_app
from pygrid_tpu_torch.plans import Plan
from pygrid_tpu_torch.plans.translators import run_oplist
from pygrid_tpu_torch.telemetry import promtext
from pygrid_tpu_torch.utils.exceptions import GetNotPermittedError, PyGridError
from pygrid_tpu_torch.web import client as http

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent.parent / "pygrid_tpu_torch" / "plans" / "fixtures"
SECRET = "very-secret-hmac-key"
NAME, VERSION = "mnist", "1.0"
B = 64  # the committed plans' batch
NODES = ("alice", "bob", "charlie", "dan")


@pytest.fixture(scope="module")
def grid():
    prev = tasks._sync
    tasks.set_sync(True)  # deterministic aggregation inside report handling
    servers = {}
    for name in NODES:
        servers[name] = web.BackgroundServer(create_app(name, device="cpu")).start()
        servers[name].app["node"].address = servers[name].url
    yield servers
    for server in servers.values():
        server.stop()
    tasks.set_sync(prev)


def _url(grid, name):
    return grid[name].url


def _token():
    return jwt_encode({"sub": "worker"}, secret=SECRET)


def _mlp_params(seed=7):
    g = torch.Generator().manual_seed(seed)
    return [p.numpy() for p in mlp.init((784, 392, 10), generator=g, device="cpu")]


def _batch(seed, shape=(B, 784)):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, size=shape).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, B)]
    return torch.from_numpy(X), torch.from_numpy(y)


@pytest.fixture(scope="module")
def hosted(grid):
    """The committed JAX-built MLP plan hosted on alice with JWT auth."""
    params = _mlp_params()
    mc = ModelCentricFLClient(_url(grid, "alice"), device="cpu")
    response = mc.host_federated_training(
        model=params,
        client_plans={"training_plan": (FIXTURES / "mlp_training_plan.bin").read_bytes()},
        client_config={"name": NAME, "version": VERSION, "batch_size": B, "lr": 0.1,
                       "max_updates": 2},
        server_config={"min_workers": 2, "max_workers": 4, "pool_selection": "random",
                       "do_not_reuse_workers_until_cycle": 0, "cycle_length": 28800,
                       "num_cycles": 4, "max_diffs": 2, "min_diffs": 2,
                       "authentication": {"secret": SECRET}},
    )
    assert response.get("status") == "success"
    mc.close()
    return params


# --------------------------------------------------------------------------
# model-centric
# --------------------------------------------------------------------------


def test_host_conflict_rejected(grid, hosted):
    mc = ModelCentricFLClient(_url(grid, "alice"), device="cpu")
    with pytest.raises(PyGridError):
        mc.host_federated_training(
            model=hosted, client_plans={"training_plan": b"x"},
            client_config={"name": NAME, "version": VERSION}, server_config={})
    mc.close()


@pytest.mark.parametrize("token", ["garbage.token.here", None])
def test_authenticate_rejects_bad_or_missing_token(grid, hosted, token):
    client = FLClient(_url(grid, "alice"), auth_token=token, device="cpu")
    assert "error" in client.authenticate(NAME, VERSION)
    client.close()


def test_authenticate_accepts_valid_jwt(grid, hosted):
    client = FLClient(_url(grid, "alice"), auth_token=_token(), device="cpu")
    auth = client.authenticate(NAME, VERSION)
    assert auth.get("status") == "success" and auth.get("worker_id")
    assert auth.get("requires_speed_test") is False
    assert client.ws.wire_v2  # "auto" negotiated wire-v2 with the port's server
    client.close()


def test_cycle_request_rejects_negative_speed(grid, hosted):
    client = FLClient(_url(grid, "alice"), auth_token=_token(), device="cpu")
    wid = client.authenticate(NAME, VERSION)["worker_id"]
    cycle = client.cycle_request(wid, NAME, VERSION, ping=-5, download=1.0, upload=1.0)
    assert cycle["status"] == "rejected" and "positive number" in cycle.get("error", "")
    client.close()


def test_full_fedavg_round_over_sockets(grid, hosted):
    """Two FLJobs train on the downloaded plan and report; the node's
    checkpoint 2 is old - f32(f64 mean of the diffs), checkpoint 1 the
    hosted params."""
    mc = ModelCentricFLClient(_url(grid, "alice"), device="cpu")
    old = [p.clone() for p in mc.retrieve_model(NAME, VERSION)]
    diffs, errors = [], []
    for k in range(2):
        client = FLClient(_url(grid, "alice"), auth_token=_token(), device="cpu")
        job = client.new_job(NAME, VERSION)

        def on_accept(job, k=k):
            X, y = _batch(k)
            out = job.plans["training_plan"](X, y, torch.tensor(0.1), *job.model_params,
                                             device="cpu")
            diff = [p - n for p, n in zip(job.model_params, out[2:])]
            assert not job.report(diff).get("error")
            diffs.append(diff)

        job.add_listener(job.EVENT_ACCEPTED, on_accept)
        job.add_listener(job.EVENT_ERROR, lambda j, e: errors.append(e))
        job.start()
        client.close()
    assert not errors and len(diffs) == 2
    latest = mc.retrieve_model(NAME, VERSION)
    for i, (o, g) in enumerate(zip(old, latest)):
        mean64 = (diffs[0][i].double() + diffs[1][i].double()) / 2
        assert torch.equal(g, o - mean64.float()), i
    first = mc.retrieve_model(NAME, VERSION, checkpoint=1)
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(first, hosted))
    assert mc.cycle_metrics(NAME, VERSION)
    mc.close()


def test_worker_already_in_cycle_rejected(grid, hosted):
    client = FLClient(_url(grid, "alice"), auth_token=_token(), device="cpu")
    wid = client.authenticate(NAME, VERSION)["worker_id"]
    assert client.cycle_request(wid, NAME, VERSION, 1.0, 100.0, 100.0)["status"] == "accepted"
    assert client.cycle_request(wid, NAME, VERSION, 1.0, 100.0, 100.0)["status"] == "rejected"
    client.close()


def test_req_join_admission(grid, hosted):
    url = _url(grid, "alice") + "/model-centric/req-join"
    ok = http.get(url, params={"name": NAME, "version": VERSION, "worker_id": "fresh",
                               "up_speed": "99999", "down_speed": "99999",
                               "request_rate": "0.00001"}, timeout=10)
    assert ok.status_code == 200 and ok.json()["status"] == "accepted"
    slow = http.get(url, params={"name": NAME, "version": VERSION, "worker_id": "slow",
                                 "up_speed": "-1", "down_speed": "0"}, timeout=10)
    assert slow.status_code == 400 and slow.json()["status"] == "rejected"
    bad = http.get(url, params={"name": NAME, "up_speed": "fast"}, timeout=10)
    assert bad.status_code == 400


def test_download_routes_name_missing_params(grid, hosted):
    base = _url(grid, "alice") + "/model-centric"
    r = http.get(base + "/get-model", params={"model_id": "1"}, timeout=10)
    assert r.status_code == 400
    assert "worker_id" in r.json()["error"] and "request_key" in r.json()["error"]
    r = http.get(base + "/get-model", timeout=10)
    assert r.status_code == 400 and "model_id" in r.json()["error"]
    r = http.get(base + "/get-plan", timeout=10)
    assert r.status_code == 400 and "plan_id" in r.json()["error"]
    r = http.get(base + "/retrieve-model", params={"name": "nope"}, timeout=10)
    assert r.status_code == 404


def test_speed_test_streams_exact_bytes(grid, hosted):
    url = _url(grid, "alice") + "/model-centric/speed-test"
    r = http.get(url, params={"worker_id": "w", "random": "1",
                              "size": str(3 * 1024 * 1024 + 7)}, timeout=30)
    assert r.status_code == 200 and len(r.content) == 3 * 1024 * 1024 + 7
    assert http.get(url, params={"worker_id": "w"}, timeout=10).status_code == 400
    client = FLClient(_url(grid, "alice"), device="cpu")
    ping, down, up = client.speed_test("w", sample_bytes=1 << 16)
    assert ping > 0 and down > 0 and up > 0
    client.close()


@pytest.mark.parametrize("wire", ["binary", "json"])
def test_wire_round_on_bob(grid, wire):
    """A cycle over the msgpack twin (bf16 diffs) and over the legacy JSON
    contract: both aggregate to old - f32(f64 mean) of what was sent."""
    name = f"mlp-{wire}"
    params = _mlp_params(seed=11)
    mc = ModelCentricFLClient(_url(grid, "bob"), device="cpu")
    assert mc.host_federated_training(
        model=params,
        client_plans={"training_plan": (FIXTURES / "mlp_training_plan.bin").read_bytes()},
        client_config={"name": name, "version": VERSION, "diff_precision": "bf16"},
        server_config={"min_workers": 1, "max_workers": 1, "min_diffs": 1, "max_diffs": 1,
                       "num_cycles": 2})["status"] == "success"
    client = FLClient(_url(grid, "bob"), wire=wire, device="cpu")
    wid = client.authenticate(name, VERSION)["worker_id"]
    cyc = client.cycle_request(wid, name, VERSION, 1.0, 1000.0, 1000.0)
    got = client.get_model(wid, cyc["request_key"], cyc["model_id"])
    oplist = client.get_plan(wid, cyc["request_key"], cyc["plans"]["training_plan"],
                             receive_operations_as="list")
    X, y = _batch(3)
    out = run_oplist(oplist, X, y, torch.tensor(0.1), *got, device="cpu")
    diff = [p - n for p, n in zip(got, out[2:])]
    job = client.new_job(name, VERSION)
    job.worker_id, job.request_key, job.client_config = wid, cyc["request_key"], {
        "diff_precision": "bf16"}
    assert not job.report(diff).get("error")
    assert client.ws.wire_v2 is (wire == "binary")
    new = mc.retrieve_model(name, VERSION)
    for p, d, n in zip(params, diff, new):
        sent = d.to(torch.bfloat16).float()
        assert torch.equal(n, torch.from_numpy(p) - sent.double().float())
    client.close()
    mc.close()


def test_cnn_plan_full_cycle(grid):
    """The committed JAX-built CNN plan through the whole protocol on
    charlie: download, the "list" variant on the port's interpreter,
    report, checkpoint 2."""
    name = "mnist-cnn"
    params = [p.numpy() for p in cnn.init(torch.Generator().manual_seed(0), device="cpu")]
    mc = ModelCentricFLClient(_url(grid, "charlie"), device="cpu")
    assert mc.host_federated_training(
        model=params,
        client_plans={"training_plan": (FIXTURES / "cnn_training_plan.bin").read_bytes()},
        client_config={"name": name, "version": VERSION},
        server_config={"min_workers": 1, "max_workers": 1, "min_diffs": 1, "max_diffs": 1,
                       "num_cycles": 2})["status"] == "success"
    client = FLClient(_url(grid, "charlie"), device="cpu")
    job = client.new_job(name, VERSION)
    sent = []

    def on_accept(job):
        X, y = _batch(5, shape=(B, 28, 28, 1))
        out = job.plans["training_plan"](X, y, torch.tensor(0.005), *job.model_params,
                                         device="cpu")
        assert 0.0 <= float(out[1]) <= 1.0
        sent.append([p - n for p, n in zip(job.model_params, out[2:])])
        job.report(sent[-1])

    job.add_listener(job.EVENT_ACCEPTED, on_accept)
    job.start()
    assert sent
    new = mc.retrieve_model(name, VERSION)
    assert all(torch.equal(n, torch.from_numpy(p) - d) for p, d, n in zip(params, sent[0], new))
    client.close()
    mc.close()


def test_metrics_and_telemetry_routes_strictly_valid(grid, hosted):
    base = _url(grid, "alice")
    assert http.get(base + "/healthz", timeout=10).status_code == 200
    families = promtext.parse(http.get(base + "/metrics", timeout=10).text)
    for name in ("pygrid_workers_total", "pygrid_cycles_total", "pygrid_http_requests_total",
                 "pygrid_http_request_seconds"):
        assert name in families, name
    assert http.get(base + "/healthz", timeout=10).json() == {"status": "ok"}
    assert http.get(base + "/healthz", params={"deep": "1"}, timeout=10).status_code in (200, 503)
    assert "slo" in http.get(base + "/telemetry/slo", timeout=10).json()
    assert http.get(base + "/telemetry/cycles", timeout=10).json()["cycles"]
    assert http.get(base + "/telemetry/cycles/999999", timeout=10).status_code == 404
    assert http.get(base + "/telemetry/cycles/x", timeout=10).status_code == 400
    assert "events" in http.get(base + "/telemetry/events", timeout=10).json()
    assert "programs" in http.get(base + "/telemetry/programs", timeout=10).json()
    assert http.get(base + "/model-centric/processes", timeout=10).json()["processes"]
    assert http.post(base + "/telemetry/dump", timeout=10).status_code == 400


# --------------------------------------------------------------------------
# data-centric
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def alice(grid):
    client = DataCentricFLClient(_url(grid, "alice"), device="cpu")
    yield client
    client.close()


@pytest.fixture(scope="module")
def bob(grid):
    client = DataCentricFLClient(_url(grid, "bob"), device="cpu")
    yield client
    client.close()


def test_identity_ping_and_status(grid, alice):
    assert alice.get_node_infos()["id"] == "alice" and alice.ping()
    base = _url(grid, "alice")
    assert http.get(base + "/data-centric/identity/", timeout=10).json()["identity"] == "alice"
    assert http.get(base + "/data-centric/status/", timeout=10).json()["status"] == "OK"
    assert http.get(base + "/", timeout=10).json()["node_id"] == "alice"
    page = http.get(base + "/", headers={"Accept": "text/html"}, timeout=10)
    assert page.headers["content-type"].startswith("text/html") and "alice" in page.text


def test_send_get_search_and_gc(alice):
    x = np.array([1.0, 2.0, 3.0])
    ptr = alice.send(x, tags={"#test-send"})
    assert ptr.shape == (3,)
    np.testing.assert_array_equal(ptr.get(), x)
    alice.send(np.ones((2, 2)), tags={"#mnist", "#data"}, description="d")
    found = alice.search("#mnist", "#data")
    assert len(found) == 1 and found[0].shape == (2, 2)
    np.testing.assert_array_equal(found[0].get(delete=False), np.ones((2, 2)))
    alice.send(np.arange(3.0), tags={"#gc-test"}).get(delete=True)
    assert alice.search("#gc-test") == []


def test_remote_arithmetic(alice):
    a = alice.send(np.array([2.0, 4.0]))
    b = alice.send(np.array([10.0, 20.0]))
    np.testing.assert_array_equal((a + b).get(), [12.0, 24.0])
    np.testing.assert_array_equal((b - a).get(delete=False), [8.0, 16.0])
    c = alice.send(np.eye(2))
    d = alice.send(np.array([[1.0, 2.0], [3.0, 4.0]]))
    np.testing.assert_array_equal((c @ d).get(), [[1.0, 2.0], [3.0, 4.0]])


def test_private_tensor_permissions(alice):
    ptr = alice.send(np.array([42.0]), allowed_users={"someone-else"})
    with pytest.raises(GetNotPermittedError):
        ptr.get()


def test_move_between_nodes(grid, alice, bob):
    alice.connect_nodes(bob)
    moved = alice.send(np.array([7.0, 8.0]), tags={"#movable"}).move(bob)
    np.testing.assert_array_equal(moved.get(), [7.0, 8.0])
    assert alice.search("#movable") == []
    tags = http.get(_url(grid, "bob") + "/data-centric/dataset-tags", timeout=10).json()
    assert isinstance(tags, list)


def _triple_plan():
    """``x * 3`` as an op list — what a worker runs (never a torch_blob)."""
    return Plan(name="triple", oplist={
        "constvars": [], "consts": [], "invars": [0],
        "eqns": [{"op": "mul", "in": [{"var": 0}, {"lit": 3.0}], "out": [1], "params": {}}],
        "outvars": [{"var": 1}]})


def test_serve_inference_permissions_and_delete(grid, alice):
    assert alice.serve_model(_triple_plan(), "triple", allow_remote_inference=True,
                             allow_download=True)["success"]
    assert "triple" in alice.models
    np.testing.assert_allclose(alice.run_remote_inference("triple", np.ones((1, 4), np.float32)),
                               3 * np.ones((1, 4)))
    assert isinstance(alice.download_model("triple"), Plan)
    alice.serve_model(_triple_plan(), "private")
    with pytest.raises(PyGridError):
        alice.run_remote_inference("private", np.ones((1, 2), np.float32))
    with pytest.raises(PyGridError):
        alice.download_model("private")
    assert not alice.serve_model(_triple_plan(), "private").get("success", False)
    listed = http.get(_url(grid, "alice") + "/data-centric/detailed-models-list/",
                      timeout=10).json()["models"]
    assert {m["model_id"] for m in listed} >= {"triple", "private"}
    alice.delete_model("private")
    assert "private" not in alice.models


def test_a_torch_blob_plan_is_not_run_for_inference(alice):
    built = Plan(name="neg", fn=torch.neg).build(torch.ones(1, 2))
    blob_only = Plan(name="neg", torch_blob=built.torch_blob, input_specs=built.input_specs)
    assert alice.serve_model(blob_only, "blob-plan", allow_remote_inference=True)["success"]
    with pytest.raises(PyGridError, match="torch_blob"):
        alice.run_remote_inference("blob-plan", np.ones((1, 2), np.float32))


def test_a_port_built_plan_runs_for_inference_from_its_op_list(alice, monkeypatch):
    """The node's run_inference runs a port-built plan's op list and never
    reaches torch.export.load (the node serves in this process)."""
    built = Plan(name="neg", fn=torch.neg).build(torch.ones(1, 2))
    assert built.oplist is not None

    def refuse(*a, **k):
        raise AssertionError("torch.export.load reached on the inference path")

    monkeypatch.setattr(torch.export, "load", refuse)
    assert alice.serve_model(built, "listed-plan", allow_remote_inference=True)["success"]
    x = np.array([[1.0, -2.0]], np.float32)
    np.testing.assert_array_equal(alice.run_remote_inference("listed-plan", x), -x)


def test_http_serve_model_multipart_and_json(grid, alice):
    url = _url(grid, "alice") + "/data-centric/serve-model/"
    blob = serde.serialize(_triple_plan())
    headers = {"token": alice._auth_token}
    r = http.post(url, headers=headers, timeout=10, json={
        "model": base64.b64encode(blob).decode(), "model_id": "http-json",
        "allow_remote_inference": "True"})
    assert r.status_code == 200 and r.json()["success"]
    assert http.post(url, timeout=10, json={"model_id": "anon"}).status_code == 400
    import requests

    r = requests.post(url, headers=headers, timeout=10, files={"model": ("m", blob)},
                      data={"model_id": "http-multipart", "allow_download": "True"})
    assert r.status_code == 200 and r.json()["success"]
    got = http.get(url, params={"model_id": "http-multipart"}, headers=headers, timeout=10)
    assert got.status_code == 200 and got.content == blob


def test_bad_login(grid):
    with pytest.raises(PyGridError):
        DataCentricFLClient(_url(grid, "alice"), username="admin", password="wrong",
                            device="cpu")


# --------------------------------------------------------------------------
# generation serving
# --------------------------------------------------------------------------

CFG = transformer.TransformerConfig(vocab=37, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                                    max_len=48)


@pytest.fixture(scope="module")
def gen_model(grid):
    params = transformer.init(CFG, generator=torch.Generator().manual_seed(11), device="cpu")
    client = DataCentricFLClient(_url(grid, "dan"), device="cpu")
    assert client.serve_model(decode.bundle(CFG, params), "gen",
                              allow_remote_inference=True)["success"]
    yield params, client
    client.close()


def _generate(params, prompt, n_new):
    return decode.generate(params, torch.as_tensor(prompt).long(), n_new, CFG).numpy()


def test_concurrent_ws_generations_equal_generate(grid, gen_model):
    params, _ = gen_model
    rng = np.random.RandomState(3)
    cases = [(rng.randint(0, CFG.vocab, size=(1, int(rng.randint(1, 9)))), int(rng.randint(1, 10)))
             for _ in range(6)]
    results, errors = [None] * len(cases), []

    def go(i):
        client = DataCentricFLClient(_url(grid, "dan"), device="cpu")
        try:
            results[i] = client.run_remote_generation("gen", cases[i][0], n_new=cases[i][1])
        except Exception as err:  # noqa: BLE001 — collected for the assert
            errors.append(err)
        finally:
            client.close()

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    for (prompt, n_new), got in zip(cases, results):
        np.testing.assert_array_equal(got, _generate(params, prompt, n_new))


def test_http_generation_equal_generate_and_typed(grid, gen_model):
    params, client = gen_model
    url = _url(grid, "dan") + "/data-centric/run-generation"
    prompt = np.array([[1, 2, 3]], np.int32)
    body = {"model_id": "gen", "data": base64.b64encode(serde.serialize(prompt)).decode(),
            "n_new": 4}
    headers = {"token": client._auth_token}
    r = http.post(url, json=body, headers=headers, timeout=60)
    assert r.status_code == 200, r.text
    np.testing.assert_array_equal(np.asarray(r.json()["tokens"]), _generate(params, prompt, 4))
    r = http.post(url, json=dict(body, temperature=True), headers=headers, timeout=30)
    assert r.status_code == 400 and "temperature" in r.json()["error"]
    assert http.post(url, json=body, timeout=30).status_code in (400, 401, 403)
    assert http.post(url, data=b"{not json", headers=headers, timeout=30).status_code == 400


def test_sampled_generation_reproducible(gen_model):
    _, client = gen_model
    a = client.run_remote_generation("gen", np.array([[5, 6]]), n_new=6, temperature=0.8, seed=99)
    b = client.run_remote_generation("gen", np.array([[5, 6]]), n_new=6, temperature=0.8, seed=99)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < CFG.vocab)).all()


@pytest.mark.parametrize("prompt, kwargs, pattern", [
    (np.ones((1, 3), np.float32), {}, "int tokens"),
    (np.zeros((1, 0), np.int32), {}, "int tokens"),
    (np.array([1, 2], np.int32), {}, "int tokens"),
    (np.array([[1, 99]], np.int32), {}, "out of range"),
    (np.array([[-1, 2]], np.int32), {}, "out of range"),
    (np.array([[1, 2, 3]], np.int32), {"n_new": 500}, "max_len"),
    (np.array([[1, 2]], np.int32), {"n_new": 0}, "n_new"),
    (np.array([[1, 2]], np.int32), {"temperature": -0.5}, "temperature"),
    (np.array([[1, 2]], np.int32), {"temperature": float("nan")}, "temperature"),
    (np.array([[1, 2]], np.int32), {"temperature": 0.5, "seed": -1}, "seed"),
])
def test_generation_validation_errors(gen_model, prompt, kwargs, pattern):
    _, client = gen_model
    with pytest.raises(PyGridError, match=pattern):
        client.run_remote_generation("gen", prompt, **{"n_new": 2, **kwargs})


@pytest.mark.parametrize("field, value", [("n_new", True), ("n_new", "8"), ("n_new", 1.5),
                                          ("temperature", "0.9"), ("seed", 2 ** 63)])
def test_generation_raw_frame_types_bounce(gen_model, field, value):
    _, client = gen_model
    frame = {"model_id": "gen", "n_new": 2, "temperature": 0.5,
             "data": base64.b64encode(serde.serialize(np.array([[1]], np.int32))).decode(),
             field: value}
    out = client.ws.send_json("run-generation", **frame)
    assert out.get("success") is False and field in out["error"]


def test_generation_needs_a_bundle_and_permission(grid, gen_model):
    _, client = gen_model
    client.serve_model(_triple_plan(), "plain", allow_remote_inference=True)
    with pytest.raises(PyGridError, match="bundle"):
        client.run_remote_generation("plain", np.array([[1, 2]], np.int32), n_new=2)
    params = transformer.init(CFG, generator=torch.Generator().manual_seed(2), device="cpu")
    client.serve_model(decode.bundle(CFG, params), "private-gen")
    with pytest.raises(PyGridError, match="not allowed"):
        client.run_remote_generation("private-gen", np.array([[1, 2]], np.int32), n_new=2)


def test_serving_metrics_families_strictly_valid(grid, gen_model):
    _, client = gen_model
    client.run_remote_generation("gen", np.array([[4, 2]], np.int32), n_new=3)
    base = _url(grid, "dan")
    families = promtext.parse(http.get(base + "/metrics", timeout=10).text)
    for name, kind in (("pygrid_serving_requests_total", "counter"),
                       ("pygrid_serving_tokens_total", "counter"),
                       ("pygrid_serving_ttft_seconds", "histogram"),
                       ("pygrid_serving_queue_depth", "gauge"),
                       ("pygrid_serving_live_slots", "gauge")):
        assert families[name].type == kind, name
    (engine,) = [e for e in http.get(base + "/telemetry/serving", timeout=10).json()["engines"]
                 if e["model_id"] == "gen"]
    assert engine["tokens_total"] >= 3 and engine["requests_total"] >= 1


# --------------------------------------------------------------------------
# users over HTTP, and the app's lifecycle
# --------------------------------------------------------------------------


def test_users_http_routes(grid):
    base = _url(grid, "bob")
    r = http.post(base + "/users/signup", json={"email": "o@n.org", "password": "pw"}, timeout=10)
    assert r.status_code == 200 and r.json()["user"]["id"] == 1
    assert "hashed_password" not in r.json()["user"]
    token = http.post(base + "/users/login", json={"email": "o@n.org", "password": "pw"},
                      timeout=10).json()["token"]
    users = http.get(base + "/users/", headers={"token": token}, timeout=10)
    assert users.status_code == 200 and [u["email"] for u in users.json()["data"]] == ["o@n.org"]
    r = http.request("PUT", base + "/users/1/email", json={"email": "n@n.org"}, headers={"token": token},
                 timeout=10)
    assert r.status_code == 200 and r.json()["data"]["email"] == "n@n.org"
    assert http.get(base + "/users/", timeout=10).status_code == 400
    assert http.post(base + "/users/login", json={"email": "n@n.org", "password": "x"},
                     timeout=10).status_code == 400
    assert http.request("PUT", base + "/users/", timeout=10).status_code == 405
    assert http.get(base + "/no/such/route", timeout=10).status_code == 404
    families = promtext.parse(http.get(base + "/metrics", timeout=10).text)
    codes = {(labels.get("route"), labels.get("code"))
             for _, labels, _ in families["pygrid_http_requests_total"].samples}
    assert ("unmatched", "404") in codes and ("unmatched", "405") in codes
    assert ("/users/{id}/email", "200") in codes


def _fds() -> int:
    return len(os.listdir("/proc/self/fd"))


def test_start_stop_20_times_leaks_no_thread_or_socket():
    def cycle():
        server = web.BackgroundServer(create_app("cycler", device="cpu")).start()
        client = DataCentricFLClient(server.url, device="cpu")
        assert client.ping()
        client.close()
        server.stop()

    def ours(names):
        # the WS executor is the process's pool (PYGRID_WS_THREADS), not a node's
        return [n for n in names if not n.startswith("pygrid-ws")]

    from pygrid_tpu_torch.node import ws

    cycle()
    threads, fds = {t.ident for t in threading.enumerate()}, _fds()
    for _ in range(20):
        cycle()
    deadline = time.time() + 5
    while time.time() < deadline:
        extra = ours(t.name for t in threading.enumerate() if t.ident not in threads)
        if not extra and _fds() <= fds:
            break
        time.sleep(0.05)
    assert not extra, extra
    assert _fds() <= fds
    pool = [t for t in threading.enumerate() if t.name.startswith("pygrid-ws")]
    assert len(pool) <= ws._WS_EXECUTOR._max_workers


def test_the_node_runs_on_the_card_unless_told_otherwise():
    from pygrid_tpu_torch.node.__main__ import parse_args

    assert parse_args([]).device == "cuda"
    assert parse_args(["--device", "cpu", "--id", "alice"]).device == "cpu"
    ctx = NodeContext("n", device="cpu")
    assert ctx.local_worker.device == ctx.serving.device == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    for make in (lambda: create_app("x"), lambda: NodeContext("x"),
                 lambda: FLClient("http://127.0.0.1:1"),
                 lambda: ModelCentricFLClient("http://127.0.0.1:1"),
                 lambda: DataCentricFLClient("http://127.0.0.1:1", auto_login=False)):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make()
