"""The port's SecAgg client (``client/secagg.py``) over the real cycle
protocol: the flows of ``tests/integration/test_secagg_protocol.py``
against a port node on the CPU, and across the stacks both ways.

Four workers run the Bonawitz rounds (advertise → roster → sealed shares →
masked report → unmask): with full participation and with one worker that
leaves after the masking phase opens; the node only ever sees masked uint32
envelopes, and the checkpoint equals the survivors' plain mean within
``n · step`` (``step`` the quantisation step). Port sessions run against a
port node and a JAX node, JAX sessions against a port node. Then: a plain
diff refused, a partial roster, the masking deadline, corrupt shares, an
incomplete bundle, bad host configs, the session's two refusals
(a sub-majority threshold, an sk share of a worker it saw report), a masked
blob byte for byte the JAX session's, and one masked cycle through a port
sub-aggregator.

Every phase change is the node's: sessions poll its state, and no worker
reports before all have seen the masking phase (a barrier), so the worker
that leaves does so after it whatever the thread schedule — otherwise the
survivors could close the cycle before it polls. The two flows whose
subject is a node timer (the roster grace, the masking deadline) wait for
it; every other wait has a timeout only a hang reaches.
"""

import threading

import numpy as np
import pytest
import torch

from pygrid_tpu.client import FLClient as JFLClient
from pygrid_tpu.client.secagg import SecAggSession as JSecAggSession
from pygrid_tpu.federated import secagg as jsecagg
from pygrid_tpu.federated import tasks as jtasks
from pygrid_tpu.node import create_app as j_create_app
from pygrid_tpu_torch import serde, web
from pygrid_tpu_torch.client import FLClient, ModelCentricFLClient, SecAggRefusal, SecAggSession
from pygrid_tpu_torch.federated import secagg, tasks
from pygrid_tpu_torch.models import mlp
from pygrid_tpu_torch.node import create_app
from pygrid_tpu_torch.plans import Plan
from pygrid_tpu_torch.plans.state import serialize_model_params
from pygrid_tpu_torch.utils.codes import MODEL_CENTRIC_FL_EVENTS
from pygrid_tpu_torch.utils.exceptions import PyGridError
from pygrid_tpu_torch.worker.subagg import create_subagg_app
from test_torch_network import restore_process_state  # noqa: F401 (an autouse fixture)
from test_torch_network import wait_for
from test_torch_web import AioServer

torch.set_num_threads(1)

D, H, C, B = 20, 8, 4, 4
CLIP = 0.5
N_WORKERS = 4
THRESHOLD = 3
#: a hang is the only thing that reaches these
WAIT, JOIN = 60.0, 180.0


@pytest.fixture(scope="module")
def nodes():
    prev = (jtasks._sync, tasks._sync)
    jtasks.set_sync(True)
    tasks.set_sync(True)
    port = web.BackgroundServer(create_app("secagg-port", device="cpu")).start()
    try:
        with AioServer(j_create_app("secagg-jax")) as jax_url:
            yield {"port": port.url, "jax": jax_url}
    finally:
        port.stop()
        jtasks.set_sync(prev[0])
        tasks.set_sync(prev[1])


@pytest.fixture(scope="module")
def plan_blob():
    """The port-built MLP training plan (op list and torch_blob)."""
    params = [p.numpy() for p in mlp.init((D, H, C), torch.Generator().manual_seed(3),
                                          device="cpu")]
    plan = Plan(name="training_plan", fn=mlp.training_step)
    plan.build(np.zeros((B, D), np.float32), np.zeros((B, C), np.float32), np.float32(0.1),
               *params)
    return params, serde.serialize(plan)


def _host(url, plan_blob, name, *, min_workers=N_WORKERS, min_diffs=THRESHOLD,
          max_diffs=THRESHOLD, **secure):
    params, blob = plan_blob
    mc = ModelCentricFLClient(url, device="cpu")
    try:
        resp = mc.host_federated_training(
            model=params,
            client_plans={"training_plan": blob},
            client_config={"name": name, "version": "1.0", "batch_size": B, "lr": 0.1,
                           "max_updates": 1},
            server_config={
                "min_workers": min_workers, "max_workers": N_WORKERS,
                "min_diffs": min_diffs, "max_diffs": max_diffs, "num_cycles": 1,
                "do_not_reuse_workers_until_cycle": 0, "pool_selection": "random",
                "secure_aggregation": {"clip_range": CLIP, "threshold": THRESHOLD,
                                       "phase_timeout": 15.0, **secure},
            },
        )
    finally:
        mc.close()
    assert resp.get("status") == "success", resp
    return params


def _worker_diff(i, params):
    rng = np.random.default_rng(100 + i)
    return [rng.normal(0, 0.01, p.shape).astype(np.float32) for p in params]


def _session(stack, url, name):
    """An accepted cycle request and its session, on ``stack``'s client."""
    client = (FLClient(url, timeout=30.0, device="cpu") if stack == "port"
              else JFLClient(url, timeout=30.0))
    wid = client.authenticate(name, "1.0")["worker_id"]
    cyc = client.cycle_request(wid, name, "1.0", ping=1.0, download=1000.0, upload=1000.0)
    assert cyc.get("status") == "accepted", cyc
    session = (SecAggSession if stack == "port" else JSecAggSession)(
        client, wid, cyc["request_key"])
    return client, session


def _run_worker(stack, url, name, i, params, results, *, masked, drop=False,
                aggregator_url=None, tamper=None):
    try:
        client, session = _session(stack, url, name)
        session.advertise()
        session.wait_roster(timeout=WAIT)
        session.upload_shares()
        session.wait_masking(timeout=WAIT)
        # nobody reports before every worker has seen the masking phase: a
        # worker that leaves now leaves after it, however the threads run
        masked.wait(timeout=JOIN)
        if drop:
            results[i] = ("dropped", None)
            client.close()
            return
        diffs = _worker_diff(i, params)
        if aggregator_url:
            client.aggregator_url = aggregator_url
        # a port worker's diffs are tensors (on its device; the CPU here)
        session.report([torch.from_numpy(d) for d in diffs] if stack == "port" else diffs)
        if tamper:
            tamper(i, session)
        results[i] = (session.finish(timeout=WAIT * 2), diffs)
        client.close()
    except Exception as err:  # noqa: BLE001 — surfaced by the assertion
        results[i] = ("error", err)


def _run_round(stack, url, name, params, n=N_WORKERS, **kw):
    results: dict[int, tuple] = {}
    drop_idx = kw.pop("drop_idx", None)
    masked = threading.Barrier(n)
    threads = [threading.Thread(target=_run_worker, args=(stack, url, name, i, params, results),
                                kwargs={"masked": masked, "drop": i == drop_idx, **kw},
                                daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN)
    assert not any(t.is_alive() for t in threads), f"workers stuck: {sorted(results)}"
    errors = {i: r for i, r in results.items() if r[0] == "error"}
    assert not errors, f"worker errors: {errors}"
    return results


def _latest(url, name):
    mc = ModelCentricFLClient(url, device="cpu")
    try:
        return [np.asarray(p.cpu()) for p in mc.retrieve_model(name, "1.0")]
    finally:
        mc.close()


def _check_aggregation(url, name, params, results, n_for_scale):
    survivor_diffs = [d for _, d in results.values() if d is not None]
    expected = [p - np.mean([d[k] for d in survivor_diffs], axis=0)
                for k, p in enumerate(params)]
    step = 1.0 / secagg.choose_scale(CLIP, n_for_scale)
    got = _latest(url, name)
    for a, want in zip(got, expected):
        np.testing.assert_allclose(a, want, atol=n_for_scale * step + 1e-6)
    assert not np.array_equal(got[0], params[0])


STACKS = [("port", "port"), ("port", "jax"), ("jax", "port")]


@pytest.mark.parametrize("session_stack, node_stack", STACKS)
def test_secagg_full_participation(nodes, plan_blob, session_stack, node_stack):
    """All 4 report; pairwise masks cancel in the node's accumulator and
    the unmask round only removes self-masks."""
    name = f"full-{session_stack}-on-{node_stack}"
    url = nodes[node_stack]
    params = _host(url, plan_blob, name, min_diffs=N_WORKERS, max_diffs=N_WORKERS)
    results = _run_round(session_stack, url, name, params)
    assert all(phase in ("done", "closed") for phase, _ in results.values())
    _check_aggregation(url, name, params, results, N_WORKERS)


@pytest.mark.parametrize("session_stack, node_stack", STACKS)
def test_secagg_with_dropout(nodes, plan_blob, session_stack, node_stack):
    """Worker 3 completes the key rounds then leaves before reporting:
    readiness fires at min_diffs=3, the survivors reconstruct the dropout's
    DH secret (3-of-4 Shamir) and the checkpoint is the survivors' mean."""
    name = f"drop-{session_stack}-on-{node_stack}"
    url = nodes[node_stack]
    params = _host(url, plan_blob, name)
    results = _run_round(session_stack, url, name, params, drop_idx=3)
    assert results[3][0] == "dropped"
    assert all(phase in ("done", "closed") for i, (phase, _) in results.items() if i != 3)
    _check_aggregation(url, name, params, results, N_WORKERS)


def test_secagg_rejects_plain_diff(nodes, plan_blob):
    """A raw (unmasked) State blob against a SecAgg process bounces at
    ingest."""
    url = nodes["port"]
    params = _host(url, plan_blob, "reject")
    client, session = _session("port", url, "reject")
    blob = serialize_model_params([torch.from_numpy(d) for d in _worker_diff(0, params)])
    out = client.report(session.worker_id, session.request_key, blob)
    assert "error" in out, out
    client.close()


def test_secagg_partial_roster_proceeds(nodes, plan_blob):
    """Only 3 of max_workers=4 show up: the advertise grace expires and the
    round proceeds with the 3 who advertised."""
    url = nodes["port"]
    params = _host(url, plan_blob, "partial", min_workers=3, phase_timeout=1.0)
    results = _run_round("port", url, "partial", params, n=3)
    _check_aggregation(url, "partial", params, results, 3)  # scale is len(mask_set) = 3


def test_secagg_masking_deadline_aggregates_when_sufficient(nodes, plan_blob):
    """Readiness never fires by count (max_diffs=4, 3 reports): the masking
    deadline hands the cycle to the unmask round, since reported >=
    min_diffs, instead of discarding 3 valid reports."""
    url = nodes["port"]
    params = _host(url, plan_blob, "mask-deadline", max_diffs=N_WORKERS, masking_timeout=3.0)
    results = _run_round("port", url, "mask-deadline", params, drop_idx=3)
    assert results[3][0] == "dropped"
    _check_aggregation(url, "mask-deadline", params, results, N_WORKERS)


def test_secagg_corrupt_share_fails_cycle_cleanly(nodes, plan_blob):
    """Two survivors reveal garbage b-shares: reconstruction fails and the
    cycle closes failed (the model unchanged) instead of wedging."""
    url = nodes["port"]
    params = _host(url, plan_blob, "corrupt", min_diffs=N_WORKERS, max_diffs=N_WORKERS)

    def tamper(i, session):
        if i not in (0, 1):
            return
        session._own_shares["b"] = (session._own_shares["b"][0], secagg.SHAMIR_PRIME - 12345)
        real_decrypt = session._decrypt_share

        def corrupt(from_wid):
            entry = real_decrypt(from_wid)
            entry["b"] = secagg.int_to_hex(secagg.SHAMIR_PRIME - 999)
            return entry

        session._decrypt_share = corrupt

    _run_round("port", url, "corrupt", params, tamper=tamper)
    for got, want in zip(_latest(url, "corrupt"), params):
        np.testing.assert_array_equal(got, want)


def test_secagg_incomplete_share_bundle_rejected(nodes, plan_blob):
    url = nodes["port"]
    _host(url, plan_blob, "incomplete")
    pairs = [_session("port", url, "incomplete") for _ in range(N_WORKERS)]
    for _, s in pairs:
        s.advertise()
    for _, s in pairs:
        s.wait_roster(timeout=WAIT)
    with pytest.raises(PyGridError, match="share bundle must cover"):
        pairs[0][1]._send(MODEL_CENTRIC_FL_EVENTS.SECAGG_SHARES, shares={})
    assert pairs[0][1].upload_shares().get("status") == "ok"
    for c, _ in pairs:
        c.close()


def test_secagg_host_rejects_bad_configs(nodes, plan_blob):
    params, blob = plan_blob
    base = {"min_workers": 2, "max_workers": 2, "min_diffs": 2, "max_diffs": 2,
            "num_cycles": 1}
    mc = ModelCentricFLClient(nodes["port"], device="cpu")
    for server_config in (
        {**base, "secure_aggregation": {"clip_range": -1.0}},
        {**base, "secure_aggregation": {"clip_range": 0.5},
         "differential_privacy": {"clip_norm": 1.0}},
        {**base, "secure_aggregation": "yes"},
        {**base, "secure_aggregation": {"clip_range": 0.5}, "max_workers": 1, "min_workers": 1},
        {**base, "min_workers": 4, "max_workers": 4, "min_diffs": 2, "max_diffs": 4,
         "secure_aggregation": {"clip_range": 0.5, "threshold": 2}},
    ):
        with pytest.raises(PyGridError):
            mc.host_federated_training(
                model=params, client_plans={"training_plan": blob},
                client_config={"name": "bad", "version": "1.0", "batch_size": B, "lr": 0.1,
                               "max_updates": 1},
                server_config=server_config)
    mc.close()


class _Roster:
    """A client whose every event answers a ready roster."""

    def __init__(self, threshold, n=4):
        self.pubs = {f"w{i}": secagg.DHKeyPair.generate().public for i in range(n)}
        self.threshold = threshold

    def _send_event(self, msg_type, data):
        return {"data": {"status": "ready", "threshold": self.threshold, "clip_range": CLIP,
                         "roster": {w: secagg.int_to_hex(p) for w, p in self.pubs.items()}}}


def test_session_refuses_a_sub_majority_threshold():
    with pytest.raises(SecAggRefusal, match="sub-majority"):
        SecAggSession(_Roster(threshold=2), "w0", "key").wait_roster(timeout=WAIT)
    SecAggSession(_Roster(threshold=3), "w0", "key").wait_roster(timeout=WAIT)


def test_session_refuses_to_reveal_the_sk_share_of_a_worker_it_saw_report():
    session = SecAggSession(_Roster(threshold=3), "w0", "key")
    session.wait_roster(timeout=WAIT)
    session._reported_survivors.add("w0")
    with pytest.raises(SecAggRefusal, match="refusing to unmask"):
        session.answer_unmask(["w1", "w2"], ["w0"])


def test_masked_blob_is_byte_identical_to_the_jax_sessions():
    """The same keys, seeds, roster and mask set in a port session (diffs
    as tensors) and a JAX session (numpy): the same masked envelope."""
    keys = {w: secagg.DHKeyPair.generate() for w in ("w0", "w1", "w2")}
    diffs = _worker_diff(7, [np.zeros((D, H), np.float32), np.zeros((H,), np.float32)])
    blobs = []
    for Session, lib, tensors in ((SecAggSession, secagg, True),
                                  (JSecAggSession, jsecagg, False)):
        s = Session(None, "w0", "key")
        s.keypair = lib.DHKeyPair(secret=keys["w0"].secret, public=keys["w0"].public)
        s.self_seed = bytes(range(16))
        s.clip_range, s.mask_set = CLIP, ["w0", "w1", "w2"]
        s.pair_secrets = {w: lib.dh_shared_secret(keys["w0"].secret, keys[w].public)
                          for w in ("w1", "w2")}
        blobs.append(s.masked_blob([torch.from_numpy(d) for d in diffs] if tensors else diffs))
    assert blobs[0] == blobs[1]


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def test_secagg_masked_cycle_through_one_subaggregator_hop(nodes, plan_blob):
    """Every masked report rides a port sub-aggregator: the node ingests
    masked partials (sums mod 2^32; the masks still cancel at unmask) and
    the checkpoint is the plain mean within n · step. The tail of the fold
    is flushed by advancing the sub-aggregator's injected clock once all
    four reports reached it."""
    url = nodes["port"]
    name = "hop"
    params = _host(url, plan_blob, name, min_diffs=N_WORKERS, max_diffs=N_WORKERS)
    clock = _Clock()
    server = web.BackgroundServer(create_subagg_app(url, fanout=N_WORKERS, flush_interval=0.5,
                                                    clock=clock)).start()
    agg = server.app["subagg"]
    agg.address = server.url
    results: dict[int, tuple] = {}
    masked = threading.Barrier(N_WORKERS)
    threads = [threading.Thread(target=_run_worker, args=("port", url, name, i, params, results),
                                kwargs={"masked": masked, "aggregator_url": server.url},
                                daemon=True)
               for i in range(N_WORKERS)]
    try:
        for t in threads:
            t.start()
        wait_for(lambda: agg.stats()["reports"] == N_WORKERS, timeout=JOIN,
                 what="four reports at the sub-aggregator")
        clock.t += 1.0
        agg.flush_stale()
        for t in threads:
            t.join(timeout=JOIN)
    finally:
        server.stop()
    assert not any(t.is_alive() for t in threads)
    errors = {i: r for i, r in results.items() if r[0] == "error"}
    assert not errors, f"worker errors: {errors}"
    stats = agg.stats()
    assert stats["leaves_forwarded"] == N_WORKERS and stats["flush_errors"] == 0, stats
    _check_aggregation(url, name, params, results, N_WORKERS)
