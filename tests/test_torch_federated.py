"""The port's model-centric FL cycle against the JAX package's.

Each scenario of tests/unit/test_federated.py (host conflict, assign /
accept / dedup / bandwidth, an invalid request key, a full round,
learning, ``num_cycles`` exhaustion, the iterative averaging plan, the
deadline with zero diffs) runs on both controllers, each on a sqlite
``Database``, with the same inputs: one JAX-built training plan blob, the
same params and data. Responses and typed errors must match; checkpoints
match within the plan dialect's tolerance (rtol 2e-4, atol 2e-5: the port's
workers run the plan's op list through ``run_oplist(backend="torch")``, the
JAX package's run its ``jax.export`` program).

Across the two stacks, at the controller level:
1. a JAX controller hosts the JAX-built plan, port workers download its
   ``"list"`` variant, train and report; the checkpoint equals a JAX-only
   run's within tolerance;
2. a port controller hosts the same plan, JAX workers train on its served
   ``"torchscript"`` bytes (the JAX node's bytes exactly); given the same
   diffs, its checkpoint is bit-identical to the JAX controller's.
"""

from __future__ import annotations

import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pygrid_tpu import federated as jfed
from pygrid_tpu import serde as jserde
from pygrid_tpu.plans import Plan as JPlan
from pygrid_tpu.plans import state as jstate
from pygrid_tpu.storage import Database as JDatabase
from pygrid_tpu.utils import exceptions as JE
from pygrid_tpu.utils.codes import CYCLE
from pygrid_tpu_torch import federated as tfed
from pygrid_tpu_torch import serde as tserde
from pygrid_tpu_torch.plans import state as tstate
from pygrid_tpu_torch.plans.translators import run_oplist
from pygrid_tpu_torch.storage import Database as TDatabase
from pygrid_tpu_torch.utils import exceptions as TE

RTOL, ATOL = 2e-4, 2e-5

jfed.tasks.set_sync(True)  # deterministic cycle completion
tfed.tasks.set_sync(True)


def _model_params():
    rng = np.random.RandomState(0)
    return [rng.randn(10, 4).astype(np.float32) * 0.1, np.zeros(4, np.float32)]


def _step(X, y, lr, w, b):
    def loss_fn(p):
        pred = X @ p[0] + p[1]
        return jnp.mean((pred - y) ** 2)

    loss, g = jax.value_and_grad(loss_fn)((w, b))
    return loss, w - lr * g[0], b - lr * g[1]


def _running_mean(avg_w, avg_b, diff_w, diff_b, i):
    return (avg_w * (i - 1) + diff_w) / i, (avg_b * (i - 1) + diff_b) / i


@pytest.fixture(scope="module")
def plans():
    """The JAX-built training and averaging plans, as wire blobs: both
    controllers host the same bytes."""
    train = JPlan(name="training_plan", id="fed-train", fn=_step).build(
        np.zeros((8, 10), np.float32), np.zeros((8, 4), np.float32), np.float32(0.1),
        *_model_params())
    avg = JPlan(name="avg", id="fed-avg", fn=_running_mean).build(
        np.zeros((10, 4), np.float32), np.zeros(4, np.float32),
        np.zeros((10, 4), np.float32), np.zeros(4, np.float32), np.float32(1.0))
    return {"train": jserde.serialize(train), "avg": jserde.serialize(avg)}


def _jax_run(plan, *args):
    return [np.asarray(o) for o in plan(*args)]


def _port_run(plan, *args):
    return [o.numpy() for o in plan(*args, device="cpu")]


STACKS = {
    "jax": types.SimpleNamespace(
        fed=jfed, Database=JDatabase, E=JE, serialize_params=jstate.serialize_model_params,
        host_params=jstate.unserialize_model_params, run=_jax_run),
    "torch": types.SimpleNamespace(
        fed=tfed, Database=TDatabase, E=TE, serialize_params=tstate.serialize_model_params,
        host_params=tstate.host_model_params, run=_port_run),
}

SERVER_CONFIG = {
    "min_workers": 2, "max_workers": 5, "num_cycles": 2, "cycle_length": None,
    "max_diffs": 2, "min_diffs": 2, "minimum_upload_speed": 0, "minimum_download_speed": 0,
}
CLIENT_CONFIG = {"name": "mnist", "version": "1.0", "batch_size": 8, "lr": 0.1,
                 "max_updates": 2}


def _controller(s, plans, server_config=None, avg=False, name="mnist"):
    ctl = s.fed.FLController(s.Database(":memory:"))
    ctl.create_process(
        model_blob=s.serialize_params(_model_params()),
        client_plans={"training_plan": plans["train"]},
        server_averaging_plan=plans["avg"] if avg else None,
        name=name, version="1.0",
        client_config=dict(CLIENT_CONFIG, name=name),
        server_config=dict(server_config or SERVER_CONFIG),
    )
    return ctl


def _register(ctl, wid, upload=100.0, download=100.0):
    w = ctl.worker_manager.create(wid)
    w.avg_upload, w.avg_download, w.ping = upload, download, 1.0
    ctl.worker_manager.update(w)
    return ctl.worker_manager.get(id=wid)


def _data():
    rng = np.random.RandomState(42)
    X = rng.randn(8, 10).astype(np.float32)
    return X, X @ rng.randn(10, 4).astype(np.float32)


def _one_round(s, ctl, worker_ids, lr=0.1):
    """Each worker assigns, downloads the model and the plan's
    "torchscript" variant, trains on the shared batch and reports."""
    X, y = _data()
    for wid in worker_ids:
        resp = ctl.assign("mnist", "1.0", _register(ctl, wid))
        if resp[CYCLE.STATUS] != CYCLE.ACCEPTED:
            continue
        params = s.host_params(ctl.model_manager.load(model_id=resp["model_id"],
                                                      alias="latest").value)
        plan = ctl.plan_manager.deserialize_plan(ctl.plan_manager.get_variant(
            resp[CYCLE.PLANS]["training_plan"], "torchscript"))
        _, new_w, new_b = s.run(plan, X, y, np.float32(lr), *params)
        diff = [np.asarray(p) - n for p, n in zip(params, (new_w, new_b))]
        ctl.submit_diff(wid, resp[CYCLE.KEY], s.serialize_params(diff))


def _latest(s, ctl, model_id=1):
    return s.host_params(ctl.model_manager.load(model_id=model_id, alias="latest").value)


def _error(fn):
    try:
        fn()
    except Exception as err:  # noqa: BLE001 — the class name is compared
        return type(err).__name__
    return None


# --- the scenarios: each returns what both stacks must agree on --------------------


def sc_host_conflict(s, plans):
    ctl = _controller(s, plans)
    return _error(lambda: ctl.create_process(
        model_blob=b"x", client_plans={"p": plans["train"]}, name="mnist", version="1.0",
        client_config={}, server_config={}))


def sc_assign_accept(s, plans):
    ctl = _controller(s, plans)
    resp = ctl.assign("mnist", "1.0", _register(ctl, "w1"))
    return {**{k: v for k, v in resp.items() if k != CYCLE.KEY},
            "key_len": len(resp[CYCLE.KEY]), "key_hex": int(resp[CYCLE.KEY], 16) >= 0}


def sc_assign_dedup(s, plans):
    ctl = _controller(s, plans)
    w = _register(ctl, "w1")
    return [ctl.assign("mnist", "1.0", w)[CYCLE.STATUS] for _ in range(2)]


def sc_assign_bandwidth(s, plans):
    ctl = _controller(s, plans, dict(SERVER_CONFIG, minimum_upload_speed=2.0,
                                     minimum_download_speed=4.0))
    slow = _register(ctl, "slow", upload=0.1, download=0.1)
    fast = _register(ctl, "fast")
    return [ctl.assign("mnist", "1.0", w)[CYCLE.STATUS] for w in (slow, fast)]


def sc_invalid_request_key(s, plans):
    ctl = _controller(s, plans)
    _register(ctl, "w1")
    return [_error(lambda: ctl.submit_diff("w1", "bogus", b"diff")),
            _error(lambda: ctl.submit_diff("w1", "", b"diff"))]


def sc_full_round(s, plans):
    ctl = _controller(s, plans)
    before = ctl.model_manager.load(model_id=1, alias="latest")
    _one_round(s, ctl, ["w1", "w2"])
    after = ctl.model_manager.load(model_id=1, alias="latest")
    return {"numbers": (before.number, after.number, after.alias),
            "sequence": ctl.cycle_manager.last(1).sequence,
            "first": ctl.model_manager.load(model_id=1, number=1).number,
            "params": s.host_params(after.value)}


def sc_learning(s, plans):
    ctl = _controller(s, plans)
    X, y = _data()

    def loss(p):
        return float(np.mean((X @ p[0] + p[1] - y) ** 2))

    l0 = loss(_latest(s, ctl))
    _one_round(s, ctl, ["w1", "w2"])
    _one_round(s, ctl, ["w3", "w4"])
    params = _latest(s, ctl)
    return {"learned": loss(params) < l0, "params": params}


def sc_num_cycles_exhaustion(s, plans):
    ctl = _controller(s, plans)
    _one_round(s, ctl, ["w1", "w2"])
    _one_round(s, ctl, ["w3", "w4"])
    return _error(lambda: ctl.cycle_manager.last(1))


def sc_iterative_averaging_plan(s, plans):
    ctl = _controller(s, plans, dict(SERVER_CONFIG, iterative_plan=True, num_cycles=1),
                      avg=True)
    p0 = _latest(s, ctl)
    for wid, (dw, db) in (("w1", (0.5, 0.1)), ("w2", (1.5, 0.3))):
        resp = ctl.assign("mnist", "1.0", _register(ctl, wid))
        ctl.submit_diff(wid, resp[CYCLE.KEY], s.serialize_params(
            [np.full((10, 4), dw, np.float32), np.full(4, db, np.float32)]))
    p1 = _latest(s, ctl)
    return {"delta": [a - b for a, b in zip(p0, p1)]}


def sc_deadline_zero_diffs(s, plans):
    ctl = _controller(s, plans, {"min_workers": 1, "max_workers": 5, "cycle_length": 1,
                                 "num_cycles": 2})
    first = ctl.cycle_manager._cycles.first(is_completed=False)
    deadline = time.monotonic() + 8.0
    while time.monotonic() < deadline:
        if ctl.cycle_manager._cycles.first(id=first.id).is_completed:
            break
        time.sleep(0.05)
    model = ctl.model_manager.get(fl_process_id=1)
    out = {"closed": ctl.cycle_manager._cycles.first(id=first.id).is_completed,
           "number": ctl.model_manager.load(model_id=model.id, alias="latest").number,
           "sequence": ctl.cycle_manager.last(1).sequence}
    for timer in list(ctl.cycle_manager._deadline_timers.values()):
        timer.cancel()  # the next cycle's deadline must not fire into later tests
    return out


SCENARIOS = [sc_host_conflict, sc_assign_accept, sc_assign_dedup, sc_assign_bandwidth,
             sc_invalid_request_key, sc_full_round, sc_learning, sc_num_cycles_exhaustion,
             sc_iterative_averaging_plan, sc_deadline_zero_diffs]


def _assert_agree(ref, got):
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _assert_agree(ref[k], got[k])
    elif isinstance(ref, (list, tuple)) and ref and isinstance(ref[0], np.ndarray):
        assert len(got) == len(ref)
        for a, b in zip(ref, got):
            assert b.dtype == a.dtype and b.shape == a.shape
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    else:
        assert got == ref


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
def test_scenario_matches_the_jax_controller(scenario, plans):
    ref = scenario(STACKS["jax"], plans)
    got = scenario(STACKS["torch"], plans)
    assert ref is not None
    _assert_agree(ref, got)


def test_scenarios_reach_their_outcomes(plans):
    """What each scenario shows, stated on the port alone."""
    s = STACKS["torch"]
    assert sc_host_conflict(s, plans) == "FLProcessConflict"
    assert sc_assign_dedup(s, plans) == [CYCLE.ACCEPTED, CYCLE.REJECTED]
    assert sc_assign_bandwidth(s, plans) == [CYCLE.REJECTED, CYCLE.ACCEPTED]
    assert sc_invalid_request_key(s, plans) == ["InvalidRequestKeyError",
                                                "MissingRequestKeyError"]
    full = sc_full_round(s, plans)
    assert full["numbers"] == (1, 2, "latest") and full["sequence"] == 2
    assert not np.allclose(full["params"][0], _model_params()[0])
    assert sc_learning(s, plans)["learned"]
    assert sc_num_cycles_exhaustion(s, plans) == "CycleNotFoundError"
    delta = sc_iterative_averaging_plan(s, plans)["delta"]
    np.testing.assert_allclose(delta[0], np.full((10, 4), 1.0), atol=1e-5)
    np.testing.assert_allclose(delta[1], np.full(4, 0.2), atol=1e-5)


# --- across the two stacks ----------------------------------------------------------


def test_jax_controller_trains_with_port_workers(plans):
    """Port workers fetch the JAX node's model (f32, and bf16 for one) and
    its "list" variant, run the op list on torch and report through the
    port's serde; the JAX node's checkpoint equals a JAX-only run's."""
    j, t = STACKS["jax"], STACKS["torch"]
    reference = _controller(j, plans)
    _one_round(j, reference, ["w1", "w2"])
    mixed = _controller(j, plans)
    X, y = _data()
    for k, wid in enumerate(("w1", "w2")):
        resp = mixed.assign("mnist", "1.0", _register(mixed, wid))
        blob = mixed.model_manager.load_encoded(resp["model_id"],
                                                precision="bf16" if k else None)
        params = [p.numpy() for p in tstate.unserialize_model_params(blob, device="cpu")]
        if k:  # the bf16 download decodes to the f32 values' bf16 rounding
            f32 = _model_params()
            assert all(np.allclose(a, b, rtol=2 ** -8, atol=0) for a, b in zip(params, f32))
            params = f32
        oplist = tserde.deserialize(mixed.plan_manager.get_variant(
            resp[CYCLE.PLANS]["training_plan"], "list"))
        _, new_w, new_b = run_oplist(oplist, X, y, np.float32(0.1), *params, device="cpu")
        diff = [p - n.numpy() for p, n in zip(params, (new_w, new_b))]
        mixed.submit_diff(wid, resp[CYCLE.KEY], t.serialize_params(diff))
    got, ref = _latest(j, mixed), _latest(j, reference)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    assert mixed.cycle_manager.last(1).sequence == 2


def _assert_bits(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_port_controller_serves_jax_workers_bit_for_bit(plans):
    """A port node serves the JAX node's plan bytes for every variant and
    the same model bytes; JAX workers train on the "torchscript" bytes it
    serves, and given the same diff blobs its checkpoints hold the JAX
    node's tensors bit for bit, round after round."""
    j, t = STACKS["jax"], STACKS["torch"]
    jctl, tctl = _controller(j, plans), _controller(t, plans)
    for variant in ("list", "torchscript", "tfjs"):
        assert tctl.plan_manager.get_variant(1, variant) == jctl.plan_manager.get_variant(
            1, variant)
    assert tctl.plan_manager.get_variant(1, "torchscript") == plans["train"]
    for precision in (None, "bf16"):  # PlaceHolder ids are drawn per blob: compare tensors
        _assert_bits(j.host_params(tctl.model_manager.load_encoded(1, precision=precision)),
                     j.host_params(jctl.model_manager.load_encoded(1, precision=precision)))
    X, y = _data()
    for rnd, workers in enumerate((("w1", "w2"), ("w3", "w4"))):
        for k, wid in enumerate(workers):
            tresp = tctl.assign("mnist", "1.0", _register(tctl, wid))
            jresp = jctl.assign("mnist", "1.0", _register(jctl, wid))
            plan = jserde.deserialize(tctl.plan_manager.get_variant(
                tresp[CYCLE.PLANS]["training_plan"], "torchscript"))
            assert plan.exported_blob is not None
            params = j.host_params(tctl.model_manager.load_encoded(tresp["model_id"]))
            _, new_w, new_b = plan(X * (k + 1), y, np.float32(0.1), *params)
            diff = [p - np.asarray(n) for p, n in zip(params, (new_w, new_b))]
            blob = j.serialize_params(diff, bf16=bool(k))
            tctl.submit_diff(wid, tresp[CYCLE.KEY], blob)
            jctl.submit_diff(wid, jresp[CYCLE.KEY], blob)
        tckpt = tctl.model_manager.load(model_id=1, alias="latest")
        jckpt = jctl.model_manager.load(model_id=1, alias="latest")
        assert tckpt.number == jckpt.number == rnd + 2
        _assert_bits(j.host_params(tckpt.value), j.host_params(jckpt.value))
    with pytest.raises(TE.CycleNotFoundError):
        tctl.cycle_manager.last(1)


def test_port_cycle_manager_decodes_on_the_host():
    """The cycle manager's checkpoints decode to host numpy (the
    reference's form), and its accumulator folds exactly as the JAX
    package's does."""
    from pygrid_tpu.federated.cycle_manager import _DiffAccumulator as JAcc
    from pygrid_tpu_torch.federated.cycle_manager import _DiffAccumulator as TAcc

    rng = np.random.RandomState(11)
    diffs = [[rng.randn(37, 5).astype(np.float32), rng.randn(5).astype(np.float32)]
             for _ in range(4)]
    accs = {"jax": JAcc(), "torch": TAcc()}
    for d in diffs:
        for name, acc in accs.items():
            acc.add_raw((jserde if name == "jax" else tserde).state_raw_tensors(
                jstate.serialize_model_params(d, bf16=True)), weight=0.5)
            acc.add(d)
    for a, b in zip(accs["jax"].mean(), accs["torch"].mean()):
        np.testing.assert_array_equal(a, b)
    params = tstate.host_model_params(tstate.serialize_model_params(diffs[0]))
    assert all(type(p) is np.ndarray for p in params)


# --- the host-side helpers, module for module ---------------------------------------

_DIFFS = [[np.random.RandomState(k).randn(40, 3).astype(np.float32),
           np.random.RandomState(k + 50).randn(3).astype(np.float32)] for k in range(7)]


def _h_auth_hs256(fed, sd):
    token = fed.auth.jwt_encode({"sub": "w1", "n": 3}, secret="topsecret")
    return [token, fed.auth.verify_token(token, {"authentication": {"secret": "topsecret"}}),
            _error(lambda: fed.auth.verify_token(token[:-3] + "xyz",
                                                 {"authentication": {"secret": "topsecret"}})),
            _error(lambda: fed.auth.verify_token(None, {"authentication": {"secret": "s"}})),
            fed.auth.verify_token(None, {})]


def _h_compression(fed, sd):
    from importlib import import_module

    comp = import_module(fed.__name__ + ".compression")
    payload, residual = comp.topk_compress(_DIFFS[0] + [np.arange(2000, dtype=np.float32)], 0.1)
    return [sd.serialize(payload), residual, comp.decode_diff(sd.serialize(payload))]


def _h_robust(fed, sd):
    from importlib import import_module

    robust = import_module(fed.__name__ + ".robust")
    return [robust.robust_aggregate(_DIFFS, {"name": "median"}),
            robust.robust_aggregate(_DIFFS, {"name": "trimmed_mean", "trim_fraction": 0.2}),
            _error(lambda: robust.validate_config({"robust_aggregation": {"name": "mode"}}))]


def _h_server_opt(fed, sd):
    from importlib import import_module

    opt = import_module(fed.__name__ + ".server_opt")
    out = []
    for cfg in (None, {"name": "sgd", "lr": 0.5}, {"name": "momentum", "lr": 0.5},
                {"name": "adam", "lr": 0.1}):
        params, state = opt.apply_server_optimizer(_DIFFS[1], _DIFFS[2], cfg, None)
        out += params
        if state is not None:  # a second step from the first one's state
            out += opt.apply_server_optimizer(params, _DIFFS[3], cfg, state)[0]
    return out + [_error(lambda: opt.apply_server_optimizer(_DIFFS[1], _DIFFS[2],
                                                            {"name": "lion"}, None))]


def _h_privacy(fed, sd):
    from importlib import import_module

    priv = import_module(fed.__name__ + ".privacy")
    return [priv.global_l2_norm(_DIFFS[0]), priv.clip_diff(_DIFFS[0], 1.5),
            priv.clip_diff(_DIFFS[0], 1e9), priv.add_gaussian_noise(_DIFFS[1], 1.0, 0.0, 4),
            [t.shape for t in priv.local_dp_noise(_DIFFS[1], 1.0, 0.5)]]


def _h_selection(fed, sd):
    from importlib import import_module

    sel = import_module(fed.__name__ + ".selection")
    gates = [sel.eligibility_reason(server_config={"minimum_upload_speed": 2,
                                                   "do_not_reuse_workers_until_cycle": 3},
                                    cycle_sequence=c, already_in_cycle=a, last_participation=lp,
                                    up_speed=up, down_speed=5.0)
             for c, a, lp, up in ((4, False, 0, 1.0), (4, False, 2, 5.0), (4, True, 0, 5.0),
                                  (9, False, 2, 5.0))]
    return gates + [sel.solve_admission_rate(k) for k in (1, 4, 16, 100)]


def _h_secagg(fed, sd):
    from importlib import import_module

    sa = import_module(fed.__name__ + ".secagg")
    q = sa.quantize(_DIFFS[0], 4.0, 8)
    return [sa.expand_mask(b"seed", [(3, 4), (5,)]), q,
            sa.dequantize_sum(q, 4.0, 8, 1), sa.shamir_recover(
                sa.shamir_share(12345678901234567890, 5, 3)[1:4]),
            sa.decode_masked_diff(sa.encode_masked_diff(q)), sa.kdf(b"k", "pairwise-mask")]


def _h_partials(fed, sd):
    from importlib import import_module

    part = import_module(fed.__name__ + ".partials")
    env = part.encode_partial_envelope(b"state-bytes", 3, 2.5, masked=True)
    return [env, part.decode_partial_envelope(env), part.decode_partial_envelope(b"\x00\x01")]


HELPERS = [_h_auth_hs256, _h_compression, _h_robust, _h_server_opt, _h_privacy,
           _h_selection, _h_secagg, _h_partials]


def _same(ref, got):
    if isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for a, b in zip(ref, got):
            _same(a, b)
    elif isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _same(ref[k], got[k])
    else:
        assert got == ref


@pytest.mark.parametrize("helper", HELPERS, ids=lambda f: f.__name__[3:])
def test_host_side_helper_matches_the_jax_package(helper):
    """The port's copies of the federated helpers give the JAX package's
    results, bytes and typed errors on the same inputs (exact: they are
    the same numpy and stdlib code)."""
    _same(helper(jfed, jserde), helper(tfed, tserde))


def test_rs256_tokens_cross_between_the_packages():
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import rsa

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    priv = key.private_bytes(serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
                             serialization.NoEncryption())
    cfg = {"authentication": {"pub_key": key.public_key().public_bytes(
        serialization.Encoding.PEM, serialization.PublicFormat.SubjectPublicKeyInfo).decode()}}
    for enc, dec in ((jfed, tfed), (tfed, jfed)):
        token = enc.auth.jwt_encode({"sub": "w2", "exp": time.time() + 60},
                                    private_key_pem=priv)
        assert dec.auth.verify_token(token, cfg)["payload"]["sub"] == "w2"
        expired = enc.auth.jwt_encode({"sub": "w2", "exp": time.time() - 10},
                                      private_key_pem=priv)
        with pytest.raises(TE.AuthorizationError if dec is tfed else JE.AuthorizationError):
            dec.auth.verify_token(expired, cfg)
