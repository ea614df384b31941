"""Port parity: the port's remote SMPC plane (RemoteCryptoProvider,
RemoteSharedTensor, the Beaver round across worker parties) and its
encrypted inference (run_encrypted_oplist, EncryptedModel) against the JAX
package's, bit for bit.

The two stacks get the same random quantities: input shares, Beaver
triples and truncation pairs are drawn once with numpy and injected — the
shares sent to the parties of each stack, the primitives put into both
providers' strict stores (the JAX side as ``Ring64``, the port's through
``convert.ring_from_numpy``). Every client message travels as a frame
through the party's ``_recv_msg`` and object ids are drawn from one
counter per stack, so the two stacks' frames are compared byte for byte,
and each party's output shares bit for bit. The port runs on the CPU
(its ring matmul takes the plain version).
"""

import itertools

import numpy as np
import pytest
import torch

from pygrid_tpu import serde as jserde
from pygrid_tpu.runtime import VirtualWorker as JWorker
from pygrid_tpu.runtime import pointers as JP
from pygrid_tpu.runtime import store as JS
from pygrid_tpu.smpc import remote as JRemote
from pygrid_tpu.smpc import ring as JR
from pygrid_tpu.smpc.encrypted_model import run_encrypted_oplist as j_run_encrypted
from pygrid_tpu.smpc.fixed import FixedPointEncoder as JEncoder
from pygrid_tpu.smpc.provider import CryptoProvider as JProvider
from pygrid_tpu.smpc.provider import CryptoStore as JStore
from pygrid_tpu_torch import convert, serde
from pygrid_tpu_torch.plans import Plan
from pygrid_tpu_torch.runtime import PointerTensor, VirtualWorker, send
from pygrid_tpu_torch.runtime import pointers as P
from pygrid_tpu_torch.runtime import store as S
from pygrid_tpu_torch.smpc import (
    CryptoProvider,
    CryptoStore,
    EncryptedModel,
    FixedPointEncoder,
    RemoteCryptoProvider,
    RemoteSharedTensor,
    SharedTensorRef,
    fix_prec_share_to_nodes,
    publish_encrypted_model,
    run_encrypted_oplist,
    share_to_nodes,
)
from pygrid_tpu_torch.smpc import remote as PRemote
from pygrid_tpu_torch.smpc import ring as R
from pygrid_tpu_torch.utils.exceptions import EmptyCryptoPrimitiveStoreError, PlanInvalidError
from test_torch_plans import FIXTURES, build_cryptonets_plan, cryptonets_forward

torch.set_num_threads(1)

U64 = np.uint64
HOLDERS = ("alice", "bob", "charlie")
#: the small CryptoNets MLP: x, w1, b1, w2, b2 (16→8→4, batch 4)
SMALL = ((4, 16), (16, 8), (8,), (8, 4), (4,))
#: the decoded output against the float64 forward at the small size: two
#: 1e-3 encodings of 16- and 8-term sums and two truncations (ε ≤ 1 ulp each)
SMALL_ATOL = 2e-2


def np_shares(rng, v, n):
    v = np.asarray(v, dtype=U64)
    r = rng.integers(0, 2**64, size=(n - 1,) + v.shape, dtype=U64)
    with np.errstate(over="ignore"):
        return np.concatenate([r, (v - r.sum(axis=0, dtype=U64))[None]])


def np_triple(rng, op, sx, sy, n):
    a = rng.integers(0, 2**64, size=sx, dtype=U64)
    b = rng.integers(0, 2**64, size=sy, dtype=U64)
    with np.errstate(over="ignore"):
        c = a * b if op == "mul" else np.matmul(a, b)
    return [np_shares(rng, v, n) for v in (a, b, c)]


def np_trunc_pair(rng, shape, scale, n):
    r = rng.integers(0, 2**62, size=shape, dtype=U64)
    return [np_shares(rng, r, n), np_shares(rng, r // U64(scale), n)]


def weights_for(shapes, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, shapes[0])
    w1 = rng.standard_normal(shapes[1]) * (2.0 / shapes[1][0]) ** 0.5
    b1 = rng.uniform(-0.1, 0.1, shapes[2])
    w2 = rng.standard_normal(shapes[3]) * (2.0 / shapes[3][0]) ** 0.5
    b2 = rng.uniform(-0.1, 0.1, shapes[4])
    return [x, w1, b1, w2, b2]


def steps(shapes):
    """(op, shape_x, shape_y, truncated shape) of each Beaver round of the
    CryptoNets forward, in order."""
    (B, d0), (_, d1), _, (_, d2), _ = shapes
    return (("matmul", (B, d0), (d0, d1), (B, d1)),
            ("mul", (B, d1), (B, d1), (B, d1)),
            ("matmul", (B, d1), (d1, d2), (B, d2)))


class Wire:
    """A party as a client reaches it over the network: every message is a
    frame through the party's ``_recv_msg``; (party, request, response)
    bytes are logged."""

    def __init__(self, worker, ser, de, log):
        self.worker, self.id, self._ser, self._de, self.log = worker, worker.id, ser, de, log

    def recv_obj_msg(self, msg, user=None):
        request = self._ser(msg)
        response = self.worker._recv_msg(request, user=user)
        self.log.append((self.id, request, response))
        return self._de(response)


def _counter(monkeypatch, *modules):
    ids = itertools.count(1000)
    for mod in modules:
        monkeypatch.setattr(mod, "fresh_id", lambda: next(ids))


def build_stacks(monkeypatch, shapes, n_parties=3, refill_first=True, seed=1):
    """Both stacks' parties and providers, with the same primitives in both
    strict stores. With ``refill_first`` the first matmul triple is held
    back: the first deal answers EmptyCryptoPrimitiveStoreError, and the
    client's auto_refill ``provide`` round puts it in (``provide`` is
    replaced by the injection, in both stacks)."""
    _counter(monkeypatch, JP, JS, JRemote)
    _counter(monkeypatch, P, S, PRemote)
    rng = np.random.default_rng(seed)
    names = HOLDERS[:n_parties] if n_parties <= 3 else HOLDERS + ("erin",)
    jlog, plog = [], []
    jws = [JWorker(n) for n in names]
    pws = [VirtualWorker(n, device="cpu") for n in names]
    jdan, pdan = JWorker("dan"), VirtualWorker("dan", device="cpu")
    jdan.crypto_provider = JProvider(strict_store=True)
    pdan.crypto_provider = CryptoProvider(strict_store=True, device="cpu")
    for w in jws:
        jdan.add_worker(w)
    for w in pws:
        pdan.add_worker(w)
    scale = JEncoder().scale
    held = {}
    for k, (op, sx, sy, ts) in enumerate(steps(shapes)):
        items = [(JStore.key(op, sx, sy, n_parties), np_triple(rng, op, sx, sy, n_parties)),
                 (JStore.key("trunc", ts, (scale,), n_parties),
                  np_trunc_pair(rng, ts, scale, n_parties))]
        for key, arrays in items:
            jitem = tuple(JR.to_ring(a) for a in arrays)
            pitem = convert.ring_from_numpy(tuple((np.asarray(r.lo), np.asarray(r.hi))
                                                  for r in jitem), "cpu")
            if refill_first and k == 0 and key[0] == "matmul":
                held[key] = (jitem, pitem)
                continue
            jdan.crypto_provider.store.put(key, jitem)
            pdan.crypto_provider.store.put(key, pitem)
    refills = {"jax": 0, "port": 0}

    def refill(name, prov, idx):
        def provide(op, shape_x, shape_y, n, n_instances=1):
            key = CryptoStore.key(op, shape_x, shape_y, n)
            prov.store.put(key, held[key][idx])
            refills[name] += 1
        return provide

    jdan.crypto_provider.provide = refill("jax", jdan.crypto_provider, 0)
    pdan.crypto_provider.provide = refill("port", pdan.crypto_provider, 1)
    j_parties = [Wire(w, jserde.serialize, jserde.deserialize, jlog) for w in jws]
    p_parties = [Wire(w, serde.serialize, lambda b: serde.deserialize(b, device="cpu"), plog)
                 for w in pws]
    jprov = JRemote.RemoteCryptoProvider(Wire(jdan, jserde.serialize, jserde.deserialize, jlog))
    pprov = RemoteCryptoProvider(Wire(pdan, serde.serialize,
                                      lambda b: serde.deserialize(b, device="cpu"), plog))
    return dict(rng=rng, j_parties=j_parties, p_parties=p_parties, jprov=jprov, pprov=pprov,
                jlog=jlog, plog=plog, refills=refills, jws=jws, pws=pws)


def share_both(st, value):
    """One fixed-point secret shared alike in both stacks: the same numpy
    shares sent to each stack's parties."""
    n = len(st["j_parties"])
    v = JR.from_ring(JEncoder().encode(value))
    shares = np_shares(st["rng"], v, n).view(np.int64)
    jptrs = [JP.send(shares[i], p) for i, p in enumerate(st["j_parties"])]
    pptrs = [send(torch.from_numpy(shares[i].copy()), p) for i, p in enumerate(st["p_parties"])]
    return (JRemote.RemoteSharedTensor(jptrs, JEncoder(), st["jprov"]),
            RemoteSharedTensor(pptrs, FixedPointEncoder(), st["pprov"], device="cpu"))


def party_shares(jt, pt):
    """Each party's output share in both stacks (read without deleting)."""
    j = [np.asarray(p.get(delete=False)) for p in jt.pointers]
    q = [np.asarray(p.get(delete=False)) for p in pt.pointers]
    return j, q


def run_plan_both(monkeypatch, plan_blob, shapes, **kw):
    st = build_stacks(monkeypatch, shapes, **kw)
    values = weights_for(shapes)
    pairs = [share_both(st, v) for v in values]
    jplan, pplan = jserde.deserialize(plan_blob), serde.deserialize(plan_blob, device="cpu")
    jout = j_run_encrypted(jplan.oplist, [j for j, _ in pairs])
    pout = run_encrypted_oplist(pplan.oplist, [p for _, p in pairs])
    return st, values, jout, pout


# --------------------------------------------------------------------------
# bit-identical encrypted inference against the JAX package
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_plan_blob():
    return jserde.serialize(build_cryptonets_plan(SMALL, plan_id="cryptonets-16-8-4-b4"))


def test_encrypted_oplist_bit_identical_to_the_jax_package(monkeypatch, small_plan_blob):
    """The JAX-built plan's op-list over three parties in both stacks, the
    same shares and primitives injected: every party's output share is the
    same bits, every frame (request and answer) the same bytes, and the
    first deal goes through auto_refill's EmptyCryptoPrimitiveStoreError
    round trip once in each stack."""
    st, values, jout, pout = run_plan_both(monkeypatch, small_plan_blob, SMALL)
    jsh, psh = party_shares(jout, pout)
    for a, b in zip(jsh, psh):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    assert st["refills"] == {"jax": 1, "port": 1}
    errors = [r for _, _, r in st["plog"] if b"EmptyCryptoPrimitiveStoreError" in r]
    assert len(errors) == 1
    assert len(st["plog"]) == len(st["jlog"]) > 100
    for i, (j, p) in enumerate(zip(st["jlog"], st["plog"])):
        assert j == p, (i, jserde.deserialize(j[1]), serde.deserialize(p[1], device="cpu"))
    want = cryptonets_forward(*[v.astype(np.float32).astype(np.float64) if i == 0 else v
                                for i, v in enumerate(values)])
    got = pout.get()
    np.testing.assert_array_equal(got, jout.get())
    assert np.abs(got - want).max() <= SMALL_ATOL
    # temporaries are deleted as the reference deletes them: the parties
    # hold the same objects at the same ids
    for jw, pw in zip(st["jws"], st["pws"]):
        assert sorted(jw.store.ids()) == sorted(pw.store.ids())


@pytest.mark.parametrize("n_parties", [2, 4])
def test_beaver_rounds_bit_identical_over_2_and_4_parties(monkeypatch, n_parties):
    """The three Beaver rounds of the forward driven directly (matmul, mul,
    matmul, each truncated), over 2 and 4 parties."""
    st = build_stacks(monkeypatch, SMALL, n_parties=n_parties, refill_first=False, seed=n_parties)
    x, w1, _, w2, _ = [share_both(st, v) for v in weights_for(SMALL, seed=n_parties)]
    for side in (0, 1):
        h = x[side] @ w1[side]
        h2 = h * h
        out = h2 @ w2[side]
        if side == 0:
            jsteps = (h, h2, out)
        else:
            psteps = (h, h2, out)
    for jt, pt in zip(jsteps, psteps):
        for a, b in zip(*party_shares(jt, pt)):
            np.testing.assert_array_equal(a, b)
    for j, p in zip(st["jlog"], st["plog"]):
        assert j == p


def test_committed_cryptonets_fixture(monkeypatch):
    """pygrid_tpu_torch/plans/fixtures/cryptonets_plan.bin, the plan the
    card's machine runs: it decodes in both packages, re-serializes to its
    own bytes in both, has the op-list the encrypted interpreter lowers,
    and its full-width forward (784→392→10, batch 256) gives bit-identical
    output shares in both stacks."""
    blob = (FIXTURES / "cryptonets_plan.bin").read_bytes()
    plan, jplan = serde.deserialize(blob, device="cpu"), jserde.deserialize(blob)
    assert isinstance(plan, Plan) and plan.oplist is not None
    assert serde.serialize(plan) == blob and jserde.serialize(jplan) == blob
    assert [e["op"] for e in plan.oplist["eqns"]] == [
        "dot_general", "broadcast_in_dim", "add", "mul", "dot_general", "broadcast_in_dim", "add"]
    full = tuple(tuple(s["shape"]) for s in plan.input_specs)
    assert full == ((256, 784), (784, 392), (392,), (392, 10), (10,))
    st, values, jout, pout = run_plan_both(monkeypatch, blob, full, refill_first=False)
    for a, b in zip(*party_shares(jout, pout)):
        np.testing.assert_array_equal(a, b)
    assert len(st["jlog"]) == len(st["plog"])
    assert all(j == p for j, p in zip(st["jlog"], st["plog"]))


def test_encrypted_forward_launches_the_ring_kernel_16_times(monkeypatch, small_plan_blob):
    """EncryptedModel.predict with a provider dealing on demand: each of the
    two matmul rounds calls the ring-matmul kernel's wrapper 8 times (the
    dealt c = a·b, d·[b]ᵢ and [a]ᵢ·e at 3 parties, the client's d·e); the
    mul round and the truncations call it none. On the card each call is
    one launch (phase datacentric counts them there)."""
    calls = []
    real = R.ring_matmul_kernel
    monkeypatch.setattr(R, "ring_matmul_kernel", lambda a, b: calls.append(a.shape) or real(a, b))
    holders = [VirtualWorker(n, device="cpu") for n in HOLDERS]
    dan = VirtualWorker("dan", device="cpu")
    dan.crypto_provider = CryptoProvider(seed=3, device="cpu")
    for h in holders:
        dan.add_worker(h)
    provider = RemoteCryptoProvider(dan)
    x, *weights = weights_for(SMALL)
    g = torch.Generator().manual_seed(4)
    shared = [fix_prec_share_to_nodes(w, holders, crypto_provider=provider, generator=g,
                                      device="cpu") for w in weights]
    assert not calls
    model = EncryptedModel(serde.deserialize(small_plan_blob, device="cpu"), shared, holders,
                           provider, FixedPointEncoder(), device="cpu")
    got = model.predict(x, generator=g)
    assert len(calls) == 16
    want = cryptonets_forward(x.astype(np.float32).astype(np.float64), *weights)
    assert got.shape == (4, 4) and np.abs(got - want).max() <= SMALL_ATOL


def test_port_built_plan_predicts_bit_identically_to_the_jax_built_plan(
        monkeypatch, small_plan_blob):
    """A CryptoNets forward built by the port (its op list from
    fx_to_oplist) runs through EncryptedModel.predict on CPU workers to the
    same output, bit for bit, as the JAX-built plan given the same dealer
    seed and generator — and with the same 16 ring-kernel calls."""
    calls = []
    real = R.ring_matmul_kernel
    monkeypatch.setattr(R, "ring_matmul_kernel", lambda a, b: calls.append(a.shape) or real(a, b))
    port_plan = Plan(name="encrypted_forward", fn=cryptonets_forward)
    port_plan.build(*[np.zeros(s, np.float32) for s in SMALL])
    x, *weights = weights_for(SMALL)
    outs = []
    for plan in (serde.deserialize(small_plan_blob, device="cpu"), port_plan):
        holders = [VirtualWorker(n, device="cpu") for n in HOLDERS]
        dan = VirtualWorker("dan", device="cpu")
        dan.crypto_provider = CryptoProvider(seed=3, device="cpu")
        for h in holders:
            dan.add_worker(h)
        provider = RemoteCryptoProvider(dan)
        g = torch.Generator().manual_seed(4)
        shared = [fix_prec_share_to_nodes(w, holders, crypto_provider=provider, generator=g,
                                          device="cpu") for w in weights]
        calls.clear()
        model = EncryptedModel(plan, shared, holders, provider, FixedPointEncoder(),
                               device="cpu")
        outs.append(model.predict(x, generator=g))
        assert len(calls) == 16
    np.testing.assert_array_equal(outs[0], outs[1])


def test_predict_raises_for_a_plan_without_an_op_list():
    built = Plan(name="port-built", fn=cryptonets_forward)
    built.build(*[np.zeros(s, np.float32) for s in SMALL])
    plan = Plan(name="blob-only", torch_blob=built.torch_blob)
    assert plan.oplist is None
    w = VirtualWorker("alice", device="cpu")
    model = EncryptedModel(plan, [], [w, w], RemoteCryptoProvider(w), FixedPointEncoder(),
                           device="cpu")
    with pytest.raises(PlanInvalidError):
        model.predict(np.zeros(SMALL[0], np.float32))


# --------------------------------------------------------------------------
# the remote shared tensor's own surface (tests/integration/test_remote_smpc.py
# on in-process port workers)
# --------------------------------------------------------------------------


@pytest.fixture()
def grid():
    holders = [VirtualWorker(n, device="cpu") for n in HOLDERS + ("erin",)]
    dan = VirtualWorker("dan", device="cpu")
    dan.crypto_provider = CryptoProvider(seed=7, device="cpu")
    for h in holders:
        dan.add_worker(h)
    return holders, RemoteCryptoProvider(dan)


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


def test_share_across_four_parties_and_reconstruct(grid):
    holders, _ = grid
    x = np.array([[1.5, -2.25], [0.125, 4.0]])
    shared = fix_prec_share_to_nodes(x, holders, tags=("#share", "#x"), generator=_g(),
                                     device="cpu")
    assert shared.n_parties == 4 and shared.shape == (2, 2)
    alice_share = shared.pointers[0].get(delete=False)
    assert alice_share.dtype == torch.int64
    assert not np.array_equal(alice_share.numpy(), (x * 1000).astype(np.int64))
    assert len(holders[1].search("#share", "#x")) == 1
    np.testing.assert_allclose(shared.get(), x, atol=1e-3)


def test_remote_share_local_linear_ops(grid):
    holders, _ = grid
    x, y = np.array([2.5, -1.0, 0.5]), np.array([0.25, 3.0, -0.75])
    sx = fix_prec_share_to_nodes(x, holders, generator=_g(1), device="cpu")
    sy = fix_prec_share_to_nodes(y, holders, generator=_g(2), device="cpu")
    np.testing.assert_allclose((sx + sy).get(delete=False), x + y, atol=1e-3)
    np.testing.assert_allclose((sx - sy).get(delete=False), x - y, atol=1e-3)
    np.testing.assert_allclose(sx.mul_public(3).get(delete=False), 3 * x, atol=1e-3)
    np.testing.assert_allclose((sx * 2).get(), 2 * x, atol=1e-3)


def test_integer_sharing_without_encoder(grid):
    holders, _ = grid
    v = np.array([123456789, -42], dtype=np.int64)
    np.testing.assert_array_equal(share_to_nodes(v, holders, generator=_g(), device="cpu").get(), v)


def test_mismatched_parties_and_encoders_rejected(grid):
    holders, _ = grid
    sx = share_to_nodes(np.array([1]), holders[:2], device="cpu")
    sy = share_to_nodes(np.array([2]), holders[:3], device="cpu")
    with pytest.raises(ValueError):
        _ = sx + sy
    with pytest.raises(ValueError):
        sx.mul_public(1.5)
    with pytest.raises(ValueError, match="encoder"):
        _ = fix_prec_share_to_nodes(np.array([1.0]), holders, device="cpu") + \
            share_to_nodes(np.array([2]), holders, device="cpu")
    with pytest.raises(ValueError, match="different parties"):
        _ = share_to_nodes(np.array([1]), holders[:2], device="cpu") + \
            share_to_nodes(np.array([2]), holders[2:], device="cpu")
    with pytest.raises(ValueError, match="crypto_provider"):
        _ = sx * share_to_nodes(np.array([2]), holders[:2], device="cpu")
    with pytest.raises(TypeError):
        _ = sx @ np.ones(1)


def test_cross_party_beaver_matmul_mul_and_int(grid):
    holders, rp = grid
    holders = holders[:3]
    rng = np.random.default_rng(3)
    x, y = rng.uniform(-2, 2, (3, 4)), rng.uniform(-2, 2, (4, 2))
    sx = fix_prec_share_to_nodes(x, holders, crypto_provider=rp, device="cpu")
    sy = fix_prec_share_to_nodes(y, holders, crypto_provider=rp, device="cpu")
    np.testing.assert_allclose((sx @ sy).get(), x @ y, atol=2e-2)
    a, b = np.array([[1.5, -2.0], [0.25, 3.0]]), np.array([[2.0, 0.5], [-1.0, 1.5]])
    sa = fix_prec_share_to_nodes(a, holders, crypto_provider=rp, device="cpu")
    sb = fix_prec_share_to_nodes(b, holders, crypto_provider=rp, device="cpu")
    np.testing.assert_allclose((sa * sb).get(), a * b, atol=5e-3)
    ix = np.array([[3, -7], [2, 5]], dtype=np.int64)
    iy = np.array([[2, 1], [-4, 6]], dtype=np.int64)
    six = share_to_nodes(ix, holders, crypto_provider=rp, device="cpu")
    siy = share_to_nodes(iy, holders, crypto_provider=rp, device="cpu")
    np.testing.assert_array_equal((six @ siy).get(), ix @ iy)


def test_strict_store_refill(grid):
    """Without auto_refill the empty store's error reaches the caller typed,
    with its refill kwargs; a provide round unblocks the op."""
    holders, rp = grid
    holders = holders[:3]
    rp.location.crypto_provider.strict_store = True
    strict = RemoteCryptoProvider(rp.location, auto_refill=False)
    sx = fix_prec_share_to_nodes(np.array([[1.0, 2.0]]), holders, crypto_provider=strict,
                                 device="cpu")
    sy = fix_prec_share_to_nodes(np.array([[3.0], [4.0]]), holders, crypto_provider=strict,
                                 device="cpu")
    with pytest.raises(EmptyCryptoPrimitiveStoreError) as exc:
        _ = sx @ sy
    assert exc.value.kwargs_["op"] == "matmul" and exc.value.kwargs_["shapes"] == [[1, 2], [2, 1]]
    strict.provide("matmul", (1, 2), (2, 1), 3)
    strict.provide("trunc", (1, 1), (1000,), 3)
    np.testing.assert_allclose((sx @ sy).get(), [[11.0]], atol=1e-2)


def test_failed_deal_rolls_back_pushed_shares(grid):
    holders, rp = grid
    dan = rp.location
    ghost = VirtualWorker("ghost", device="cpu")
    dan.add_worker(ghost)

    def refuse(msg, user=None):
        raise RuntimeError("disk full")

    ghost.recv_obj_msg = refuse
    before = [len(h.store) for h in holders[:2]]
    with pytest.raises(RuntimeError):
        rp.deal("mul", (2,), (2,), [holders[0], holders[1], ghost])
    assert [len(h.store) for h in holders[:2]] == before


# --------------------------------------------------------------------------
# publishing an encrypted model (duck-typed clients)
# --------------------------------------------------------------------------


class _ProviderClient:
    """A provider node's client: the worker's messages, and ``connect_nodes``
    dialing it into a holder."""

    def __init__(self, worker):
        self.worker, self.id, self.closed = worker, worker.id, False

    def recv_obj_msg(self, msg, user=None):
        return self.worker.recv_obj_msg(msg, user=user)

    def connect_nodes(self, holder):
        self.worker.add_worker(holder)

    def close(self):
        self.closed = True


class _HostClient:
    def __init__(self):
        self.served = {}

    def serve_model(self, plan, model_id, mpc=False, allow_download=False):
        self.served[model_id] = (serde.serialize(plan), mpc, allow_download)
        return {"success": True}


def test_publish_and_predict(small_plan_blob):
    """The model owner shares the weights and serves the plan: its State
    carries SharedTensorRefs and no share material; a data scientist wires
    the refs back into handles and predicts."""
    holders = [VirtualWorker(n, device="cpu") for n in HOLDERS]
    dan = VirtualWorker("dan", device="cpu")
    dan.crypto_provider = CryptoProvider(seed=11, device="cpu")
    provider_client, host = _ProviderClient(dan), _HostClient()
    x, *weights = weights_for(SMALL, seed=5)
    plan = serde.deserialize(small_plan_blob, device="cpu")
    shared = publish_encrypted_model(plan, "emlp", host, holders, provider_client, weights,
                                     generator=_g(5), device="cpu")
    blob, mpc, allow_download = host.served["emlp"]
    assert mpc and allow_download
    served = serde.deserialize(blob, device="cpu")
    refs = served.state.tensors()
    assert all(isinstance(r, SharedTensorRef) for r in refs) and len(refs) == 4
    assert refs[0].owners == HOLDERS and refs[0].crypto_provider_id == "dan"
    assert [r.share_ids for r in refs] == [tuple(p.id_at_location for p in s.pointers)
                                           for s in shared]
    # wiring only: no share material (no shared tensor, no int64 array)
    assert b"pygrid.AdditiveSharingTensor" not in blob and b"<i8" not in blob
    provider = RemoteCryptoProvider(provider_client)
    handles = [RemoteSharedTensor(
        [PointerTensor(h, sid, shape=r.shape) for h, sid in zip(holders, r.share_ids)],
        FixedPointEncoder(r.base, r.precision_fractional), provider, device="cpu")
        for r in refs]
    model = EncryptedModel(served, handles, holders, provider, FixedPointEncoder(), device="cpu")
    got = model.predict(x, generator=_g(6))
    want = cryptonets_forward(x.astype(np.float32).astype(np.float64), *weights)
    assert np.abs(got - want).max() <= SMALL_ATOL
    model.close()
    assert provider_client.closed


def test_transpose_of_a_shared_operand_is_remote_t():
    """The reference's lowering, kept: ``transpose`` of a shared operand is a
    remote ``t`` whatever the permutation (the last two axes swap)."""
    holders = [VirtualWorker(n, device="cpu") for n in HOLDERS[:2]]
    x = np.arange(6.0).reshape(2, 3)
    sx = fix_prec_share_to_nodes(x, holders, generator=_g(), device="cpu")
    oplist = {"constvars": [], "consts": [], "invars": [1], "outvars": [{"var": 2}],
              "eqns": [{"op": "transpose", "in": [{"var": 1}], "out": [2],
                        "params": {"permutation": [1, 0]}}]}
    np.testing.assert_allclose(run_encrypted_oplist(oplist, [sx]).get(), x.T, atol=1e-3)
    np.testing.assert_array_equal(run_encrypted_oplist(oplist, [x]), x.T)
