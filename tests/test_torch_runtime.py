"""Port parity: the port's party runtime (messages, store, pointers,
VirtualWorker) against the JAX package's.

- Every wire message is the same bytes in both packages, and a frame made
  by either is answered by the other's worker with the same bytes.
- The JAX package's tests/unit/test_runtime.py cases, mirrored on port
  workers with ``device="cpu"``: permissions, id reuse, the op allowlists,
  moves, search, plans, int64 width.
- The ring path keeps ``np.matmul``'s semantics (1-D operands, batch axes
  that broadcast, the errors numpy raises), bit for bit against numpy.
- The float path's dtypes and values against the JAX worker's ``jnp`` ops
  (64-bit types off): float64 computes as float32, a 0-d int64 acts as
  int32, ``argmax`` is int32, an integer ``sum`` stays 32-bit. Values agree
  within rtol 1e-6 (both compute in float32; elementwise results are
  exact, reductions and transcendental functions may round differently).
"""

import numpy as np
import pytest
import torch

from pygrid_tpu import serde as jserde
from pygrid_tpu.plans import Plan as JPlan
from pygrid_tpu.runtime import VirtualWorker as JWorker
from pygrid_tpu.runtime import messages as JM
from pygrid_tpu_torch import serde
from pygrid_tpu_torch.plans import Plan
from pygrid_tpu_torch.runtime import PointerTensor, VirtualWorker, send
from pygrid_tpu_torch.runtime import messages as M
from pygrid_tpu_torch.smpc import ring as R
from pygrid_tpu_torch.smpc.encrypted_model import SharedTensorRef
from pygrid_tpu_torch.utils.exceptions import (
    GetNotPermittedError,
    ObjectNotFoundError,
    PlanInvalidError,
    PyGridError,
)

torch.set_num_threads(1)


@pytest.fixture()
def alice():
    return VirtualWorker("alice", device="cpu")


@pytest.fixture()
def bob():
    return VirtualWorker("bob", device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------
# the wire: every message the same bytes in both packages
# --------------------------------------------------------------------------

_F32 = np.arange(6, dtype=np.float32).reshape(2, 3)
_I64 = np.array([2**62 + 5, -3], dtype=np.int64)

MESSAGES = {
    "ObjectMessage": lambda m, t: m.ObjectMessage(
        obj=t(_F32), id=123, tags=["#x", "#y"], description="d",
        allowed_users=["ana"], garbage_collect_data=False),
    "ObjectMessage-int64": lambda m, t: m.ObjectMessage(obj=t(_I64)),
    "ObjectRequestMessage": lambda m, t: m.ObjectRequestMessage(obj_id=7, delete=False),
    "ForceObjectDeleteMessage": lambda m, t: m.ForceObjectDeleteMessage(obj_id=9),
    "TensorCommandMessage": lambda m, t: m.TensorCommandMessage(
        op="__matmul__", args=[t(_I64), m.ref(5)], kwargs={"axis": 0}, return_id=11),
    "RunPlanMessage": lambda m, t: m.RunPlanMessage(plan_id=3, args=[m.ref(4), t(_F32)],
                                                    return_id=12),
    "SearchMessage": lambda m, t: m.SearchMessage(query=["#a", "#b"]),
    "IsNoneMessage": lambda m, t: m.IsNoneMessage(obj_id=1),
    "GetShapeMessage": lambda m, t: m.GetShapeMessage(obj_id=2),
    "CryptoRequestMessage": lambda m, t: m.CryptoRequestMessage(
        op="matmul", shape_x=[4, 16], shape_y=[16, 8], party_ids=["alice", "bob"]),
    "CryptoProvideMessage": lambda m, t: m.CryptoProvideMessage(
        op="trunc", shape_x=[4, 8], shape_y=[1000], n_parties=3, n_instances=2),
    "CryptoDealResponse": lambda m, t: m.CryptoDealResponse(
        party_ids=["alice", "bob"], ids=[[1, 2, 3], [4, 5, 6]]),
    "ErrorResponse": lambda m, t: m.ErrorResponse(
        error_type="EmptyCryptoPrimitiveStoreError",
        data={"op": "mul", "shapes": [[2], [2]], "n_instances": 1, "n_parties": 3}),
    "PointerResponse": lambda m, t: m.PointerResponse(
        id_at_location=5, location="alice", shape=[2, 3], tags=["#t"]),
}


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_message_is_the_same_bytes_in_both_packages(name):
    """The JAX package's message with numpy payloads and the port's with
    torch tensors serialize alike; each package decodes the other's bytes
    and writes them back unchanged."""
    jblob = jserde.serialize(MESSAGES[name](JM, np.asarray))
    blob = serde.serialize(MESSAGES[name](M, lambda a: torch.from_numpy(a.copy())))
    assert blob == jblob
    assert serde.serialize(serde.deserialize(jblob, device="cpu")) == jblob
    assert jserde.serialize(jserde.deserialize(blob)) == blob


def test_shared_tensor_ref_is_the_same_bytes():
    from pygrid_tpu.smpc.encrypted_model import SharedTensorRef as JRef

    args = (["alice", "bob", "charlie"], [11, 12, 13], (16, 8), 10, 3, "dan")
    blob = serde.serialize(SharedTensorRef(*args))
    assert blob == jserde.serialize(JRef(*args))
    back = serde.deserialize(jserde.serialize(JRef(*args)), device="cpu")
    assert isinstance(back, SharedTensorRef) and back.shape == (16, 8)
    assert back.owners == ("alice", "bob", "charlie") and back.crypto_provider_id == "dan"


def _frames(m):
    """A session of frames: push two tensors, add, matmul, reduce, read,
    then errors (a missing object, an op off the allowlist, a shape
    mismatch)."""
    x = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    y = np.array([[10.0, -2.0], [0.5, 4.0]], np.float32)
    return [
        m.ObjectMessage(obj=x, id=101, tags=["#x"]),
        m.ObjectMessage(obj=y, id=102),
        m.TensorCommandMessage(op="__add__", args=[m.ref(101), m.ref(102)], return_id=103),
        m.TensorCommandMessage(op="__matmul__", args=[m.ref(101), m.ref(102)], return_id=104),
        m.TensorCommandMessage(op="sum", args=[m.ref(104)], kwargs={"axis": 0}, return_id=105),
        m.ObjectRequestMessage(obj_id=103),
        m.ObjectRequestMessage(obj_id=105, delete=False),
        m.GetShapeMessage(obj_id=104),
        m.IsNoneMessage(obj_id=103),
        m.SearchMessage(query=["#x"]),
        m.ObjectMessage(obj=x, id=101),
        m.ObjectRequestMessage(obj_id=999999),
        m.TensorCommandMessage(op="__setattr__", args=[m.ref(101)], return_id=106),
        m.TensorCommandMessage(op="__matmul__", args=[m.ref(104), m.ref(105)], return_id=107),
        m.ForceObjectDeleteMessage(obj_id=101),
    ]


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_frames_answered_alike_by_both_workers(maker):
    """The same frames (made by ``maker``'s serde) go to a JAX worker and a
    port worker: every answer is the same bytes — PointerResponses, values,
    shapes, search results and typed ErrorResponses."""
    msgs = _frames(JM) if maker == "jax" else _frames(M)
    ser = jserde.serialize if maker == "jax" else serde.serialize
    jw, pw = JWorker("alice"), VirtualWorker("alice", device="cpu")
    for msg in msgs:
        frame = ser(msg)
        want, got = jw._recv_msg(frame), pw._recv_msg(frame)
        assert got == want, (msg, jserde.deserialize(want), serde.deserialize(got, device="cpu"))
    assert sorted(jw.store.ids()) == sorted(pw.store.ids())


def test_error_frames_are_typed(alice):
    err = serde.deserialize(alice._recv_msg(b"\xc1garbage"), device="cpu")
    assert isinstance(err, M.ErrorResponse)
    err = serde.deserialize(alice._recv_msg(serde.serialize(M.ObjectRequestMessage(obj_id=1))),
                            device="cpu")
    assert err.error_type == "ObjectNotFoundError" and err.message == "object 1 not found"


# --------------------------------------------------------------------------
# the JAX package's tests/unit/test_runtime.py, on port workers
# --------------------------------------------------------------------------


def test_send_get_roundtrip(alice):
    x = np.array([1.0, 2.0, 3.0], np.float32)
    ptr = send(x, alice, tags=("#x", "#test"))
    assert ptr.shape == (3,) and ptr.id_at_location in alice.store
    got = ptr.get()
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), x)
    assert ptr.id_at_location not in alice.store  # gc on get


def test_get_without_gc(alice):
    ptr = send(np.ones(2), alice, garbage_collect_data=False)
    assert ptr.get().dtype == torch.float64  # stored at the dtype it arrived with
    assert ptr.id_at_location in alice.store


def test_send_takes_a_torch_tensor_as_it_is(alice):
    t = torch.arange(4, dtype=torch.int64)
    ptr = send(t, alice)
    assert alice.store.get_obj(ptr.id_at_location).value is t  # no host round trip


def test_remote_arithmetic(alice):
    x = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    y = np.array([[10.0, 20.0], [30.0, 40.0]], np.float32)
    px, py = send(x, alice), send(y, alice)
    np.testing.assert_allclose(_np((px + py).get()), x + y)
    np.testing.assert_allclose(_np((px - py).get(delete=False)), x - y)
    np.testing.assert_allclose(_np((px * py).get(delete=False)), x * y)
    np.testing.assert_allclose(_np((px @ py).get(delete=False)), x @ y)
    np.testing.assert_allclose(_np((px + 1.0).get(delete=False)), x + 1)
    np.testing.assert_allclose(_np(px.sum(axis=0).get()), x.sum(0))
    np.testing.assert_allclose(_np((-py).get()), -y)


def test_pointer_chaining(alice):
    ptr = send(np.array([1.0, -2.0, 3.0], np.float32), alice)
    assert float(ptr.relu().sum().get()) == pytest.approx(4.0)


def test_private_tensor_permissions(alice):
    x = np.array([42.0])
    ptr = send(x, alice, allowed_users=("ana",), user="ana")
    np.testing.assert_array_equal(_np(ptr.get(delete=False)), x)
    with pytest.raises(GetNotPermittedError):
        PointerTensor(alice, ptr.id_at_location, owner_user="eve").get()
    with pytest.raises(GetNotPermittedError):
        PointerTensor(alice, ptr.id_at_location).get()


def test_move_between_workers(alice, bob):
    alice.add_worker(bob)
    x = np.array([5.0, 6.0])
    ptr = send(x, alice)
    moved = ptr.move(bob)
    assert moved.id_at_location in bob.store
    assert ptr.id_at_location not in alice.store
    np.testing.assert_array_equal(_np((moved + 1.0).get()), (x + 1).astype(np.float32))


def test_move_preserves_privacy_and_tags(alice, bob):
    alice.add_worker(bob)
    ptr = send(np.array([1.0]), alice, tags=("#priv",), allowed_users=("ana",), user="ana")
    moved = PointerTensor(alice, ptr.id_at_location, owner_user="ana").move(bob)
    stored = bob.store.get_obj(moved.id_at_location)
    assert stored.allowed_users == {"ana"} and "#priv" in stored.tags
    with pytest.raises(GetNotPermittedError):
        PointerTensor(bob, moved.id_at_location).get()


def test_move_to_unknown_worker(alice):
    ptr = send(np.ones(1), alice)
    with pytest.raises(PyGridError):
        ptr.move("nobody")


def test_move_between_devices_lands_on_the_target_device(alice):
    """A move hands the value to the target, which keeps it on its own
    device (here both are the CPU; on the card phase datacentric moves
    between two workers on the card)."""
    carol = VirtualWorker("carol", device="cpu")
    alice.add_worker(carol)
    moved = send(torch.ones(3), alice).move(carol)
    assert carol.store.get_obj(moved.id_at_location).value.device == carol.device


def test_compute_on_private_tensor_denied(alice):
    priv = send(np.array([3.0]), alice, allowed_users=("ana",), user="ana")
    with pytest.raises(GetNotPermittedError):
        _ = PointerTensor(alice, priv.id_at_location, owner_user="eve") + 0.0
    derived = PointerTensor(alice, priv.id_at_location, owner_user="ana") + 0.0
    with pytest.raises(GetNotPermittedError):
        PointerTensor(alice, derived.id_at_location, owner_user="eve").get()
    np.testing.assert_array_equal(_np(derived.get()), [3.0])


def test_private_objects_invisible_to_search_and_shape(alice):
    send(np.ones((2, 2)), alice, tags=("#salary",), allowed_users=("ana",), user="ana")
    assert alice.recv_obj_msg(M.SearchMessage(query=["#salary"]), user="eve") == []
    assert len(alice.recv_obj_msg(M.SearchMessage(query=["#salary"]), user="ana")) == 1


@pytest.fixture(scope="module")
def identity_plan():
    plan = Plan(name="p", fn=lambda x: x)
    return plan.build(np.zeros((1,), np.float32))


def test_plan_methods_not_remotely_invokable(alice, identity_plan):
    alice.recv_obj_msg(M.ObjectMessage(obj=identity_plan, id=555))
    with pytest.raises(PyGridError):
        alice.recv_obj_msg(
            M.TensorCommandMessage(op="__setattr__", args=[M.ref(555), "fn", None])
        )


def test_private_plan_not_runnable_by_others(alice):
    plan = Plan(name="secret-model", fn=lambda x: x * 2.0)
    plan.build(np.zeros((2,), np.float32))
    alice.recv_obj_msg(M.ObjectMessage(obj=plan, id=888, allowed_users=["ana"]), user="ana")
    with pytest.raises(GetNotPermittedError):
        alice.recv_obj_msg(M.RunPlanMessage(plan_id=888, args=[np.ones(2, np.float32)]),
                           user="eve")
    resp = alice.recv_obj_msg(M.RunPlanMessage(plan_id=888, args=[np.ones(2, np.float32)]),
                              user="ana")
    with pytest.raises(GetNotPermittedError):
        PointerTensor(alice, resp.id_at_location, owner_user="eve").get()


def test_delete_permission_gated(alice):
    priv = send(np.array([1.0]), alice, allowed_users=("ana",), user="ana")
    with pytest.raises(GetNotPermittedError):
        alice.recv_obj_msg(M.ForceObjectDeleteMessage(obj_id=priv.id_at_location), user="eve")
    assert priv.id_at_location in alice.store
    alice.recv_obj_msg(M.ForceObjectDeleteMessage(obj_id=priv.id_at_location), user="ana")
    assert priv.id_at_location not in alice.store


def test_id_reuse_rejected(alice):
    alice.recv_obj_msg(M.ObjectMessage(obj=np.ones(2), id=321))
    with pytest.raises(PyGridError):
        alice.recv_obj_msg(M.ObjectMessage(obj=np.zeros(2), id=321))
    np.testing.assert_array_equal(_np(alice.store.get_obj(321).value), np.ones(2))
    with pytest.raises(PyGridError):
        alice.recv_obj_msg(M.TensorCommandMessage(op="add", args=[1.0, 1.0], return_id=321))
    np.testing.assert_array_equal(_np(alice.store.get_obj(321).value), np.ones(2))


def test_crypto_provider_streams_differ():
    from pygrid_tpu_torch.smpc import CryptoProvider

    t1 = CryptoProvider(device="cpu")._make_triple("mul", (4,), (4,), 2)
    t2 = CryptoProvider(device="cpu")._make_triple("mul", (4,), (4,), 2)
    assert not torch.equal(t1[0], t2[0])


def test_shape_mismatch_returns_error_frame(alice):
    p1, p2 = send(np.ones((2, 3)), alice), send(np.ones((4, 5)), alice)
    blob = serde.serialize(M.TensorCommandMessage(
        op="__matmul__", args=[M.ref(p1.id_at_location), M.ref(p2.id_at_location)]))
    err = serde.deserialize(alice._recv_msg(blob), device="cpu")
    assert isinstance(err, M.ErrorResponse) and err.error_type == "TypeError"


def test_tag_search(alice):
    send(np.ones(2), alice, tags=("#mnist", "#data"))
    send(np.ones(3), alice, tags=("#mnist", "#labels"))
    send(np.ones(4), alice, tags=("#cifar",))
    assert len(alice.search("#mnist")) == 2
    assert len(alice.search("#mnist", "#labels")) == 1
    assert alice.store.tags() >= {"#mnist", "#data", "#labels", "#cifar"}


def test_run_remote_plan(alice):
    plan = Plan(name="affine", fn=lambda x: x * 2.0 + 1.0)
    plan.build(np.zeros((3,), np.float32))
    alice.recv_obj_msg(M.ObjectMessage(obj=plan, id=777))
    x = np.array([1.0, 2.0, 3.0], np.float32)
    xptr = send(x, alice)
    resp = alice.recv_obj_msg(M.RunPlanMessage(plan_id=777, args=[M.ref(xptr.id_at_location)]))
    np.testing.assert_allclose(_np(alice.store.get_obj(resp.id_at_location).value), x * 2 + 1)


def test_run_a_jax_built_plan_sent_as_a_frame(alice):
    """A plan built by the JAX package travels as a frame and runs on a port
    worker through its op-list."""
    jplan = JPlan(name="affine", fn=lambda x: x * 2.0 + 1.0)
    jplan.build(np.zeros((3,), np.float32))
    resp = serde.deserialize(alice._recv_msg(jserde.serialize(JM.ObjectMessage(obj=jplan, id=778))),
                             device="cpu")
    assert isinstance(resp, M.PointerResponse)
    x = np.array([1.0, 2.0, 3.0], np.float32)
    resp = alice.recv_obj_msg(M.RunPlanMessage(plan_id=778, args=[x]))
    np.testing.assert_allclose(_np(alice.store.get_obj(resp.id_at_location).value), x * 2 + 1)


def _blob_only(plan):
    """``plan`` with its torch_blob as its only artifact (no op list)."""
    return Plan(name=plan.name, torch_blob=plan.torch_blob, input_specs=plan.input_specs)


def test_a_torch_blob_only_plan_sent_as_a_frame_is_refused(alice, identity_plan):
    """A torch_blob loads through torch.export.load, which can unpickle: a
    worker refuses a plan whose only artifact is one when it arrives in a
    frame, and will not run one it holds without a live fn."""
    blob = serde.serialize(M.ObjectMessage(obj=_blob_only(identity_plan), id=779))
    err = serde.deserialize(alice._recv_msg(blob), device="cpu")
    assert isinstance(err, M.ErrorResponse) and err.error_type == "PlanInvalidError"
    assert 779 not in alice.store
    alice.store.set_obj(_blob_only(identity_plan), id=780)
    with pytest.raises(PlanInvalidError):
        alice.recv_obj_msg(M.RunPlanMessage(plan_id=780, args=[np.ones(1, np.float32)]))


def test_port_built_plan_sent_as_a_frame_runs_from_its_op_list(alice, monkeypatch):
    """A plan built by the port carries an op list beside its torch_blob:
    sent as a frame, a worker stores it and runs the list, and
    torch.export.load is never reached."""
    plan = Plan(name="affine", fn=lambda x: x * 2.0 + 1.0).build(np.zeros((3,), np.float32))
    assert plan.oplist is not None and plan.torch_blob is not None

    def refuse(*a, **k):
        raise AssertionError("torch.export.load reached from a frame")

    monkeypatch.setattr(torch.export, "load", refuse)
    resp = serde.deserialize(alice._recv_msg(serde.serialize(M.ObjectMessage(obj=plan, id=781))),
                             device="cpu")
    assert isinstance(resp, M.PointerResponse)
    x = np.array([1.0, 2.0, 3.0], np.float32)
    resp = alice.recv_obj_msg(M.RunPlanMessage(plan_id=781, args=[x]))
    np.testing.assert_array_equal(_np(alice.store.get_obj(resp.id_at_location).value), x * 2 + 1)


def test_binary_frame_transport(alice):
    blob = serde.serialize(M.ObjectMessage(obj=np.arange(4.0), id=123, tags=["#t"]))
    resp = serde.deserialize(alice._recv_msg(blob), device="cpu")
    assert isinstance(resp, M.PointerResponse) and resp.id_at_location == 123
    err = serde.deserialize(alice._recv_msg(serde.serialize(M.ObjectRequestMessage(obj_id=999999))),
                            device="cpu")
    assert isinstance(err, M.ErrorResponse) and err.error_type == "ObjectNotFoundError"


def test_unknown_op_rejected(alice):
    ptr = send(np.ones(2), alice)
    with pytest.raises(PyGridError):
        ptr.remote_op("__class__")
    with pytest.raises(PyGridError):
        ptr.remote_op("os_system")
    with pytest.raises(PyGridError, match="not permitted on 64-bit"):
        send(np.ones(2, np.int64), alice).remote_op("exp")


def test_missing_object(alice):
    with pytest.raises(ObjectNotFoundError):
        PointerTensor(alice, 424242).get()


def test_remote_int64_ops_keep_full_width():
    w = VirtualWorker(id="i64", device="cpu")
    a = np.array([2**62 + 12345, -17], dtype=np.int64)
    b = np.array([2**62 + 1, 23], dtype=np.int64)
    pa, pb = send(a, w), send(b, w)
    out = (pa + pb).get()
    assert out.dtype == torch.int64
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(out.numpy(), a + b)
        np.testing.assert_array_equal((pa * pb).get(delete=False).numpy(), a * b)
        np.testing.assert_array_equal((-pa).get(delete=False).numpy(), -a)
        np.testing.assert_array_equal(pa.sum().get(delete=False).numpy(), a.sum())
    m = np.array([[3, 1], [2, 5]], dtype=np.int64)
    pm = send(m, w)
    got = (pm @ pm).get()
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), m @ m)


def test_remote_uint64_ops_keep_their_dtype():
    w = VirtualWorker(id="u64", device="cpu")
    a = np.array([2**64 - 1, 7], dtype=np.uint64)
    pa = send(a, w)
    with np.errstate(over="ignore"):
        got = (pa + pa).get(delete=False)
        assert got.dtype == torch.uint64
        np.testing.assert_array_equal(got.numpy(), a + a)
        np.testing.assert_array_equal((pa @ pa).get().numpy(), a @ a)


def test_float_tensor_scalar_ops_not_hijacked_by_i64_path():
    w = VirtualWorker(id="fs", device="cpu")
    p = send(np.array([2.0, 4.0], dtype=np.float32), w)
    np.testing.assert_allclose(_np((p / 2).get()), [1.0, 2.0])
    np.testing.assert_allclose(_np((p * 2).get(delete=False)), [4.0, 8.0])


def test_worker_without_device_cpu_raises_on_a_gpu_less_host():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        VirtualWorker("alice")


# --------------------------------------------------------------------------
# the ring path keeps np.matmul's semantics, bit for bit
# --------------------------------------------------------------------------

MATMUL_SHAPES = [
    ((5,), (5,)), ((5,), (5, 3)), ((4, 5), (5,)), ((4, 5), (5, 3)),
    ((2, 4, 5), (5, 3)), ((4, 5), (2, 5, 3)), ((2, 1, 4, 5), (3, 5, 2)),
    ((2, 3, 1, 4, 5), (1, 2, 5, 3)), ((3, 4, 0), (3, 0, 2)),
]


@pytest.mark.parametrize("sa,sb", MATMUL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ring_matmul_has_np_matmul_semantics(alice, sa, sb):
    rng = np.random.default_rng(len(sa) * 10 + len(sb))
    a = rng.integers(-2**63, 2**63 - 1, size=sa, dtype=np.int64)
    b = rng.integers(-2**63, 2**63 - 1, size=sb, dtype=np.int64)
    with np.errstate(over="ignore"):
        want = np.matmul(a, b)
    got = (send(a, alice) @ send(b, alice)).get().numpy()
    assert got.shape == want.shape and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    # a public operand first (the Beaver round's d·[b]) takes the same path
    resp = alice.recv_obj_msg(M.TensorCommandMessage(
        op="__matmul__", args=[a, M.ref(send(b, alice).id_at_location)]))
    np.testing.assert_array_equal(alice.store.get_obj(resp.id_at_location).value.numpy(), want)


@pytest.mark.parametrize("sa,sb", [((), (3,)), ((3,), ()), ((2, 3), (4, 2)), ((3,), (4,)),
                                   ((2, 2, 3), (3, 3, 2))],
                         ids=["0d-a", "0d-b", "core", "1d-core", "batch"])
def test_ring_matmul_raises_where_numpy_raises(alice, sa, sb):
    a, b = np.ones(sa, np.int64), np.ones(sb, np.int64)
    with pytest.raises(ValueError):
        np.matmul(a, b)
    with pytest.raises(ValueError):
        alice.recv_obj_msg(M.TensorCommandMessage(op="__matmul__", args=[a, b]))


def test_ring_broadcast_to_is_an_owned_copy(alice):
    p = send(np.arange(3, dtype=np.int64), alice)
    out = alice.store.get_obj(p.remote_op("broadcast_to", shape=[2, 3]).id_at_location).value
    assert out.shape == (2, 3) and out.is_contiguous() and out.stride() == (3, 1)


def test_ring_matmul_launches_the_kernel_once_per_call(alice, monkeypatch):
    calls = []
    real = R.ring_matmul_kernel
    monkeypatch.setattr(R, "ring_matmul_kernel", lambda a, b: calls.append(1) or real(a, b))
    a = np.ones((2, 3, 1, 4, 5), np.int64)
    b = np.ones((1, 2, 5, 3), np.int64)
    (send(a, alice) @ send(b, alice)).get()
    assert len(calls) == 1


# --------------------------------------------------------------------------
# the float path against the JAX worker's jnp ops (64-bit types off)
# --------------------------------------------------------------------------

_X = np.array([[0.5, -1.25, 2.0], [3.0, 0.25, -0.75]])
FLOAT_CASES = {
    # (op, operands, kwargs, expected dtype)
    "add-f32-f64scalar": ("__add__", [_X.astype(np.float32), np.asarray(1.5)], {}, "float32"),
    "mul-f32-i64scalar": ("__mul__", [_X.astype(np.float32), np.asarray(2)], {}, "float32"),
    "div-f32-i64scalar": ("__truediv__", [_X.astype(np.float32), np.asarray(2)], {}, "float32"),
    "add-f64-f64": ("__add__", [_X, _X], {}, "float32"),
    "add-i32-i64scalar": ("__add__", [np.arange(3, dtype=np.int32), np.asarray(2**40 + 3)], {},
                          "int32"),
    "add-u8-i64scalar": ("__add__", [np.arange(3, dtype=np.uint8), np.asarray(7)], {}, "int32"),
    "div-i32-i32": ("div", [np.arange(3, dtype=np.int32), np.array([2, 4, 8], np.int32)], {},
                    "float32"),
    "matmul-f64": ("__matmul__", [_X, _X.T.copy()], {}, "float32"),
    "matmul-i32": ("__matmul__", [np.arange(6, dtype=np.int32).reshape(2, 3),
                                  np.arange(6, dtype=np.int32).reshape(3, 2)], {}, "int32"),
    "neg-f64": ("__neg__", [_X], {}, "float32"),
    "sum-f64-axis0": ("sum", [_X], {"axis": 0}, "float32"),
    "sum-i32": ("sum", [np.arange(6, dtype=np.int32).reshape(2, 3)], {}, "int32"),
    "sum-bool": ("sum", [np.array([True, False, True])], {}, "int32"),
    "sum-u8": ("sum", [np.array([200, 100], np.uint8)], {}, "uint32"),
    "mean-i32": ("mean", [np.arange(5, dtype=np.int32)], {}, "float32"),
    "max-axis1": ("max", [_X.astype(np.float32)], {"axis": 1}, "float32"),
    "min": ("min", [_X.astype(np.float32)], {}, "float32"),
    "exp-i32": ("exp", [np.arange(3, dtype=np.int32)], {}, "float32"),
    "log": ("log", [np.abs(_X).astype(np.float32)], {}, "float32"),
    "tanh": ("tanh", [_X.astype(np.float32)], {}, "float32"),
    "sqrt": ("sqrt", [np.abs(_X)], {}, "float32"),
    "abs-i32": ("abs", [np.array([-3, 2], np.int32)], {}, "int32"),
    "sigmoid": ("sigmoid", [_X.astype(np.float32)], {}, "float32"),
    "relu-f32": ("relu", [_X.astype(np.float32)], {}, "float32"),
    "relu-i32": ("relu", [np.array([-3, 2], np.int32)], {}, "float32"),
    "t": ("t", [_X.astype(np.float32)], {}, "float32"),
    "reshape-f64": ("reshape", [_X, 3, 2], {}, "float32"),
    "broadcast_to": ("broadcast_to", [_X[0].astype(np.float32)], {"shape": [2, 3]}, "float32"),
    "argmax": ("argmax", [_X.astype(np.float32)], {}, "int32"),
    "argmax-axis1": ("argmax", [_X.astype(np.float32)], {"axis": 1}, "int32"),
    "softmax": ("softmax", [_X.astype(np.float32)], {}, "float32"),
}


def _run_op(worker, m, op, operands, kwargs):
    """Store the rank ≥ 1 operands, pass 0-d ones as literals, run ``op``."""
    args = []
    for i, v in enumerate(operands):
        if np.ndim(v) >= 1:
            worker.recv_obj_msg(m.ObjectMessage(obj=v, id=1000 + i))
            args.append(m.ref(1000 + i))
        else:
            args.append(v)
    resp = worker.recv_obj_msg(m.TensorCommandMessage(op=op, args=args, kwargs=kwargs))
    return worker.store.get_obj(resp.id_at_location).value


@pytest.mark.parametrize("case", sorted(FLOAT_CASES))
def test_float_path_matches_jnp(case):
    op, operands, kwargs, dtype = FLOAT_CASES[case]
    want = np.asarray(_run_op(JWorker("j"), JM, op, operands, kwargs))
    got = _run_op(VirtualWorker("p", device="cpu"), M, op, operands, kwargs)
    assert isinstance(got, torch.Tensor)
    assert str(want.dtype) == dtype and str(got.numpy().dtype) == dtype, (want.dtype, got.dtype)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
