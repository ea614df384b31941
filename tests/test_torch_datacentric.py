"""Port parity: the port's data-centric persistence plane (KV store, object
write-through and recovery, model storage/controller, user sessions)
against the JAX package's.

The JAX package's tests/unit/test_datacentric.py cases run on port workers
with ``device="cpu"``; then the two packages share one store: objects a
JAX worker wrote are recovered by a port worker onto its device and the
other way round, models hosted by one are served by the other, and a
password digest made by one verifies in the other.
"""

import numpy as np
import pytest
import torch

from pygrid_tpu import datacentric as jdc
from pygrid_tpu.plans import Plan as JPlan
from pygrid_tpu.runtime import VirtualWorker as JWorker
from pygrid_tpu.serde import serialize as jserialize
from pygrid_tpu.smpc import AdditiveSharingTensor as JAST
from pygrid_tpu.smpc import FixedPointEncoder as JEncoder
from pygrid_tpu_torch import serde
from pygrid_tpu_torch.datacentric import (
    MemoryKV,
    ModelController,
    SessionsRepository,
    SqliteKV,
    UserSession,
    recover_objects,
    set_persistent_mode,
)
from pygrid_tpu_torch.plans import Plan, func2plan
from pygrid_tpu_torch.runtime import VirtualWorker, send
from pygrid_tpu_torch.smpc import AdditiveSharingTensor
from pygrid_tpu_torch.utils.exceptions import (
    InvalidCredentialsError,
    ModelNotFoundError,
    PyGridError,
)

torch.set_num_threads(1)


@pytest.fixture(params=["memory", "sqlite"])
def kv(request, tmp_path):
    if request.param == "memory":
        return MemoryKV()
    return SqliteKV(str(tmp_path / "kv.db"))


def worker(name):
    return VirtualWorker(id=name, device="cpu")


# --------------------------------------------------------------------------
# the JAX package's tests/unit/test_datacentric.py, on the port
# --------------------------------------------------------------------------


class TestKVStore:
    def test_hash_ops(self, kv):
        kv.hset("h", "a", b"1")
        kv.hset("h", "b", b"2")
        assert kv.hget("h", "a") == b"1"
        assert kv.hgetall("h") == {"a": b"1", "b": b"2"}
        assert kv.hexists("h", "b") and not kv.hexists("h", "zz")
        assert kv.hdel("h", "a") == 1
        assert kv.hget("h", "a") is None
        kv.delete("h")
        assert kv.hgetall("h") == {}

    def test_overwrite(self, kv):
        kv.hset("h", "k", b"old")
        kv.hset("h", "k", b"new")
        assert kv.hget("h", "k") == b"new"


class TestObjectPersistence:
    def test_write_through_and_recover(self, kv):
        w = worker("alice")
        set_persistent_mode(w, kv)
        obj = w.store.set_obj(torch.arange(6.0).reshape(2, 3), tags={"#x", "#mnist"},
                              description="train data")
        w2 = worker("alice")
        set_persistent_mode(w2, kv)
        assert recover_objects(w2, kv) == 1
        got = w2.store.get_obj(obj.id)
        assert isinstance(got.value, torch.Tensor) and got.value.device == w2.device
        assert torch.equal(got.value, obj.value)
        assert got.tags == {"#x", "#mnist"} and got.description == "train data"

    def test_objects_pushed_by_message_persist(self, kv):
        w = worker("alice")
        set_persistent_mode(w, kv)
        ptr = send(np.arange(3, dtype=np.int64), w, tags=("#share",))
        w2 = worker("alice")
        assert recover_objects(w2, kv) == 1
        back = w2.store.get_obj(ptr.id_at_location).value
        assert back.dtype == torch.int64 and torch.equal(back, torch.arange(3))

    def test_delete_propagates(self, kv):
        w = worker("bob")
        set_persistent_mode(w, kv)
        obj = w.store.set_obj(torch.ones(3))
        w.store.rm_obj(obj.id)
        assert recover_objects(worker("bob"), kv) == 0

    def test_permissions_survive_restart(self, kv):
        w = worker("carol")
        set_persistent_mode(w, kv)
        obj = w.store.set_obj(torch.ones(2), allowed_users={"dan"})
        w2 = worker("carol")
        recover_objects(w2, kv)
        assert w2.store.get_obj(obj.id).allowed_users == {"dan"}

    def test_recover_idempotent(self, kv):
        w = worker("erin")
        set_persistent_mode(w, kv)
        w.store.set_obj(torch.ones(2))
        assert recover_objects(w, kv) == 0

    def test_objects_resident_before_attach_are_mirrored(self, kv):
        w = worker("fay")
        obj = w.store.set_obj(torch.full((2,), 7, dtype=torch.int64))
        set_persistent_mode(w, kv)
        w2 = worker("fay")
        assert recover_objects(w2, kv) == 1
        assert torch.equal(w2.store.get_obj(obj.id).value, obj.value)


class TestModelStorage:
    def _plan_blob(self):
        @func2plan(args_shape=[(1, 4)])
        def model(x):
            return x * 2.0

        return serde.serialize(model)

    @pytest.fixture(scope="class")
    def plan_blob(self):
        return self._plan_blob()

    def test_save_get_flags(self, kv, plan_blob):
        mc = ModelController(kv, device="cpu")
        mc.save("node1", plan_blob, "mnist", allow_remote_inference=True, mpc=False)
        hosted = mc.get("node1", "mnist")
        assert hosted.allow_remote_inference and not hosted.allow_download
        assert "mnist" in mc.models("node1")

    def test_duplicate_id_rejected(self, kv, plan_blob):
        mc = ModelController(kv, device="cpu")
        mc.save("node1", plan_blob, "m1")
        with pytest.raises(PyGridError):
            mc.save("node1", plan_blob, "m1")

    def test_delete(self, kv, plan_blob):
        mc = ModelController(kv, device="cpu")
        mc.save("node1", plan_blob, "m1")
        mc.delete("node1", "m1")
        with pytest.raises(ModelNotFoundError):
            mc.get("node1", "m1")
        assert "m1" not in mc.models("node1")

    def test_survives_controller_restart(self, tmp_path, plan_blob):
        path = str(tmp_path / "models.db")
        ModelController(SqliteKV(path), device="cpu").save(
            "node1", plan_blob, "persisted", allow_download=True)
        hosted = ModelController(SqliteKV(path), device="cpu").get("node1", "persisted")
        assert hosted.allow_download
        assert "persisted" in ModelController(SqliteKV(path), device="cpu").models("node1")

    def test_inference_via_stored_plan(self, kv, plan_blob):
        mc = ModelController(kv, device="cpu")
        mc.save("node1", plan_blob, "double", allow_remote_inference=True)
        hosted = mc.get("node1", "double")
        assert isinstance(hosted.model, Plan)
        out = hosted.model(np.ones((1, 4), np.float32), device="cpu")
        np.testing.assert_allclose(out.numpy(), 2 * np.ones((1, 4)))


class TestSessions:
    def test_default_admin(self):
        repo = SessionsRepository(device="cpu")
        session, token = repo.login("admin", "admin")
        assert session.authenticated and repo.by_token(token) is session

    def test_bad_credentials(self):
        repo = SessionsRepository(device="cpu")
        with pytest.raises(InvalidCredentialsError):
            repo.login("admin", "wrong")
        with pytest.raises(InvalidCredentialsError):
            repo.login("ghost", "x")

    def test_per_user_worker(self):
        repo = SessionsRepository(device="cpu")
        repo.register("ds1", "pw")
        s1, _ = repo.login("ds1", "pw")
        s2, _ = repo.login("admin", "admin")
        assert s1.worker.id == "ds1" and s2.worker.id == "admin"
        assert s1.worker is not s2.worker and s1.worker.device == torch.device("cpu")

    def test_logout(self):
        repo = SessionsRepository(device="cpu")
        _, token = repo.login("admin", "admin")
        repo.logout(token)
        assert repo.by_token(token) is None

    def test_tensor_request_queue(self):
        repo = SessionsRepository(device="cpu")
        s, _ = repo.login("admin", "admin")
        s.save_tensor_request({"object_id": 42, "reason": "research"})
        assert s.tensor_requests[0]["object_id"] == 42

    def test_worker_on_the_card_by_default(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is valid here")
        s, _ = SessionsRepository().login("admin", "admin")
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            _ = s.worker


# --------------------------------------------------------------------------
# one store, two packages
# --------------------------------------------------------------------------


def test_jax_written_objects_recover_onto_a_port_worker(tmp_path):
    path = str(tmp_path / "objects.db")
    jw = JWorker("alice")
    jdc.set_persistent_mode(jw, jdc.SqliteKV(path))
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    share = np.array([2**63 - 1, -5], np.int64)
    ast = JAST.share(np.array([1.5, -2.0]), ["alice", "bob"], encoder=JEncoder())
    ids = [jw.store.set_obj(v, tags={"#t"}, allowed_users=u).id
           for v, u in ((x, None), (share, {"ana"}), (ast, None))]
    pw = worker("alice")
    assert recover_objects(pw, SqliteKV(path)) == 3
    got_x, got_share, got_ast = (pw.store.get_obj(i) for i in ids)
    assert got_x.value.dtype == torch.float32 and np.array_equal(got_x.value.numpy(), x)
    assert got_share.value.dtype == torch.int64 and np.array_equal(got_share.value.numpy(), share)
    assert got_share.allowed_users == {"ana"} and got_x.tags == {"#t"}
    assert isinstance(got_ast.value, AdditiveSharingTensor)
    assert got_ast.value.shares.device == pw.device
    np.testing.assert_allclose(got_ast.value.get(), [1.5, -2.0])


def test_port_written_objects_recover_onto_a_jax_worker(tmp_path):
    path = str(tmp_path / "objects.db")
    pw = worker("bob")
    set_persistent_mode(pw, SqliteKV(path))
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    obj = pw.store.set_obj(x, tags={"#x"}, description="d")
    jw = JWorker("bob")
    assert jdc.recover_objects(jw, jdc.SqliteKV(path)) == 1
    back = jw.store.get_obj(obj.id)
    np.testing.assert_array_equal(np.asarray(back.value), x.numpy())
    assert back.tags == {"#x"} and back.description == "d"
    # the same record bytes in both packages
    jc, pc = JWorker("dan"), worker("dan")
    kj, kp = jdc.MemoryKV(), MemoryKV()
    jdc.set_persistent_mode(jc, kj)
    set_persistent_mode(pc, kp)
    jc.store.set_obj(np.ones(3, np.float32), id=5, tags={"#a", "#b"}, allowed_users={"ana"})
    pc.store.set_obj(torch.ones(3), id=5, tags={"#a", "#b"}, allowed_users={"ana"})
    assert kj.hgetall("objects:dan") == kp.hgetall("objects:dan")


def test_models_hosted_by_one_package_are_served_by_the_other(tmp_path):
    path = str(tmp_path / "models.db")
    jplan = JPlan(name="affine", id="affine-3", fn=lambda x: x * 2.0 + 1.0)
    jplan.build(np.zeros((3,), np.float32))
    jdc.ModelController(jdc.SqliteKV(path)).save(
        "node1", jserialize(jplan), "affine", allow_remote_inference=True, mpc=True)
    mc = ModelController(SqliteKV(path), device="cpu")
    hosted = mc.get("node1", "affine")
    assert hosted.flags() == {"model_id": "affine", "allow_download": False,
                              "allow_remote_inference": True, "mpc": True}
    x = np.array([1.0, 2.0, 3.0], np.float32)
    np.testing.assert_allclose(hosted.model(x, device="cpu").numpy(), x * 2 + 1)
    assert serde.serialize(hosted.model) == hosted.serialized
    mc.save("node1", hosted.serialized, "affine-copy")
    jmc = jdc.ModelController(jdc.SqliteKV(path))
    assert sorted(jmc.models("node1")) == sorted(mc.models("node1")) == ["affine", "affine-copy"]
    np.testing.assert_allclose(np.asarray(jmc.get("node1", "affine-copy").model(x)), x * 2 + 1)


def test_password_digests_cross_packages():
    jrepo = jdc.SessionsRepository()
    jrepo.register("ds", "s3cret")
    digest = jrepo.get_session("ds")._password_hash
    session = UserSession("ds", digest, device="cpu")
    assert session.check_credentials("s3cret") and not session.check_credentials("nope")
    repo = SessionsRepository(device="cpu")
    repo.register("ds", "s3cret")
    assert jdc.UserSession("ds", repo.get_session("ds")._password_hash).check_credentials("s3cret")
