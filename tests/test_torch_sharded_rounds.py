"""The sharded FedAvg round builders (``make_sharded_round``,
``make_sharded_fused_round``) and the SecAgg simulation's mesh path in a
gloo world of 4 rank processes (``torch_world.sharded_rounds``), against
the JAX package's on a 4-device sub-mesh, mirroring
``tests/unit/test_fedavg_sim.py``, ``tests/unit/test_fedavg_fused.py`` and
``tests/unit/test_secagg.py``'s mesh cases: the same params, client data
and tolerances; the masked sums bit for bit."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from pygrid_tpu.models import mlp
from pygrid_tpu.parallel import make_round, make_sharded_round, run_rounds
from pygrid_tpu.parallel import secagg_sim as jsim
from pygrid_tpu.parallel.fedavg_fused import make_sharded_fused_round

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_world import world  # noqa: E402

FUSED = [(1, None, "fused_1"), (2, None, "fused_2"), (3, jnp.bfloat16, "fused_3_bf16")]


def _clients(key, n_clients, per_client, dim, classes):
    kx, kw = jax.random.split(key)
    X = jax.random.normal(kx, (n_clients, per_client, dim))
    labels = jnp.argmax(X.reshape(-1, dim) @ jax.random.normal(kw, (dim, classes)), -1)
    return X, jax.nn.one_hot(labels.reshape(n_clients, per_client), classes)


def _np(prefix, params, X, y):
    out = {f"{prefix}_p{i}": np.asarray(p) for i, p in enumerate(params)}
    out[f"{prefix}_X"], out[f"{prefix}_y"] = np.asarray(X), np.asarray(y)
    return out


def _inputs():
    out = {}
    out.update(_np("r", mlp.init(jax.random.PRNGKey(2), (32, 16, 4)),
                   *_clients(jax.random.PRNGKey(3), 16, 8, 32, 4)))
    out.update(_np("l", mlp.init(jax.random.PRNGKey(4), (64, 32, 4)),
                   *_clients(jax.random.PRNGKey(5), 32, 16, 64, 4)))
    out.update(_np("f", mlp.init(jax.random.PRNGKey(9), (64, 32, 10)),
                   *_clients(jax.random.PRNGKey(10), 16, 8, 64, 10)))
    rng = np.random.default_rng(5)
    out["sum_q"] = rng.integers(0, 1 << 32, (32, 17), dtype=np.uint32)  # 8 clients a rank
    out["sum_key"] = np.asarray(jax.random.PRNGKey(9))
    out["round_diffs"] = np.random.default_rng(6).normal(0, 0.01, (8, 5, 3)).astype(np.float32)
    out["round_key"] = np.asarray(jax.random.PRNGKey(1))
    return out


@pytest.fixture(scope="module")
def w(tmp_path_factory):
    return world(tmp_path_factory, "sharded_rounds", _inputs)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:4]), ("clients",))


def _jax_args(inp, prefix):
    return ([jnp.asarray(inp[f"{prefix}_p{i}"]) for i in range(4)],
            jnp.asarray(inp[f"{prefix}_X"]), jnp.asarray(inp[f"{prefix}_y"]))


def _same_on_every_rank(w, case):
    ranks = w.ranks(case)
    for r in ranks[1:]:
        for k, v in r.items():
            np.testing.assert_array_equal(v, ranks[0][k])
    return ranks[0]


def test_sharded_round_matches_the_jax_mesh_round_and_vmap(w, mesh):
    """pmean-over-mesh aggregation agrees with the JAX package's sharded
    round and its single-device vmap round."""
    params, X, y = _jax_args(w.inputs, "r")
    got = _same_on_every_rank(w, "sharded_round")
    for ref in (make_sharded_round(mlp.training_step, mesh, local_steps=1),
                make_round(mlp.training_step, local_steps=1)):
        p, loss, acc = ref(params, X, y, jnp.float32(0.1))
        for i, a in enumerate(p):
            np.testing.assert_allclose(got[f"p{i}"], np.asarray(a), atol=1e-5)
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(got["acc"], float(acc), rtol=1e-5)


def test_sharded_round_learns_on_mesh(w, mesh):
    params, X, y = _jax_args(w.inputs, "l")
    got = _same_on_every_rank(w, "sharded_round_learns")
    assert got["accs"][-1] > got["accs"][0]  # accuracy improves
    round_fn = make_sharded_round(mlp.training_step, mesh, local_steps=2)
    p, metrics = run_rounds(round_fn, params, X, y, jnp.float32(0.5), 4)
    np.testing.assert_allclose(got["losses"], [float(l) for l, _ in metrics], rtol=1e-4)
    for i, a in enumerate(p):
        np.testing.assert_allclose(got[f"p{i}"], np.asarray(a), atol=1e-4)


@pytest.mark.parametrize("local_steps, carry_dtype, case", FUSED)
def test_sharded_fused_matches_the_jax_sharded_fused_round(w, mesh, local_steps, carry_dtype,
                                                           case):
    params, X, y = _jax_args(w.inputs, "f")
    got = _same_on_every_rank(w, case)
    ref = make_sharded_fused_round(mlp.loss_and_acc, mesh, local_steps=local_steps,
                                   carry_dtype=carry_dtype)
    p, loss, acc = ref(params, X, y, jnp.float32(0.2))
    for i, a in enumerate(p):
        np.testing.assert_allclose(got[f"p{i}"], np.asarray(a), atol=2e-5)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(got["acc"], float(acc), rtol=1e-5)


def test_sharded_fused_loss_keeps_no_gradient_buffer_alive(w):
    """The round's loss and accuracy own their storage: a caller that keeps
    every round's loss (as the benchmark's window does) keeps no
    all-reduced gradient buffer with it."""
    for got in w.ranks("fused_loss_storage"):
        assert got["bytes"].tolist() == [4, 4]


def test_sharded_local_steps_validation():
    from pygrid_tpu_torch.models import mlp as tmlp
    from pygrid_tpu_torch.parallel import make_sharded_fused_round as port_round

    with pytest.raises(ValueError):
        port_round(tmlp.loss_and_acc, None, local_steps=0)


def test_sharded_masked_sum_is_bit_identical_to_the_jax_mesh_path(w, mesh):
    q = w.inputs["sum_q"]
    key = jnp.asarray(w.inputs["sum_key"])
    want = np.asarray(jsim.make_sharded_masked_sum(mesh)(key, jnp.asarray(q)))
    plain = np.zeros(q.shape[1:], np.uint32)
    for row in q:
        np.add(plain, row, out=plain)
    for got in w.ranks("masked_sum_on_mesh"):
        np.testing.assert_array_equal(got["total"].astype(np.uint32), want)
        np.testing.assert_array_equal(got["total"].astype(np.uint32), plain)
        np.testing.assert_array_equal(got["total"], got["single"])


def test_simulated_secagg_round_on_the_mesh_is_bit_identical(w, mesh):
    diffs = w.inputs["round_diffs"]
    want = jsim.simulate_secagg_round(jnp.asarray(w.inputs["round_key"]), diffs, clip_range=0.1,
                                      mesh=mesh)
    for got in w.ranks("secagg_round_on_mesh"):
        assert got["mesh"].dtype == np.float32
        np.testing.assert_array_equal(got["mesh"], want)
        np.testing.assert_array_equal(got["mesh"], got["single"])
