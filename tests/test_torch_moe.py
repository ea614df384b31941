"""The expert-parallel MoE (``models/moe.py``) in a gloo world of 4 rank
processes (``torch_world.moe``) against the JAX package's on a 4-device
sub-mesh, mirroring ``tests/unit/test_moe.py``: with room for every token
the expert-parallel output equals the dense reference and the JAX
package's; at a capacity of one a token per expert shard every row is the
dense row or zero, as the JAX package drops them; the expert FFN's
gradients through the two all-to-alls equal the dense ones and the JAX
package's (and the gate's gradient sums over the ranks' tokens, as the
reference's implicit psum of a replicated input does); bad shapes raise."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from pygrid_tpu.models import moe

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_world import world  # noqa: E402

P_SZ, D, FF, E, T = 4, 8, 16, 8, 32


def _inputs():
    out = {f"p{i}": np.asarray(p) for i, p in enumerate(moe.init(jax.random.PRNGKey(0), D, FF, E))}
    for i in (1, 2, 3):
        out[f"x{i}"] = np.asarray(jax.random.normal(jax.random.PRNGKey(i), (T, D)))
    return out


@pytest.fixture(scope="module")
def w(tmp_path_factory):
    return world(tmp_path_factory, "moe", _inputs)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:P_SZ]), ("expert",))


def _jparams(w):
    return [jnp.asarray(w.inputs[f"p{i}"]) for i in range(5)]


def test_expert_parallel_matches_dense(w, mesh):
    params, x = _jparams(w), jnp.asarray(w.inputs["x1"])
    dense = np.asarray(moe.apply_dense(params, x))
    # generous capacity → no token drops → exact match
    ep = np.asarray(jax.jit(lambda p, x: moe.apply_expert_parallel(
        p, x, mesh, capacity_factor=float(E)))(params, x))
    for got in w.ranks("matches_dense"):
        np.testing.assert_allclose(got["ep"], dense, atol=1e-5)
        np.testing.assert_allclose(got["ep"], ep, atol=1e-5)
        np.testing.assert_allclose(got["dense"], dense, atol=1e-5)


def test_capacity_drops_tokens_deterministically(w, mesh):
    """With capacity 1 per expert shard, overflow tokens contribute zero
    (GShard drop semantics): the same rows as the JAX package's."""
    params, x = _jparams(w), jnp.asarray(w.inputs["x2"])
    want = np.asarray(jax.jit(lambda p, x: moe.apply_expert_parallel(
        p, x, mesh, capacity_factor=0.125))(params, x))
    for got in w.ranks("capacity_drops"):
        row_match = np.isclose(got["ep"], got["dense"], atol=1e-5).all(axis=1)
        row_zero = np.isclose(got["ep"], 0.0).all(axis=1)
        assert np.all(row_match | row_zero)
        assert row_zero.any(), "capacity 1 should drop something"
        np.testing.assert_array_equal(row_zero, np.isclose(want, 0.0).all(axis=1))
        np.testing.assert_allclose(got["ep"], want, atol=1e-5)


def test_gradients_flow_through_dispatch(w, mesh):
    params, x = _jparams(w), jnp.asarray(w.inputs["x3"])
    g_ep = jax.jit(jax.grad(lambda p: jnp.mean(
        moe.apply_expert_parallel(p, x, mesh, capacity_factor=float(E)) ** 2)))(params)
    g_dense = jax.jit(jax.grad(lambda p: jnp.mean(moe.apply_dense(p, x) ** 2)))(params)
    for got in w.ranks("gradients"):
        # expert FFN grads agree (gate grads differ between the two
        # routings: dense selects through a softmax of all experts)
        for i in range(1, 5):
            np.testing.assert_allclose(got[f"ep_g{i}"], np.asarray(g_dense[i]), atol=1e-5)
            np.testing.assert_allclose(got[f"ep_g{i}"], np.asarray(g_ep[i]), atol=1e-5)
        for i in range(5):
            np.testing.assert_allclose(got[f"dense_g{i}"], np.asarray(g_dense[i]), atol=1e-5)
        np.testing.assert_allclose(got["ep_g0"], np.asarray(g_ep[0]), atol=1e-5)


def test_shape_validation(w, mesh):
    params = _jparams(w)
    with pytest.raises(ValueError):
        moe.apply_expert_parallel(params, jnp.zeros((T + 1, D)), mesh)
    with pytest.raises(ValueError):
        moe.apply_expert_parallel(moe.init(jax.random.PRNGKey(0), D, FF, E + 1),
                                  jnp.zeros((T, D)), mesh)
    w("shape_validation")  # the port raised for both
