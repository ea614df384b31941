"""Pipeline parallelism (``parallel/pipeline.py``) in a gloo world of 4
rank processes (``torch_world.pipeline``) against the JAX package's on a
4-device sub-mesh, mirroring ``tests/unit/test_pipeline.py``: the schedule
equals the sequential fold for 2, 4 and 8 microbatches, an indivisible
batch is refused, the gradients through the schedule (``ppermute``'s
reverse hops and the stage slice's all-gather) equal the sequential ones,
and the training step learns as the JAX step does."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from pygrid_tpu.parallel.pipeline import (
    make_pipeline_training_step,
    pipeline_apply,
    sequential_apply,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_world import world  # noqa: E402

P_STAGES, D = 4, 16


def _stage_fn(params, h):
    w, b = params
    return jnp.tanh(h @ w + b)


def _params(key):
    kw, kb = jax.random.split(key)
    return (jax.random.normal(kw, (P_STAGES, D, D)) / np.sqrt(D),
            jax.random.normal(kb, (P_STAGES, D)) * 0.1)


def _inputs():
    out = {}
    for prefix, key in (("m", 0), ("g", 2), ("t", 5)):
        w, b = _params(jax.random.PRNGKey(key))
        out[f"{prefix}_w"], out[f"{prefix}_b"] = np.asarray(w), np.asarray(b)
    out["m_x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, D)))
    out["g_x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (8, D)))
    out["g_y"] = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (8, D)))
    out["t_x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(6), (16, D)))
    return out


@pytest.fixture(scope="module")
def w(tmp_path_factory):
    return world(tmp_path_factory, "pipeline", _inputs)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:P_STAGES]), ("stage",))


def _jparams(w, prefix):
    return jnp.asarray(w.inputs[f"{prefix}_w"]), jnp.asarray(w.inputs[f"{prefix}_b"])


@pytest.mark.parametrize("n_micro", [None, 2, 8])
def test_pipeline_matches_sequential(w, mesh, n_micro):
    params, x = _jparams(w, "m"), jnp.asarray(w.inputs["m_x"])
    for want in (sequential_apply(_stage_fn, params, x),
                 pipeline_apply(_stage_fn, params, x, mesh, n_microbatches=n_micro)):
        for got in w.ranks(f"matches_{n_micro}"):
            np.testing.assert_allclose(got["out"], np.asarray(want), atol=1e-6)


def test_pipeline_rejects_indivisible_batch(w, mesh):
    with pytest.raises(ValueError):
        pipeline_apply(_stage_fn, _jparams(w, "m"), jnp.zeros((6, D)), mesh, n_microbatches=4)
    w("rejects_indivisible_batch")  # the port raised too


def test_pipeline_gradients_match_sequential(w, mesh):
    params = _jparams(w, "g")
    x, y = jnp.asarray(w.inputs["g_x"]), jnp.asarray(w.inputs["g_y"])
    g_pipe = jax.jit(jax.grad(
        lambda p: jnp.mean((pipeline_apply(_stage_fn, p, x, mesh) - y) ** 2)))(params)
    g_seq = jax.jit(jax.grad(lambda p: jnp.mean((sequential_apply(_stage_fn, p, x) - y) ** 2)))(
        params)
    for got in w.ranks("gradients"):  # the whole stacked gradient on every rank
        for want in (g_pipe, g_seq):
            np.testing.assert_allclose(got["w"], np.asarray(want[0]), atol=1e-6)
            np.testing.assert_allclose(got["b"], np.asarray(want[1]), atol=1e-6)


def test_pipeline_training_step_learns(w, mesh):
    params, x = _jparams(w, "t"), jnp.asarray(w.inputs["t_x"])
    step = jax.jit(make_pipeline_training_step(
        _stage_fn, lambda yh, yy: jnp.mean((yh - yy) ** 2), mesh))
    y = jnp.zeros((16, D))
    losses = []
    for _ in range(6):
        loss, params = step(params, x, y, jnp.float32(0.5))
        losses.append(float(loss))
    for got in w.ranks("training_step_learns"):
        assert got["losses"][-1] < got["losses"][0]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(got["w"], np.asarray(params[0]), atol=1e-5)
