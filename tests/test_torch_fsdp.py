"""FSDP (``parallel/fsdp.py``) in a gloo world of 4 rank processes
(``torch_world.fsdp``) against the JAX package's on a 4-device sub-mesh,
mirroring ``tests/unit/test_fsdp.py``: every optimizer family equals the
JAX FSDP step and the unsharded full-batch update, each rank holds one
row of every shard and moment, the padding stays inert, the MLP learns,
and the transformer's step matches the unsharded SGD update."""

import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from pygrid_tpu.models import mlp, transformer
from pygrid_tpu.parallel import make_mesh
from pygrid_tpu.parallel.fsdp import make_fsdp_training_step, unshard_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_world import world  # noqa: E402

SIZES = (12, 16, 10)  # the last bias (10) does not divide 4: the padding path
B = 32
TF_CFG = transformer.TransformerConfig(vocab=29, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                                       max_len=8)


def _data(seed):
    k = jax.random.PRNGKey(seed)
    X = jax.random.normal(jax.random.fold_in(k, 1), (B, SIZES[0]))
    y = jax.nn.one_hot(jax.random.randint(jax.random.fold_in(k, 2), (B,), 0, SIZES[-1]),
                       SIZES[-1])
    return np.asarray(X), np.asarray(y)


def _params(prefix, params):
    out = {f"{prefix}_p{i}": np.asarray(p) for i, p in enumerate(params)}
    out[f"{prefix}_n"] = np.array(len(params))
    return out


def _inputs():
    out = {}
    out.update(_params("m", mlp.init(jax.random.PRNGKey(0), SIZES)))
    out.update(_params("pad", mlp.init(jax.random.PRNGKey(3), SIZES)))
    out.update(_params("learn", mlp.init(jax.random.PRNGKey(1), SIZES)))
    out.update(_params("tf", transformer.init(jax.random.PRNGKey(0), TF_CFG)))
    out["d0_X"], out["d0_y"] = _data(0)
    out["d7_X"], out["d7_y"] = _data(7)
    out["tf_tok"] = np.asarray(
        jax.random.randint(jax.random.PRNGKey(1), (8, 8), 0, TF_CFG.vocab)).astype(np.int64)
    return out


@pytest.fixture(scope="module")
def w(tmp_path_factory):
    return world(tmp_path_factory, "fsdp", _inputs)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(4, axes=("fsdp",))


def _jparams(w, prefix):
    return [jnp.asarray(w.inputs[f"{prefix}_p{i}"]) for i in range(int(w.inputs[f"{prefix}_n"]))]


def _reference_updates(params, X, y, lr, optimizer, n_steps):
    """Unsharded full-batch reference for each optimizer family."""
    m = [jnp.zeros_like(p) for p in params]
    v = [jnp.zeros_like(p) for p in params]
    losses = []
    for t in range(1, n_steps + 1):
        (loss, _), grads = jax.value_and_grad(mlp.loss_and_acc, has_aux=True)(params, X, y)
        losses.append(float(loss))
        if optimizer == "sgd":
            params = [p - lr * g for p, g in zip(params, grads)]
        elif optimizer == "momentum":
            m = [0.9 * mi + g for mi, g in zip(m, grads)]
            params = [p - lr * mi for p, mi in zip(params, m)]
        else:  # adam
            m = [0.9 * mi + 0.1 * g for mi, g in zip(m, grads)]
            v = [0.999 * vi + 0.001 * g * g for vi, g in zip(v, grads)]
            params = [p - lr * (mi / (1 - 0.9**t)) / (jnp.sqrt(vi / (1 - 0.999**t)) + 1e-8)
                      for p, mi, vi in zip(params, m, v)]
    return params, losses


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam"])
def test_fsdp_matches_the_jax_fsdp_step_and_unsharded(w, mesh, optimizer):
    params = _jparams(w, "m")
    X, y = jnp.asarray(w.inputs["d0_X"]), jnp.asarray(w.inputs["d0_y"])
    lr = jnp.float32(0.1)
    init_state, step = make_fsdp_training_step(mlp.loss_and_acc, params, mesh,
                                               optimizer=optimizer)
    state = init_state(params)
    s = NamedSharding(mesh, P("fsdp"))
    jax_losses = []
    for _ in range(3):
        state, loss, _ = step(state, jax.device_put(X, s), jax.device_put(y, s), lr)
        jax_losses.append(float(loss))
    ref_params, ref_losses = _reference_updates(params, X, y, lr, optimizer, 3)
    jax_params = unshard_params(state["shards"], params)
    for got in w.ranks(f"matches_{optimizer}"):
        for want_losses, want_params in ((jax_losses, jax_params), (ref_losses, ref_params)):
            np.testing.assert_allclose(got["losses"], want_losses, rtol=2e-5)
            for i, r in enumerate(want_params):
                np.testing.assert_allclose(got[f"p{i}"], np.asarray(r), atol=1e-5, rtol=1e-4)


def test_state_is_actually_sharded(w):
    """Each rank holds one [1, shard_len] row of every shard and moment
    buffer, and the four ranks' rows differ: the ZeRO memory claim."""
    for got in w.ranks("state_is_sharded"):
        assert int(got["n_buffers"]) == 3 * int(got["n_params"])  # shards + m + v
        assert (got["row_shapes"][:, 0] == 1).all()
        sizes = [int(np.prod(w.inputs[f"m_p{i}"].shape)) for i in range(int(got["n_params"]))]
        assert got["row_shapes"][:, 1].tolist() == [-(-n // 4) for n in sizes] * 3
        assert (got["rows_differ"][: len(sizes)] == 4).all()  # the param shards differ


def test_padding_is_inert(w):
    for got in w.ranks("padding_is_inert"):
        for i in range(int(w.inputs["pad_n"])):
            np.testing.assert_array_equal(got[f"back{i}"], w.inputs[f"pad_p{i}"])
        assert got["tail"].shape == (2,)
        np.testing.assert_array_equal(got["tail"], np.zeros(2, np.float32))


def test_fsdp_learns(w):
    for got in w.ranks("learns"):
        assert float(got["loss"]) < float(got["first"]) * 0.5
        assert float(got["acc"]) > 0.5


def test_transformer_fsdp_compiles_and_matches(w):
    """The flagship family through the same FSDP step (tiny config): one
    step matches the unsharded transformer SGD update."""
    params = _jparams(w, "tf")
    loss_fn = partial(transformer.loss_and_acc, cfg=TF_CFG)
    tok = jnp.asarray(w.inputs["tf_tok"])
    (ref_loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, tok, jnp.roll(tok, -1, axis=1))
    ref = [p - 0.1 * g for p, g in zip(params, grads)]
    for got in w.ranks("transformer_fsdp"):
        np.testing.assert_allclose(float(got["loss"]), float(ref_loss), rtol=2e-5)
        for i, r in enumerate(ref):
            np.testing.assert_allclose(got[f"p{i}"], np.asarray(r), atol=5e-6, rtol=3e-5)


def test_bad_optimizer_rejected():
    from pygrid_tpu_torch.models import mlp as tmlp
    from pygrid_tpu_torch.parallel import make_fsdp_training_step as port_step

    params = tmlp.init(SIZES, device="cpu")
    with pytest.raises(ValueError, match="optimizer"):
        port_step(tmlp.loss_and_acc, params, None, optimizer="lion")
