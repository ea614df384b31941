"""Port parity: pygrid_tpu_torch's FedAvg round builders against the JAX
package's, on the same numpy params and client data.

The transformer rounds attend through the flash kernel on both sides
(interpret-mode Pallas in JAX, the plain versions in the port). Tolerances:
f32 params rtol 1e-4 (atol 1e-5), losses rtol 1e-5; the bf16 delta carry
at bf16 resolution (params atol 3e-3). Accuracies may differ by one argmax
tie per client batch.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygrid_tpu.models import mlp as jmlp
from pygrid_tpu.models import transformer as jtf
from pygrid_tpu.parallel import make_fused_rounds as j_fused_rounds
from pygrid_tpu.parallel import make_round as j_make_round
from pygrid_tpu.parallel import make_scanned_rounds as j_scanned_rounds
from pygrid_tpu.parallel.pallas_attention import flash_attention as jax_flash
from pygrid_tpu_torch import convert
from pygrid_tpu_torch.models import mlp as tmlp
from pygrid_tpu_torch.models import transformer as ttf
from pygrid_tpu_torch.parallel import (
    make_fused_round,
    make_fused_rounds,
    make_round,
    make_scanned_rounds,
    run_rounds,
)
from pygrid_tpu_torch.parallel import flash_attention as fa

torch.set_num_threads(1)

JCFG = jtf.TransformerConfig(
    vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_len=32
)
TCFG = ttf.TransformerConfig(*JCFG)
K, B = 2, 2


def _close(tparams, jparams, rtol=1e-4, atol=1e-5):
    assert len(tparams) == len(jparams)
    for a, b in zip(tparams, jparams):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)


def _transformer_setup(seed=0):
    jparams = jtf.init(jax.random.PRNGKey(seed), JCFG)
    tparams = convert.params_from_numpy(
        [np.asarray(p) for p in jparams], device="cpu", cfg=TCFG
    )
    rng = np.random.default_rng(seed + 1)
    X = rng.integers(0, JCFG.vocab, (K, B, JCFG.max_len), dtype=np.int32)
    return jparams, tparams, X, np.roll(X, -1, axis=-1)


def _mlp_setup(sizes, n_clients, per_client, seed=0):
    """``jmlp.init``'s layout and scales (He-normal weights, zero biases),
    drawn with numpy: the MLP cases need no JAX compile for their params."""
    rng = np.random.default_rng(seed)
    arrays = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        arrays.append(rng.standard_normal((n_in, n_out), dtype=np.float32)
                      * np.float32((2.0 / n_in) ** 0.5))
        arrays.append(np.zeros((n_out,), np.float32))
    jparams = [jnp.asarray(a) for a in arrays]
    tparams = convert.params_from_numpy(arrays, device="cpu", mlp_sizes=sizes)
    rng = np.random.default_rng(seed + 1)
    X = rng.standard_normal((n_clients, per_client, sizes[0]), dtype=np.float32)
    labels = rng.integers(0, sizes[-1], (n_clients, per_client))
    y = np.eye(sizes[-1], dtype=np.float32)[labels]
    return jparams, tparams, X, y


@pytest.mark.parametrize(
    "local_steps,carry",
    [(1, None), (2, None), (2, "bfloat16")],
    ids=["steps1", "steps2", "steps2_bf16_carry"],
)
def test_fused_transformer_rounds_match_jax(local_steps, carry):
    jparams, tparams, X, y = _transformer_setup()
    j_loss = partial(jtf.loss_and_acc, cfg=JCFG, attn_fn=partial(jax_flash, interpret=True))
    t_loss = partial(ttf.loss_and_acc, cfg=TCFG, attn_fn=fa.flash_attention)
    jp, jl, ja = j_fused_rounds(
        j_loss, n_rounds=2, local_steps=local_steps,
        carry_dtype=getattr(jnp, carry) if carry else None,
    )(jparams, jnp.asarray(X), jnp.asarray(y), jnp.float32(0.1))
    tp, tl, ta = make_fused_rounds(
        t_loss, n_rounds=2, local_steps=local_steps,
        carry_dtype=getattr(torch, carry) if carry else None,
    )(tparams, torch.from_numpy(X).long(), torch.from_numpy(y).long(), 0.1)
    assert tl.shape == ta.shape == (2,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1.0 / (B * JCFG.max_len))
    if carry is None:
        _close(tp, jp)
    else:
        _close(tp, jp, rtol=0, atol=3e-3)


def test_mlp_make_round_matches_jax():
    """The port's twin of __graft_entry__.entry(): one opaque FedAvg round
    of the MNIST MLP, K=8 clients x B=16."""
    jparams, tparams, X, y = _mlp_setup((784, 392, 10), 8, 16)
    jp, jl, ja = j_make_round(jmlp.training_step)(
        jparams, jnp.asarray(X), jnp.asarray(y), jnp.float32(0.1)
    )
    tp, tl, ta = make_round(tmlp.training_step)(
        tparams, torch.from_numpy(X), torch.from_numpy(y), 0.1
    )
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), atol=1.0 / 16)
    _close(tp, jp)


@pytest.mark.parametrize(
    "local_steps,fold",
    [(1, False), (3, False), (1, True)],
    ids=["steps1", "steps3", "folded"],
)
def test_mlp_scanned_rounds_match_jax(local_steps, fold):
    sizes = (64, 32, 10)
    jparams, tparams, X, y = _mlp_setup(sizes, 8, 16, seed=2)
    jp, jl, _ = j_scanned_rounds(
        jmlp.training_step, n_rounds=3, local_steps=local_steps, fold_clients=fold
    )(jparams, jnp.asarray(X), jnp.asarray(y), jnp.float32(0.2))
    tp, tl, _ = make_scanned_rounds(
        tmlp.training_step, n_rounds=3, local_steps=local_steps, fold_clients=fold
    )(tparams, torch.from_numpy(X), torch.from_numpy(y), 0.2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    _close(tp, jp)


@pytest.mark.parametrize("local_steps", [1, 3])
def test_fused_matches_opaque_mlp(local_steps):
    """Port against port: the fused reassociation equals the opaque
    per-client builder (mirrors tests/unit/test_fedavg_fused.py)."""
    _, params, X, y = _mlp_setup((64, 32, 10), 8, 16, seed=3)
    X, y = torch.from_numpy(X), torch.from_numpy(y)
    p1, l1, a1 = make_scanned_rounds(
        tmlp.training_step, n_rounds=3, local_steps=local_steps
    )(params, X, y, 0.2)
    p2, l2, a2 = make_fused_rounds(
        tmlp.loss_and_acc, n_rounds=3, local_steps=local_steps
    )(params, X, y, 0.2)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(a1.numpy(), a2.numpy(), rtol=1e-4, atol=1e-6)


def test_fused_round_and_run_rounds_learn():
    _, params, X, y = _mlp_setup((32, 16, 4), 8, 8, seed=4)
    X, y = torch.from_numpy(X), torch.from_numpy(y)
    round_fn = make_fused_round(tmlp.loss_and_acc, local_steps=2)
    p, loss, acc = round_fn(params, X, y, 0.3)
    assert torch.isfinite(loss) and loss.dim() == 0
    p, metrics = run_rounds(round_fn, p, X, y, 0.3, n_rounds=4)
    assert len(metrics) == 4
    assert float(metrics[-1][0]) < float(loss)


def test_local_steps_and_fold_validation():
    with pytest.raises(ValueError):
        make_fused_rounds(tmlp.loss_and_acc, n_rounds=1, local_steps=0)
    with pytest.raises(ValueError, match="fold_clients"):
        make_scanned_rounds(tmlp.training_step, n_rounds=1, local_steps=2, fold_clients=True)
