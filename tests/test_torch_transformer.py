"""Port parity: pygrid_tpu_torch's transformer against the JAX package's.

The JAX params come from ``transformer.init`` as numpy and cross over
through ``convert.params_from_numpy``; tokens are drawn with numpy. The JAX
side attends through the Pallas flash kernel in interpret mode, the port
through its flash wrapper on the CPU (the kernels' plain versions).

Tolerances: f32 losses rtol 1e-5 and f32 params after a step rtol 1e-4
(atol 1e-6); accuracies may differ by one argmax tie per N tokens, so they
are compared at atol 1/N. The bf16 paths (compute dtype, CE backward) are
held at bf16 resolution: loss rtol 1e-2, gradients atol 5e-3.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygrid_tpu.models import transformer as jtf
from pygrid_tpu.parallel.pallas_attention import flash_attention as jax_flash
from pygrid_tpu_torch import convert
from pygrid_tpu_torch.models import transformer as ttf
from pygrid_tpu_torch.parallel import flash_attention as fa

torch.set_num_threads(1)

JCFG = jtf.TransformerConfig(
    vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32
)
TCFG = ttf.TransformerConfig(*JCFG)
B, L = 2, 32
N = B * L
JFLASH = partial(jax_flash, interpret=True)


def _setup(seed=0):
    jparams = jtf.init(jax.random.PRNGKey(seed), JCFG)
    np_params = [np.asarray(p) for p in jparams]
    tparams = convert.params_from_numpy(np_params, device="cpu", cfg=TCFG)
    rng = np.random.default_rng(seed + 1)
    X = rng.integers(0, JCFG.vocab, (B, L), dtype=np.int32)
    y = np.roll(X, -1, axis=-1)
    return jparams, tparams, X, y


_JAX_RUNS: dict = {}


def _jgrad(kw, seed):
    """``jax.value_and_grad`` of the JAX loss on ``_setup(seed)``, run once
    per distinct computation. ``remat`` trades memory for recomputation and
    changes no math in either package, so the remat cases are held against
    the plain JAX run: one interpret-mode pass fewer for each."""
    kw = {k: v for k, v in kw.items() if k != "remat"}
    key = (seed, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        jparams, _, X, y = _setup(seed)
        _JAX_RUNS[key] = jax.value_and_grad(
            lambda p: jtf.loss_and_acc(
                p, jnp.asarray(X), jnp.asarray(y), JCFG, JFLASH, **kw
            ),
            has_aux=True,
        )(jparams)
    return _JAX_RUNS[key]


def _tgrad(kw, tparams, X, y):
    leaves = [p.clone().requires_grad_() for p in tparams]
    loss, acc = ttf.loss_and_acc(
        leaves, torch.from_numpy(X).long(), torch.from_numpy(y).long(),
        TCFG, fa.flash_attention, **kw,
    )
    return loss, acc, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize(
    "kw",
    [{}, {"ce_chunk": 16}, {"remat": True}, {"remat": "dots"}],
    ids=["plain", "ce_chunk", "remat", "remat_dots"],
)
def test_loss_and_grads_match_jax_f32(kw):
    _, tparams, X, y = _setup()
    (jl, ja), jg = _jgrad(kw, seed=0)
    tl, ta, tg = _tgrad(kw, tparams, X, y)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), atol=1.0 / N)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "kw",
    [
        {"ce_grad_dtype": "bfloat16"},
        {"compute_dtype": "bfloat16"},
        {"compute_dtype": "bfloat16", "ce_grad_dtype": "bfloat16"},
    ],
    ids=["bf16_ce_bwd", "bf16_compute", "bf16_both"],
)
def test_bf16_paths_match_jax(kw):
    _, tparams, X, y = _setup(seed=2)
    (jl, ja), jg = _jgrad(kw, seed=2)
    tl, ta, tg = _tgrad(kw, tparams, X, y)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-2)
    # a bf16 logit can tip an argmax either way; allow a few per 64 tokens
    np.testing.assert_allclose(float(ta), float(ja), atol=4.0 / N)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-3)


def test_ce_grad_dtype_excludes_ce_chunk():
    _, tparams, X, y = _setup()
    with pytest.raises(ValueError, match="mutually exclusive"):
        ttf.loss_and_acc(
            tparams, torch.from_numpy(X).long(), torch.from_numpy(y).long(),
            TCFG, ce_chunk=16, ce_grad_dtype="bfloat16",
        )


def test_training_step_matches_jax():
    jparams, tparams, X, y = _setup(seed=4)
    jstep = jtf.make_training_step(JCFG, attn_fn=JFLASH)
    tstep = ttf.make_training_step(TCFG, attn_fn=fa.flash_attention)
    jout = jstep(jnp.asarray(X), jnp.asarray(y), jnp.float32(0.1), *jparams)
    tout = tstep(
        torch.from_numpy(X).long(), torch.from_numpy(y).long(), 0.1, *tparams
    )
    np.testing.assert_allclose(float(tout[0]), float(jout[0]), rtol=1e-5)
    np.testing.assert_allclose(float(tout[1]), float(jout[1]), atol=1.0 / N)
    assert len(tout) == len(jout) == 2 + len(jparams)
    for a, b in zip(tout[2:], jout[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_apply_logits_match_jax_and_dense_attention():
    jparams, tparams, X, _ = _setup(seed=5)
    jl = jtf.apply(jparams, jnp.asarray(X), JCFG)
    tX = torch.from_numpy(X).long()
    dense = ttf.apply(tparams, tX, TCFG)
    flash = ttf.apply(tparams, tX, TCFG, attn_fn=fa.flash_attention)
    assert dense.dtype == torch.float32 and dense.shape == (B, L, JCFG.vocab)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(flash.numpy(), np.asarray(jl), atol=1e-4)


def test_params_round_trip_and_shape_check():
    jparams = jtf.init(jax.random.PRNGKey(7), JCFG)
    arrays = [np.asarray(p) for p in jparams]
    tparams = convert.params_from_numpy(arrays, device="cpu", cfg=TCFG)
    assert [tuple(p.shape) for p in tparams] == ttf.param_shapes(TCFG)
    back = convert.params_to_numpy(tparams, cfg=TCFG)
    for a, b in zip(back, arrays):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    bad = list(arrays)
    bad[3] = np.zeros((JCFG.d_model + 1,), np.float32)
    with pytest.raises(ValueError, match="param 3"):
        convert.params_from_numpy(bad, device="cpu", cfg=TCFG)
    with pytest.raises(ValueError, match="expected"):
        convert.params_from_numpy(arrays[:-1], device="cpu", cfg=TCFG)
    with pytest.raises(ValueError, match="exactly one"):
        convert.params_from_numpy(arrays, device="cpu")


def test_init_layout_and_generator():
    g = torch.Generator().manual_seed(3)
    p1 = ttf.init(TCFG, generator=g, device="cpu")
    p2 = ttf.init(TCFG, generator=torch.Generator().manual_seed(3), device="cpu")
    assert len(p1) == ttf.N_GLOBAL + ttf.PARAMS_PER_LAYER * TCFG.n_layers
    assert [tuple(p.shape) for p in p1] == ttf.param_shapes(TCFG)
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)
