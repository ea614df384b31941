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

import ast
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygrid_tpu.models import transformer as jtf
from pygrid_tpu.parallel.pallas_attention import flash_attention as jax_flash
from pygrid_tpu_torch import convert
from pygrid_tpu_torch import models as models_pkg
from pygrid_tpu_torch.models import lm
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


def _setup(seed=0, vocab=JCFG.vocab):
    jcfg = JCFG._replace(vocab=vocab)
    jparams = jtf.init(jax.random.PRNGKey(seed), jcfg)
    np_params = [np.asarray(p) for p in jparams]
    tparams = convert.params_from_numpy(
        np_params, device="cpu", cfg=ttf.TransformerConfig(*jcfg)
    )
    rng = np.random.default_rng(seed + 1)
    X = rng.integers(0, vocab, (B, L), dtype=np.int32)
    y = np.roll(X, -1, axis=-1)
    return jparams, tparams, X, y


_JAX_RUNS: dict = {}


def _jgrad(kw, seed, vocab=JCFG.vocab):
    """``jax.value_and_grad`` of the JAX loss on ``_setup(seed)``, run once
    per distinct computation. ``remat`` trades memory for recomputation and
    changes no math in either package, so the remat cases are held against
    the plain JAX run: one interpret-mode pass fewer for each."""
    kw = {k: v for k, v in kw.items() if k != "remat"}
    key = (seed, vocab, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        jparams, _, X, y = _setup(seed, vocab)
        jcfg = JCFG._replace(vocab=vocab)
        _JAX_RUNS[key] = jax.value_and_grad(
            lambda p: jtf.loss_and_acc(
                p, jnp.asarray(X), jnp.asarray(y), jcfg, JFLASH, **kw
            ),
            has_aux=True,
        )(jparams)
    return _JAX_RUNS[key]


def _tgrad(kw, tparams, X, y, cfg=TCFG):
    leaves = [p.clone().requires_grad_() for p in tparams]
    loss, acc = ttf.loss_and_acc(
        leaves, torch.from_numpy(X).long(), torch.from_numpy(y).long(),
        cfg, fa.flash_attention, **kw,
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


_BF16_KWS = {
    "bf16_ce_bwd": {"ce_grad_dtype": "bfloat16"},
    "bf16_compute": {"compute_dtype": "bfloat16"},
    "bf16_both": {"compute_dtype": "bfloat16", "ce_grad_dtype": "bfloat16"},
}


# odd vocabularies run the CE head at its padded width (lm.VOCAB_ALIGN);
# the embedding's gradient must still come back [V, d]
@pytest.mark.parametrize(
    "kw, vocab",
    [
        pytest.param(kw, v, id=name if v == JCFG.vocab else f"{name}-v{v}")
        for v in (JCFG.vocab, 131, 257)
        for name, kw in _BF16_KWS.items()
    ],
)
def test_bf16_paths_match_jax(kw, vocab):
    _, tparams, X, y = _setup(seed=2, vocab=vocab)
    (jl, ja), jg = _jgrad(kw, seed=2, vocab=vocab)
    tl, ta, tg = _tgrad(kw, tparams, X, y, TCFG._replace(vocab=vocab))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-2)
    # a bf16 logit can tip an argmax either way; allow a few per 64 tokens
    np.testing.assert_allclose(float(ta), float(ja), atol=4.0 / N)
    assert tg[0].shape == (vocab, JCFG.d_model)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-3)


@pytest.mark.parametrize("vocab", [131, 128])
def test_ce_head_pad_columns_never_count(vocab):
    """Every real logit is negative, so a pad column left at 0 would win
    the argmax and enter the log-sum-exp; the head must match a plain
    log_softmax at width V, and count its padding."""
    d, n = 16, 40
    g = torch.Generator().manual_seed(vocab)
    h2 = torch.rand(n, d, generator=g) + 0.1
    embed = -(torch.rand(vocab, d, generator=g) + 0.1)
    y1 = torch.randint(0, vocab, (n,), generator=g)
    logits = h2 @ embed.T
    assert (logits < 0).all()
    ref_loss = -torch.log_softmax(logits, -1).gather(1, y1[:, None]).sum()
    ref_hits = (logits.argmax(-1) == y1).float().sum()

    lm.reset_head_counts()
    loss, hits = lm.CEHead.apply(h2, embed, y1, None, torch.float32)
    pad = -vocab % lm.VOCAB_ALIGN
    assert lm.head_counts() == {
        "calls": 1, "padded_calls": int(pad > 0), "pad_columns": pad
    }
    torch.testing.assert_close(loss, ref_loss, rtol=1e-6, atol=0)
    assert float(hits) == float(ref_hits)

    leaf = embed.clone().requires_grad_()
    loss, _ = lm.CEHead.apply(h2, leaf, y1, None, torch.float32)
    (grad,) = torch.autograd.grad(loss, leaf)
    e = embed.clone().requires_grad_()
    (ref_grad,) = torch.autograd.grad(
        -torch.log_softmax(h2 @ e.T, -1).gather(1, y1[:, None]).sum(), e
    )
    assert grad.shape == (vocab, d)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-5, atol=1e-6)


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


def _private_reaches(path: Path) -> list[str]:
    """Each ``_``-prefixed name that the module at ``path`` takes from
    another module of the models package: imported by name, or read as an
    attribute of a sibling module it imported."""
    pkg = "pygrid_tpu_torch.models"
    siblings = {q.stem for q in path.parent.glob("*.py")} - {"__init__", path.stem}
    tree = ast.parse(path.read_text())
    bound, found = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            ours = node.level > 0 or mod == pkg or mod.startswith(pkg + ".")
            if not ours:
                continue
            for a in node.names:
                if mod in (pkg, "") and a.name in siblings:
                    bound.add(a.asname or a.name)
                elif a.name.startswith("_"):
                    found.append(f"{path.name}:{node.lineno} imports {a.name} from {mod}")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith(pkg + ".") and a.asname:
                    bound.add(a.asname)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                and node.value.id in bound and node.attr.startswith("_")
                and not node.attr.startswith("__")):
            found.append(f"{path.name}:{node.lineno} reads {node.value.id}.{node.attr}")
    return found


def test_no_model_reaches_into_another_models_private_names():
    """What two decoders share lives under a public name (``models/lm.py``
    holds the head, the loss and the step), never as a private name that
    one model file takes from another."""
    paths = sorted(Path(models_pkg.__file__).parent.glob("*.py"))
    assert {p.stem for p in paths} >= {"lm", "transformer", "deepseek_v3", "decode"}
    assert [f for p in paths for f in _private_reaches(p)] == []
