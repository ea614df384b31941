"""Ring and Ulysses sequence parallelism in a gloo world of 4 rank
processes (``torch_world.seq_parallel``) against the JAX package's on a
4-device sub-mesh, mirroring ``tests/unit/test_ring_attention.py``: both
schemes against the JAX ones and dense attention, Ulysses with the flash
kernel (the JAX side in Pallas interpret mode, the port's wrapper on its
plain version), gradients through the ring (the slice/gather pair and the
ring's reverse ``ppermute``) and through Ulysses, the transformer's forward
with each scheme as ``attn_fn`` and its training step through the ring,
and bf16 inputs with an f32 softmax."""

import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pygrid_tpu.models import transformer
from pygrid_tpu.parallel import make_mesh
from pygrid_tpu.parallel.pallas_attention import flash_attention
from pygrid_tpu.parallel.ring_attention import attention, ring_attention, ulysses_attention

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_world import world  # noqa: E402

CFG = transformer.TransformerConfig(vocab=31, d_model=32, n_heads=8, n_layers=2, d_ff=64,
                                    max_len=64)


def _qkv(B=2, L=32, H=8, D=4, seed=0, dtype=jnp.float32):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return [jax.random.normal(k, (B, L, H, D), dtype) for k in ks]


def _inputs():
    out = {}
    for prefix, qkv in (("qkv", _qkv()), ("g", _qkv(B=1, L=16, H=2, D=4)),
                        ("u", _qkv(B=1, L=16, H=4, D=4, seed=2)),
                        ("b", _qkv(L=64, H=4, D=16, seed=5))):
        out.update({f"{prefix}_{n}": np.asarray(t) for n, t in zip("qkv", qkv)})
    params = transformer.init(jax.random.PRNGKey(0), CFG)
    out.update({f"tf_p{i}": np.asarray(p) for i, p in enumerate(params)})
    out["tf_n"] = np.array(len(params))
    out["tf_tokens"] = np.asarray(
        jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0, CFG.vocab)).astype(np.int64)
    out["tf_X"] = out["tf_tokens"]
    return out


@pytest.fixture(scope="module")
def w(tmp_path_factory):
    return world(tmp_path_factory, "seq_parallel", _inputs)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(4, axes=("seq",))


def _jqkv(w, prefix="qkv"):
    return [jnp.asarray(w.inputs[f"{prefix}_{n}"]) for n in "qkv"]


def _every_rank(w, case, want, atol):
    for got in w.ranks(case):
        np.testing.assert_allclose(got["out"], np.asarray(want), atol=atol)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_the_jax_ring_and_full(w, mesh, causal):
    q, k, v = _jqkv(w)
    case = f"ring_{'causal' if causal else 'full'}"
    _every_rank(w, case, attention(q, k, v, causal=causal), 1e-5)
    ring = jax.jit(partial(ring_attention, mesh=mesh, causal=causal))
    _every_rank(w, case, ring(q, k, v), 1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_the_jax_ulysses_and_full(w, mesh, causal):
    q, k, v = _jqkv(w)
    case = f"ulysses_{'causal' if causal else 'full'}"
    _every_rank(w, case, attention(q, k, v, causal=causal), 1e-5)
    ulysses = jax.jit(partial(ulysses_attention, mesh=mesh, causal=causal))
    _every_rank(w, case, ulysses(q, k, v), 1e-5)


def test_ulysses_rejects_indivisible_heads(w, mesh):
    q, k, v = _qkv(H=6)
    with pytest.raises(ValueError):
        ulysses_attention(q, k, v, mesh)
    w("ulysses_rejects_indivisible_heads")  # the port raised too


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_with_flash_kernel(w, mesh, causal):
    """The flash kernel as the per-head-group primitive inside the
    all-to-all scheme: the JAX side's Pallas kernel in interpret mode."""
    q, k, v = _jqkv(w)
    case = f"ulysses_flash_{'causal' if causal else 'full'}"
    _every_rank(w, case, attention(q, k, v, causal=causal), 3e-5)
    want = ulysses_attention(q, k, v, mesh, causal=causal,
                             attn_fn=partial(flash_attention, interpret=True))
    _every_rank(w, case, want, 3e-5)


def _jax_grads(fn, q, k, v):
    return jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) ** 2), (0, 1, 2)))(q, k, v)


@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_gradients_match_full_and_the_jax_scheme(w, mesh, scheme):
    q, k, v = _jqkv(w, "g" if scheme == "ring" else "u")  # Ulysses needs heads % 4 == 0
    fn = ring_attention if scheme == "ring" else ulysses_attention
    refs = [_jax_grads(partial(attention, causal=True), q, k, v),
            _jax_grads(partial(fn, mesh=mesh, causal=True), q, k, v)]
    for got in w.ranks(f"{scheme}_grads"):
        for ref in refs:
            for name, g in zip("qkv", ref):
                np.testing.assert_allclose(got[name], np.asarray(g), atol=1e-4)


def _jparams(w):
    return [jnp.asarray(w.inputs[f"tf_p{i}"]) for i in range(int(w.inputs["tf_n"]))]


@pytest.mark.parametrize("sp_attn", ["ring", "ulysses"])
def test_transformer_sequence_parallel_matches_local(w, mesh, sp_attn):
    params, tokens = _jparams(w), jnp.asarray(w.inputs["tf_tokens"])
    fn = ring_attention if sp_attn == "ring" else ulysses_attention
    sp = jax.jit(lambda p, t: transformer.apply(p, t, CFG, attn_fn=partial(fn, mesh=mesh)))
    for want in (transformer.apply(params, tokens, CFG), sp(params, tokens)):
        for got in w.ranks("transformer_sp"):
            np.testing.assert_allclose(got[sp_attn], np.asarray(want), atol=2e-4)


def test_transformer_sequence_parallel_training_step(w, mesh):
    """The full train step (forward and backward through ring attention)."""
    params, X = _jparams(w), jnp.asarray(w.inputs["tf_X"])
    y = jnp.roll(X, -1, axis=1)
    want = jax.jit(transformer.make_training_step(
        CFG, attn_fn=partial(ring_attention, mesh=mesh)))(X, y, jnp.float32(0.1), *params)
    local = jax.jit(transformer.make_training_step(CFG))(X, y, jnp.float32(0.1), *params)
    for got in w.ranks("transformer_sp_training_step"):
        for ref in (want, local):
            np.testing.assert_allclose(got["loss"], float(ref[0]), atol=1e-5)
            for i, b in enumerate(ref[2:]):
                np.testing.assert_allclose(got[f"p{i}"], np.asarray(b), atol=5e-4)


def test_attention_bf16_inputs_f32_softmax(w, mesh):
    """bf16 q/k/v through the ring: a bf16 result within bf16 input
    resolution of the f32 reference, as the JAX ring's is."""
    q32, k32, v32 = _jqkv(w, "b")
    ref = attention(q32, k32, v32, causal=True)
    bf = [t.astype(jnp.bfloat16) for t in (q32, k32, v32)]
    ring16 = ring_attention(*bf, mesh, causal=True)
    for got in w.ranks("ring_bf16"):
        assert got["dtype"] == "torch.bfloat16"
        np.testing.assert_allclose(got["out"], np.asarray(ref), atol=0.04)
        np.testing.assert_allclose(got["out"], np.asarray(ring16, np.float32), atol=0.04)
