"""The port's threefry PRNG against ``jax.random``, bit for bit.

``pygrid_tpu_torch.utils.prng`` carries the part of ``jax.random`` that
generation serving samples with. Keys, splits, fold-ins, random bits and
uniforms must equal jax 0.9's (``jax_threefry_partitionable=True``, 32-bit
seeds) exactly; the Gumbel noise within a few f32 ulps (the ``log`` of two
libraries), and categorical draws must pick the same tokens on the same
logits. Batched keys act as ``jax.vmap`` of the reference.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygrid_tpu_torch.utils import prng

SEEDS = [0, 1, 7, 123456789, 2**31 - 1, 3_000_000_000, 2**40 + 5, -1]
SHAPES = [(), (1,), (3,), (2, 5), (31,), (4, 3, 2)]


def _t(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _n(x: torch.Tensor) -> np.ndarray:
    return x.numpy()


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bits(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed, device="cpu")
    assert tk.dtype == torch.int64 and tuple(tk.shape) == (2,)
    assert np.array_equal(np.asarray(jk).astype(np.int64), _n(tk))
    for num in (1, 2, 5, 33):
        assert np.array_equal(np.asarray(jax.random.split(jk, num)).astype(np.int64),
                              _n(prng.split(tk, num)))
    for data in (0, 1, 3, 2**31 + 9):
        assert np.array_equal(np.asarray(jax.random.fold_in(jk, data)).astype(np.int64),
                              _n(prng.fold_in(tk, data)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 7, 2**40 + 5])
def test_uniform_and_bits_match_bit_for_bit(seed, shape):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed, device="cpu")
    want = np.asarray(jax.random.uniform(jk, shape))
    got = _n(prng.uniform(tk, shape))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    bits = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    assert np.array_equal(_n(prng.random_bits(tk, shape)), bits)
    lo_hi = np.asarray(jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0))
    assert np.array_equal(_n(prng.uniform(tk, shape, -2.0, 3.0)), lo_hi)


@pytest.mark.parametrize("seed", [0, 11, 3_000_000_000])
def test_gumbel_within_f32_ulps(seed):
    jk = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.gumbel(jk, (4, 257)))
    got = _n(prng.gumbel(prng.PRNGKey(seed, device="cpu"), (4, 257)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_batched_keys_are_vmap_of_the_reference():
    """``keys[w, 2]`` and ``keys[steps, w, 2]`` — the engine's schedules —
    act per key as the reference's vmapped calls do."""
    keys = jax.random.split(jax.random.PRNGKey(5), 12).reshape(3, 4, 2)
    tkeys = _t(keys)
    want = jax.vmap(jax.vmap(lambda k: jax.random.fold_in(k, 2)))(keys)
    assert np.array_equal(np.asarray(want).astype(np.int64), _n(prng.fold_in(tkeys, 2)))
    want = jax.vmap(jax.vmap(jax.random.uniform))(keys)
    assert np.array_equal(np.asarray(want), _n(prng.uniform(tkeys)))
    want = jax.vmap(lambda k: jax.random.split(k, 3))(keys[0])
    assert np.array_equal(np.asarray(want).astype(np.int64), _n(prng.split(tkeys[0], 3)))
    want = jax.vmap(lambda k: jax.random.uniform(k, (6,)))(keys[1])
    assert np.array_equal(np.asarray(want), _n(prng.uniform(tkeys[1], (6,))))


@pytest.mark.parametrize("vocab", [31, 127, 8192])
def test_categorical_picks_the_same_tokens(vocab):
    rng = np.random.RandomState(vocab)
    logits = (rng.randn(6, vocab) * 3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(vocab), 6)
    # one key per row, as the engine's vmapped _pick draws
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
    got = _n(prng.categorical(_t(keys), torch.from_numpy(logits)))
    assert np.array_equal(got, want)
    # one key over a [B, vocab] batch, as generate() draws
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.categorical(key, logits, axis=-1))
    assert np.array_equal(_n(prng.categorical(prng.PRNGKey(3, device="cpu"),
                                              torch.from_numpy(logits))), want)
    # keys [w, K, 2] over logits [w, K, vocab], the speculative residual draw
    k3 = jax.random.split(jax.random.PRNGKey(9), 12).reshape(3, 4, 2)
    l3 = (rng.randn(3, 4, vocab)).astype(np.float32)
    want = np.asarray(jax.vmap(jax.vmap(jax.random.categorical))(k3, l3))
    assert np.array_equal(_n(prng.categorical(_t(k3), torch.from_numpy(l3))), want)


def test_keys_must_be_pairs_and_the_default_device_is_the_card():
    with pytest.raises(ValueError, match=r"\[\.\.\., 2\]"):
        prng.uniform(torch.zeros(3, dtype=torch.int64))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            prng.PRNGKey(0)


@pytest.mark.cuda
def test_card_bits_equal_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    k = prng.split(prng.PRNGKey(20260, device="cuda"), 64)
    kc = prng.split(prng.PRNGKey(20260, device="cpu"), 64)
    assert torch.equal(k.cpu(), kc)
    assert torch.equal(prng.random_bits(k, (8, 100)).cpu(), prng.random_bits(kc, (8, 100)))
    assert torch.equal(prng.uniform(k, (50,)).cpu(), prng.uniform(kc, (50,)))
