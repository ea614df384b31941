"""Port parity: pygrid_tpu_torch.models.decode against the JAX package's.

The same numpy params (the reference's ``transformer.init``, carried over
by ``convert.params_from_numpy``), caches and tokens go through both
packages' KV-cache functions: ``prefill``/``decode_step``, the slot family,
the paged family (with and without the ``active`` mask, and the verify
pass) and ``generate``. Tolerances: logits rtol 1e-5 and atol 1e-5 of the
largest |logit| (at least 1) in f32, 2e-2 with bf16 compute and a bf16
cache; the live cache rows within the same bounds; positions exact;
greedy and sampled tokens equal.

The reference's index semantics at the edges each have a case here: a
gather clamps (a position at ``max_len``, a token past the vocabulary, an
index below zero counts from the end), ``.at[].set`` drops an
out-of-range update, and ``dynamic_update_slice`` shifts its start so
that the update fits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygrid_tpu.models import decode as jdec
from pygrid_tpu.models import transformer as jtf
from pygrid_tpu_torch import convert
from pygrid_tpu_torch.models import decode as tdec
from pygrid_tpu_torch.models import transformer as ttf
from pygrid_tpu_torch.utils import prng

torch.set_num_threads(1)

JCFG = jtf.TransformerConfig(vocab=127, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=64)
TCFG = ttf.TransformerConfig(*JCFG)
DH = JCFG.d_model // JCFG.n_heads
TOL = {None: 1e-5, "bfloat16": 2e-2}
DTYPES = {None: (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def params():
    jp = jtf.init(jax.random.PRNGKey(5), JCFG)
    arrays = [np.asarray(p) for p in jp]
    return jp, convert.params_from_numpy(arrays, device="cpu", cfg=TCFG)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(j, t, tol):
    """``t`` within ``tol`` of ``j``: rtol, and atol as a share of the
    largest |j|. At f32 the share is of a value near 1; with bf16 compute
    the two packages round differently (XLA may keep a fused chain's
    intermediates wider than bf16, PyTorch rounds each op), so the bound
    follows the tensor's scale."""
    j, t = _np(j), _np(t)
    scale = max(1.0, float(np.abs(j).max())) if j.size else 1.0
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol * scale)


def _pools(shape, dtype_pair, seed):
    """The same random pool in both packages' dtypes (rounded to bf16
    first where the cache is bf16, so both start from equal values)."""
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    t = torch.from_numpy(a).to(dtype_pair[1])
    return jnp.asarray(t.float().numpy(), dtype_pair[0]), t


def _tok(x) -> tuple:
    x = np.asarray(x, np.int32)
    return jnp.asarray(x), torch.from_numpy(x.astype(np.int64))


# ── bundles ──────────────────────────────────────────────────────────────


def test_bundle_round_trip_and_validation(params):
    jp, tp = params
    spec = tdec.bundle(TCFG, tp)
    assert spec["family"] == "transformer" and spec["cfg"] == list(TCFG)
    cfg, back = tdec.from_bundle(spec, device="cpu")
    assert cfg == TCFG and all(torch.equal(a, b) for a, b in zip(back, tp))
    # the JAX package's own bundle decodes in the port, and the reverse
    cfg, back = tdec.from_bundle(jdec.bundle(JCFG, jp), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, tp))
    jcfg, jback = jdec.from_bundle(spec)
    assert jcfg == JCFG and all(np.array_equal(a, b) for a, b in zip(jback, jp))
    with pytest.raises(ValueError, match="not a generative"):
        tdec.from_bundle({"family": "mlp"}, device="cpu")
    with pytest.raises(ValueError, match="config needs"):
        tdec.from_bundle({**spec, "params": spec["params"][:-1]}, device="cpu")


# ── the contiguous cache ─────────────────────────────────────────────────


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_prefill_and_decode_step_match_jax(params, cd):
    jp, tp = params
    jdt, tdt = DTYPES[cd]
    prompt = np.random.RandomState(1).randint(0, JCFG.vocab, (3, 7))
    jc = jdec.init_cache(JCFG, 3, dtype=jdt)
    tc = tdec.init_cache(TCFG, 3, dtype=tdt, device="cpu")
    jl, jc = jdec.prefill(jp, jc, _tok(prompt)[0], JCFG, cd)
    tl, tc = tdec.prefill(tp, tc, _tok(prompt)[1], TCFG, cd)
    _close(jl, tl, TOL[cd])
    assert tc.pos == int(jc.pos) == 7
    for step in range(3):
        jt, tt = _tok([step, 5, 100])
        jl, jc = jdec.decode_step(jp, jc, jt, JCFG, cd)
        tl, tc = tdec.decode_step(tp, tc, tt, TCFG, cd)
        _close(jl, tl, TOL[cd])
    assert tc.pos == int(jc.pos) == 10
    _close(jc.k[:, :, :10], tc.k[:, :, :10], TOL[cd])
    _close(jc.v[:, :, :10], tc.v[:, :, :10], TOL[cd])


def test_decode_step_at_max_len_drops_the_write_and_clamps_the_position(params):
    jp, tp = params
    shape = (JCFG.n_layers, 2, JCFG.max_len, JCFG.n_heads, DH)
    jk, tk = _pools(shape, DTYPES[None], 3)
    jv, tv = _pools(shape, DTYPES[None], 4)
    jt, tt = _tok([3, 9])
    jl, jc = jdec.decode_step(jp, jdec.KVCache(jk, jv, jnp.int32(JCFG.max_len)), jt, JCFG)
    tl, tc = tdec.decode_step(tp, tdec.KVCache(tk.clone(), tv.clone(), JCFG.max_len), tt, TCFG)
    _close(jl, tl, 1e-5)
    assert torch.equal(tc.k, tk) and torch.equal(tc.v, tv)  # the write was dropped
    _close(jc.k, tc.k, 0)
    assert tc.pos == int(jc.pos) == JCFG.max_len + 1


def test_prefill_past_max_len_shifts_the_write_to_fit(params):
    """``dynamic_update_slice`` at start = max_len - 2 with a 5-row update
    writes rows [max_len - 5, max_len), while the mask keeps the
    unshifted positions."""
    jp, tp = params
    shape = (JCFG.n_layers, 1, JCFG.max_len, JCFG.n_heads, DH)
    jk, tk = _pools(shape, DTYPES[None], 5)
    jv, tv = _pools(shape, DTYPES[None], 6)
    start = JCFG.max_len - 2
    prompt = np.array([[1, 2, 3, 4, 5]])
    jl, jc = jdec.prefill(jp, jdec.KVCache(jk, jv, jnp.int32(start)), _tok(prompt)[0], JCFG)
    tl, tc = tdec.prefill(tp, tdec.KVCache(tk, tv, start), _tok(prompt)[1], TCFG)
    _close(jl, tl, 1e-5)
    _close(jc.k, tc.k, 1e-5)
    _close(jc.v, tc.v, 1e-5)
    assert not torch.equal(tc.k[:, :, -5:-2], _pools(shape, DTYPES[None], 5)[1][:, :, -5:-2])
    assert tc.pos == int(jc.pos) == start + 5


def test_gathers_clamp_tokens_and_positions(params):
    """A token past the vocabulary reads the last embedding row, a
    negative one counts from the end — the reference's gather, where
    torch would raise (and a CUDA assert would poison the context)."""
    jp, tp = params
    jc = jdec.init_cache(JCFG, 3)
    tc = tdec.init_cache(TCFG, 3, device="cpu")
    prompt = np.array([[JCFG.vocab + 40, -1, 7], [-JCFG.vocab - 9, 3, 3], [0, 1, 2]])
    jl, jc = jdec.prefill(jp, jc, _tok(prompt)[0], JCFG)
    tl, tc = tdec.prefill(tp, tc, _tok(prompt)[1], TCFG)
    _close(jl, tl, 1e-5)
    jl, _ = jdec.decode_step(jp, jc, _tok([JCFG.vocab, -2, 5])[0], JCFG)
    tl, _ = tdec.decode_step(tp, tc, _tok([JCFG.vocab, -2, 5])[1], TCFG)
    _close(jl, tl, 1e-5)


# ── the slot cache ───────────────────────────────────────────────────────


def _slot_caches(cd, S=3, seed=7):
    shape = (JCFG.n_layers, S, JCFG.max_len, JCFG.n_heads, DH)
    jk, tk = _pools(shape, DTYPES[cd], seed)
    jv, tv = _pools(shape, DTYPES[cd], seed + 1)
    pos = np.array([5, 0, 9][:S])
    return (jdec.SlotKVCache(jk, jv, jnp.asarray(pos, jnp.int32)),
            tdec.SlotKVCache(tk, tv, torch.from_numpy(pos.astype(np.int64))))


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("length", [5, 8, 1])
def test_prefill_slot_matches_jax(params, cd, length):
    jp, tp = params
    jc, tc = _slot_caches(cd)
    prompt = np.zeros(8, np.int64)
    prompt[:length] = np.arange(3, 3 + length)
    jl, jc = jdec.prefill_slot(jp, jc, jnp.int32(1), _tok(prompt)[0], jnp.int32(length), JCFG, cd)
    tl, tc = tdec.prefill_slot(tp, tc, 1, _tok(prompt)[1], length, TCFG, cd)
    _close(jl, tl, TOL[cd])
    assert tl.shape == (JCFG.vocab,)
    assert np.array_equal(tc.pos.numpy(), np.asarray(jc.pos)) and int(tc.pos[1]) == length
    _close(jc.k[:, 1, :length], tc.k[:, 1, :length], TOL[cd])
    _close(jc.v[:, 1, :length], tc.v[:, 1, :length], TOL[cd])
    _close(jc.k[:, [0, 2]], tc.k[:, [0, 2]], 0)  # other slots untouched


@pytest.mark.parametrize("length", [0, 12])
def test_prefill_slot_index_is_normalised_then_clamped(params, length):
    """``dynamic_index_in_dim`` at ``length - 1``: -1 reads the last padded
    row, past the end reads the last row too."""
    jp, tp = params
    jc, tc = _slot_caches(None)
    prompt = np.arange(1, 9)
    jl, jc = jdec.prefill_slot(jp, jc, jnp.int32(2), _tok(prompt)[0], jnp.int32(length), JCFG)
    tl, tc = tdec.prefill_slot(tp, tc, 2, _tok(prompt)[1], length, TCFG)
    _close(jl, tl, 1e-5)
    assert np.array_equal(tc.pos.numpy(), np.asarray(jc.pos))


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_decode_step_slots_matches_jax(params, cd):
    jp, tp = params
    jc, tc = _slot_caches(cd)
    for step in range(3):
        jt, tt = _tok([11 + step, 4, 90])
        jl, jc = jdec.decode_step_slots(jp, jc, jt, JCFG, cd)
        tl, tc = tdec.decode_step_slots(tp, tc, tt, TCFG, cd)
        _close(jl, tl, TOL[cd])
    assert np.array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    for s, n in enumerate(np.asarray(jc.pos)):
        _close(jc.k[:, s, :n], tc.k[:, s, :n], TOL[cd])
        _close(jc.v[:, s, :n], tc.v[:, s, :n], TOL[cd])


def test_decode_step_slots_drops_writes_past_max_len(params):
    """A free slot's stale position runs past ``max_len``: its write is
    dropped (the reference's scatter) and its position row clamped."""
    jp, tp = params
    jc, tc = _slot_caches(None, seed=17)
    pos = np.array([3, JCFG.max_len, JCFG.max_len + 4])
    jc = jc._replace(pos=jnp.asarray(pos, jnp.int32))
    tc = tc._replace(pos=torch.from_numpy(pos.astype(np.int64)))
    before = tc.k.clone()
    jl, jc = jdec.decode_step_slots(jp, jc, _tok([1, 2, 3])[0], JCFG)
    tl, tc = tdec.decode_step_slots(tp, tc, _tok([1, 2, 3])[1], TCFG)
    _close(jl, tl, 1e-5)
    _close(jc.k, tc.k, 1e-5)
    _close(jc.v, tc.v, 1e-5)
    assert torch.equal(tc.k[:, 1:], before[:, 1:])
    assert np.array_equal(tc.pos.numpy(), np.asarray(jc.pos))


# ── the paged cache ──────────────────────────────────────────────────────

BLOCK = 8
PAGES = JCFG.max_len // BLOCK
NUM_BLOCKS = 20


def _paged(cd, seed=21):
    shape = (JCFG.n_layers, NUM_BLOCKS, BLOCK, JCFG.n_heads, DH)
    jk, tk = _pools(shape, DTYPES[cd], seed)
    jv, tv = _pools(shape, DTYPES[cd], seed + 1)
    pos = np.array([12, 0, 7, 30])
    table = np.zeros((4, PAGES), np.int64)
    table[0, :3] = [5, 2, 9]  # slot 0: 12 rows + room
    table[2, :2] = [3, 11]
    table[3, :5] = [1, 4, 6, 7, 8]
    return (jdec.PagedKVCache(jk, jv, jnp.asarray(pos, jnp.int32)),
            tdec.PagedKVCache(tk, tv, torch.from_numpy(pos)), table)


def _live_rows(cache, table, slot, n):
    """Slot ``slot``'s logical rows [0, n) gathered through its table."""
    k = cache.k
    idx = [int(table[slot, j // BLOCK]) for j in range(n)]
    off = [j % BLOCK for j in range(n)]
    if isinstance(k, torch.Tensor):
        return k[:, idx, off].float().numpy(), cache.v[:, idx, off].float().numpy()
    return (np.asarray(k[:, np.array(idx), np.array(off)], np.float32),
            np.asarray(cache.v[:, np.array(idx), np.array(off)], np.float32))


def _check_rows(jc, tc, table, tol, slots=(0, 2, 3)):
    assert np.array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    for s in slots:
        n = int(tc.pos[s])
        for a, b in zip(_live_rows(jc, table, s, n), _live_rows(tc, table, s, n)):
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("start,length", [(0, 11), (8, 13), (56, 60)])
def test_paged_prefill_chunk_matches_jax(params, cd, start, length):
    """A fresh prompt, a continuation after a one-page shared prefix, and
    a chunk whose padded tail runs past ``max_len`` (positions clamped,
    pad rows routed to trash block 0)."""
    jp, tp = params
    jc, tc, table = _paged(cd)
    table[1, :] = [13, 14, 15, 16, 17, 18, 19, 10]
    chunk = np.zeros(16, np.int64)
    chunk[: length - start] = np.arange(2, 2 + length - start)
    jl, jc = jdec.paged_prefill_chunk(
        jp, jc, jnp.asarray(table, jnp.int32), jnp.int32(1), _tok(chunk)[0],
        jnp.int32(start), jnp.int32(length), JCFG, cd)
    tl, tc = tdec.paged_prefill_chunk(
        tp, tc, torch.from_numpy(table), 1, _tok(chunk)[1], start, length, TCFG, cd)
    _close(jl, tl, TOL[cd])
    _check_rows(jc, tc, table, TOL[cd], slots=(0, 2, 3))
    # the chunk's own rows
    n = length
    for a, b in zip(_live_rows(jc, table, 1, n), _live_rows(tc, table, 1, n)):
        np.testing.assert_allclose(b[:, start:], a[:, start:], rtol=TOL[cd], atol=TOL[cd])


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("active", [None, [True, False, True, True]])
def test_paged_decode_step_matches_jax(params, cd, active):
    jp, tp = params
    jc, tc, table = _paged(cd)
    ja = None if active is None else jnp.asarray(active)
    ta = None if active is None else torch.tensor(active)
    for step in range(3):
        jt, tt = _tok([3 + step, 8, 19, 120])
        jl, jc = jdec.paged_decode_step(jp, jc, jnp.asarray(table, jnp.int32), jt, JCFG, cd,
                                        active=ja)
        tl, tc = tdec.paged_decode_step(tp, tc, torch.from_numpy(table), tt, TCFG, cd,
                                        active=ta)
        live = [0, 2, 3]
        _close(jl[np.array(live)], tl[live], TOL[cd])
    _check_rows(jc, tc, table, TOL[cd])


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("active", [None, [True, True, False, True]])
def test_paged_verify_chunk_matches_jax(params, cd, active):
    """K = 4 tokens per slot in one pass; slot 3 (at 30 of 40 table rows)
    and slot 0 run past their pages near the end — those writes land in
    trash; ``pos`` does not move."""
    jp, tp = params
    jc, tc, table = _paged(cd)
    tokens = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12], [13, 14, 15, 16]])
    ja = None if active is None else jnp.asarray(active)
    ta = None if active is None else torch.tensor(active)
    jl, jc = jdec.paged_verify_chunk(jp, jc, jnp.asarray(table, jnp.int32), _tok(tokens)[0],
                                     JCFG, cd, active=ja)
    tl, tc = tdec.paged_verify_chunk(tp, tc, torch.from_numpy(table), _tok(tokens)[1],
                                     TCFG, cd, active=ta)
    assert tl.shape == (4, 4, JCFG.vocab)
    _close(jl[np.array([0, 2, 3])], tl[[0, 2, 3]], TOL[cd])
    assert np.array_equal(tc.pos.numpy(), [12, 0, 7, 30])
    # rows the pass wrote (pos .. pos + K) read back equal
    for s in (0, 2, 3):
        n = min(int(tc.pos[s]) + 4, int((table[s] > 0).sum()) * BLOCK)
        for a, b in zip(_live_rows(jc, table, s, n), _live_rows(tc, table, s, n)):
            np.testing.assert_allclose(b, a, rtol=TOL[cd], atol=TOL[cd])


# ── generate ─────────────────────────────────────────────────────────────


@pytest.mark.parametrize("shape,n_new", [((3, 6), 10), ((1, 1), 12), ((2, 17), 5)])
def test_greedy_generate_bit_identical_to_jax(params, shape, n_new):
    jp, tp = params
    prompt = np.random.RandomState(sum(shape)).randint(0, JCFG.vocab, shape)
    want = np.asarray(jdec.generate(jp, jnp.asarray(prompt, jnp.int32), n_new, JCFG))
    got = tdec.generate(tp, torch.from_numpy(prompt), n_new, TCFG)
    assert got.dtype == torch.int64 and tuple(got.shape) == (shape[0], n_new)
    assert np.array_equal(got.numpy(), want)


def test_greedy_generate_matches_teacher_forced_apply(params):
    _, tp = params
    prompt = torch.tensor([[3, 9, 27, 81], [5, 25, 125, 1]])
    toks = tdec.generate(tp, prompt, 6, TCFG)
    seq = prompt
    for t in range(6):
        expect = ttf.apply(tp, seq, TCFG)[:, -1].argmax(-1)
        assert torch.equal(toks[:, t], expect)
        seq = torch.cat([seq, expect[:, None]], dim=1)


def test_sampled_generate_equal_to_jax(params):
    jp, tp = params
    prompt = np.array([[3, 5, 2], [7, 7, 1]])
    for seed, temp in ((7, 0.8), (11, 1.3)):
        want = np.asarray(jdec.generate(jp, jnp.asarray(prompt, jnp.int32), 8, JCFG,
                                        temperature=temp, key=jax.random.PRNGKey(seed)))
        got = tdec.generate(tp, torch.from_numpy(prompt), 8, TCFG, temperature=temp,
                            key=prng.PRNGKey(seed, device="cpu"))
        assert np.array_equal(got.numpy(), want)
    # a tensor temperature is the traced one: zero falls back to greedy
    key = prng.PRNGKey(11, device="cpu")
    zero = tdec.generate(tp, torch.from_numpy(prompt), 5, TCFG, temperature=torch.tensor(0.0),
                         key=key)
    assert torch.equal(zero, tdec.generate(tp, torch.from_numpy(prompt), 5, TCFG))
    hot = tdec.generate(tp, torch.from_numpy(prompt), 5, TCFG, temperature=torch.tensor(0.8),
                        key=key)
    assert torch.equal(hot, tdec.generate(tp, torch.from_numpy(prompt), 5, TCFG,
                                          temperature=0.8, key=key))


def test_bf16_generate_close_to_f32(params):
    _, tp = params
    prompt = torch.tensor([[3, 5, 2, 9]])
    lf, _ = tdec.prefill(tp, tdec.init_cache(TCFG, 1, device="cpu"), prompt, TCFG)
    lb, _ = tdec.prefill(tp, tdec.init_cache(TCFG, 1, dtype="bfloat16", device="cpu"), prompt,
                         TCFG, compute_dtype="bfloat16")
    assert float((lf - lb).abs().max() / lf.abs().max()) < 0.05


def test_cast_cache_changes_no_bit(params):
    _, tp = params
    prompt = torch.tensor([[3, 5, 2, 9], [1, 1, 2, 3]])
    cast = tdec.cast_params(tp, "bfloat16")
    assert tdec.cast_params(tp, None) is None
    a = tdec.generate(tp, prompt, 6, TCFG, compute_dtype="bfloat16")
    b = tdec.generate(tp, prompt, 6, TCFG, compute_dtype="bfloat16", cast_cache=cast)
    assert torch.equal(a, b)


@pytest.mark.parametrize("kw,match", [
    (dict(n_new=64), "max_len"),
    (dict(n_new=2, temperature=0.5), "PRNG key"),
    (dict(n_new=2, temperature=-0.1), ">= 0"),
    (dict(n_new=2, temperature="traced"), "traced temperature"),
])
def test_generate_validation_raises_where_jax_raises(params, kw, match):
    jp, tp = params
    prompt = np.ones((1, 3), np.int32)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("temperature") == "traced":
        jkw["temperature"], tkw["temperature"] = jnp.float32(0.5), torch.tensor(0.5)
    with pytest.raises(ValueError, match=match):
        jdec.generate(jp, jnp.asarray(prompt), cfg=JCFG, **jkw)
    with pytest.raises(ValueError, match=match):
        tdec.generate(tp, torch.from_numpy(prompt).long(), cfg=TCFG, **tkw)


def test_truncated_draft_keeps_the_reference_param_list(params):
    jp, tp = params
    for n in (1,):
        jcfg, jd = jdec.truncated_draft(JCFG, jp, n)
        tcfg, td = tdec.truncated_draft(TCFG, tp, n)
        assert tuple(tcfg) == tuple(jcfg) and len(td) == len(jd)
        assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(td, jd))
        assert td[-1] is tp[-1] and td[0] is tp[0]  # shared tensors, no copy
    for bad in (0, 2):
        with pytest.raises(ValueError, match="draft must keep"):
            jdec.truncated_draft(JCFG, jp, bad)
        with pytest.raises(ValueError, match="draft must keep"):
            tdec.truncated_draft(TCFG, tp, bad)


def test_entry_points_default_to_the_card(params):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _, tp = params
    for call in (lambda: tdec.init_cache(TCFG, 1), lambda: tdec.init_slot_cache(TCFG, 2),
                 lambda: tdec.init_paged_cache(TCFG, 2, 4, 8),
                 lambda: tdec.from_bundle(tdec.bundle(TCFG, tp))):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()
    cache = tdec.init_paged_cache(TCFG, 2, 4, 8, device="cpu")
    assert cache.k.device.type == "cpu" and not cache.k.any()  # zeros, never empty
