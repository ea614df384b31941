"""The port's continuous-batching engine (pygrid_tpu_torch.serving).

The contracts of the JAX package's ``test_serving.py`` and
``test_serving_fused.py``, held on the port on the CPU: (1) greedy tokens
from the engine — contiguous and paged, per step and fused, with and
without speculative decode, single, multi-row and concurrent — are
bit-identical to the port's ``generate`` and equal to the JAX package's
``generate`` on the same params; (2) request-shape variety builds no new
program; (3) sampling is reproducible per (seed, row) and equal to the JAX
engine's on the same params in f32; (4) backpressure is typed, an
impossible request is a defect, and a failed device loop recovers; (5) the
``serving_*``, ``serving_spec_*`` and ``profiler_*`` families flow. A
JAX-built bundle, serialized by the JAX package's serde, serves through
the port with the same greedy tokens.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import jax

from pygrid_tpu import serde as jserde
from pygrid_tpu.models import decode as jdec
from pygrid_tpu.models import transformer as jtf
from pygrid_tpu.serving import EngineConfig as JEngineConfig
from pygrid_tpu.serving import GenerationEngine as JGenerationEngine
from pygrid_tpu_torch import convert, serde, telemetry
from pygrid_tpu_torch.datacentric.model_storage import HostedModel
from pygrid_tpu_torch.models import decode
from pygrid_tpu_torch.models import transformer as T
from pygrid_tpu_torch.serving import EngineConfig, GenerationEngine, ServingManager
from pygrid_tpu_torch.serving.pagedkv import (
    fused_enabled,
    resolve_spec_k,
    resolve_spec_layers,
    spec_enabled,
)
from pygrid_tpu_torch.utils import exceptions as E

torch.set_num_threads(1)

CFG = T.TransformerConfig(vocab=31, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_len=32)
#: two layers, so a truncated draft exists
CFG2 = T.TransformerConfig(vocab=31, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_len=32)


def _jparams(cfg, seed):
    return jtf.init(jax.random.PRNGKey(seed), jtf.TransformerConfig(*cfg))


def _port(jp, cfg):
    return convert.params_from_numpy([np.asarray(p) for p in jp], device="cpu", cfg=cfg)


@pytest.fixture(scope="module")
def both():
    jp = _jparams(CFG, 5)
    return jp, _port(jp, CFG)


@pytest.fixture(scope="module")
def params(both):
    return both[1]


@pytest.fixture(scope="module")
def both2():
    jp = _jparams(CFG2, 5)
    return jp, _port(jp, CFG2)


@pytest.fixture(scope="module")
def params2(both2):
    return both2[1]


def _ref(params, prompt, n_new, cfg=CFG, **kw):
    return decode.generate(params, torch.as_tensor(np.asarray(prompt)).long(), n_new, cfg,
                           **kw).numpy()


def _engine(params, model_id="unit", cfg=CFG, **over):
    kw = dict(max_slots=4, slot_buckets=(1, 2, 4), min_prompt_bucket=8)
    kw.update(over)
    return GenerationEngine(cfg, params, EngineConfig(**kw), model_id=model_id, device="cpu")


@pytest.fixture(scope="module")
def engine(params):
    eng = _engine(params)
    yield eng
    eng.close()


def _concurrent(eng, cases):
    results: list = [None] * len(cases)

    def go(i):
        prompt, n = cases[i]
        results[i] = eng.submit(prompt, n)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


MIXED = [(np.array([[2 + i, 5, 1, 7][: 1 + i % 4]]), 1 + (i * 3) % 9) for i in range(10)]


# ── the core contracts ───────────────────────────────────────────────────


def test_greedy_bit_identical_to_generate_and_to_jax(engine, both):
    jp, params = both
    for p, n in zip([[3, 5, 2, 9, 11], [1, 2], [7, 8, 9], [4]], [6, 3, 5, 8]):
        got = engine.submit(np.array([p]), n)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, _ref(params, [p], n))
        want = np.asarray(jdec.generate(jp, np.array([p], np.int32), n, jtf.TransformerConfig(*CFG)))
        np.testing.assert_array_equal(got, want)


def test_multi_row_prompt_reassembles_in_order(engine, params):
    prompt = np.array([[3, 5, 2], [1, 2, 4], [9, 9, 1]])
    np.testing.assert_array_equal(engine.submit(prompt, 4), _ref(params, prompt, 4))


def test_concurrent_mixed_requests_no_cross_slot_leakage(engine, params):
    cases = [(np.array([[2 + i, 5, 1, 7][: 1 + i % 4]]), 2 + (i * 3) % 7) for i in range(10)]
    for (prompt, n), got in zip(cases, _concurrent(engine, cases)):
        np.testing.assert_array_equal(got, _ref(params, prompt, n))


def test_shape_variety_within_buckets_builds_no_program(engine):
    engine.warmup(prompt_lens=(1, 8))
    before = engine.compile_count()
    for i, (p_len, n_new) in enumerate([(1, 2), (3, 9), (5, 4), (8, 1), (2, 7), (6, 3)]):
        got = engine.submit(np.full((1, p_len), 1 + i % 7), n_new,
                            temperature=0.0 if i % 2 == 0 else 0.7, seed=i)
        assert got.shape == (1, n_new)
    assert engine.compile_count() == before
    # every program saw one argument signature: no call site drifted
    assert engine.programs.trace_count() == engine.compile_count()


def test_sampling_reproducible_and_seed_sensitive(engine):
    prompt = np.array([[3, 5, 2]])
    a = engine.submit(prompt, 8, temperature=0.9, seed=123)
    np.testing.assert_array_equal(a, engine.submit(prompt, 8, temperature=0.9, seed=123))
    assert (a >= 0).all() and (a < CFG.vocab).all()
    outs = {tuple(engine.submit(prompt, 8, temperature=0.9, seed=s)[0]) for s in range(6)}
    assert len(outs) > 1


SAMPLED = [
    (np.array([[3, 5, 2]]), 9, 0.9, 123),
    (np.array([[1, 2, 3, 4, 5, 6, 7, 8, 9, 10]]), 6, 1.3, 7),
    (np.array([[3, 5, 2], [3, 5, 2]]), 5, 0.8, 99),  # rows fold their index in
    (np.array([[6]]), 4, 0.0, None),
]


@pytest.mark.parametrize("mode", [
    dict(),  # paged, fused
    dict(fused=False),
    dict(paged=False),
    dict(spec_decode=True, spec_k=3),
], ids=["paged-fused", "per-step", "contiguous", "spec"])
def test_sampled_output_equals_the_jax_engine(both2, mode):
    """The same params, f32 cache, requests, temperatures and seeds through
    the JAX engine and the port's: the same tokens, sampled rows included
    (the keys are threefry's bits, the logits agree to f32 rounding)."""
    jp, params = both2
    kw = dict(max_slots=4, slot_buckets=(1, 2, 4), min_prompt_bucket=8, block_size=8, **mode)
    jeng = JGenerationEngine(jtf.TransformerConfig(*CFG2), jp,
                             JEngineConfig(cache_dtype=jax.numpy.float32, **kw), model_id="j")
    teng = GenerationEngine(CFG2, params, EngineConfig(cache_dtype=torch.float32, **kw),
                            model_id="t", device="cpu")
    try:
        for prompt, n, temp, seed in SAMPLED:
            want = jeng.submit(prompt, n, temperature=temp, seed=seed)
            got = teng.submit(prompt, n, temperature=temp, seed=seed)
            np.testing.assert_array_equal(got, want)
    finally:
        jeng.close()
        teng.close()


def test_queue_backpressure_is_typed_and_recoverable(params):
    eng = _engine(params, "bp", max_slots=1, slot_buckets=(1,), max_queue=2)
    try:
        eng.warmup(prompt_lens=(2,))
        futures = [eng.enqueue(np.array([[1, 2]]), 24) for _ in range(2)]
        with pytest.raises(E.ServerBusyError, match="queue full"):
            for _ in range(8):
                futures.append(eng.enqueue(np.array([[1, 2]]), 24))
        for f in futures:
            assert f.result(timeout=60).shape == (1, 24)
        assert eng.submit(np.array([[1, 2]]), 2).shape == (1, 2)
    finally:
        eng.close()


def test_oversized_batch_is_permanent_defect_not_busy(params):
    eng = _engine(params, max_slots=1, slot_buckets=(1,), max_queue=3)
    try:
        with pytest.raises(E.PyGridError, match="queue capacity") as exc:
            eng.enqueue(np.ones((4, 2), np.int32), 2)
        assert not isinstance(exc.value, E.ServerBusyError)
        with pytest.raises(E.PyGridError, match="exceeds max_len"):
            eng.enqueue(np.ones((1, 30), np.int32), 5)
    finally:
        eng.close()


@pytest.mark.parametrize("paged", [False, True])
def test_bf16_cache_greedy_matches_generate(params, paged):
    eng = _engine(params, "bf16", max_slots=2, slot_buckets=(1, 2), paged=paged, block_size=8,
                  cache_dtype=torch.bfloat16)
    try:
        for prompt, n in ([[3, 5, 2, 9]], 6), ([[1, 2]], 4), ([[6, 4, 2, 8, 1, 3]], 5):
            got = eng.submit(np.array(prompt), n)
            np.testing.assert_array_equal(got, _ref(params, prompt, n, cache_dtype=torch.bfloat16))
    finally:
        eng.close()


def test_bf16_compute_greedy_matches_generate(params):
    """With bf16 compute the engine narrows the weights once (the
    ProgramSet's cast cache) and still equals generate()."""
    eng = _engine(params, "bf16c", max_slots=2, slot_buckets=(1, 2), compute_dtype="bfloat16")
    try:
        assert eng.programs.cast_cache is not None
        for prompt, n in ([[3, 5, 2, 9]], 6), ([[1, 2]], 4):
            got = eng.submit(np.array(prompt), n)
            np.testing.assert_array_equal(got, _ref(params, prompt, n, compute_dtype="bfloat16"))
    finally:
        eng.close()


def test_manager_rebuilds_engine_on_rehost():
    params_a = _port(_jparams(CFG, 1), CFG)
    params_b = _port(_jparams(CFG, 2), CFG)
    mgr = ServingManager(EngineConfig(max_slots=1, slot_buckets=(1,), min_prompt_bucket=8),
                         device="cpu")
    try:
        hosted_a = HostedModel("m", decode.bundle(CFG, params_a))
        hosted_b = HostedModel("m", decode.bundle(CFG, params_b))
        eng_a = mgr.engine_for("m", hosted_a)
        assert mgr.engine_for("m", hosted_a) is eng_a
        assert eng_a.device == torch.device("cpu")
        np.testing.assert_array_equal(eng_a.submit(np.array([[3, 5]]), 4),
                                      _ref(params_a, [[3, 5]], 4))
        eng_b = mgr.engine_for("m", hosted_b)
        assert eng_b is not eng_a
        np.testing.assert_array_equal(eng_b.submit(np.array([[3, 5]]), 4),
                                      _ref(params_b, [[3, 5]], 4))
        mgr.evict("m")
        assert mgr.stats() == []
    finally:
        mgr.close()


@pytest.mark.parametrize("program", ["paged_prefill", "prefill"])
def test_engine_recovers_after_device_loop_failure(params, program):
    eng = _engine(params, "boom", max_slots=1, slot_buckets=(1,), paged=program == "paged_prefill")
    try:
        original = getattr(eng.programs, program)

        def boom(bucket):
            raise RuntimeError("injected device failure")

        setattr(eng.programs, program, boom)
        with pytest.raises(E.PyGridError, match="engine error"):
            eng.submit(np.array([[1, 2]]), 2, timeout=30)
        setattr(eng.programs, program, original)
        np.testing.assert_array_equal(eng.submit(np.array([[1, 2]]), 2, timeout=60),
                                      _ref(params, [[1, 2]], 2))
    finally:
        eng.close()


def test_closed_engine_rejects_typed(params):
    eng = _engine(params, max_slots=1)
    eng.close()
    with pytest.raises(E.PyGridError, match="closed"):
        eng.enqueue(np.array([[1]]), 2)


def test_serving_and_profiler_telemetry_families_flow(engine):
    # twice: the second request hits the programs the first built, whatever
    # ran on this module-scoped engine before (or nothing, under xdist)
    for _ in range(2):
        engine.submit(np.array([[1, 2, 3]]), 3)
    counters = {name for (name, _), _ in telemetry.counters().items()}
    for family in ("serving_requests_total", "serving_tokens_total", "serving_compiles_total"):
        assert family in counters, family
    hists = {name for (name, _), _ in telemetry.histograms().items()}
    for family in ("serving_ttft_seconds", "serving_token_seconds", "serving_prefill_seconds",
                   "serving_queue_wait_seconds", "serving_batch_occupancy",
                   "profiler_compile_seconds", "profiler_execute_seconds"):
        assert family in hists, family
    rows = [r for r in telemetry.profiler.programs_snapshot() if r["model"] == "unit"]
    assert {r["kind"] for r in rows} >= {"paged_prefill", "paged_decode_fused"}
    assert all(r["compiles"] == 1 for r in rows)
    assert any(r["hits"] > 0 for r in rows)


def test_engine_and_manager_default_to_the_card(params):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        GenerationEngine(CFG, params, EngineConfig(max_slots=1))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ServingManager(EngineConfig(max_slots=1))


def test_jax_built_bundle_through_jax_serde_serves_the_same_tokens(both):
    """A bundle the JAX package builds and serializes decodes with the
    port's serde and ``decode.from_bundle``, and the port's engine serves
    the JAX package's greedy tokens."""
    jp, _ = both
    jcfg = jtf.TransformerConfig(*CFG)
    blob = jserde.serialize(jdec.bundle(jcfg, jp))
    spec = serde.deserialize(blob)
    cfg, params = decode.from_bundle(spec, device="cpu")
    assert cfg == CFG
    mgr = ServingManager(EngineConfig(max_slots=2, slot_buckets=(1, 2), min_prompt_bucket=8),
                         device="cpu")
    try:
        eng = mgr.engine_for("jax-built", HostedModel("jax-built", spec))
        for prompt, n in ([[3, 5, 2, 9]], 7), ([[1, 2], [4, 4]], 5):
            want = np.asarray(jdec.generate(jp, np.array(prompt, np.int32), n, jcfg))
            np.testing.assert_array_equal(eng.submit(np.array(prompt), n), want)
        np.testing.assert_array_equal(
            eng.submit(np.array([[3, 5, 2, 9]]), 7),
            decode.generate(params, torch.tensor([[3, 5, 2, 9]]), 7, cfg).numpy())
    finally:
        mgr.close()


# ── fused multi-step decode ──────────────────────────────────────────────


def test_knob_resolution(monkeypatch):
    assert fused_enabled() is True
    monkeypatch.setenv("PYGRID_FUSED_DECODE", "off")
    assert fused_enabled() is False
    assert fused_enabled(True) is True
    assert spec_enabled() is False
    monkeypatch.setenv("PYGRID_SPEC_DECODE", "on")
    assert spec_enabled() is True
    assert resolve_spec_k() == 4
    assert resolve_spec_k(999) == 16
    monkeypatch.setenv("PYGRID_SPEC_K", "2")
    assert resolve_spec_k() == 2
    assert resolve_spec_layers(4) == 2
    assert resolve_spec_layers(4, 9) == 3
    assert resolve_spec_layers(2) == 1


def test_fused_greedy_bit_identical_incl_mid_scan_finish(params2):
    eng = _engine(params2, "fused", cfg=CFG2, block_size=8, fused=True)
    try:
        for p, n in (([[3, 5, 2, 9, 11]], 6), ([[1, 2]], 2), ([[7, 8, 9]], 11), ([[4]], 1),
                     ([[6, 6, 6]], 8)):
            np.testing.assert_array_equal(eng.submit(np.array(p), n), _ref(params2, p, n, CFG2))
        stats = eng.stats()
        assert stats["fused"] is True and stats["fused_scans"] > 0
        assert stats["fused_wasted_steps"] > 0
    finally:
        eng.close()


def test_fused_concurrent_widths_and_finishes_match_generate(params2, both2):
    jp, _ = both2
    eng = _engine(params2, "fused-mix", cfg=CFG2, block_size=8, fused=True)
    try:
        for (prompt, n), got in zip(MIXED, _concurrent(eng, MIXED)):
            np.testing.assert_array_equal(got, _ref(params2, prompt, n, CFG2))
        # and the JAX package's generate on two of them
        for prompt, n in MIXED[3:5]:
            want = np.asarray(jdec.generate(jp, prompt.astype(np.int32), n,
                                            jtf.TransformerConfig(*CFG2)))
            np.testing.assert_array_equal(eng.submit(prompt, n), want)
    finally:
        eng.close()


def test_fused_no_rebuilds_and_sampling_reproducible(params2):
    eng = _engine(params2, "fused-rc", cfg=CFG2, block_size=8, fused=True)
    try:
        eng.warmup(prompt_lens=(1, 8))
        before = eng.compile_count()
        prompt = np.array([[3, 5, 2]])
        a = eng.submit(prompt, 9, temperature=0.9, seed=123)
        np.testing.assert_array_equal(a, eng.submit(prompt, 9, temperature=0.9, seed=123))
        outs = {tuple(eng.submit(prompt, 9, temperature=0.9, seed=s)[0]) for s in range(6)}
        assert len(outs) > 1
        for p_len, n in ((1, 2), (5, 9), (8, 1), (2, 12)):
            eng.submit(np.full((1, p_len), 3), n)
        assert eng.compile_count() == before
        assert eng.programs.trace_count() == eng.compile_count()
    finally:
        eng.close()


def test_fused_program_never_waits_on_the_device(params2, monkeypatch):
    """One fused call of 8 steps reads no device value on the host: every
    way a tensor reaches Python (``item``, ``tolist``, ``bool``, ``int``,
    ``float``, ``cpu``, ``numpy``) raises while it runs."""
    eng = _engine(params2, "fused-sync", cfg=CFG2, block_size=8, fused=True)
    try:
        eng.warmup(prompt_lens=(1,))
        fn = eng.programs.paged_decode_fused(4, 8)

        def refuse(*_a, **_k):
            raise AssertionError("a host sync inside the fused program")

        for name in ("item", "tolist", "__bool__", "__int__", "__float__", "cpu", "numpy"):
            monkeypatch.setattr(torch.Tensor, name, refuse)
        for temps in (np.zeros(4, np.float32), np.array([0.0, 0.7, 0.0, 1.1], np.float32)):
            out, *_ = fn(eng.params, eng._k, eng._v, eng._pos, eng._table(),
                         np.array([1, 2, 3, 4], np.int32), np.array([8, 3, 0, 5], np.int32),
                         temps, np.zeros((8, 4, 2), np.int64))
        monkeypatch.undo()
        assert tuple(out.shape) == (8, 4)
    finally:
        monkeypatch.undo()
        eng.close()


def test_fused_off_env_reverts_to_per_step(params2, monkeypatch):
    monkeypatch.setenv("PYGRID_FUSED_DECODE", "off")
    eng = _engine(params2, "unfused", cfg=CFG2, block_size=8)
    try:
        assert eng.stats()["fused"] is False
        np.testing.assert_array_equal(eng.submit(np.array([[3, 5, 2]]), 6),
                                      _ref(params2, [[3, 5, 2]], 6, CFG2))
    finally:
        eng.close()


# ── self-speculative decoding ────────────────────────────────────────────


def test_spec_greedy_bit_identical_to_generate(params2):
    eng = _engine(params2, "spec", cfg=CFG2, block_size=8, spec_decode=True, spec_k=3)
    try:
        for p, n in (([[3, 5, 2, 9, 11]], 6), ([[1, 2]], 3), ([[7, 8, 9]], 11), ([[4]], 1)):
            np.testing.assert_array_equal(eng.submit(np.array(p), n), _ref(params2, p, n, CFG2))
        stats = eng.stats()
        assert stats["spec"] is True and stats["spec_draft_layers"] == 1
        assert stats["spec_proposed"] > 0
        assert 0 <= stats["spec_accepted"] <= stats["spec_proposed"]
        assert stats["spec_acceptance"] is not None
    finally:
        eng.close()


def test_spec_concurrent_mixed_requests_match_generate(params2):
    eng = _engine(params2, "spec-mix", cfg=CFG2, block_size=8, spec_decode=True, spec_k=4)
    try:
        for (prompt, n), got in zip(MIXED, _concurrent(eng, MIXED)):
            np.testing.assert_array_equal(got, _ref(params2, prompt, n, CFG2))
    finally:
        eng.close()


def test_spec_sampling_reproducible_per_seed_row(params2):
    eng = _engine(params2, "spec-rng", cfg=CFG2, block_size=8, spec_decode=True, spec_k=3)
    try:
        prompt = np.array([[3, 5, 2]])
        a = eng.submit(prompt, 8, temperature=0.9, seed=123)
        np.testing.assert_array_equal(a, eng.submit(prompt, 8, temperature=0.9, seed=123))
        assert (a >= 0).all() and (a < CFG2.vocab).all()
        outs = {tuple(eng.submit(prompt, 8, temperature=0.9, seed=s)[0]) for s in range(6)}
        assert len(outs) > 1
        multi = np.array([[3, 5, 2], [3, 5, 2]])
        m1 = eng.submit(multi, 6, temperature=0.9, seed=7)
        np.testing.assert_array_equal(m1, eng.submit(multi, 6, temperature=0.9, seed=7))
        assert not np.array_equal(m1[0], m1[1])
    finally:
        eng.close()


def test_spec_no_rebuilds_under_shape_variety(params2):
    eng = _engine(params2, "spec-rc", cfg=CFG2, block_size=8, spec_decode=True, spec_k=3)
    try:
        eng.warmup(prompt_lens=(1, 8))
        before = eng.compile_count()
        for i, (p_len, n) in enumerate([(1, 2), (3, 9), (5, 4), (8, 1), (2, 7)]):
            eng.submit(np.full((1, p_len), 1 + i % 7), n,
                       temperature=0.0 if i % 2 == 0 else 0.7, seed=i)
        assert eng.compile_count() == before
        assert eng.programs.trace_count() == eng.compile_count()
    finally:
        eng.close()


def test_spec_prefix_sharing_still_bit_identical(params2):
    eng = _engine(params2, "spec-prefix", cfg=CFG2, block_size=8, spec_decode=True, spec_k=3,
                  max_slots=2, slot_buckets=(1, 2))
    try:
        sys_prompt = np.arange(1, 17, dtype=np.int32)
        cases = [np.concatenate([sys_prompt, np.array([20 + i], np.int32)])[None, :]
                 for i in range(3)]
        for prompt in cases:
            np.testing.assert_array_equal(eng.submit(prompt, 5), _ref(params2, prompt, 5, CFG2))
        assert eng.stats()["prefix_hits"] >= 2
    finally:
        eng.close()


def test_spec_disabled_on_single_layer_model(params):
    eng = _engine(params, "shallow", max_slots=2, slot_buckets=(1, 2), spec_decode=True)
    try:
        assert eng.stats()["spec"] is False
        np.testing.assert_array_equal(eng.submit(np.array([[3, 5]]), 4),
                                      _ref(params, [[3, 5]], 4))
    finally:
        eng.close()


def test_spec_recovers_after_device_loop_failure(params2):
    eng = _engine(params2, "spec-boom", cfg=CFG2, block_size=8, spec_decode=True, spec_k=3)
    try:
        original = eng.programs.spec_verify

        def boom(width, k):
            raise RuntimeError("injected device failure")

        eng.programs.spec_verify = boom
        with pytest.raises(E.PyGridError, match="engine error"):
            eng.submit(np.array([[1, 2]]), 4, timeout=30)
        eng.programs.spec_verify = original
        np.testing.assert_array_equal(eng.submit(np.array([[1, 2]]), 4, timeout=60),
                                      _ref(params2, [[1, 2]], 4, CFG2))
    finally:
        eng.close()


def test_fused_and_spec_telemetry_families_flow(params2):
    for name, over in (("tele-f", dict(fused=True)), ("tele-s", dict(spec_decode=True, spec_k=3))):
        eng = _engine(params2, name, cfg=CFG2, block_size=8, **over)
        try:
            eng.submit(np.array([[1, 2, 3]]), 9)
        finally:
            eng.close()
    counters = {name for (name, _), _ in telemetry.counters().items()}
    for family in ("serving_fused_scans_total", "serving_fused_steps_total",
                   "serving_spec_verifies_total", "serving_spec_proposed_total"):
        assert family in counters, family
