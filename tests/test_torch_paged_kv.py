"""The port's paged KV cache: host bookkeeping and the engine's paged path.

The JAX package's ``test_paged_kv.py`` held on the port on the CPU, plus a
hypothesis property that drives one random sequence of allocations,
releases, prefix inserts, matches, evictions and retirements through both
packages' ``BlockPool`` and ``PrefixCache`` and compares every result and
``ledger()``. Engine cases: greedy output bit-identical to the port's
``generate`` (f32 and a bf16 cache), prefix sharing copy-on-write, busy
on block exhaustion, an impossible request as a typed defect, exact
refcounts after mixed outcomes, no program built under prefix variety, and
live re-partitioning of one device budget.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax

from pygrid_tpu.models import transformer as jtf
from pygrid_tpu.serving import pagedkv as jpagedkv
from pygrid_tpu_torch import convert
from pygrid_tpu_torch.datacentric.model_storage import HostedModel
from pygrid_tpu_torch.models import decode
from pygrid_tpu_torch.models import transformer as T
from pygrid_tpu_torch.serving import (
    BlockPool,
    DeviceBudget,
    EngineConfig,
    GenerationEngine,
    PrefixCache,
    ServingManager,
    pagedkv,
)
from pygrid_tpu_torch.utils import exceptions as E

torch.set_num_threads(1)

CFG = T.TransformerConfig(vocab=31, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_len=32)


@pytest.fixture(scope="module")
def params():
    jp = jtf.init(jax.random.PRNGKey(5), jtf.TransformerConfig(*CFG))
    return convert.params_from_numpy([np.asarray(p) for p in jp], device="cpu", cfg=CFG)


def _ref(params, prompt, n_new, **kw):
    return decode.generate(params, torch.as_tensor(np.asarray(prompt)).long(), n_new, CFG,
                           **kw).numpy()


def _paged_engine(params, **over):
    kw = dict(max_slots=4, slot_buckets=(1, 2, 4), min_prompt_bucket=8, paged=True,
              block_size=8)
    kw.update(over)
    return GenerationEngine(CFG, params, EngineConfig(**kw), model_id="pg", device="cpu")


# ── allocator / prefix-cache units ───────────────────────────────────────


def test_block_pool_refcounts_and_trash_reservation():
    pool = BlockPool(8)
    assert pool.usable == 7
    got = pool.alloc(3)
    assert got is not None and 0 not in got
    assert pool.free_count() == 4
    assert pool.alloc(5) is None
    pool.incref(got[:1])
    pool.release(got)
    assert pool.free_count() == 6
    pool.release(got[:1])
    assert pool.free_count() == 7
    with pytest.raises(RuntimeError):
        pool.release(got[:1])
    with pytest.raises(ValueError, match="at least 2 blocks"):
        BlockPool(1)


def test_prefix_cache_match_insert_evict_lru_leaf_first():
    pool = BlockPool(16)
    cache = PrefixCache(pool, block_tokens=4)
    prompt = np.arange(12, dtype=np.int32)
    assert cache.probe(prompt) == 0
    pages = pool.alloc(3)
    cache.insert(prompt, pages)
    assert cache.block_count() == 2
    assert cache.probe(prompt) == 2
    other = np.concatenate([prompt[:4], np.array([9, 9, 9, 9, 9], np.int32)])
    assert cache.probe(other) == 1
    matched = cache.match(prompt)
    assert matched == pages[:2]
    pool.release(pages)
    assert not cache.evict_one()
    assert cache.probe(prompt) == 2
    pool.release(matched)
    assert cache.evict_one()
    assert cache.probe(prompt) == 1
    assert cache.evict_one()
    assert cache.probe(prompt) == 0
    assert not cache.evict_one()
    assert pool.free_count() == pool.usable


def test_device_budget_weight_partition():
    budget = DeviceBudget(total_bytes=1000, weights={"a": 3.0, "b": 1.0})
    assert budget.blocks_for("a", bytes_per_block=10) == 75
    assert budget.blocks_for("b", bytes_per_block=10) == 25
    budget.release("a")
    assert budget.blocks_for("a", bytes_per_block=10) == 75
    assert DeviceBudget(None).blocks_for("x", 10) is None


def test_block_size_and_knob_resolution(monkeypatch):
    assert pagedkv.resolve_block_size(512) == 64
    assert pagedkv.resolve_block_size(512, 100) == 64
    assert pagedkv.resolve_block_size(32, 64) == 32
    monkeypatch.setenv("PYGRID_KV_BLOCK", "16")
    assert pagedkv.resolve_block_size(512) == 16
    monkeypatch.setenv("PYGRID_KV_BLOCK", "garbage")
    assert pagedkv.resolve_block_size(512) == 64
    assert pagedkv.parse_budget_bytes("256M") == 256 << 20
    assert pagedkv.parse_budget_bytes("1.5K") == 1536
    assert pagedkv.parse_budget_bytes("oops") is None
    assert pagedkv.parse_weights("a=2,b=1,junk,c=x") == {"a": 2.0, "b": 1.0}
    assert pagedkv.paged_enabled() is True
    monkeypatch.setenv("PYGRID_KV_PAGED", "off")
    assert pagedkv.paged_enabled() is False
    assert pagedkv.paged_enabled(True) is True


def test_default_cache_dtype_is_bf16_on_the_card():
    assert pagedkv.default_cache_dtype("cuda") == torch.bfloat16
    assert pagedkv.default_cache_dtype("cuda:1") == torch.bfloat16
    assert pagedkv.default_cache_dtype("cpu") == torch.float32
    assert pagedkv.default_cache_dtype() == torch.bfloat16  # the port's default device


def test_block_bytes_matches_the_jax_package():
    jcfg = jtf.TransformerConfig(*CFG)
    for block, extra in ((8, 0), (16, 1), (64, 3)):
        assert pagedkv.block_bytes(CFG, block, torch.float32, extra) == \
            jpagedkv.block_bytes(jcfg, block, jax.numpy.float32, extra)
        assert pagedkv.block_bytes(CFG, block, torch.bfloat16, extra) == \
            jpagedkv.block_bytes(jcfg, block, jax.numpy.bfloat16, extra)


def test_block_pool_retire_takes_only_free_blocks():
    pool = BlockPool(9)
    held = pool.alloc(3)
    assert pool.retire(100) == 5
    assert pool.usable == 3
    assert pool.free_count() == 0
    with pytest.raises(RuntimeError):
        pool.incref([8])
    pool.release(held)
    assert pool.free_count() == 3


def test_budget_overage_and_record_shrink_ledger():
    budget = DeviceBudget(total_bytes=1000, weights={"a": 1.0, "b": 1.0})
    assert budget.blocks_for("a", 10) == 50
    assert budget.overage("a") == 0
    budget2 = DeviceBudget(total_bytes=1000)
    assert budget2.blocks_for("a", 10) == 100
    assert budget2.overage("a", joining="b") == 500
    budget2.record_shrink("a", 500)
    assert budget2.overage("a", joining="b") == 0
    assert budget2.blocks_for("b", 10) == 50


# ── both packages' host bookkeeping, one random sequence ─────────────────

_PAGE = 4
_OPS = st.lists(
    st.tuples(
        st.sampled_from(["alloc", "release", "incref", "insert", "match", "probe", "evict",
                         "retire", "clear"]),
        st.integers(0, 6),
        st.lists(st.integers(0, 2), min_size=1, max_size=14),
    ),
    min_size=1,
    max_size=40,
)


def _run(mod, ops):
    """Apply ``ops`` to one package's pool and prefix cache; returns every
    result and ledger. Holdings (the test's own block refs) are tracked
    so a release names only held blocks, as the engine does."""
    pool = mod.BlockPool(12)
    cache = mod.PrefixCache(pool, _PAGE)
    held: list[list[int]] = []
    trace = []
    for op, n, toks in ops:
        prompt = np.array(toks, np.int32)
        if op == "alloc":
            got = pool.alloc(n)
            if got:
                held.append(got)
            out = got
        elif op == "release":
            out = held.pop(n % len(held)) if held else None
            if out:
                pool.release(out)
        elif op == "incref":
            out = held[n % len(held)][:1] if held else None
            if out:
                pool.incref(out)
                held.append(list(out))
        elif op == "insert":
            out = cache.insert(prompt, held[n % len(held)]) if held else None
        elif op == "match":
            out = cache.match(prompt)
            if out:
                held.append(out)
        elif op == "probe":
            out = cache.probe(prompt)
        elif op == "evict":
            out = cache.evict_one()
        elif op == "retire":
            out = pool.retire(n)
        else:
            out = cache.clear()
        trace.append((op, out, pool.ledger(), cache.block_count(), cache.idle_block_count(),
                      pool.free_count(), pool.held()))
    for blocks in held:
        pool.release(blocks)
    cache.clear()
    trace.append(pool.ledger())
    return trace


@settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_OPS)
def test_pool_and_prefix_cache_ledgers_match_the_jax_package(ops):
    got, want = _run(pagedkv, ops), _run(jpagedkv, ops)
    assert got == want
    assert got[-1]["balanced"] and got[-1]["free"] == got[-1]["usable"]


# ── engine paged path ────────────────────────────────────────────────────


def test_paged_greedy_bit_identical_and_fragmentation_gauges(params):
    eng = _paged_engine(params)
    try:
        for p, n in ([[3, 5, 2, 9, 11]], 6), ([[1, 2]], 3), ([[7]], 8):
            np.testing.assert_array_equal(eng.submit(np.array(p), n), _ref(params, p, n))
        stats = eng.stats()
        assert stats["paged"] is True and stats["block_size"] == 8
        assert stats["kv_blocks_free"] >= 0
        assert eng._k.shape == (CFG.n_layers, 1 + 4 * 4, 8, CFG.n_heads, 8)
    finally:
        eng.close()


def test_paged_bf16_cache_parity_with_generate(params):
    eng = _paged_engine(params, cache_dtype=torch.bfloat16)
    try:
        for p, n in ([[3, 5, 2, 9]], 6), ([[1, 2]], 4), ([[6, 4, 2, 8, 1, 3]], 5):
            np.testing.assert_array_equal(
                eng.submit(np.array(p), n), _ref(params, p, n, cache_dtype=torch.bfloat16))
    finally:
        eng.close()


def test_prefix_sharing_copy_on_write_correctness(params):
    common = [3, 5, 2, 9, 11, 4, 7, 1]
    eng = _paged_engine(params, max_slots=4)
    try:
        cases = [(common + [6, 2], 5), (common + [1], 4), (common + [8, 8, 3], 6),
                 (common + [6, 2], 5)]
        for p, n in cases:
            np.testing.assert_array_equal(eng.submit(np.array([p]), n), _ref(params, [p], n))
        stats = eng.stats()
        assert stats["prefix_hits"] >= 3, stats
        assert stats["prefix_tokens_saved"] >= 3 * 8, stats
    finally:
        eng.close()


def test_prefix_sharing_concurrent_hits_match_reference(params):
    common = [3, 5, 2, 9, 11, 4, 7, 1]
    eng = _paged_engine(params)
    try:
        np.testing.assert_array_equal(eng.submit(np.array([common + [2]]), 4),
                                      _ref(params, [common + [2]], 4))
        cases = [(common + [10 + i], 3 + i % 4) for i in range(6)]
        results: list = [None] * len(cases)

        def go(i):
            p, n = cases[i]
            results[i] = eng.submit(np.array([p]), n)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(len(cases))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for (p, n), got in zip(cases, results):
            np.testing.assert_array_equal(got, _ref(params, [p], n))
        assert eng.stats()["prefix_hits"] >= len(cases)
    finally:
        eng.close()


def test_busy_fires_on_block_exhaustion_not_slots(params):
    eng = _paged_engine(params, max_slots=4, num_blocks=3, kv_overcommit=1.0, max_queue=64)
    try:
        eng.warmup(prompt_lens=(2,))
        futures = [eng.enqueue(np.array([[1, 2]]), 12)]
        with pytest.raises(E.ServerBusyError, match="KV block pool"):
            for _ in range(8):
                futures.append(eng.enqueue(np.array([[1, 2]]), 12))
        for f in futures:
            assert f.result(timeout=60).shape == (1, 12)
        assert eng.submit(np.array([[1, 2]]), 2).shape == (1, 2)
    finally:
        eng.close()


def test_impossible_request_is_typed_defect_not_busy(params):
    eng = _paged_engine(params, num_blocks=2)
    try:
        with pytest.raises(E.PyGridError, match="KV blocks") as exc:
            eng.enqueue(np.array([[1, 2, 3]]), 20)
        assert not isinstance(exc.value, E.ServerBusyError)
    finally:
        eng.close()


def _wait_idle(eng, secs=30):
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline:
        s = eng.stats()
        if s["live_slots"] == 0 and s["queue_depth"] == 0:
            return
        time.sleep(0.05)


def test_block_refcount_leak_free_after_mixed_outcomes(params):
    eng = _paged_engine(params, max_slots=2, num_blocks=7, kv_overcommit=1.0, max_queue=8)
    try:
        eng.warmup(prompt_lens=(4, 2))
        for p, n in ([[3, 5, 2, 9, 1, 7, 4, 8, 6]], 5), ([[1, 2]], 3):
            np.testing.assert_array_equal(eng.submit(np.array(p), n), _ref(params, p, n))
        accepted = []
        with pytest.raises(E.ServerBusyError):
            for _ in range(32):
                accepted.append(eng.enqueue(np.array([[1, 2, 3]]), 18))
        for f in accepted:
            assert f.result(timeout=60).shape == (1, 18)
        original = eng.programs.paged_prefill

        def boom(bucket):
            raise RuntimeError("injected device failure")

        eng.programs.paged_prefill = boom
        with pytest.raises(E.PyGridError, match="engine error"):
            eng.submit(np.array([[4, 4]]), 2, timeout=30)
        eng.programs.paged_prefill = original
        _wait_idle(eng)
        np.testing.assert_array_equal(eng.submit(np.array([[1, 2]]), 2, timeout=60),
                                      _ref(params, [[1, 2]], 2))
        stats = eng.stats()
        assert stats["live_slots"] == 0 and stats["queue_depth"] == 0
        pool, prefix = eng._pool, eng._prefix
        assert pool.free_count() + prefix.block_count() == pool.usable
        assert stats["kv_demand_pages"] == 0
        led = eng.ledger()
        assert led["balanced"] and led["drained"]
        prefix.clear()
        assert pool.free_count() == pool.usable
    finally:
        eng.close()


def test_paged_no_rebuilds_across_prefix_variety(params):
    eng = _paged_engine(params)
    try:
        eng.warmup(prompt_lens=(1, 8, 10))
        before = eng.compile_count()
        common = [3, 5, 2, 9, 11, 4, 7, 1]
        for i, (p, n) in enumerate([([1, 2], 3), (common + [5], 4), (common + [2, 2], 6),
                                    ([4], 7), (common + [9], 2), ([6, 6, 6], 5)]):
            got = eng.submit(np.array([p]), n, temperature=0.0 if i % 2 == 0 else 0.8, seed=i)
            assert got.shape == (1, n)
        assert eng.compile_count() == before
        assert eng.programs.trace_count() == eng.compile_count()
    finally:
        eng.close()


def test_paged_off_env_falls_back_to_contiguous(params, monkeypatch):
    monkeypatch.setenv("PYGRID_KV_PAGED", "off")
    eng = GenerationEngine(CFG, params, EngineConfig(max_slots=2, slot_buckets=(1, 2),
                                                     min_prompt_bucket=8),
                           model_id="legacy", device="cpu")
    try:
        assert eng.stats()["paged"] is False
        assert eng.ledger() == {"model_id": "legacy", "paged": False, "queue_depth": 0,
                                "live_slots": 0, "balanced": True}
        np.testing.assert_array_equal(eng.submit(np.array([[3, 5, 2]]), 4),
                                      _ref(params, [[3, 5, 2]], 4))
    finally:
        eng.close()


def test_chaos_holds_are_counted_by_the_ledger(params):
    eng = _paged_engine(params, num_blocks=6)
    try:
        assert eng.chaos_hold_blocks(2) == 2
        led = eng.ledger()
        assert led["chaos_held"] == 2 and not led["drained"]
        assert eng.chaos_release_blocks() == 2
        assert eng.ledger()["drained"]
    finally:
        eng.close()


# ── live DeviceBudget re-partitioning ────────────────────────────────────


def test_engine_shrink_reclaims_free_then_cached_never_live(params):
    eng = _paged_engine(params, num_blocks=17)
    try:
        eng.submit(np.arange(1, 18, dtype=np.int32)[None, :], 2)
        stats = eng.stats()
        assert stats["kv_blocks_cached"] == 2
        free_before = stats["kv_blocks_free"]
        assert eng.shrink_blocks(free_before + 1) == free_before + 1
        stats = eng.stats()
        assert stats["kv_blocks_total"] == 1
        assert stats["kv_blocks_cached"] == 1
        assert stats["kv_blocks_retired"] == free_before + 1
        np.testing.assert_array_equal(eng.submit(np.array([[3, 5, 2]]), 4),
                                      _ref(params, [[3, 5, 2]], 4))
    finally:
        eng.close()


def test_engine_shrink_cannot_touch_live_requests(params):
    eng = _paged_engine(params, num_blocks=5)
    try:
        fut = eng.enqueue(np.array([[1, 2, 3, 4, 5, 6, 7]]), 9)
        deadline = time.monotonic() + 10
        while eng.stats()["kv_blocks_free"] == 4:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        assert eng.shrink_blocks(100) <= 2
        assert fut.result(timeout=60).shape == (1, 9)
    finally:
        eng.close()


def test_manager_repartitions_live_engines_on_late_registration(params):
    per_block = pagedkv.block_bytes(CFG, 16, torch.float32)
    mgr = ServingManager(
        EngineConfig(max_slots=2, slot_buckets=(1, 2), min_prompt_bucket=8, paged=True,
                     block_size=16, cache_dtype=torch.float32),
        budget=DeviceBudget(total_bytes=16 * per_block), device="cpu")
    try:
        eng_a = mgr.engine_for("model-a", HostedModel("model-a", decode.bundle(CFG, params)))
        assert eng_a.stats()["kv_blocks_total"] == 15
        eng_b = mgr.engine_for("model-b", HostedModel("model-b", decode.bundle(CFG, params)))
        assert eng_a.stats()["kv_blocks_total"] == 7
        assert eng_b.stats()["kv_blocks_total"] == 7
        for eng in (eng_a, eng_b):
            np.testing.assert_array_equal(eng.submit(np.array([[3, 5, 2]]), 4),
                                          _ref(params, [[3, 5, 2]], 4))
        assert mgr.ledger()["balanced"]
    finally:
        mgr.close()


def test_shrink_realized_in_bytes_at_failure_recovery(params):
    eng = _paged_engine(params, num_blocks=17)
    try:
        assert eng.shrink_blocks(6) == 6
        assert eng.stats()["kv_blocks_total"] == 10
        original = eng.programs.paged_prefill

        def boom(bucket):
            raise RuntimeError("injected device failure")

        eng.programs.paged_prefill = boom
        with pytest.raises(E.PyGridError, match="engine error"):
            eng.submit(np.array([[1, 2]]), 2, timeout=30)
        eng.programs.paged_prefill = original
        stats = eng.stats()
        assert stats["kv_blocks_total"] == 10
        assert stats["kv_blocks_retired"] == 0
        assert eng._k.shape[1] == 11
        assert not eng._k.any()  # fresh pools are zeros
        np.testing.assert_array_equal(eng.submit(np.array([[3, 5, 2]]), 4),
                                      _ref(params, [[3, 5, 2]], 4))
    finally:
        eng.close()
