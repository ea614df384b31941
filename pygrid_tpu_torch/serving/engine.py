"""Paged continuous-batching generation engine.

The port's counterpart of :mod:`pygrid_tpu.serving.engine`, the same host
logic around the port's programs. One :class:`GenerationEngine` serves one
hosted transformer bundle on one device. It
owns a persistent KV cache and a dedicated worker thread that runs the
device loop — the Orca-style continuous-batching core (Yu et al., OSDI
'22), with **paged block-table storage by default** (PagedAttention,
Kwon et al. SOSP '23; prefix sharing after RadixAttention):

- the cache is a pool of fixed-size KV blocks
  (:class:`~pygrid_tpu_torch.models.decode.PagedKVCache`); a request holds
  only the pages covering its own prompt + ``n_new`` tokens instead of
  a contiguous ``[max_len]`` slab, so short requests stop stranding
  cache memory and the block pool — not the slot count — is what
  admission exhausts;
- identical prompt prefixes (hash-keyed full blocks, e.g. a common
  system prompt) prefill ONCE and are mapped read-only into later
  requests' block tables copy-on-write
  (:class:`~pygrid_tpu_torch.serving.pagedkv.PrefixCache`); refcounted blocks
  free when the last reader completes;
- requests wait in a bounded FIFO queue (admission past the depth limit
  — or block demand past the overcommit bound — answers a typed
  :class:`~pygrid_tpu_torch.utils.exceptions.ServerBusyError`);
- a free slot admits the oldest request via a per-slot dense chunk
  prefill (prompt suffix after the shared prefix, padded to a bucket,
  true length traced) that writes only that request's pages — live
  slots keep decoding undisturbed; when the pool is exhausted the row
  parks at the queue head until completions free blocks;
- every step advances ALL live slots with one block-table decode
  program at the narrowest width bucket covering them, each slot at its
  own position — finished requests leave between steps while the rest
  keep decoding, so short requests never wait for long ones;
- at most ``quantum`` decode steps run between admission checks (the
  fairness cap: a queued request's time-to-first-token is bounded by
  one quantum even when the batch is full of long generations);
- when no admission is pending, the whole quantum runs as ONE program
  call (**fused multi-step decode**, default on,
  ``PYGRID_FUSED_DECODE=off``): per-row token budgets freeze rows that
  finish mid-scan (their writes trash-route, their positions park), so
  the host pays one call + one token fetch per quantum instead of
  per step;
- with ``PYGRID_SPEC_DECODE=on``, a **self-speculative** truncated-layer
  draft of the same checkpoint proposes ``spec_k`` tokens per cycle and
  the full model verifies them all in one wide block-table step (the
  draft's proposal steps and the verify run as one program). Greedy
  output stays bit-identical by construction (the target's argmax
  arbitrates every emitted token); sampling uses the standard
  speculative rejection estimator, keyed per (seed, row, position). The
  draft's k/v pool shares the block tables and ids — allocation, prefix
  sharing, and COW cover both caches with zero extra bookkeeping — and
  per-model acceptance-rate telemetry (``serving_spec_*``) tells
  operators when drafting loses.

``PYGRID_KV_PAGED=off`` (or ``EngineConfig(paged=False)``) falls back
to the contiguous slot cache — the operational escape hatch and the
baseline for capacity-per-GB comparisons.

Greedy results are bit-identical to single-request
:func:`pygrid_tpu_torch.models.decode.generate` on the CPU (tested); sampling is
reproducible per (seed, row) and distribution-identical to the
single-request path. The worker thread is the ONLY thread that touches
the device loop — caller threads just enqueue and wait on a future. Every
tensor names the engine's device explicitly (a ``cuda`` without an index
is pinned to the current card when the engine is built), so the worker
never depends on which device another thread made current.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from pygrid_tpu_torch import telemetry
from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.models import decode
from pygrid_tpu_torch.serving import pagedkv
from pygrid_tpu_torch.serving.programs import (
    ProgramSet,
    prompt_buckets,
    width_buckets,
)
from pygrid_tpu_torch.utils import exceptions as E
from pygrid_tpu_torch.utils import prng

logger = logging.getLogger(__name__)

#: occupancy histogram bucket bounds: one bucket per live-slot count
#: (the seconds ladder the bus defaults to is wrong for small integers)
_OCCUPANCY_BOUNDS = [float(i) for i in range(1, 17)]

#: blocks-per-request histogram bounds: a pages ladder, not seconds
_BLOCKS_BOUNDS = [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0]


@dataclass(frozen=True)
class EngineConfig:
    """Engine shape knobs. ``slot_buckets`` are decode widths to build
    (always topped up with ``max_slots``); prompt buckets derive from
    the model's ``max_len`` (see :func:`programs.prompt_buckets`).

    Paged-KV knobs: ``paged`` defaults to on
    (``PYGRID_KV_PAGED=off`` opts out); ``block_size`` is the KV page
    in tokens (``PYGRID_KV_BLOCK``, default 64, power-of-two-bucketed);
    ``num_blocks`` overrides the pool size directly, else
    ``kv_budget_bytes`` sizes it, else the pool defaults to byte parity
    with the contiguous cache (``max_slots`` × pages-per-slot + trash);
    ``kv_overcommit`` bounds how far QUEUED worst-case block demand may
    run past the pool before enqueue answers busy — block exhaustion,
    not slot exhaustion, is the admission limit. Per-model admission
    weights for the node-wide device budget live on the
    :class:`~pygrid_tpu_torch.serving.pagedkv.DeviceBudget`
    (``PYGRID_KV_WEIGHTS``), not here — one EngineConfig is shared by
    every hosted model, so a per-model weight cannot ride on it."""

    max_slots: int = 8
    slot_buckets: tuple[int, ...] = (1, 4, 8)
    min_prompt_bucket: int = 16
    max_queue: int = 64
    quantum: int = 8
    default_timeout_s: float = 300.0
    compute_dtype: Any = None
    cache_dtype: Any = None
    paged: bool | None = None
    block_size: int | None = None
    num_blocks: int | None = None
    kv_budget_bytes: int | None = None
    kv_overcommit: float = 4.0
    #: fused multi-step decode: run ``quantum`` paged decode steps in
    #: ONE program call when no admission is pending (default on;
    #: ``PYGRID_FUSED_DECODE=off``)
    fused: bool | None = None
    #: self-speculative decoding: a truncated-layer draft of the SAME
    #: checkpoint proposes ``spec_k`` tokens, the full model verifies
    #: them in one wide block-table step (OPT-IN: ``PYGRID_SPEC_DECODE``;
    #: per-model acceptance-rate telemetry says whether it wins)
    spec_decode: bool | None = None
    spec_k: int | None = None
    spec_layers: int | None = None


class _Row:
    """One sequence occupying (or waiting for) one slot — one row of a
    client's [B, P] prompt."""

    __slots__ = (
        "pending", "row", "batch", "prompt", "n_new", "temperature",
        "seed", "keys", "out", "last_token", "enqueued_at", "admitted_at",
        "pages", "shared_pages", "start", "demand",
    )

    def __init__(self, pending, row, batch, prompt, n_new, temperature, seed):
        self.pending = pending
        self.row = row
        self.batch = batch
        self.prompt = prompt  # np int32 [P]
        self.n_new = n_new
        self.temperature = temperature
        self.seed = seed  # resolved (never None when sampling)
        #: np int64 [n_new, 2] key words when sampling — derived lazily
        #: on the ENGINE thread at admission
        self.keys = None
        self.out: list[int] = []
        self.last_token = 0
        self.enqueued_at = time.perf_counter()
        self.admitted_at: float | None = None
        #: paged-KV bookkeeping — the row's block-table pages in page
        #: order (shared prefix first), how many of them are shared,
        #: the block-aligned prefix length, and the worst-case page
        #: demand charged against the pool at enqueue
        self.pages: list[int] | None = None
        self.shared_pages = 0
        self.start = 0
        self.demand = 0


class _Pending:
    """One client request: B rows + the future their reassembled
    [B, n_new] tokens resolve. ``request_id`` names the request in
    engine snapshots and flight-recorder crash dumps."""

    def __init__(self, batch: int, n_new: int) -> None:
        import uuid

        self.request_id = uuid.uuid4().hex[:16]
        self.future: Future = Future()
        self.tokens = np.zeros((batch, n_new), np.int32)
        self.remaining = batch

    def finish_row(self, row: int, toks: list[int]) -> None:
        self.tokens[row] = toks
        self.remaining -= 1
        if self.remaining == 0 and not self.future.done():
            # done() covers both a waiter's cancel AND a racing
            # _fail_all that already set an exception
            self.future.set_result(self.tokens)


class GenerationEngine:
    """Continuous-batching server for one (config, params) bundle."""

    def __init__(
        self,
        cfg,
        params,
        config: EngineConfig | None = None,
        model_id: str = "",
        device: str | torch.device = "cuda",
    ) -> None:
        dev = resolve(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        #: the engine's ONE device: the worker thread names it on every
        #: tensor it makes
        self.device = dev
        self.cfg = cfg
        self.model_id = model_id
        self.config = config or EngineConfig()
        self.params = [
            p.to(dev) if isinstance(p, torch.Tensor)
            else torch.from_numpy(np.array(p, copy=True)).to(dev)
            for p in params
        ]
        self._paged = pagedkv.paged_enabled(self.config.paged)
        #: fused multi-step decode and self-speculative decoding both
        #: need the block-table discipline (trash-routed frozen writes),
        #: so they ride the paged path only; spec additionally needs a
        #: stack deep enough to truncate
        self._fused = self._paged and pagedkv.fused_enabled(
            self.config.fused
        )
        self._spec = (
            self._paged
            and cfg.n_layers >= 2
            and pagedkv.spec_enabled(self.config.spec_decode)
        )
        self._spec_k = pagedkv.resolve_spec_k(self.config.spec_k)
        draft_cfg = None
        self._draft_params = None
        if self._spec:
            n_draft = pagedkv.resolve_spec_layers(
                cfg.n_layers, self.config.spec_layers
            )
            draft_cfg, self._draft_params = decode.truncated_draft(
                cfg, self.params, n_draft
            )
        self._draft_cfg = draft_cfg
        self.programs = ProgramSet(
            cfg,
            compute_dtype=self.config.compute_dtype,
            cache_dtype=self.config.cache_dtype,
            model_id=model_id,
            draft_cfg=draft_cfg,
            params=self.params,
            device=dev,
        )
        self._prompt_buckets = prompt_buckets(
            cfg.max_len, self.config.min_prompt_bucket
        )
        self._widths = width_buckets(
            self.config.max_slots, self.config.slot_buckets
        )
        self._kv_dtype = (
            self.config.cache_dtype
            if self.config.cache_dtype is not None
            else (
                self.config.compute_dtype
                if self.config.compute_dtype is not None
                # bf16 on the card (decode is bandwidth-bound on the
                # cache sweep), f32 on the CPU
                else pagedkv.default_cache_dtype(dev)
            )
        )
        if self._paged:
            self._block = pagedkv.resolve_block_size(
                cfg.max_len, self.config.block_size
            )
            self._max_pages = -(-cfg.max_len // self._block)
            if self.config.num_blocks is not None:
                num_blocks = int(self.config.num_blocks)
            elif self.config.kv_budget_bytes is not None:
                per_block = pagedkv.block_bytes(
                    cfg, self._block, self._kv_dtype,
                    # the draft pool shares block ids: a block's true
                    # byte cost under spec decode includes its layers
                    extra_layers=(
                        self._draft_cfg.n_layers if self._spec else 0
                    ),
                )
                # the trash block counts INSIDE the byte budget (same
                # accounting as DeviceBudget.blocks_for): an operator
                # sizing to available HBM must never be overshot
                num_blocks = int(self.config.kv_budget_bytes) // per_block
            else:
                # byte parity with the contiguous slot cache — same
                # footprint, but short requests free what they don't use
                num_blocks = 1 + self.config.max_slots * self._max_pages
            self._num_blocks = max(2, num_blocks)
            self._pool = pagedkv.BlockPool(self._num_blocks)
            self._prefix = pagedkv.PrefixCache(self._pool, self._block)
            #: blocks given back to the device budget by live
            #: re-partitioning (shrink_blocks) — survives _fail_all's
            #: pool rebuild
            self._shrunk_blocks = 0
            #: host mirror of the device block table; rebuilt lazily
            #: (``_table``) after any admission/free edit
            self._table_np = np.zeros(
                (self.config.max_slots, self._max_pages), np.int64
            )
            self._table_dev = None
            self._table_dirty = True
            self._demand_pages = 0
            self._prefix_hits = 0
            self._prefix_misses = 0
            self._prefix_tokens_saved = 0
            cache = decode.init_paged_cache(
                cfg, self.config.max_slots, self._num_blocks,
                self._block, dtype=self._kv_dtype, device=dev,
            )
        else:
            cache = decode.init_slot_cache(
                cfg, self.config.max_slots, dtype=self._kv_dtype, device=dev
            )
        # held as separate refs: the programs update them in place and
        # return them, and the engine rebinds what they return
        self._k, self._v, self._pos = cache.k, cache.v, cache.pos
        #: the draft's k/v pool: same block ids/tables as the target
        #: (allocation covers both), fewer layers; position state is
        #: shared — the draft is always exactly at the target's pos
        self._dk = self._dv = None
        if self._spec:
            dcache = decode.init_paged_cache(
                self._draft_cfg, self.config.max_slots,
                self._num_blocks, self._block, dtype=self._kv_dtype,
                device=dev,
            )
            self._dk, self._dv = dcache.k, dcache.v
        self._fused_scans = 0
        self._fused_steps = 0
        self._fused_wasted = 0
        self._spec_verifies = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._slots: list[_Row | None] = [None] * self.config.max_slots
        self._queue: deque[_Row] = deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._running = True
        self._live = 0
        self._thread: threading.Thread | None = None
        self._requests = 0
        self._tokens_out = 0
        #: blocks withheld from the pool by fault injection
        #: (chaos_hold_blocks) — never visible to admission, always
        #: accounted for by ledger() so a forgotten hold reads as a leak
        self._chaos_blocks: list[int] = []

    # ── client surface (any thread) ─────────────────────────────────────

    def enqueue(
        self,
        prompt: np.ndarray,
        n_new: int,
        temperature: float = 0.0,
        seed: int | None = None,
    ) -> Future:
        """Queue a [B, P] int prompt for generation; resolves to int32
        tokens [B, n_new]. Raises :class:`ServerBusyError` when the
        queue is at depth — callers translate it to the typed wire
        error. Validation (shape, vocab range, cache caps, temperature/
        seed domains) is the caller's job: this is the hot path."""
        prompt = np.asarray(prompt, np.int32)
        batch, p_len = prompt.shape
        if p_len + n_new > self.cfg.max_len:
            raise E.PyGridError(
                f"prompt ({p_len}) + n_new ({n_new}) exceeds max_len "
                f"({self.cfg.max_len})"
            )
        if batch > self.config.max_queue:
            # a batch that can never fit is a client defect, not
            # backpressure — ServerBusyError would invite infinite
            # retries against a permanent condition
            raise E.PyGridError(
                f"prompt batch of {batch} rows exceeds the engine queue "
                f"capacity ({self.config.max_queue})"
            )
        if float(temperature) > 0.0 and seed is None:
            # unseeded sampling must still vary across requests (plain
            # urandom here: key derivation happens on the engine thread)
            import os

            seed = int.from_bytes(os.urandom(4), "big")
        pending = _Pending(batch, n_new)
        rows = [
            _Row(
                pending, b, batch, prompt[b], n_new, float(temperature),
                seed,
            )
            for b in range(batch)
        ]
        if self._paged:
            # worst-case page demand per row, credited with the pages
            # the prefix cache ALREADY holds for this prompt (a probe —
            # admission re-matches for real; an eviction in between
            # just parks the row until blocks free)
            pages_per_row = -(-(p_len + n_new) // self._block)
            if pages_per_row > self._pool.usable:
                raise E.PyGridError(
                    f"request needs {pages_per_row} KV blocks of "
                    f"{self._block} tokens but the pool holds "
                    f"{self._pool.usable} — prompt + n_new can never "
                    "be cached"
                )
            for row in rows:
                row.demand = max(
                    1, pages_per_row - self._prefix.probe(row.prompt)
                )
        demand = sum(r.demand for r in rows)
        with self._work:
            if not self._running:
                raise E.PyGridError("generation engine is closed")
            if len(self._queue) + batch > self.config.max_queue:
                telemetry.incr(
                    "serving_requests_total", outcome="busy",
                    model=self.model_id,
                )
                raise E.ServerBusyError(
                    f"generation queue full ({len(self._queue)} rows "
                    f"queued, depth limit {self.config.max_queue}) — "
                    "retry later"
                )
            if self._paged and self._demand_pages + demand > (
                self.config.kv_overcommit * self._pool.usable
            ):
                telemetry.incr(
                    "serving_requests_total", outcome="busy",
                    model=self.model_id,
                )
                raise E.ServerBusyError(
                    f"KV block pool exhausted ({self._demand_pages} "
                    f"pages of demand outstanding against "
                    f"{self._pool.usable} blocks, overcommit "
                    f"{self.config.kv_overcommit:g}) — retry later"
                )
            if self._paged:
                self._demand_pages += demand
            self._queue.extend(rows)
            self._requests += 1
            self._ensure_thread()
            self._work.notify()
        return pending.future

    def submit(
        self,
        prompt: np.ndarray,
        n_new: int,
        temperature: float = 0.0,
        seed: int | None = None,
        timeout: float | None = None,
    ) -> np.ndarray:
        """Blocking :meth:`enqueue` — the WS handler's enqueue-and-await
        wrapper (handler threads wait here; the device loop stays on the
        engine thread)."""
        future = self.enqueue(prompt, n_new, temperature, seed)
        try:
            return future.result(
                timeout if timeout is not None
                else self.config.default_timeout_s
            )
        except FutureTimeoutError:
            telemetry.incr(
                "serving_requests_total", outcome="timeout",
                model=self.model_id,
            )
            raise E.PyGridError(
                "generation timed out awaiting the batch engine"
            ) from None

    def stats(self) -> dict:
        """Live gauges for /metrics, /telemetry/serving, the dashboard,
        and the flight recorder: aggregate depth/occupancy plus per-slot
        row positions (request id, tokens emitted of n_new) so a crash
        dump names exactly which requests were where."""
        with self._lock:
            slots = [
                {
                    "slot": i,
                    "request_id": r.pending.request_id,
                    "row": r.row,
                    "position": len(r.out),
                    "n_new": r.n_new,
                    "prompt_len": len(r.prompt),
                }
                for i, r in enumerate(self._slots)
                if r is not None
            ]
            # dedup preserving order: a batch's rows share one request
            queued = list(
                dict.fromkeys(r.pending.request_id for r in self._queue)
            )
            out = {
                "model_id": self.model_id,
                "queue_depth": len(self._queue),
                "live_slots": self._live,
                "max_slots": self.config.max_slots,
                "requests_total": self._requests,
                "tokens_total": self._tokens_out,
                "compiles_total": self.programs.compile_count(),
                "slots": slots,
                "queued_requests": queued,
                "paged": self._paged,
                "fused": self._fused,
                "spec": self._spec,
            }
            if self._fused:
                out.update(
                    {
                        "fused_scans": self._fused_scans,
                        "fused_steps": self._fused_steps,
                        "fused_wasted_steps": self._fused_wasted,
                    }
                )
            if self._spec:
                out.update(
                    {
                        "spec_k": self._spec_k,
                        "spec_draft_layers": self._draft_cfg.n_layers,
                        "spec_verifies": self._spec_verifies,
                        "spec_proposed": self._spec_proposed,
                        "spec_accepted": self._spec_accepted,
                        # the honest per-model verdict: below ~1/k the
                        # draft is pure overhead and the operator
                        # should turn spec decode off for this model
                        "spec_acceptance": round(
                            self._spec_accepted / self._spec_proposed, 4
                        )
                        if self._spec_proposed
                        else None,
                    }
                )
            if self._paged:
                live_rows = [r for r in self._slots if r is not None]
                alloc_pages = sum(
                    len(r.pages) for r in live_rows if r.pages is not None
                )
                used_tokens = sum(
                    len(r.prompt) + len(r.out) for r in live_rows
                )
                out.update(
                    {
                        "block_size": self._block,
                        "kv_blocks_total": self._pool.usable,
                        "kv_blocks_retired": self._pool.retired_count(),
                        "kv_blocks_free": self._pool.free_count(),
                        "kv_blocks_cached": self._prefix.block_count(),
                        # cache-ONLY (reclaimable) blocks; a cached
                        # block shared with a live request counts as
                        # used in the occupancy gauges, not cached
                        "kv_blocks_idle_cached": (
                            self._prefix.idle_block_count()
                        ),
                        "kv_demand_pages": self._demand_pages,
                        # internal fragmentation of the LIVE allocation:
                        # allocated-but-unwritten token slots (page-tail
                        # waste) over allocated token slots
                        "kv_fragmentation": round(
                            1.0 - used_tokens / (alloc_pages * self._block),
                            4,
                        )
                        if alloc_pages
                        else 0.0,
                        "prefix_hits": self._prefix_hits,
                        "prefix_misses": self._prefix_misses,
                        "prefix_tokens_saved": self._prefix_tokens_saved,
                    }
                )
            return out

    def ledger(self) -> dict:
        """Leak-ledger snapshot: where every usable KV block is right
        now, plus the drain invariant. After traffic drains (no queue,
        no live slots, no chaos holds) every block must be either free
        or parked in the prefix cache — ``free + cached == usable`` —
        or some failure path leaked a reference. This is the dynamic
        twin of the reference's GL603 static discipline; a load harness
        asserts ``balanced`` after every scenario."""
        with self._lock:
            queue_depth = len(self._queue)
            live = self._live
            if not self._paged:
                return {
                    "model_id": self.model_id,
                    "paged": False,
                    "queue_depth": queue_depth,
                    "live_slots": live,
                    "balanced": queue_depth == 0 and live == 0,
                }
            pool = self._pool.ledger()
            cached = self._prefix.block_count()
            chaos = len(self._chaos_blocks)
            drained = (
                queue_depth == 0
                and live == 0
                and chaos == 0
                and self._demand_pages == 0
            )
            return {
                "model_id": self.model_id,
                "paged": True,
                "queue_depth": queue_depth,
                "live_slots": live,
                "demand_pages": self._demand_pages,
                "usable": pool["usable"],
                "free": pool["free"],
                "held": pool["held"],
                "cached": cached,
                "retired": pool["retired"],
                "chaos_held": chaos,
                "drained": drained,
                # not-drained engines are balanced as long as the pool's
                # own accounting closes; once drained the stronger
                # cache-only invariant must hold too
                "balanced": pool["balanced"]
                and (not drained or pool["free"] + cached == pool["usable"]),
            }

    # ── fault plane (fault injection) ──────────────────────────────────

    def chaos_hold_blocks(self, n: int | None = None) -> int:
        """FAULT INJECTION: withdraw up to ``n`` free blocks (all of
        them when None) from the pool, starving admission the way a
        burst of long-context requests would. Returns how many are now
        held. Release with :meth:`chaos_release_blocks`; ledger() counts
        the holds so they can never masquerade as a clean drain."""
        if not self._paged:
            return 0
        grabbed: list[int] = []
        while n is None or len(grabbed) < n:
            got = self._pool.alloc(1)
            if got is None:
                break
            grabbed.extend(got)
        with self._lock:
            self._chaos_blocks.extend(grabbed)
            return len(self._chaos_blocks)

    def chaos_release_blocks(self) -> int:
        """Undo :meth:`chaos_hold_blocks`; returns how many blocks went
        back to the pool."""
        with self._lock:
            held, self._chaos_blocks = self._chaos_blocks, []
        if held:
            self._pool.release(held)
            with self._work:
                self._work.notify_all()
        return len(held)

    def compile_count(self) -> int:
        return self.programs.compile_count()

    def block_cost_bytes(self) -> int:
        """Device bytes one of this engine's KV blocks really costs —
        target layers plus the speculative draft's layers when spec
        decode is on (the draft shares block ids, so a block carries
        rows in BOTH pools). 0 on the contiguous path."""
        if not self._paged:
            return 0
        extra = self._draft_cfg.n_layers if self._spec else 0
        return pagedkv.block_bytes(
            self.cfg, self._block, self._kv_dtype, extra_layers=extra
        )

    def shrink_blocks(self, n: int) -> int:
        """Give up to ``n`` KV blocks back to the node's device budget
        — live re-partitioning when another model registers against the
        same ``PYGRID_KV_BUDGET``. Only RECLAIMABLE blocks move: free
        blocks first, then idle-cached prefix entries are evicted to
        free more; a block held by a live request (or a prefix chain a
        live request still reads) is untouchable, so in-flight
        generations never fail. Returns the count actually retired.
        The device arrays stay allocated until the next cache
        reallocation (re-host or failure recovery) — the give-back is
        ADMISSION capacity first, bytes at the next rebuild."""
        if not self._paged or n <= 0:
            return 0
        retired = self._pool.retire(n)
        while retired < n and self._prefix.evict_one():
            retired += self._pool.retire(n - retired)
        with self._lock:
            self._shrunk_blocks += retired
        return retired

    def warmup(self, prompt_lens: tuple[int, ...] = ()) -> None:
        """Build AND run the decode width buckets (and the prompt
        buckets the given lengths land in) ahead of traffic, so the
        first real request pays admission latency, not program builds
        and first launches. Must run before serving traffic (it drives
        the device directly; with live slots it backs off to lazy builds
        instead of racing the engine thread for the cache). The garbage
        rows it writes land in free slots below their reset-at-admission
        positions — invisible to every later request."""
        with self._lock:
            if self._live > 0 or self._queue:
                return
        zero_key = np.zeros((2,), np.int64)
        seen = set()
        for p_len in prompt_lens or (1,):
            bucket = self._prompt_bucket(p_len)
            if bucket in seen:
                continue
            seen.add(bucket)
            if self._spec:
                # all-zero table: every warmup write lands in the
                # trash block, so no future request can observe it
                fn = self.programs.spec_prefill(bucket)
                _tok, self._k, self._v, self._pos, self._dk, self._dv = fn(
                    self.params, self._draft_params,
                    self._k, self._v, self._pos, self._dk, self._dv,
                    self._table(), 0, np.zeros((bucket,), np.int32), 0, 1,
                    0.0, zero_key,
                )
            elif self._paged:
                fn = self.programs.paged_prefill(bucket)
                _tok, self._k, self._v, self._pos = fn(
                    self.params, self._k, self._v, self._pos,
                    self._table(), 0, np.zeros((bucket,), np.int32), 0, 1,
                    0.0, zero_key,
                )
            else:
                fn = self.programs.prefill(bucket)
                _tok, self._k, self._v, self._pos = fn(
                    self.params, self._k, self._v, self._pos,
                    0, np.zeros((bucket,), np.int32), 1, 0.0, zero_key,
                )
        for w in self._widths:
            if self._spec:
                # a spec engine decodes ONLY through the verify program
                # (all-frozen warmup: counts 0, writes trash-routed)
                fn = self.programs.spec_verify(w, self._spec_k)
                _e, _a, _c, self._k, self._v, self._pos, self._dk, self._dv = fn(
                    self.params, self._draft_params, self._k, self._v,
                    self._pos, self._dk, self._dv, self._table(),
                    np.zeros((w,), np.int32), np.zeros((w,), bool),
                    np.zeros((w,), np.float32),
                    np.zeros((w, self._spec_k, 2), np.int64),
                )
            elif self._paged:
                fn = self.programs.paged_decode(w)
                _toks, self._k, self._v, self._pos = fn(
                    self.params, self._k, self._v, self._pos,
                    self._table(), np.zeros((w,), np.int32),
                    np.zeros((w,), np.float32), np.zeros((w, 2), np.int64),
                )
                if self._fused:
                    # zero budgets: every row frozen, nothing advances
                    fn = self.programs.paged_decode_fused(
                        w, self.config.quantum
                    )
                    _e, self._k, self._v, self._pos = fn(
                        self.params, self._k, self._v, self._pos,
                        self._table(), np.zeros((w,), np.int32),
                        np.zeros((w,), np.int32), np.zeros((w,), np.float32),
                        np.zeros((self.config.quantum, w, 2), np.int64),
                    )
            else:
                fn = self.programs.decode(w)
                _toks, self._k, self._v, self._pos = fn(
                    self.params, self._k, self._v, self._pos,
                    np.zeros((w,), np.int32), np.zeros((w,), np.float32),
                    np.zeros((w, 2), np.int64),
                )

    def close(self) -> None:
        """Stop the worker thread; queued/live requests fail typed."""
        with self._work:
            self._running = False
            self._work.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=10)
            if thread.is_alive():
                # a program call outlasted the join (e.g. a first
                # launch) — the daemon thread will see _running=False
                # at its next loop check; don't race it for the slots
                logger.warning(
                    "engine %s thread still busy at close; pending "
                    "requests fail typed, thread exits at next step",
                    self.model_id,
                )
        self._fail_all(
            E.PyGridError("generation engine closed"), reset_cache=False
        )

    # ── the device loop (engine thread only) ────────────────────────────

    def _ensure_thread(self) -> None:
        """Under the lock: both callers (enqueue's ``with self._work``
        block) hold the engine lock while (re)spawning the worker."""
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop,
                name=f"pygrid-serving-{self.model_id or 'engine'}",
                daemon=True,
            )
            self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._work:
                while self._running and not self._queue and self._live == 0:
                    self._work.wait()
                if not self._running:
                    return
            try:
                self._admit()
                if self._spec and self._live:
                    # speculative mode: each verify cycle advances every
                    # live row by up to spec_k tokens in one dispatch;
                    # the quantum still caps tokens between admission
                    # checks (fairness is measured in emitted tokens)
                    emitted = 0
                    while emitted < self.config.quantum and self._live:
                        done, freed = self._spec_cycle()
                        emitted += max(1, done)
                        if freed and self._queue:
                            break
                elif self._fused and self._live and not self._queue:
                    # no admission pending: burn the whole quantum in
                    # ONE program call — rows finishing mid-call
                    # freeze (wasted steps accepted; one call and one
                    # token fetch per quantum is the whole point)
                    self._fused_scan()
                else:
                    steps = 0
                    while steps < self.config.quantum and self._live:
                        freed = self._step()
                        steps += 1
                        if freed and self._queue:
                            break  # a slot opened and someone's waiting
            except Exception as err:  # noqa: BLE001 — device-loop boundary
                logger.exception("serving engine step failed")
                self._fail_all(
                    E.PyGridError(f"generation engine error: {err}")
                )

    def _admit(self) -> None:
        while True:
            with self._lock:
                if not self._queue:
                    return
                slot = next(
                    (i for i, r in enumerate(self._slots) if r is None),
                    None,
                )
                if slot is None:
                    return
                row = self._queue.popleft()
                self._slots[slot] = row
                self._live += 1
            if self._paged and not self._assign_pages(slot, row):
                # block pool exhausted even after prefix-cache
                # eviction: park the row at the queue HEAD (FIFO order
                # kept) until a completing request frees blocks — the
                # loop keeps stepping the live slots, so progress is
                # guaranteed
                with self._lock:
                    self._slots[slot] = None
                    self._live = max(0, self._live - 1)
                    self._queue.appendleft(row)
                return
            now = time.perf_counter()
            row.admitted_at = now
            telemetry.observe(
                "serving_queue_wait_seconds", now - row.enqueued_at
            )
            if row.temperature > 0.0 and row.keys is None:
                row.keys = self._row_keys(
                    row.seed, row.row, row.batch, row.n_new
                )
            t0 = time.perf_counter()
            if self._paged:
                chunk_len = len(row.prompt) - row.start
                bucket = self._prompt_bucket(chunk_len)
                padded = np.zeros(bucket, np.int32)
                padded[:chunk_len] = row.prompt[row.start :]
                if self._spec:
                    # spec admission prefills the DRAFT cache too (it
                    # needs the prompt's k/v before it can propose) —
                    # one program, first token still from the target
                    fn = self.programs.spec_prefill(bucket)
                    tok, self._k, self._v, self._pos, self._dk, self._dv = fn(
                        self.params, self._draft_params,
                        self._k, self._v, self._pos, self._dk, self._dv,
                        self._table(), slot, padded, row.start,
                        len(row.prompt), row.temperature,
                        self._key_for(row, 0),
                    )
                else:
                    fn = self.programs.paged_prefill(bucket)
                    # the cache buffers are single-writer: only the
                    # engine thread swaps _k/_v/_pos between lock epochs
                    tok, self._k, self._v, self._pos = fn(
                        self.params, self._k, self._v, self._pos,
                        self._table(), slot, padded, row.start,
                        len(row.prompt), row.temperature,
                        self._key_for(row, 0),
                    )
                # publish the full-prompt pages for future prefix hits
                # (first prefill wins; a matched chain is only touched)
                self._prefix.insert(row.prompt, row.pages)
            else:
                bucket = self._prompt_bucket(len(row.prompt))
                padded = np.zeros(bucket, np.int32)
                padded[: len(row.prompt)] = row.prompt
                fn = self.programs.prefill(bucket)
                # the cache buffers are engine-thread-confined
                tok, self._k, self._v, self._pos = fn(
                    self.params, self._k, self._v, self._pos,
                    slot, padded, len(row.prompt), row.temperature,
                    self._key_for(row, 0),
                )
            first = int(tok)
            telemetry.observe(
                "serving_ttft_seconds", time.perf_counter() - row.enqueued_at
            )
            telemetry.observe(
                "serving_prefill_seconds", time.perf_counter() - t0
            )
            self._emit(slot, row, first)

    def _assign_pages(self, slot: int, row: _Row) -> bool:
        """Map ``row`` into the block pool: match the longest cached
        prompt prefix (refcounted, read-only — copy-on-write by the
        scatter discipline in ``models/decode.py``), then allocate
        private pages for the rest of prompt + n_new, evicting LRU
        prefix entries under pressure. False = pool exhausted, caller
        parks the row. Engine thread only."""
        total_pages = -(-(len(row.prompt) + row.n_new) // self._block)
        shared = self._prefix.match(row.prompt)
        need = total_pages - len(shared)
        priv = self._pool.alloc(need)
        # eviction only ever targets nodes whose block actually frees
        # (cache-only refs), so live-shared chains survive pressure and
        # every True strictly grows the free list — no drain, no spin
        while priv is None and self._prefix.evict_one():
            priv = self._pool.alloc(need)
        if priv is None:
            if shared:
                self._pool.release(shared)
            return False
        row.pages = shared + priv
        row.shared_pages = len(shared)
        row.start = len(shared) * self._block
        self._table_np[slot, :] = 0
        self._table_np[slot, : len(row.pages)] = row.pages
        self._table_dirty = True
        with self._lock:
            if shared:
                self._prefix_hits += 1
                self._prefix_tokens_saved += row.start
            else:
                self._prefix_misses += 1
        telemetry.incr(
            "serving_prefix_lookups_total",
            outcome="hit" if shared else "miss", model=self.model_id,
        )
        if shared:
            telemetry.incr(
                "serving_prefix_tokens_saved_total", row.start,
                model=self.model_id,
            )
        telemetry.observe(
            "serving_blocks_per_request", float(len(row.pages)),
            bounds=_BLOCKS_BOUNDS,
        )
        return True

    def _table(self):
        """The device block table, rebuilt from the host mirror after
        any admission/free edit. Engine thread only; the same device
        tensor serves every step between edits. The copy is made from a
        fresh host array and is synchronous: admission edits the mirror
        next, and an asynchronous copy could read the edit."""
        if self._table_dirty or self._table_dev is None:
            self._table_dev = torch.from_numpy(self._table_np.copy()).to(self.device)
            self._table_dirty = False
        return self._table_dev

    def _live_snapshot(self) -> tuple[list[tuple[int, "_Row"]], int]:
        """(live (slot, row) pairs, covering width bucket) for one
        dispatch — shared by the per-step, fused-scan, and speculative
        paths. Snapshot under the lock and never re-index self._slots
        after releasing it (a close() that outwaited its join could
        swap the list under us). Width 0 means nothing is live."""
        with self._lock:
            live = [
                (i, r) for i, r in enumerate(self._slots) if r is not None
            ]
        if not live:
            return [], 0
        return live, next(w for w in self._widths if w > live[-1][0])

    def _step(self) -> bool:
        """One batched decode step over every live slot; returns True if
        any slot freed (a finished request left the batch)."""
        live, width = self._live_snapshot()
        if not live:
            return False
        tokens = np.zeros(width, np.int32)
        temps = np.zeros(width, np.float32)
        keys = np.zeros((width, 2), np.int64)
        for i, row in live:
            tokens[i] = row.last_token
            temps[i] = row.temperature
            if row.keys is not None:
                keys[i] = row.keys[len(row.out)]
        t0 = time.perf_counter()
        if self._paged:
            fn = self.programs.paged_decode(width)
            toks, self._k, self._v, self._pos = fn(
                self.params, self._k, self._v, self._pos, self._table(),
                tokens, temps, keys,
            )
        else:
            fn = self.programs.decode(width)
            toks, self._k, self._v, self._pos = fn(
                self.params, self._k, self._v, self._pos,
                tokens, temps, keys,
            )
        toks = toks.cpu().numpy()
        dt = time.perf_counter() - t0
        telemetry.observe(
            "serving_batch_occupancy", float(len(live)),
            bounds=_OCCUPANCY_BOUNDS,
        )
        freed = False
        for i, row in live:
            telemetry.observe("serving_token_seconds", dt)
            if self._emit(i, row, int(toks[i])):
                freed = True
        return freed

    def _fused_scan(self) -> None:
        """Up to ``quantum`` decode steps for every live slot in ONE
        program call (``programs.paged_decode_fused``): per-row token
        budgets freeze finished rows inside the call (their writes
        trash-route, their position parks), the emitted [steps, w]
        matrix drains into pendings afterwards. Host cost per quantum:
        one call + one device→host token fetch, instead of ``quantum``
        of each. Engine thread only."""
        live, width = self._live_snapshot()
        if not live:
            return
        steps = self.config.quantum
        tokens = np.zeros(width, np.int32)
        temps = np.zeros(width, np.float32)
        budget = np.zeros(width, np.int32)
        keys = np.zeros((steps, width, 2), np.int64)
        for i, row in live:
            tokens[i] = row.last_token
            temps[i] = row.temperature
            need = row.n_new - len(row.out)
            budget[i] = need
            if row.keys is not None:
                done = len(row.out)
                take = min(steps, need)
                keys[:take, i] = row.keys[done : done + take]
        t0 = time.perf_counter()
        fn = self.programs.paged_decode_fused(width, steps)
        toks, self._k, self._v, self._pos = fn(
            self.params, self._k, self._v, self._pos, self._table(),
            tokens, budget, temps, keys,
        )
        toks = toks.cpu().numpy()  # [steps, width]
        dt = time.perf_counter() - t0
        telemetry.observe(
            "serving_batch_occupancy", float(len(live)),
            bounds=_OCCUPANCY_BOUNDS,
        )
        drained = 0
        for i, row in live:
            need = min(steps, row.n_new - len(row.out))
            drained += need
            for j in range(need):
                telemetry.observe("serving_token_seconds", dt / steps)
                self._emit(i, row, int(toks[j, i]))
        wasted = steps * len(live) - drained
        with self._lock:
            self._fused_scans += 1
            self._fused_steps += steps
            self._fused_wasted += wasted
        telemetry.incr("serving_fused_scans_total", model=self.model_id)
        telemetry.incr(
            "serving_fused_steps_total", steps, model=self.model_id
        )
        if wasted:
            telemetry.incr(
                "serving_fused_wasted_steps_total", wasted,
                model=self.model_id,
            )

    def _spec_cycle(self) -> tuple[int, bool]:
        """One speculative cycle: the truncated-layer draft proposes
        ``spec_k`` tokens per live row and the full model verifies them
        all in one wide block-table step (``programs.spec_verify`` — one
        program call including the draft's proposal steps). Returns
        (most tokens any row emitted, any slot freed). Engine thread
        only."""
        live, width = self._live_snapshot()
        if not live:
            return 0, False
        K = self._spec_k
        tokens = np.zeros(width, np.int32)
        temps = np.zeros(width, np.float32)
        active = np.zeros(width, bool)
        keys = np.zeros((width, K, 2), np.int64)
        for i, row in live:
            tokens[i] = row.last_token
            temps[i] = row.temperature
            active[i] = True
            if row.keys is not None:
                done = len(row.out)
                # per-position key schedule, clamped at the tail: a
                # verify window reaching past n_new reuses the last
                # key for tokens the drain below discards anyway
                idx = np.minimum(
                    np.arange(done, done + K), row.n_new - 1
                )
                keys[i] = row.keys[idx]
        t0 = time.perf_counter()
        fn = self.programs.spec_verify(width, K)
        emitted, accepted, counts, self._k, self._v, self._pos, self._dk, self._dv = fn(
            self.params, self._draft_params, self._k, self._v,
            self._pos, self._dk, self._dv, self._table(),
            tokens, active, temps, keys,
        )
        emitted = emitted.cpu().numpy()
        accepted = accepted.cpu().numpy()
        counts = counts.cpu().numpy()
        dt = time.perf_counter() - t0
        telemetry.observe(
            "serving_batch_occupancy", float(len(live)),
            bounds=_OCCUPANCY_BOUNDS,
        )
        freed = False
        max_emit = 0
        proposed_total = 0
        accepted_total = 0
        for i, row in live:
            m = min(int(counts[i]), row.n_new - len(row.out))
            max_emit = max(max_emit, m)
            proposed_total += K
            # acceptance the row could USE: proposals verified past the
            # row's n_new are wasted verify width, not wins — the
            # acceptance-rate gauge must not flatter the draft
            accepted_total += min(int(accepted[i]), m)
            for j in range(m):
                telemetry.observe(
                    "serving_token_seconds", dt / max(1, int(counts[i]))
                )
                if self._emit(i, row, int(emitted[i, j])):
                    freed = True
        with self._lock:
            self._spec_verifies += 1
            self._spec_proposed += proposed_total
            self._spec_accepted += accepted_total
        telemetry.incr("serving_spec_verifies_total", model=self.model_id)
        telemetry.incr(
            "serving_spec_proposed_total", proposed_total,
            model=self.model_id,
        )
        if accepted_total:
            telemetry.incr(
                "serving_spec_accepted_total", accepted_total,
                model=self.model_id,
            )
        return max_emit, freed

    def _emit(self, slot: int, row: _Row, token: int) -> bool:
        """Append one generated token to a row; retire the row (freeing
        its slot) when it has its n_new tokens. Returns True if freed."""
        row.out.append(token)
        row.last_token = token
        with self._lock:
            # stats() reads this counter under the lock from other
            # threads — the engine thread must not += it lock-free
            self._tokens_out += 1
        telemetry.incr("serving_tokens_total", model=self.model_id)
        if len(row.out) < row.n_new:
            return False
        with self._lock:
            self._slots[slot] = None
            self._live = max(0, self._live - 1)
        if self._paged:
            self._release_row(slot, row)
        row.pending.finish_row(row.row, row.out)
        if row.pending.remaining == 0:
            telemetry.incr(
                "serving_requests_total", outcome="ok",
                model=self.model_id,
            )
        return True

    def _release_row(self, slot: int, row: _Row) -> None:
        """Return a retired row's pages to the pool (shared pages just
        decref — the prefix cache and other readers keep theirs), zero
        its table row so the freed slot's garbage decode writes land in
        trash instead of a possibly-reallocated block, and refund its
        enqueue-time demand. Engine thread only."""
        if row.pages is not None:
            self._pool.release(row.pages)
            row.pages = None
            self._table_np[slot, :] = 0
            self._table_dirty = True
        with self._lock:
            self._demand_pages = max(0, self._demand_pages - row.demand)
            row.demand = 0

    def _fail_all(self, err: Exception, reset_cache: bool = True) -> None:
        cache = None
        dcache = None
        snapshot = None
        if reset_cache:
            # a failure path, not a clean close: capture the engine's
            # last state for the flight recorder BEFORE the slots are
            # wiped (the dump is the only record of who was in flight)
            snapshot = self.stats()
            # the failed program may have left the in-place cache half
            # written — reallocate so the engine serves the next request
            # from clean pools (skipped on close: no one decodes again)
            if self._paged:
                # a live re-partition (shrink_blocks) is REALIZED in
                # bytes here: the fresh arrays are sized to the
                # shrunken pool, so the budget give-back stops being
                # merely logical at the first cache reallocation
                with self._lock:
                    self._num_blocks = max(
                        2, self._num_blocks - self._shrunk_blocks
                    )
                    self._shrunk_blocks = 0
                cache = decode.init_paged_cache(
                    self.cfg, self.config.max_slots, self._num_blocks,
                    self._block, dtype=self._kv_dtype, device=self.device,
                )
                if self._spec:
                    dcache = decode.init_paged_cache(
                        self._draft_cfg, self.config.max_slots,
                        self._num_blocks, self._block,
                        dtype=self._kv_dtype, device=self.device,
                    )
            else:
                cache = decode.init_slot_cache(
                    self.cfg, self.config.max_slots, dtype=self._kv_dtype,
                    device=self.device,
                )
        with self._lock:
            rows = [r for r in self._slots if r is not None]
            rows.extend(self._queue)
            self._queue.clear()
            self._slots = [None] * self.config.max_slots
            self._live = 0
            if self._paged:
                self._demand_pages = 0
            if cache is not None:
                self._k, self._v, self._pos = cache.k, cache.v, cache.pos
            if dcache is not None:
                self._dk, self._dv = dcache.k, dcache.v
        if self._paged:
            if reset_cache:
                # the device pool was reallocated: every cached prefix
                # block now names stale (zeroed) data — rebuild the
                # allocator and drop the prefix cache wholesale (engine
                # thread only; every request future already failed above)
                # _num_blocks was already rebased above (shrunk blocks
                # realized in the fresh arrays), so the new pool simply
                # matches the new device allocation
                self._pool = pagedkv.BlockPool(self._num_blocks)
                self._prefix = pagedkv.PrefixCache(self._pool, self._block)
                # chaos holds named the OLD pool; releasing those ids
                # against the fresh allocator would be a refcount bug
                self._chaos_blocks = []
            else:
                # clean close: refcounts must balance exactly (the
                # leak test rides on this) — release each admitted
                # row's pages individually
                for row in rows:
                    if row.pages is not None:
                        self._pool.release(row.pages)
                        row.pages = None
            self._table_np[:] = 0
            self._table_dirty = True
        failed: dict[int, str] = {}
        for row in rows:
            if id(row.pending) not in failed:
                failed[id(row.pending)] = row.pending.request_id
                if not row.pending.future.done():
                    row.pending.future.set_exception(err)
        if failed:
            telemetry.incr(
                "serving_requests_total", len(failed), outcome="error",
                model=self.model_id,
            )
        if snapshot is not None:
            snapshot["failed_request_ids"] = sorted(failed.values())
            try:
                telemetry.recorder.note(
                    "engine.fail_all", model=self.model_id, error=str(err),
                    failed=len(failed),
                )
                # the engine thread may write the dump synchronously: it
                # is already off every request path (all futures failed
                # above) — but a recorder failure (unwritable flight
                # dir, full disk) must not kill the worker thread too
                telemetry.recorder.dump(
                    "engine_fail_all", snapshot=snapshot, error=err,
                )
            except Exception:  # noqa: BLE001 — capture is best-effort
                logger.exception("flight-recorder capture failed")

    # ── helpers ─────────────────────────────────────────────────────────

    def _prompt_bucket(self, p_len: int) -> int:
        for b in self._prompt_buckets:
            if p_len <= b:
                return b
        raise E.PyGridError(
            f"prompt length {p_len} exceeds model max_len "
            f"{self.cfg.max_len}"
        )

    @staticmethod
    def _row_keys(seed, row, batch, n_new):
        """Per-row PRNG key schedule matching ``generate()``: split the
        request key into one key per token. Single-row requests use the
        request key itself (the same schedule generate() draws from);
        multi-row prompts fold the row index in, so rows sample
        independently (distribution-identical to the single-request
        path, which shares one key across rows). Hashed on the host: the
        words are the same on every device."""
        key = prng.PRNGKey(int(seed), device="cpu")
        if batch > 1:
            key = prng.fold_in(key, row)
        return prng.split(key, n_new).numpy()

    def _key_for(self, row: _Row, index: int) -> np.ndarray:
        if row.keys is None:
            return np.zeros((2,), np.int64)
        return row.keys[index]
