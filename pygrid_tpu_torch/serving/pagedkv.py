"""Host-side management for the paged KV cache.

The port's copy of :mod:`pygrid_tpu.serving.pagedkv`: the same allocator,
prefix cache, budget and knob resolvers under the same ``PYGRID_*`` names.
Three pieces, all pure host bookkeeping (the device side lives in
:mod:`pygrid_tpu_torch.models.decode` — ``PagedKVCache`` and the
block-table programs):

- :class:`BlockPool` — the refcounted allocator over one pool of
  fixed-size KV blocks. Block 0 is reserved as the TRASH block (the
  scatter target for pad positions and freed slots — never allocated,
  never read unmasked), so ``usable = num_blocks - 1``.
- :class:`PrefixCache` — RadixAttention-style prompt-prefix sharing: a
  chain of FULL blocks keyed by (parent, page-token-bytes). A request
  whose prompt starts with a cached chain maps those blocks read-only
  into its table (copy-on-write: appends only ever land in the request's
  own private pages) and skips their prefill work. Eviction is LRU
  leaf-first, and a block is never *freed* while any live request still
  reads it.
- :class:`DeviceBudget` — ONE device-memory budget for KV cache across
  every hosted model, partitioned by per-model admission weights
  (``PYGRID_KV_BUDGET`` / ``PYGRID_KV_WEIGHTS``).

Thread-safety: the allocator and prefix cache take their own locks
(probe runs on enqueueing threads; mutation on the engine thread).
Lock order is PrefixCache → BlockPool, one direction only.
"""

from __future__ import annotations

import os
import threading
from typing import Any

import numpy as np
import torch

from pygrid_tpu_torch.models.lm import resolve_dtype

#: default KV block size in tokens (PagedAttention-style page); a
#: bucketed power of two, clamped to the model's max_len at resolution
DEFAULT_BLOCK_TOKENS = 64


def resolve_block_size(max_len: int, requested: int | None = None) -> int:
    """The engine's KV page size: ``requested`` (or ``PYGRID_KV_BLOCK``,
    default 64) rounded DOWN to a power of two and clamped to
    ``max_len`` — pages stay bucketed so the program surface never
    depends on a knob typo."""
    if requested is None:
        try:
            requested = int(os.environ.get("PYGRID_KV_BLOCK", ""))
        except (TypeError, ValueError):
            requested = DEFAULT_BLOCK_TOKENS
    requested = max(1, min(int(requested), int(max_len)))
    block = 1
    while block * 2 <= requested:
        block *= 2
    return block


def paged_enabled(requested: bool | None = None) -> bool:
    """Paged storage is the default; ``PYGRID_KV_PAGED=off|0`` (or an
    explicit ``EngineConfig.paged=False``) falls back to the contiguous
    slot cache — the operational escape hatch and the capacity baseline."""
    if requested is not None:
        return bool(requested)
    return os.environ.get("PYGRID_KV_PAGED", "").lower() not in ("off", "0")


def fused_enabled(requested: bool | None = None) -> bool:
    """Fused multi-step decode (one program per quantum of decode steps)
    is the default on the paged path;
    ``PYGRID_FUSED_DECODE=off|0`` (or ``EngineConfig(fused=False)``)
    reverts to one program call per step, the baseline for the
    dispatch-overhead comparison."""
    if requested is not None:
        return bool(requested)
    return os.environ.get(
        "PYGRID_FUSED_DECODE", ""
    ).lower() not in ("off", "0")


def spec_enabled(requested: bool | None = None) -> bool:
    """Self-speculative decoding is OPT-IN per deployment
    (``PYGRID_SPEC_DECODE=on|1`` or ``EngineConfig(spec_decode=True)``):
    whether a truncated-layer draft wins depends on the checkpoint (the
    acceptance-rate telemetry is how operators find out), so it never
    silently becomes the default."""
    if requested is not None:
        return bool(requested)
    return os.environ.get(
        "PYGRID_SPEC_DECODE", ""
    ).lower() in ("on", "1", "true")


def resolve_spec_k(requested: int | None = None) -> int:
    """Draft proposals per verify step (``PYGRID_SPEC_K``, default 4),
    clamped to [1, 16] — the verify pass widens linearly with k, and a
    typo must not compile a 1000-wide program."""
    if requested is None:
        try:
            requested = int(os.environ.get("PYGRID_SPEC_K", ""))
        except (TypeError, ValueError):
            requested = 4
    return max(1, min(int(requested), 16))


def resolve_spec_layers(n_layers: int, requested: int | None = None) -> int:
    """Draft depth (``PYGRID_SPEC_LAYERS``, default: half the stack,
    floor 1), clamped to [1, n_layers - 1] so the draft is always a
    strict truncation — a draft as deep as the target proposes at full
    cost and can never win."""
    if requested is None:
        try:
            requested = int(os.environ.get("PYGRID_SPEC_LAYERS", ""))
        except (TypeError, ValueError):
            requested = n_layers // 2
    return max(1, min(int(requested), max(1, n_layers - 1)))


def default_cache_dtype(device: str | torch.device = "cuda") -> torch.dtype:
    """The KV cache dtype when neither ``cache_dtype`` nor
    ``compute_dtype`` is set: **bf16 on the card** (decode is
    bandwidth-bound on the cache sweep; bf16 halves it), f32 on the CPU —
    the reference's "bf16 on TPU, f32 elsewhere"."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def parse_budget_bytes(raw: str | None) -> int | None:
    """``PYGRID_KV_BUDGET`` parse: plain bytes or K/M/G-suffixed
    (``256M``, ``1.5G``). None/typo → None (no unified budget; each
    engine sizes its pool to contiguous parity)."""
    if not raw:
        return None
    raw = raw.strip()
    mult = 1
    suffix = raw[-1:].upper()
    if suffix in ("K", "M", "G"):
        mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}[suffix]
        raw = raw[:-1]
    try:
        value = int(float(raw) * mult)
    except (TypeError, ValueError):
        return None
    return value if value > 0 else None


def parse_weights(raw: str | None) -> dict[str, float]:
    """``PYGRID_KV_WEIGHTS="model-a=2,model-b=1"`` → admission-weight
    table; malformed entries are skipped (a knob never bricks startup)."""
    out: dict[str, float] = {}
    for part in (raw or "").split(","):
        if "=" not in part:
            continue
        name, _, val = part.partition("=")
        try:
            weight = float(val)
        except (TypeError, ValueError):
            continue
        if name.strip() and weight > 0:
            out[name.strip()] = weight
    return out


def block_bytes(cfg, block: int, dtype: Any, extra_layers: int = 0) -> int:
    """Device bytes one KV block costs for ``cfg``: k AND v, all layers
    — the unit the budget partitions. ``extra_layers`` adds the
    speculative DRAFT's layers: the draft shares the pool's block ids
    (same tables, its own k/v arrays), so a block's true device cost
    when spec decode is on is target layers + draft layers."""
    dh = cfg.d_model // cfg.n_heads
    return int(
        2 * (cfg.n_layers + extra_layers) * block * cfg.n_heads * dh
        * resolve_dtype(dtype).itemsize
    )


class BlockPool:
    """Refcounted free-list allocator over ``num_blocks`` KV blocks.

    Block 0 is the trash block: reserved at construction, never handed
    out. A block's refcount counts every holder — request tables and the
    prefix cache alike — and the block returns to the free list only at
    zero, so a shared prefix block outlives any single reader."""

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError("paged pool needs at least 2 blocks (one is trash)")
        self.num_blocks = int(num_blocks)
        self._lock = threading.Lock()
        #: LIFO free list — reuse the hottest block first
        self._free: list[int] = list(range(self.num_blocks - 1, 0, -1))
        self._ref = np.zeros(self.num_blocks, np.int64)
        #: blocks withdrawn from circulation by live re-partitioning
        #: (DeviceBudget.repartition): never allocated again, excluded
        #: from ``usable`` — the logical give-back another model's
        #: engine is sized against
        self._retired = 0

    @property
    def usable(self) -> int:
        return self.num_blocks - 1 - self._retired

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """All-or-nothing allocation of ``n`` blocks (refcount 1 each);
        None when the pool can't satisfy it — the caller evicts prefix
        entries or parks the request until completions free blocks."""
        if n <= 0:
            return []
        with self._lock:
            if len(self._free) < n:
                return None
            got = [self._free.pop() for _ in range(n)]
            self._ref[got] += 1
            return got

    def incref(self, blocks) -> None:
        with self._lock:
            for b in blocks:
                if self._ref[b] <= 0:
                    raise RuntimeError(f"incref of free block {b}")
                self._ref[b] += 1

    def release(self, blocks) -> None:
        """Drop one reference per block; zero-ref blocks rejoin the free
        list. Releasing a free block is a refcount bug — raise, don't
        corrupt the list (the leak test rides on this being exact)."""
        with self._lock:
            for b in blocks:
                if b <= 0 or self._ref[b] <= 0:
                    raise RuntimeError(f"release of unheld block {b}")
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    self._free.append(b)

    def retire(self, n: int) -> int:
        """Withdraw up to ``n`` FREE blocks from circulation forever
        (live re-partitioning: a late-registered model's share comes out
        of the blocks this engine is not using). Returns how many were
        actually retired — never more than the free list holds, so a
        block some request or the prefix cache still references is
        untouchable by construction. Retired blocks keep a poisoned
        refcount: a release/incref naming one raises like any other
        refcount bug."""
        if n <= 0:
            return 0
        with self._lock:
            take = min(int(n), len(self._free))
            for _ in range(take):
                b = self._free.pop()
                self._ref[b] = -1
            self._retired += take
            return take

    def retired_count(self) -> int:
        with self._lock:
            return self._retired

    def held(self) -> int:
        """Blocks currently referenced by anyone (excludes trash)."""
        with self._lock:
            return int((self._ref[1:] > 0).sum())

    def ref_count(self, block: int) -> int:
        with self._lock:
            return int(self._ref[block])

    def ledger(self) -> dict:
        """One-lock-acquisition accounting snapshot. Every usable block
        is either free or held by someone — ``free + held == usable`` is
        the pool-level leak invariant the storm harness (and GL603's
        dynamic twin) asserts after traffic drains."""
        with self._lock:
            free = len(self._free)
            held = int((self._ref[1:] > 0).sum())
            usable = self.num_blocks - 1 - self._retired
            return {
                "usable": usable,
                "free": free,
                "held": held,
                "retired": self._retired,
                "balanced": free + held == usable,
            }


class _PrefixNode:
    __slots__ = ("block", "parent", "children", "key")

    def __init__(self, block: int, parent: "_PrefixNode | None", key) -> None:
        self.block = block
        self.parent = parent
        self.children = 0
        self.key = key


class PrefixCache:
    """Prompt-prefix → shared-block chains, hash-keyed per FULL page.

    A chain node is keyed by ``(parent_node_id, page_token_bytes)`` so
    two prompts share exactly their common block-aligned prefix. The
    cache holds one pool ref per node; ``match`` adds one ref per
    matched block for the requesting row (released with the row's table
    on completion). Matching and insertion are both capped at
    ``floor((prompt_len - 1) / block)`` pages — the LAST prompt token
    always prefills in the request's own chunk, so a full-prompt hit
    still computes its first-token logits (and the continuation chunk is
    never empty)."""

    def __init__(self, pool: BlockPool, block_tokens: int) -> None:
        self._pool = pool
        self._block = int(block_tokens)
        self._lock = threading.Lock()
        #: key -> node; insertion-ordered = LRU (move_to_end on touch)
        self._nodes: dict[Any, _PrefixNode] = {}

    def _shareable_pages(self, prompt_len: int) -> int:
        return max(0, (int(prompt_len) - 1) // self._block)

    def probe(self, prompt: np.ndarray) -> int:
        """Pages a prompt would currently match — NO side effects (the
        enqueue path's demand credit; admission re-matches for real)."""
        with self._lock:
            pages = self._shareable_pages(len(prompt))
            matched = 0
            parent_id = 0
            for i in range(pages):
                key = (
                    parent_id,
                    np.ascontiguousarray(
                        prompt[i * self._block : (i + 1) * self._block],
                        np.int32,
                    ).tobytes(),
                )
                node = self._nodes.get(key)
                if node is None:
                    break
                matched += 1
                parent_id = id(node)
            return matched

    def match(self, prompt: np.ndarray) -> list[int]:
        """The longest cached chain for ``prompt`` (block ids in page
        order), with one pool ref taken per block FOR THE CALLER — the
        row's table owns them until the request completes. Touches the
        chain's LRU recency."""
        with self._lock:
            pages = self._shareable_pages(len(prompt))
            blocks: list[int] = []
            parent_id = 0
            for i in range(pages):
                key = (
                    parent_id,
                    np.ascontiguousarray(
                        prompt[i * self._block : (i + 1) * self._block],
                        np.int32,
                    ).tobytes(),
                )
                node = self._nodes.get(key)
                if node is None:
                    break
                blocks.append(node.block)
                self._nodes[key] = self._nodes.pop(key)  # LRU touch
                parent_id = id(node)
            if blocks:
                self._pool.incref(blocks)
            return blocks

    def insert(self, prompt: np.ndarray, row_blocks: list[int]) -> int:
        """After a successful prefill: publish the prompt's full pages
        (``row_blocks`` in page order) as shared. Existing chain nodes
        are kept (first prefill wins — a racing duplicate keeps its own
        private copies); new nodes take one cache-owned pool ref each.
        Returns the number of nodes added."""
        with self._lock:
            pages = min(self._shareable_pages(len(prompt)), len(row_blocks))
            added = 0
            parent: _PrefixNode | None = None
            parent_id = 0
            prompt = np.ascontiguousarray(
                prompt[: pages * self._block], np.int32
            )
            for i in range(pages):
                key = (
                    parent_id,
                    prompt[i * self._block : (i + 1) * self._block].tobytes(),
                )
                node = self._nodes.get(key)
                if node is None:
                    node = _PrefixNode(int(row_blocks[i]), parent, key)
                    self._pool.incref([node.block])
                    self._nodes[key] = node
                    if parent is not None:
                        parent.children += 1
                    added += 1
                else:
                    self._nodes[key] = self._nodes.pop(key)  # LRU touch
                parent = node
                parent_id = id(node)
            return added

    def evict_one(self) -> bool:
        """Drop the least-recently-used LEAF node (children == 0) whose
        block will actually FREE — i.e. the cache holds the only
        reference. A node still shared with a live request is skipped:
        evicting it would free nothing for the caller while destroying
        a chain future prompts could hit (eviction is for POOL pressure,
        and such a block contributes none). Returns False when no
        eviction can free a block."""
        with self._lock:
            victim = None
            for node in self._nodes.values():  # insertion order = LRU
                if node.children == 0 and (
                    self._pool.ref_count(node.block) == 1
                ):
                    victim = node
                    break
            if victim is None:
                return False
            del self._nodes[victim.key]
            if victim.parent is not None:
                victim.parent.children -= 1
            self._pool.release([victim.block])
            return True

    def clear(self) -> int:
        """Release every cached block (pool reset / engine failure —
        cached contents are stale once the device pool reallocates)."""
        with self._lock:
            blocks = [n.block for n in self._nodes.values()]
            self._nodes.clear()
        if blocks:
            self._pool.release(blocks)
        return len(blocks)

    def block_count(self) -> int:
        with self._lock:
            return len(self._nodes)

    def idle_block_count(self) -> int:
        """Cached blocks the cache alone holds (pool ref == 1) — the
        RECLAIMABLE population eviction can actually free. A cached
        block also mapped by live requests is pool occupancy the
        requests own, not cache bloat; the occupancy gauges split on
        this distinction."""
        with self._lock:
            return sum(
                1
                for n in self._nodes.values()
                if self._pool.ref_count(n.block) == 1
            )


class DeviceBudget:
    """One KV-cache byte budget partitioned across hosted models.

    ``share(model) = weight(model) / Σ weights × total`` where the
    weight table comes from ``PYGRID_KV_WEIGHTS`` (undeclared models
    weigh 1.0 and join the denominator as they register). A later
    registration never shrinks an existing engine's pool (reallocating
    a live cache would fail its in-flight requests) — it takes
    ``min(share, remaining)``; declare the full weight table up front
    for exact multi-model splits."""

    def __init__(
        self,
        total_bytes: int | None = None,
        weights: dict[str, float] | None = None,
    ) -> None:
        self.total_bytes = total_bytes
        self.weights = dict(weights or {})
        self._lock = threading.Lock()
        self._allocated: dict[str, int] = {}  # model_id -> bytes reserved

    @classmethod
    def from_env(cls) -> "DeviceBudget":
        return cls(
            total_bytes=parse_budget_bytes(os.environ.get("PYGRID_KV_BUDGET")),
            weights=parse_weights(os.environ.get("PYGRID_KV_WEIGHTS")),
        )

    def weight_of(self, model_id: str) -> float:
        return float(self.weights.get(model_id, 1.0))

    def _fair_share_locked(
        self, model_id: str, joining: str | None = None
    ) -> int:
        """``model_id``'s exact byte share with every currently
        registered model (plus declared-but-unregistered weights, plus
        a prospective ``joining`` model) in the denominator. Caller
        holds the lock."""
        members = set(self._allocated) | set(self.weights) | {model_id}
        if joining:
            members.add(joining)
        denom = sum(self.weight_of(m) for m in members)
        return int(self.total_bytes * self.weight_of(model_id) / denom)

    def blocks_for(self, model_id: str, bytes_per_block: int) -> int | None:
        """The block count ``model_id``'s engine should allocate, or
        None when no budget is configured (engine falls back to
        contiguous-parity sizing). Always grants at least one block
        beyond trash so a registered model can serve SOMETHING."""
        if self.total_bytes is None or bytes_per_block <= 0:
            return None
        with self._lock:
            live = dict(self._allocated)
            live.pop(model_id, None)
            self._allocated.pop(model_id, None)
            share = self._fair_share_locked(model_id)
            remaining = self.total_bytes - sum(live.values())
            grant = max(min(share, remaining), 2 * bytes_per_block)
            blocks = max(2, grant // bytes_per_block)
            self._allocated[model_id] = blocks * bytes_per_block
            return int(blocks)

    def overage(self, model_id: str, joining: str | None = None) -> int:
        """Bytes ``model_id`` currently holds BEYOND its fair share
        under the present registry (with ``joining`` — a model about to
        register — counted into the denominator) — what live
        re-partitioning asks its engine to give back (shrinking only
        reclaimable blocks; see :meth:`record_shrink`). 0 when no
        budget is configured or the model is at/under its share."""
        if self.total_bytes is None:
            return 0
        with self._lock:
            held = self._allocated.get(model_id)
            if held is None:
                return 0
            return max(
                0, held - self._fair_share_locked(model_id, joining)
            )

    def record_shrink(self, model_id: str, bytes_freed: int) -> None:
        """Book a live engine's give-back: the freed bytes return to
        ``remaining`` so the next registration's grant can use them."""
        if bytes_freed <= 0:
            return
        with self._lock:
            held = self._allocated.get(model_id)
            if held is not None:
                self._allocated[model_id] = max(0, held - int(bytes_freed))

    def release(self, model_id: str) -> None:
        with self._lock:
            self._allocated.pop(model_id, None)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "total_bytes": self.total_bytes,
                "allocated_bytes": dict(self._allocated),
                "weights": dict(self.weights),
            }
