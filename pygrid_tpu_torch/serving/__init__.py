"""Continuous-batching generation serving on the card.

The port's counterpart of :mod:`pygrid_tpu.serving`: a
:class:`ServingManager` holds one :class:`GenerationEngine` per hosted
transformer bundle, and each engine serves many concurrent requests from
one persistent paged KV cache on its device with a fixed, bucketed set of
programs. Entry points take ``device`` (default ``"cuda"``) and raise
without a GPU unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any

import torch

from pygrid_tpu_torch.device import resolve

from pygrid_tpu_torch.serving import pagedkv
from pygrid_tpu_torch.serving.engine import EngineConfig, GenerationEngine
from pygrid_tpu_torch.serving.pagedkv import (
    BlockPool,
    DeviceBudget,
    PrefixCache,
)
from pygrid_tpu_torch.serving.programs import (
    ProgramSet,
    prompt_buckets,
    width_buckets,
)

__all__ = [
    "BlockPool",
    "DeviceBudget",
    "EngineConfig",
    "GenerationEngine",
    "PrefixCache",
    "ProgramSet",
    "ServingManager",
    "prompt_buckets",
    "width_buckets",
]


class ServingManager:
    """Node-wide registry: hosted model id → its generation engine.

    Engines build lazily on first generation request (parsing the bundle
    and allocating the slot cache is paid once, not per request) and
    rebuild when a model id is re-hosted with new content — staleness is
    detected by HostedModel object identity (a re-host constructs a new
    object), tracked with a weakref so the registry never pins a deleted
    model's params in memory."""

    def __init__(
        self,
        config: EngineConfig | None = None,
        budget: DeviceBudget | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve(device)
        self.config = config or EngineConfig()
        #: ONE device KV budget across every hosted model, partitioned
        #: by admission weight (PYGRID_KV_BUDGET / PYGRID_KV_WEIGHTS);
        #: without a budget each engine sizes its own pool
        self.budget = budget if budget is not None else DeviceBudget.from_env()
        self._engines: dict[str, tuple[Any, GenerationEngine]] = {}
        self._lock = threading.Lock()
        # every flight-recorder crash dump carries the live engine
        # snapshots (weakref'd: a closed app's manager must not be
        # pinned by the process-wide recorder)
        from pygrid_tpu_torch import telemetry

        telemetry.recorder.register_stats_provider(
            f"serving-{id(self):x}", self
        )

    def engine_for(self, model_id: str, hosted) -> GenerationEngine:
        """The live engine for ``hosted`` (building/rebuilding outside
        the registry lock — compiles must not serialize other models'
        lookups)."""
        with self._lock:
            entry = self._engines.get(model_id)
            if entry is not None and entry[0]() is hosted:
                return entry[1]
        from pygrid_tpu_torch.models import decode

        if hosted.generation_cache is None:
            hosted.generation_cache = decode.from_bundle(
                hosted.model, device=self.device
            )
        cfg, params = hosted.generation_cache
        # live re-partition FIRST: engines over their fair share under
        # the new denominator give reclaimable blocks back, so the
        # late registration's grant below can be its true share instead
        # of min(share, whatever was left) forever
        self.repartition(joining=str(model_id))
        engine = GenerationEngine(
            cfg, params,
            config=self._config_for(str(model_id), cfg),
            model_id=str(model_id),
            device=self.device,
        )
        with self._lock:
            entry = self._engines.get(model_id)
            if entry is not None and entry[0]() is hosted:
                # lost the build race — serve the winner, drop ours
                winner, stale = entry[1], engine
            else:
                # fresh id, or the id was re-hosted: swap the stale
                # engine out (its params belong to the old checkpoint)
                winner, stale = engine, entry[1] if entry else None
                self._engines[model_id] = (weakref.ref(hosted), engine)
        if stale is not None:
            stale.close()
        return winner

    def _config_for(self, model_id: str, cfg) -> EngineConfig:
        """Per-model engine config: when the node carries a unified KV
        budget, size this model's block pool to its admission-weight
        share (``weight / Σ weights × PYGRID_KV_BUDGET``); explicit
        ``num_blocks``/``kv_budget_bytes`` on the base config win."""
        base = self.config
        if (
            not pagedkv.paged_enabled(base.paged)
            or base.num_blocks is not None
            or base.kv_budget_bytes is not None
            or self.budget.total_bytes is None
        ):
            return base
        import dataclasses

        block = pagedkv.resolve_block_size(cfg.max_len, base.block_size)
        dtype = base.cache_dtype or base.compute_dtype
        if dtype is None:
            dtype = pagedkv.default_cache_dtype(self.device)
        extra = 0
        if pagedkv.spec_enabled(base.spec_decode) and cfg.n_layers >= 2:
            # the speculative draft's pool rides the same block ids —
            # its layers are part of what a granted block costs
            extra = pagedkv.resolve_spec_layers(
                cfg.n_layers, base.spec_layers
            )
        blocks = self.budget.blocks_for(
            model_id,
            pagedkv.block_bytes(cfg, block, dtype, extra_layers=extra),
        )
        if blocks is None:
            return base
        return dataclasses.replace(base, num_blocks=blocks)

    def repartition(self, joining: str | None = None) -> dict[str, int]:
        """Recompute fair shares after a registry change and ask every
        over-share engine to give reclaimable blocks back (free +
        idle-cached only — live requests are untouchable; the engine's
        :meth:`~pygrid_tpu_torch.serving.engine.GenerationEngine.shrink_blocks`
        enforces that). Returns blocks shrunk per model. A model UNDER
        its share cannot grow live (its device arrays are sized) — it
        picks the larger share up at its next rebuild/re-host, which is
        why shares are recomputed on every registry change rather than
        frozen at first registration."""
        out: dict[str, int] = {}
        if self.budget.total_bytes is None:
            return out
        with self._lock:
            engines = [
                (mid, entry[1]) for mid, entry in self._engines.items()
            ]
        for mid, engine in engines:
            per = engine.block_cost_bytes()
            over = self.budget.overage(mid, joining=joining)
            if per <= 0 or over < per:
                continue
            shrunk = engine.shrink_blocks(over // per)
            if shrunk:
                self.budget.record_shrink(mid, shrunk * per)
                out[mid] = shrunk
        return out

    def evict(self, model_id: str) -> None:
        """Drop (and stop) the engine for a deleted/re-hosted model."""
        with self._lock:
            entry = self._engines.pop(model_id, None)
        self.budget.release(model_id)
        if entry is not None:
            entry[1].close()
        # shares grew for everyone left; live engines can't expand, but
        # the recompute keeps the budget ledger honest for the next
        # registration (and is a no-op when nothing is over-share)
        self.repartition()

    def stats(self) -> list[dict]:
        with self._lock:
            engines = [e for _, e in self._engines.values()]
        return [e.stats() for e in engines]

    def engines(self) -> dict[str, GenerationEngine]:
        """Live engines by model id — the fault-injection handle
        (chaos_hold_blocks etc.); everyone else should go through
        :meth:`engine_for`."""
        with self._lock:
            return {mid: e for mid, (_, e) in self._engines.items()}

    def ledger(self) -> dict:
        """Node-wide leak ledger: every engine's block accounting (see
        :meth:`~pygrid_tpu_torch.serving.engine.GenerationEngine.ledger`) plus
        the node verdict — ``balanced`` is True only when EVERY engine's
        ledger closes. Integration tests and a load harness assert
        this after traffic drains instead of poking pool internals."""
        with self._lock:
            engines = [e for _, e in self._engines.values()]
        per_engine = [e.ledger() for e in engines]
        return {
            "engines": per_engine,
            "balanced": all(led["balanced"] for led in per_engine),
        }

    def close(self) -> None:
        with self._lock:
            engines = [e for _, e in self._engines.values()]
            self._engines.clear()
        for engine in engines:
            engine.close()
