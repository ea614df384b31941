"""Bucketed programs for the continuous-batching engine.

The port's counterpart of :mod:`pygrid_tpu.serving.programs`. The program
surface is fixed up front, keyed only by bucket sizes:

- one **prefill** program per prompt-length *bucket* (prompt padded up,
  true length an argument);
- one **decode-step** program per slot-width *bucket*;
- ``n_new`` never reaches a program: it is a host-side loop bound.

A "program" here is the port function built for one bucket (and the
hosted model's params already cast to the compute dtype, once, when the
set is built). Building one counts once in ``serving_compiles_total``.
Each program keeps the distinct argument signatures (shapes and dtypes)
it was called with: :meth:`ProgramSet.trace_count` sums them, so a call
site that drifts in shape or dtype shows as a second "trace", as a jit
retrace does in the reference.

Temperature and the PRNG keys are arguments; greedy and sampled rows
share one program (the ``_pick`` guard). Host inputs (tokens, budgets,
temperatures, keys) arrive as numpy arrays and cross to the device once
a call; the KV pools are updated in place. The fused program is a Python
loop over its steps with no host sync inside: the host fetches tokens
once per quantum, as the reference's ``lax.scan`` does.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from pygrid_tpu_torch import telemetry
from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.models import decode
from pygrid_tpu_torch.utils import prng


def prompt_buckets(max_len: int, smallest: int = 16) -> tuple[int, ...]:
    """Doubling ladder of prompt pad widths, capped at ``max_len``:
    16, 32, … max_len."""
    buckets: list[int] = []
    b = min(smallest, max_len)
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


def width_buckets(max_slots: int, ladder: Sequence[int]) -> tuple[int, ...]:
    """Slot-width buckets ≤ ``max_slots`` (always including it), so the
    decode program runs at the narrowest width covering the live slots."""
    widths = sorted({w for w in ladder if 0 < w < max_slots} | {max_slots})
    return tuple(widths)


def _signature(args) -> tuple:
    """Shapes and dtypes of a call's array arguments and the types of its
    scalars; a param list counts by its length only."""
    sig = []
    for a in args:
        if isinstance(a, (torch.Tensor, np.ndarray)):
            sig.append((tuple(a.shape), str(a.dtype)))
        elif isinstance(a, (list, tuple)):
            sig.append(("list", len(a)))
        else:
            sig.append(type(a).__name__)
    return tuple(sig)


class _Program:
    """One bucket's program and the argument signatures it has seen."""

    def __init__(self, fn: Callable) -> None:
        self._fn = fn
        self._seen: set[tuple] = set()

    def __call__(self, *args):
        self._seen.add(_signature(args))
        return self._fn(*args)

    def _cache_size(self) -> int:
        return len(self._seen)


class ProgramSet:
    """The program cache for one hosted model: keyed only by bucket
    sizes, never by request shape. ``compile_count()`` is the observable
    the no-rebuild contract is asserted against."""

    def __init__(
        self,
        cfg,
        compute_dtype: Any | None = None,
        cache_dtype: Any | None = None,
        model_id: str = "",
        draft_cfg: Any | None = None,
        params: Sequence[torch.Tensor] | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.cache_dtype = cache_dtype
        self.model_id = model_id
        self.device = resolve(device)
        #: truncated-layer draft config for the speculative programs
        #: (None: spec_prefill/spec_verify are unavailable)
        self.draft_cfg = draft_cfg
        #: the hosted params narrowed to the compute dtype ONCE (the
        #: draft's params are a subset of the same tensors, so it covers
        #: both); every program looks its weights up here
        self.cast_cache = (
            decode.cast_params(params, compute_dtype) if params is not None else None
        )
        self._prefill: dict[int, Callable] = {}
        self._decode: dict[int, Callable] = {}
        self._paged_prefill: dict[int, Callable] = {}
        self._paged_decode: dict[int, Callable] = {}
        self._paged_fused: dict[tuple[int, int], Callable] = {}
        self._spec_prefill: dict[int, Callable] = {}
        self._spec_verify: dict[tuple[int, int], Callable] = {}
        self._compiles = 0

    def compile_count(self) -> int:
        return self._compiles

    def trace_count(self) -> int:
        """Distinct argument signatures across every program — catches a
        call site whose shapes or dtypes drift, which the build
        counter cannot see. Equals :meth:`compile_count` when the
        no-rebuild contract holds (and every built program has run)."""
        total = 0
        for fn in [
            *self._prefill.values(),
            *self._decode.values(),
            *self._paged_prefill.values(),
            *self._paged_decode.values(),
            *self._paged_fused.values(),
            *self._spec_prefill.values(),
            *self._spec_verify.values(),
        ]:
            size = getattr(fn, "_cache_size", None)
            total += size() if callable(size) else 1
        return total

    def _count(self, kind: str) -> None:
        self._compiles += 1
        telemetry.incr("serving_compiles_total", kind=kind)

    def _build(self, fn: Callable, kind: str, bucket: int) -> Callable:
        self._count(kind)
        return telemetry.profiler.wrap(
            _Program(fn), kind=kind, bucket=bucket, model_id=self.model_id
        )

    # ── host inputs ─────────────────────────────────────────────────────

    def _ints(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.int64).to(self.device)

    def _floats(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32).to(self.device)

    @staticmethod
    def _pick(logits, temps, keys):
        """Greedy/sampled token per row from ``logits [..., vocab]``,
        ``temps [...]`` and ``keys [..., 2]`` on the device: one call
        serves every temperature INCLUDING zero (categorical over
        logits/0 is NaN, so a zero row takes the argmax)."""
        safe_t = torch.where(temps > 0.0, temps, torch.ones_like(temps))
        sampled = prng.categorical(keys, logits / safe_t[..., None])
        return torch.where(temps > 0.0, sampled, torch.argmax(logits, dim=-1))

    def _picker(self, temps, keys) -> tuple[Callable, torch.Tensor | None]:
        """``(pick, device_keys)`` for one call: ``pick(logits, keys)`` is
        the argmax when no row samples, else :meth:`_pick` with the rows'
        temperatures. Whether a row samples is read on the HOST from the
        numpy temperatures, so an all-greedy call draws no noise it would
        discard and its keys never cross to the device."""
        if not np.any(np.asarray(temps) > 0.0):
            return (lambda logits, _k: torch.argmax(logits, dim=-1)), None
        t = self._floats(temps)
        return (lambda logits, k: self._pick(logits, t, k)), self._ints(keys)

    # ── contiguous programs ─────────────────────────────────────────────

    def prefill(self, bucket: int) -> Callable:
        """``fn(params, k, v, pos, slot, prompt[bucket], length, temp,
        key) -> (first_token, k, v, pos)`` — admission of one request
        into one slot, first token picked on the device."""
        fn = self._prefill.get(bucket)
        if fn is None:
            cfg, cd, cast = self.cfg, self.compute_dtype, self.cast_cache

            def _prefill(params, k, v, pos, slot, prompt, length, temp, key):
                cache = decode.SlotKVCache(k=k, v=v, pos=pos)
                logits, cache = decode.prefill_slot(
                    params, cache, slot, self._ints(prompt), length, cfg, cd, cast
                )
                pick, key_d = self._picker(np.float32(temp), key)
                return pick(logits, key_d), cache.k, cache.v, cache.pos

            fn = self._prefill[bucket] = self._build(_prefill, "prefill", bucket)
        return fn

    def decode(self, width: int) -> Callable:
        """``fn(params, k, v, pos, tokens[w], temps[w], keys[w, 2]) ->
        (next_tokens[w], k, v, pos)`` — one step for the first ``w``
        slots, each at its own position and with its own temperature and
        key."""
        fn = self._decode.get(width)
        if fn is None:
            cfg, cd, cast = self.cfg, self.compute_dtype, self.cast_cache

            def _decode_step(params, k, v, pos, tokens, temps, keys):
                cache = decode.SlotKVCache(k=k, v=v, pos=pos)
                logits, cache = decode.decode_step_slots(
                    params, cache, self._ints(tokens), cfg, cd, cast
                )
                pick, keys_d = self._picker(temps, keys)
                return pick(logits, keys_d), cache.k, cache.v, cache.pos

            fn = self._decode[width] = self._build(_decode_step, "decode", width)
        return fn

    # ── paged (block-table) programs ────────────────────────────────────
    #
    # The block TABLE is a plain device argument of constant [S,
    # max_pages] shape; ``start``/``length`` are arguments, so a prefix
    # hit of any block-aligned depth reuses one program.

    def paged_prefill(self, bucket: int) -> Callable:
        """``fn(params, k, v, pos, table, slot, chunk[bucket], start,
        length, temp, key) -> (first_token, k, v, pos)`` — admission of
        one request through its block table, continuing after a shared
        prefix of ``start`` tokens."""
        fn = self._paged_prefill.get(bucket)
        if fn is None:
            cfg, cd, cast = self.cfg, self.compute_dtype, self.cast_cache

            def _paged_prefill(
                params, k, v, pos, table, slot, chunk, start, length, temp, key,
            ):
                cache = decode.PagedKVCache(k=k, v=v, pos=pos)
                logits, cache = decode.paged_prefill_chunk(
                    params, cache, table, slot, self._ints(chunk), start, length,
                    cfg, cd, cast,
                )
                pick, key_d = self._picker(np.float32(temp), key)
                return pick(logits, key_d), cache.k, cache.v, cache.pos

            fn = self._paged_prefill[bucket] = self._build(
                _paged_prefill, "paged_prefill", bucket
            )
        return fn

    def paged_decode_fused(self, width: int, steps: int) -> Callable:
        """``fn(params, k, v, pos, table, tokens[w], budget[w], temps[w],
        keys[steps, w, 2]) -> (emitted[steps, w], k, v, pos)`` — up to
        ``steps`` block-table decode steps in ONE program call.

        ``budget[i]`` is how many tokens row ``i`` still needs: the loop
        decrements it per step and FREEZES the row at zero (k/v write to
        trash, position parked, token carried — see
        ``decode.paged_decode_step``'s ``active`` mask). Every step's
        tokens stay on the device until the call returns; nothing inside
        waits on the device or branches on a device value."""
        cache_key = (width, steps)
        fn = self._paged_fused.get(cache_key)
        if fn is None:
            cfg, cd, cast = self.cfg, self.compute_dtype, self.cast_cache

            def _fused(params, k, v, pos, table, tokens, budget, temps, keys):
                cache = decode.PagedKVCache(k=k, v=v, pos=pos)
                pick, keys_d = self._picker(temps, keys)
                tok = self._ints(tokens)
                remaining = self._ints(budget)
                emitted = []
                for s in range(steps):
                    alive = remaining > 0
                    logits, cache = decode.paged_decode_step(
                        params, cache, table, tok, cfg, cd, active=alive,
                        cast_cache=cast,
                    )
                    picked = pick(logits, None if keys_d is None else keys_d[s])
                    tok = torch.where(alive, picked, tok)
                    remaining = remaining - alive.to(remaining.dtype)
                    emitted.append(tok)
                return torch.stack(emitted), cache.k, cache.v, cache.pos

            fn = self._paged_fused[cache_key] = self._build(
                _fused, "paged_decode_fused", width
            )
        return fn

    def paged_decode(self, width: int) -> Callable:
        """``fn(params, k, v, pos, table, tokens[w], temps[w], keys[w, 2])
        -> (next_tokens[w], k, v, pos)`` — one block-table step for the
        first ``w`` slots."""
        fn = self._paged_decode.get(width)
        if fn is None:
            cfg, cd, cast = self.cfg, self.compute_dtype, self.cast_cache

            def _paged_decode_step(params, k, v, pos, table, tokens, temps, keys):
                cache = decode.PagedKVCache(k=k, v=v, pos=pos)
                logits, cache = decode.paged_decode_step(
                    params, cache, table, self._ints(tokens), cfg, cd,
                    cast_cache=cast,
                )
                pick, keys_d = self._picker(temps, keys)
                return pick(logits, keys_d), cache.k, cache.v, cache.pos

            fn = self._paged_decode[width] = self._build(
                _paged_decode_step, "paged_decode", width
            )
        return fn

    # ── self-speculative programs (truncated-layer draft) ───────────────
    #
    # The draft shares the paged pool's BLOCK IDS: its k/v pools carry
    # fewer layers but use the same tables, so every allocation /
    # prefix-share / COW rule covers both caches.

    def spec_prefill(self, bucket: int) -> Callable:
        """``fn(params, dparams, k, v, pos, dk, dv, table, slot,
        chunk[bucket], start, length, temp, key) -> (first_token, k, v,
        pos, dk, dv)`` — admission when spec decode is on: the chunk is
        prefilled through BOTH caches, the first token picked from the
        TARGET logits."""
        fn = self._spec_prefill.get(bucket)
        if fn is None:
            cfg, dcfg, cd, cast = self.cfg, self.draft_cfg, self.compute_dtype, self.cast_cache

            def _spec_prefill(
                params, dparams, k, v, pos, dk, dv, table, slot, chunk,
                start, length, temp, key,
            ):
                chunk = self._ints(chunk)
                cache = decode.PagedKVCache(k=k, v=v, pos=pos)
                logits, cache = decode.paged_prefill_chunk(
                    params, cache, table, slot, chunk, start, length, cfg, cd, cast,
                )
                # the draft pass only writes the draft's k/v rows for the
                # prompt; it sets the shared pos to the same length
                dcache = decode.PagedKVCache(k=dk, v=dv, pos=pos)
                _dl, dcache = decode.paged_prefill_chunk(
                    dparams, dcache, table, slot, chunk, start, length, dcfg, cd, cast,
                )
                pick, key_d = self._picker(np.float32(temp), key)
                return pick(logits, key_d), cache.k, cache.v, cache.pos, dcache.k, dcache.v

            fn = self._spec_prefill[bucket] = self._build(
                _spec_prefill, "spec_prefill", bucket
            )
        return fn

    def spec_verify(self, width: int, k_spec: int) -> Callable:
        """``fn(params, dparams, k, v, pos, dk, dv, table, tokens[w],
        active[w], temps[w], keys[w, K, 2]) -> (emitted[w, K],
        accepted[w], counts[w], k, v, pos, dk, dv)`` — one speculative
        decode cycle for the first ``w`` slots in ONE program call:

        1. the DRAFT proposes K tokens autoregressively (K truncated-layer
           block-table steps, on a copy of the positions);
        2. the TARGET verifies all K in one wide step
           (``decode.paged_verify_chunk``);
        3. acceptance: greedy rows accept while the proposal equals the
           target argmax and emit the target's token at the first
           mismatch — bit-identical to plain greedy decode; sampling rows
           accept ``x`` with probability ``min(1, p_t(x)/p_d(x))`` and
           draw the first rejection from ``norm(max(p_t - p_d, 0))``, every
           draw keyed from the row's per-position key schedule
           (``fold_in`` tags 1/2/3 for draft/accept/residual).

        ``counts[i]`` ∈ [1, K] tokens emitted per active row (0 for
        frozen rows); ``accepted[i]`` counts the accepted proposals."""
        cache_key = (width, k_spec)
        fn = self._spec_verify.get(cache_key)
        if fn is None:
            cfg, dcfg, cd, cast = self.cfg, self.draft_cfg, self.compute_dtype, self.cast_cache

            def _spec_verify(
                params, dparams, k, v, pos, dk, dv, table, tokens, active, temps, keys,
            ):
                act = torch.as_tensor(np.asarray(active), dtype=torch.bool).to(self.device)
                pick, keys_d = self._picker(temps, keys)  # keys_d [w, K, 2]
                w = act.shape[0]
                # the draft steps on its OWN copy of the positions; the
                # target's advance by the accepted count below
                dcache = decode.PagedKVCache(k=dk, v=dv, pos=pos[:w].clone())
                tok = self._ints(tokens)
                fed, props, dlg = [], [], []
                for j in range(k_spec):
                    dlogits, dcache = decode.paged_decode_step(
                        dparams, dcache, table, tok, dcfg, cd, active=act,
                        cast_cache=cast,
                    )
                    step_keys = None if keys_d is None else prng.fold_in(keys_d[:, j], 1)
                    proposal = pick(dlogits, step_keys)
                    fed.append(tok)
                    props.append(proposal)
                    dlg.append(dlogits)
                    tok = proposal
                cache = decode.PagedKVCache(k=k, v=v, pos=pos)
                tlogits, cache = decode.paged_verify_chunk(
                    params, cache, table, torch.stack(fed, 1), cfg, cd,
                    active=act, cast_cache=cast,
                )  # [w, K, vocab]
                X = torch.stack(props, 1)  # [w, K] proposal for index j
                greedy_tok = torch.argmax(tlogits, dim=-1)
                if keys_d is not None:
                    t = self._floats(temps)
                    D = torch.stack(dlg, 1)  # [w, K, vocab]
                    safe_t = torch.where(t > 0.0, t, torch.ones_like(t))
                    p_t = torch.softmax(tlogits / safe_t[:, None, None], -1)
                    p_d = torch.softmax(D / safe_t[:, None, None], -1)
                    px_t = p_t.gather(-1, X[:, :, None])[..., 0]
                    px_d = p_d.gather(-1, X[:, :, None])[..., 0]
                    u = prng.uniform(prng.fold_in(keys_d, 2))
                    # u ≤ p_t/p_d, multiplied through: a zero draft
                    # probability accepts
                    sampled_ok = u * px_d <= px_t
                    ok = torch.where(t[:, None] > 0.0, sampled_ok, X == greedy_tok)
                    residual = torch.clamp(p_t - p_d, min=0.0)
                    resid_tok = prng.categorical(
                        prng.fold_in(keys_d, 3), torch.log(residual + 1e-20)
                    )
                    corr = torch.where(t[:, None] > 0.0, resid_tok, greedy_tok)
                else:
                    ok = X == greedy_tok
                    corr = greedy_tok
                n_acc = torch.cumprod(ok.long(), dim=1).sum(dim=1)  # [w]
                jidx = torch.arange(k_spec, device=X.device)[None, :]
                emitted = torch.where(
                    jidx < n_acc[:, None], X,
                    torch.where(jidx == n_acc[:, None], corr, torch.zeros_like(X)),
                )
                counts = torch.clamp(n_acc + 1, max=k_spec)
                counts = torch.where(act, counts, torch.zeros_like(counts))
                cache.pos[:w] += counts
                return emitted, n_acc, counts, cache.k, cache.v, cache.pos, dk, dv

            fn = self._spec_verify[cache_key] = self._build(
                _spec_verify, "spec_verify", width
            )
        return fn
