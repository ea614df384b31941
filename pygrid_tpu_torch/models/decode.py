"""Autoregressive decoding for the transformer family — KV-cache serving.

Counterpart of :mod:`pygrid_tpu.models.decode`, with its public contracts:
a static-shape KV cache allocated at ``max_len`` and masked by position, a
dense single-pass ``prefill``, a decode loop, the continuous-batching
``SlotKVCache`` family and the paged ``PagedKVCache`` family (block
tables, prefix sharing, the speculative verify pass) that the serving
engine (:mod:`pygrid_tpu_torch.serving`) drives.

PyTorch idiom: plain functions on tensors with an explicit device. The KV
pools are updated in place — the port's counterpart of the reference's
donated buffers — and each function returns the cache it was given. Host
scalars (a contiguous cache's ``pos``, a slot index, a prompt's start and
length) are Python ints, so no function waits on the device.

The reference's index semantics are written out, because an out-of-range
index on the card is a device-side assert that poisons the CUDA context:
gathers clamp (a free slot's stale position reads the last position row),
``.at[].set`` drops an out-of-range update, and ``dynamic_update_slice``
shifts its start so that the update fits. Products of narrow operands
accumulate and return f32 where the reference asks
``preferred_element_type=float32``.

No kernel of its own: at single-token decode attention is a masked dense
pass over the cache, bandwidth-bound on the cache read, as in the
reference, which runs no Pallas kernel here either.

Correctness contract: greedy decode from a prompt equals repeated
full-forward ``transformer.apply`` argmax, and the serving engine's greedy
tokens equal :func:`generate`'s bit for bit on the CPU.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.models.lm import cast, resolve_dtype
from pygrid_tpu_torch.models.transformer import PARAMS_PER_LAYER, TransformerConfig, layer_norm
from pygrid_tpu_torch.utils import prng


def bundle(cfg: TransformerConfig, params: Sequence[Any]) -> dict:
    """Servable transformer bundle: a plain serde-serializable dict
    carrying the config and numpy parameters — the reference's layout, so
    a bundle crosses between the packages through either serde."""
    return {
        "family": "transformer",
        "cfg": list(cfg),
        "params": [
            p.detach().cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
            for p in params
        ],
    }


def from_bundle(
    spec: dict, device: str | torch.device = "cuda"
) -> tuple[TransformerConfig, list[torch.Tensor]]:
    """Inverse of :func:`bundle` (validates the family tag and the param
    count); the params land on ``device``."""
    if not isinstance(spec, dict) or spec.get("family") != "transformer":
        raise ValueError("not a generative transformer bundle")
    dev = resolve(device)
    cfg = TransformerConfig(*[int(v) for v in spec["cfg"]])
    params = [
        p.to(dev) if isinstance(p, torch.Tensor)
        else torch.from_numpy(np.array(p, copy=True)).to(dev)
        for p in spec["params"]
    ]
    expect = 2 + PARAMS_PER_LAYER * cfg.n_layers + 2
    if len(params) != expect:
        raise ValueError(
            f"bundle has {len(params)} params, config needs {expect}"
        )
    return cfg, params


# ── numerics helpers ─────────────────────────────────────────────────────


def cast_params(params: Sequence[torch.Tensor], compute_dtype: Any) -> dict | None:
    """The compute-dtype copy of every param, made once: pass it as
    ``cast_cache`` and the decode functions narrow a param by lookup
    instead of casting all weights at every step (inside a ``jit`` XLA
    folds the reference's casts away; eager PyTorch would not). The cast
    is the same one, so the numerics do not change. None without a
    compute dtype."""
    cd = resolve_dtype(compute_dtype)
    if cd is None:
        return None
    return {id(p): (p, cast(p, cd)) for p in params}


def _caster(compute_dtype: Any, cast_cache: dict | None):
    cd = resolve_dtype(compute_dtype)
    if cd is None:
        return lambda x: x
    if not cast_cache:
        return lambda x: cast(x, cd)

    def c(x):
        hit = cast_cache.get(id(x))
        return hit[1] if hit is not None and hit[0] is x else cast(x, cd)

    return c


def _rows2(x: torch.Tensor):
    """On the CPU a one-row product takes MKL's matrix-vector path, which
    sums in another order than its matrix-matrix path. Products here run
    with two rows or more, so a row's result does not depend on how many
    rows share the call — the engine's width-w batch and ``generate``'s
    batch then agree bit for bit."""
    return (not x.is_cuda) and x.shape[-2] == 1


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x[..., K] @ w[K, N]`` in the operands' dtype."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _rows2(x2):
        out = (torch.cat([x2, x2]) @ w)[:1]
    else:
        out = x2 @ w
    return out.reshape(*lead, w.shape[-1])


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` accumulated and returned in f32 — the reference's
    ``preferred_element_type=float32``. Two narrow operands on the card go
    to the native-dtype product with an f32 output; otherwise the
    operands are promoted to f32 first (exact: a bf16 product fits)."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    a, b = a.float(), b.float()
    if _rows2(a):
        return torch.bmm(torch.cat([a, a], 1), b)[:, :1]
    return torch.bmm(a, b)


def _logits(h: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """``h[..., d] @ embed.T`` accumulated and returned in f32 (the tied
    output head); ``h`` and ``embed`` already in the compute dtype."""
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    if h2.is_cuda and h2.dtype == embed.dtype and h2.dtype != torch.float32:
        out = torch.mm(h2, embed.T, out_dtype=torch.float32)
    else:
        out = _mm(h2.float(), embed.float().T)
    return out.reshape(*lead, embed.shape[0])


def _attend(q, k, v, mask, scale) -> torch.Tensor:
    """Masked dense attention, f32 softmax per the repo-wide contract.

    ``q [N, Pq, H, dh]``; ``k``/``v [N, L, H, dh]`` (the cache dtype);
    ``mask`` bool, broadcastable to ``[N, H, Pq, L]``. Returns the f32
    result ``[N, Pq, H, dh]``; P is rounded to ``v``'s dtype before the
    second product, as the reference rounds it."""
    N, Pq, H, dh = q.shape
    L = k.shape[1]
    qh = q.permute(0, 2, 1, 3).reshape(N * H, Pq, dh)
    kh = k.permute(0, 2, 3, 1).reshape(N * H, dh, L)
    s = _bmm_f32(qh, kh).reshape(N, H, Pq, L) * scale
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    vh = v.permute(0, 2, 1, 3).reshape(N * H, L, dh)
    o = _bmm_f32(p.reshape(N * H, Pq, L), vh)
    return o.reshape(N, H, Pq, dh).permute(0, 2, 1, 3)


def _clip(i: int, n: int) -> int:
    """A host index as a gather or ``dynamic_index_in_dim`` reads it in
    the reference: negative counts from the end, then clamped."""
    i = int(i)
    if i < 0:
        i += n
    return min(max(i, 0), n - 1)


def _set_pos(pos: torch.Tensor, slot: int, length: int) -> None:
    """``pos.at[slot].set(length)``: an out-of-range slot is dropped. The
    fill takes ``length`` as a kernel argument, so nothing crosses from
    the host and the stream is not waited on."""
    S = pos.shape[0]
    slot = int(slot)
    if -S <= slot < S:
        pos.narrow(0, slot % S, 1).fill_(int(length))


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with the reference's gather semantics: negative
    indices count from the end, then every index is clamped in range."""
    n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return table[idx]


def _block(h, layer_params, c, attn):
    """One transformer block with an injected attention stage — the ONE
    copy of the per-layer numerics every decode variant shares (the
    bit-identical-greedy contract between ``generate()`` and the serving
    engine rides on these staying in lockstep). ``attn(x, wq, wk, wv)``
    receives the ln1 output and the cast projection weights and returns
    the attention result [..., d_model]."""
    (ln1_s, ln1_b, wq, wk, wv, wo, ln2_s, ln2_b, w1, b1, w2, b2) = layer_params
    x = c(layer_norm(h, ln1_s, ln1_b))
    a = attn(x, c(wq), c(wk), c(wv))
    h = h + _mm(c(a), c(wo))
    x = c(layer_norm(h, ln2_s, ln2_b))
    mlp = F.gelu(_mm(x, c(w1)) + c(b1), approximate="tanh")
    return h + _mm(c(mlp), c(w2)) + c(b2)


# ── contiguous cache (generate) ──────────────────────────────────────────


class KVCache(NamedTuple):
    """Static-shape per-layer key/value cache.

    ``k``/``v``: [n_layers, B, max_len, n_heads, head_dim]; ``pos``: the
    number of valid positions already written (a host int)."""

    k: torch.Tensor
    v: torch.Tensor
    pos: int


def init_cache(
    cfg: TransformerConfig,
    batch: int,
    dtype: Any = torch.float32,
    device: str | torch.device = "cuda",
) -> KVCache:
    dh = cfg.d_model // cfg.n_heads
    shape = (cfg.n_layers, batch, cfg.max_len, cfg.n_heads, dh)
    dev = resolve(device)
    dt = resolve_dtype(dtype)
    # zeros, never empty: a masked column has p == 0, and 0 * NaN from
    # uninitialised memory would leak into p @ v
    return KVCache(
        k=torch.zeros(shape, dtype=dt, device=dev),
        v=torch.zeros(shape, dtype=dt, device=dev),
        pos=0,
    )


def decode_step(
    params: Sequence[torch.Tensor],
    cache: KVCache,
    token: torch.Tensor,
    cfg: TransformerConfig = TransformerConfig(),
    compute_dtype: Any | None = None,
    cast_cache: dict | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """One decode step: ``token`` [B] at position ``cache.pos`` →
    (logits [B, vocab] f32, the cache with k/v appended in place).
    At ``pos >= max_len`` the write is dropped and the position row is
    the last one, as in the reference."""
    c = _caster(compute_dtype, cast_cache)
    embed, pos_emb = params[0], params[1]
    B = token.shape[0]
    dh = cfg.d_model // cfg.n_heads
    t = int(cache.pos)
    h = c(_take(embed, token) + pos_emb[_clip(t, cfg.max_len)])  # [B, d]
    write = 0 <= t < cfg.max_len
    mask = torch.arange(cfg.max_len, device=token.device) < t + 1
    scale = dh**-0.5

    idx = 2
    for layer in range(cfg.n_layers):

        def attn(x, wq, wk, wv, layer=layer):
            q = _mm(x, wq).reshape(B, 1, cfg.n_heads, dh)
            k = _mm(x, wk).reshape(B, cfg.n_heads, dh)
            v = _mm(x, wv).reshape(B, cfg.n_heads, dh)
            if write:
                cache.k[layer, :, t] = k.to(cache.k.dtype)
                cache.v[layer, :, t] = v.to(cache.v.dtype)
            return _attend(
                q, cache.k[layer], cache.v[layer], mask, scale
            ).reshape(B, cfg.d_model)

        h = _block(h, params[idx: idx + PARAMS_PER_LAYER], c, attn)
        idx += PARAMS_PER_LAYER
    h = layer_norm(h, params[idx], params[idx + 1])
    logits = _logits(c(h), c(embed))
    return logits, KVCache(k=cache.k, v=cache.v, pos=t + 1)


def prefill(
    params: Sequence[torch.Tensor],
    cache: KVCache,
    prompt: torch.Tensor,
    cfg: TransformerConfig = TransformerConfig(),
    compute_dtype: Any | None = None,
    cast_cache: dict | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Ingest a [B, P] prompt in ONE dense causal pass; returns the last
    position's logits and the filled cache. The k/v rows land at
    ``cache.pos`` — shifted down so the P rows fit, as
    ``dynamic_update_slice`` does — while the attention mask keeps the
    unshifted positions."""
    c = _caster(compute_dtype, cast_cache)
    embed, pos_emb = params[0], params[1]
    B, P = prompt.shape
    dh = cfg.d_model // cfg.n_heads
    t0 = int(cache.pos)
    dev = prompt.device
    positions = t0 + torch.arange(P, device=dev)
    h = c(_take(embed, prompt) + _take(pos_emb, positions))  # [B, P, d]
    scale = dh**-0.5
    mask = torch.arange(cfg.max_len, device=dev)[None, :] <= positions[:, None]
    start = min(max(t0, 0), cfg.max_len - P)

    idx = 2
    for layer in range(cfg.n_layers):

        def attn(x, wq, wk, wv, layer=layer):
            q = _mm(x, wq).reshape(B, P, cfg.n_heads, dh)
            k = _mm(x, wk).reshape(B, P, cfg.n_heads, dh)
            v = _mm(x, wv).reshape(B, P, cfg.n_heads, dh)
            cache.k[layer, :, start: start + P] = k.to(cache.k.dtype)
            cache.v[layer, :, start: start + P] = v.to(cache.v.dtype)
            return _attend(
                q, cache.k[layer], cache.v[layer], mask, scale
            ).reshape(B, P, cfg.d_model)

        h = _block(h, params[idx: idx + PARAMS_PER_LAYER], c, attn)
        idx += PARAMS_PER_LAYER
    h = layer_norm(h[:, -1], params[idx], params[idx + 1])  # last position only
    logits = _logits(c(h), c(embed))
    return logits, KVCache(k=cache.k, v=cache.v, pos=t0 + P)


# ── slot-structured shared cache (continuous-batching serving) ───────────


class SlotKVCache(NamedTuple):
    """Per-slot key/value cache shared by independent requests.

    ``k``/``v``: [n_layers, S, max_len, n_heads, head_dim]; ``pos``: [S]
    int64 on the device, each slot's count of valid rows. Every read is
    masked per slot, so no slot can see another's rows."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


def init_slot_cache(
    cfg: TransformerConfig,
    slots: int,
    dtype: Any = torch.float32,
    device: str | torch.device = "cuda",
) -> SlotKVCache:
    dh = cfg.d_model // cfg.n_heads
    shape = (cfg.n_layers, slots, cfg.max_len, cfg.n_heads, dh)
    dev = resolve(device)
    dt = resolve_dtype(dtype)
    return SlotKVCache(
        k=torch.zeros(shape, dtype=dt, device=dev),
        v=torch.zeros(shape, dtype=dt, device=dev),
        pos=torch.zeros((slots,), dtype=torch.int64, device=dev),
    )


def prefill_slot(
    params: Sequence[torch.Tensor],
    cache: SlotKVCache,
    slot: int,
    prompt: torch.Tensor,
    length: int,
    cfg: TransformerConfig = TransformerConfig(),
    compute_dtype: Any | None = None,
    cast_cache: dict | None = None,
) -> tuple[torch.Tensor, SlotKVCache]:
    """Dense single-pass prefill of ONE slot of the shared cache.

    ``prompt``: [P] padded to a bucket width; ``length``: the true token
    count. Returns the logits at position ``length - 1`` ([vocab]) and the
    cache with rows [0, P) of that slot rewritten and ``pos[slot] =
    length`` — other slots are untouched. Rows ≥ ``length`` hold pad
    garbage, masked by ``pos`` and overwritten by later decode steps."""
    c = _caster(compute_dtype, cast_cache)
    embed, pos_emb = params[0], params[1]
    P = prompt.shape[0]
    S = cache.k.shape[1]
    dh = cfg.d_model // cfg.n_heads
    dev = prompt.device
    h = c(_take(embed, prompt) + pos_emb[:P])  # [P, d] — a slot starts at 0
    scale = dh**-0.5
    ar = torch.arange(P, device=dev)
    causal = ar[None, :] <= ar[:, None]  # [P, P]
    s_row = _clip(slot, S)  # dynamic_update_slice clamps its start

    idx = 2
    for layer in range(cfg.n_layers):

        def attn(x, wq, wk, wv, layer=layer):
            q = _mm(x, wq).reshape(1, P, cfg.n_heads, dh)
            # round k/v through the CACHE dtype before attending: decode
            # reads these rows post-rounding, and prefill must see the
            # same values or the bit-identical-greedy contract breaks
            k = _mm(x, wk).reshape(1, P, cfg.n_heads, dh).to(cache.k.dtype)
            v = _mm(x, wv).reshape(1, P, cfg.n_heads, dh).to(cache.v.dtype)
            cache.k[layer, s_row, :P] = k[0]
            cache.v[layer, s_row, :P] = v[0]
            # attention stays within the prompt: a fresh slot has no
            # earlier rows
            return _attend(q, k, v, causal, scale).reshape(P, cfg.d_model)

        h = _block(h, params[idx: idx + PARAMS_PER_LAYER], c, attn)
        idx += PARAMS_PER_LAYER
    h_last = h[_clip(length - 1, P)]
    h_last = layer_norm(h_last, params[idx], params[idx + 1])
    logits = _logits(c(h_last)[None], c(embed))[0]
    _set_pos(cache.pos, slot, length)
    return logits, cache


def decode_step_slots(
    params: Sequence[torch.Tensor],
    cache: SlotKVCache,
    token: torch.Tensor,
    cfg: TransformerConfig = TransformerConfig(),
    compute_dtype: Any | None = None,
    cast_cache: dict | None = None,
) -> tuple[torch.Tensor, SlotKVCache]:
    """One decode step for the first ``w = token.shape[0]`` slots, each
    at its OWN position ``cache.pos[s]`` → (logits [w, vocab] f32, the
    cache with one row appended per advanced slot).

    Free slots inside the width write a garbage row at their stale
    position; a write at a position ≥ ``max_len`` is dropped, as the
    reference's scatter drops it."""
    c = _caster(compute_dtype, cast_cache)
    embed, pos_emb = params[0], params[1]
    w = token.shape[0]
    dh = cfg.d_model // cfg.n_heads
    dev = token.device
    t = cache.pos[:w].clone()  # [w] per-slot positions
    slots = torch.arange(w, device=dev)
    h = c(_take(embed, token) + _take(pos_emb, t))  # [w, d]
    #: slot s may read rows [0, t_s] — its own history plus this step's
    mask = torch.arange(cfg.max_len, device=dev)[None, :] <= t[:, None]
    ok = (t >= 0) & (t < cfg.max_len)
    t_in = torch.where(ok, t, torch.zeros_like(t))
    keep = ok[:, None, None]
    scale = dh**-0.5

    idx = 2
    for layer in range(cfg.n_layers):

        def attn(x, wq, wk, wv, layer=layer):
            q = _mm(x, wq).reshape(w, 1, cfg.n_heads, dh)
            k = _mm(x, wk).reshape(w, cfg.n_heads, dh)
            v = _mm(x, wv).reshape(w, cfg.n_heads, dh)
            for buf, new in ((cache.k[layer], k), (cache.v[layer], v)):
                # a dropped write rewrites the row it would have hit with
                # that row's own value
                cur = buf[slots, t_in]
                buf[slots, t_in] = torch.where(keep, new.to(buf.dtype), cur)
            return _attend(
                q, cache.k[layer, :w], cache.v[layer, :w],
                mask[:, None, None, :], scale,
            ).reshape(w, cfg.d_model)

        h = _block(h, params[idx: idx + PARAMS_PER_LAYER], c, attn)
        idx += PARAMS_PER_LAYER
    h = layer_norm(h, params[idx], params[idx + 1])
    logits = _logits(c(h), c(embed))
    cache.pos[:w] += 1
    return logits, cache


# ── paged (block-table) shared cache ─────────────────────────────────────
#
# k/v live in ONE pool of fixed-size blocks and each slot carries a block
# table mapping logical pages to pool blocks (PagedAttention; prefix
# sharing after RadixAttention). Block 0 is the TRASH block: never
# allocated, the scatter target for pad positions, frozen rows and freed
# slots, never read unmasked. Several rows may hit one trash offset in
# one step: the write is a plain index_put_ (no accumulate) whose winner
# nobody reads.


class PagedKVCache(NamedTuple):
    """Block-pool key/value cache shared by independent requests.

    ``k``/``v``: [n_layers, num_blocks, block, n_heads, head_dim];
    ``pos``: [S] int64 per-slot valid-row counts. Logical row ``j`` of
    slot ``s`` lives at block ``table[s, j // block]``, offset
    ``j % block``; the table is a separate argument (engine-owned)."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


def init_paged_cache(
    cfg: TransformerConfig,
    slots: int,
    num_blocks: int,
    block: int,
    dtype: Any = torch.float32,
    device: str | torch.device = "cuda",
) -> PagedKVCache:
    dh = cfg.d_model // cfg.n_heads
    shape = (cfg.n_layers, num_blocks, block, cfg.n_heads, dh)
    dev = resolve(device)
    dt = resolve_dtype(dtype)
    # zeros: the trash block is read (masked) by free slots and frozen rows
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dt, device=dev),
        v=torch.zeros(shape, dtype=dt, device=dev),
        pos=torch.zeros((slots,), dtype=torch.int64, device=dev),
    )


def paged_prefill_chunk(
    params: Sequence[torch.Tensor],
    cache: PagedKVCache,
    table: torch.Tensor,
    slot: int,
    chunk: torch.Tensor,
    start: int,
    length: int,
    cfg: TransformerConfig = TransformerConfig(),
    compute_dtype: Any | None = None,
    cast_cache: dict | None = None,
) -> tuple[torch.Tensor, PagedKVCache]:
    """Dense prefill of one slot's prompt SUFFIX through its block table.

    ``chunk``: [Pb], the prompt's tokens from ``start`` on, padded to a
    bucket; ``start``: the global position of ``chunk[0]`` (0, or the
    block-aligned length of a shared prefix already mapped into
    ``table[slot]``); ``length``: the TOTAL prompt length. Returns the
    logits at position ``length - 1`` and the cache with the chunk's rows
    written through the table and ``pos[slot] = length``.

    Attention reads the slot's logical rows [0, max_pages*block) masked
    to ``l <= start + p`` — a continuation chunk reads the shared prefix
    it did not compute. Pad positions scatter into trash block 0, never
    into an allocated page, so a SHARED page is never written: the whole
    copy-on-write discipline."""
    c = _caster(compute_dtype, cast_cache)
    embed, pos_emb = params[0], params[1]
    Pb = chunk.shape[0]
    block = cache.k.shape[2]
    max_pages = table.shape[1]
    rows = max_pages * block
    dh = cfg.d_model // cfg.n_heads
    dev = chunk.device
    ar = torch.arange(Pb, device=dev)
    positions = start + ar  # global positions, unclipped
    h = c(_take(embed, chunk) + pos_emb[positions.clamp(max=cfg.max_len - 1)])
    row = table[_clip(slot, table.shape[0])]  # [max_pages]
    real = ar < (length - start)
    page = (positions // block).clamp(max=max_pages - 1)
    #: pad scatter targets route to trash block 0 — a pad row must never
    #: land in a real page (it could be SHARED with another request)
    blk = torch.where(real, row[page], 0)
    off = torch.where(real, positions % block, 0)
    mask = torch.arange(rows, device=dev)[None, :] <= positions[:, None]  # [Pb, rows]
    scale = dh**-0.5

    idx = 2
    for layer in range(cfg.n_layers):

        def attn(x, wq, wk, wv, layer=layer):
            q = _mm(x, wq).reshape(1, Pb, cfg.n_heads, dh)
            # round k/v through the CACHE dtype before attending
            k = _mm(x, wk).reshape(Pb, cfg.n_heads, dh).to(cache.k.dtype)
            v = _mm(x, wv).reshape(Pb, cfg.n_heads, dh).to(cache.v.dtype)
            cache.k[layer].index_put_((blk, off), k)
            cache.v[layer].index_put_((blk, off), v)
            k_rows = cache.k[layer][row].reshape(1, rows, cfg.n_heads, dh)
            v_rows = cache.v[layer][row].reshape(1, rows, cfg.n_heads, dh)
            return _attend(q, k_rows, v_rows, mask, scale).reshape(Pb, cfg.d_model)

        h = _block(h, params[idx: idx + PARAMS_PER_LAYER], c, attn)
        idx += PARAMS_PER_LAYER
    h_last = h[_clip(length - 1 - start, Pb)]
    h_last = layer_norm(h_last, params[idx], params[idx + 1])
    logits = _logits(c(h_last)[None], c(embed))[0]
    _set_pos(cache.pos, slot, length)
    return logits, cache


def paged_decode_step(
    params: Sequence[torch.Tensor],
    cache: PagedKVCache,
    table: torch.Tensor,
    token: torch.Tensor,
    cfg: TransformerConfig = TransformerConfig(),
    compute_dtype: Any | None = None,
    active: torch.Tensor | None = None,
    cast_cache: dict | None = None,
) -> tuple[torch.Tensor, PagedKVCache]:
    """One decode step for the first ``w`` slots through their block
    tables — the paged twin of :func:`decode_step_slots`. A free slot has
    a zeroed table row, so its garbage write lands in trash block 0.

    ``active`` ([w] bool, optional) freezes rows: a frozen row's k/v
    write routes to trash block 0 and its ``pos`` does not advance, so
    its cache state is exactly as if the step never ran for it — what
    lets the fused multi-step program keep stepping a batch after some
    rows finish. An active row's numerics are untouched by the mask."""
    c = _caster(compute_dtype, cast_cache)
    embed, pos_emb = params[0], params[1]
    w = token.shape[0]
    block = cache.k.shape[2]
    max_pages = table.shape[1]
    rows = max_pages * block
    dh = cfg.d_model // cfg.n_heads
    dev = token.device
    t = cache.pos[:w].clone()  # [w] per-slot positions
    tw = table[:w]  # [w, max_pages]
    page = (t // block).clamp(max=max_pages - 1)
    blk = tw.gather(1, page[:, None])[:, 0]  # [w]
    off = t % block
    if active is not None:
        blk = torch.where(active, blk, 0)  # frozen rows scatter to trash
    h = c(_take(embed, token) + pos_emb[t.clamp(max=cfg.max_len - 1)])
    mask = torch.arange(rows, device=dev)[None, :] <= t[:, None]  # [w, rows]
    scale = dh**-0.5

    idx = 2
    for layer in range(cfg.n_layers):

        def attn(x, wq, wk, wv, layer=layer):
            q = _mm(x, wq).reshape(w, 1, cfg.n_heads, dh)
            k = _mm(x, wk).reshape(w, cfg.n_heads, dh)
            v = _mm(x, wv).reshape(w, cfg.n_heads, dh)
            cache.k[layer].index_put_((blk, off), k.to(cache.k.dtype))
            cache.v[layer].index_put_((blk, off), v.to(cache.v.dtype))
            k_rows = cache.k[layer][tw].reshape(w, rows, cfg.n_heads, dh)
            v_rows = cache.v[layer][tw].reshape(w, rows, cfg.n_heads, dh)
            return _attend(
                q, k_rows, v_rows, mask[:, None, None, :], scale
            ).reshape(w, cfg.d_model)

        h = _block(h, params[idx: idx + PARAMS_PER_LAYER], c, attn)
        idx += PARAMS_PER_LAYER
    h = layer_norm(h, params[idx], params[idx + 1])
    logits = _logits(c(h), c(embed))
    if active is None:
        cache.pos[:w] += 1
    else:
        cache.pos[:w] += active.to(cache.pos.dtype)
    return logits, cache


def paged_verify_chunk(
    params: Sequence[torch.Tensor],
    cache: PagedKVCache,
    table: torch.Tensor,
    tokens: torch.Tensor,
    cfg: TransformerConfig = TransformerConfig(),
    compute_dtype: Any | None = None,
    active: torch.Tensor | None = None,
    cast_cache: dict | None = None,
) -> tuple[torch.Tensor, PagedKVCache]:
    """Speculative VERIFY pass: ``K`` consecutive tokens per slot in one
    wide step through the block tables.

    ``tokens``: [w, K] — slot ``s`` feeds positions ``pos[s] ..
    pos[s]+K-1``; their k/v are written through the table and the logits
    [w, K, vocab] give the target's next-token distribution at each of
    the K positions. ``pos`` is NOT advanced (the caller advances by the
    accepted count). Positions past the slot's table, and the whole row
    where ``active`` is False, scatter into trash block 0."""
    c = _caster(compute_dtype, cast_cache)
    embed, pos_emb = params[0], params[1]
    w, K = tokens.shape
    block = cache.k.shape[2]
    max_pages = table.shape[1]
    rows = max_pages * block
    dh = cfg.d_model // cfg.n_heads
    dev = tokens.device
    t0 = cache.pos[:w].clone()  # [w]
    tw = table[:w]  # [w, max_pages]
    positions = t0[:, None] + torch.arange(K, device=dev)[None, :]  # [w, K]
    valid = positions < rows
    page = (positions // block).clamp(max=max_pages - 1)
    blk = tw.gather(1, page)  # [w, K]
    if active is not None:
        valid = valid & active[:, None]
    blk = torch.where(valid, blk, 0)
    off = torch.where(valid, positions % block, 0)
    h = c(_take(embed, tokens) + pos_emb[positions.clamp(max=cfg.max_len - 1)])
    #: query j of slot s sees rows [0, t0_s + j]
    mask = torch.arange(rows, device=dev)[None, None, :] <= positions[:, :, None]
    scale = dh**-0.5

    idx = 2
    for layer in range(cfg.n_layers):

        def attn(x, wq, wk, wv, layer=layer):
            q = _mm(x, wq).reshape(w, K, cfg.n_heads, dh)
            k = _mm(x, wk).reshape(w, K, cfg.n_heads, dh)
            v = _mm(x, wv).reshape(w, K, cfg.n_heads, dh)
            cache.k[layer].index_put_((blk, off), k.to(cache.k.dtype))
            cache.v[layer].index_put_((blk, off), v.to(cache.v.dtype))
            k_rows = cache.k[layer][tw].reshape(w, rows, cfg.n_heads, dh)
            v_rows = cache.v[layer][tw].reshape(w, rows, cfg.n_heads, dh)
            return _attend(
                q, k_rows, v_rows, mask[:, None, :, :], scale
            ).reshape(w, K, cfg.d_model)

        h = _block(h, params[idx: idx + PARAMS_PER_LAYER], c, attn)
        idx += PARAMS_PER_LAYER
    h = layer_norm(h, params[idx], params[idx + 1])
    logits = _logits(c(h), c(embed))
    return logits, cache


def truncated_draft(
    cfg: TransformerConfig,
    params: Sequence[torch.Tensor],
    n_layers: int,
) -> tuple[TransformerConfig, list[torch.Tensor]]:
    """The self-speculative DRAFT: the same checkpoint truncated to its
    first ``n_layers`` blocks, reusing the full model's embeddings and
    final layer norm as its head (the same tensors, no copy). The target
    verifies every proposal, so draft quality moves only the acceptance
    rate, never correctness."""
    if not 1 <= n_layers < cfg.n_layers:
        raise ValueError(
            f"draft must keep between 1 and {cfg.n_layers - 1} of the "
            f"model's {cfg.n_layers} layers, got {n_layers}"
        )
    draft_cfg = TransformerConfig(
        vocab=cfg.vocab, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_layers=n_layers, d_ff=cfg.d_ff, max_len=cfg.max_len,
    )
    draft_params = (
        list(params[: 2 + PARAMS_PER_LAYER * n_layers]) + list(params[-2:])
    )
    return draft_cfg, draft_params


def generate(
    params: Sequence[torch.Tensor],
    prompt: torch.Tensor,
    n_new: int,
    cfg: TransformerConfig = TransformerConfig(),
    temperature: float | torch.Tensor = 0.0,
    key: torch.Tensor | None = None,
    compute_dtype: Any | None = None,
    cache_dtype: Any | None = None,
    cast_cache: dict | None = None,
) -> torch.Tensor:
    """Generate ``n_new`` tokens after a [B, P] prompt on the prompt's
    device; returns [B, n_new] in the prompt's dtype.

    ``temperature == 0``: greedy argmax. Otherwise softmax sampling at the
    given temperature (``key``, a :mod:`~pygrid_tpu_torch.utils.prng` key,
    required); a tensor ``temperature`` is the reference's traced one: a
    zero falls back to greedy. ``cache_dtype`` narrows the KV cache
    (defaults to ``compute_dtype`` when set, else f32). One prefill, then
    exactly ``n_new - 1`` decode steps; no step waits on the device."""
    if prompt.shape[1] + n_new > cfg.max_len:
        raise ValueError(
            f"prompt ({prompt.shape[1]}) + n_new ({n_new}) exceeds "
            f"max_len ({cfg.max_len})"
        )
    temp_is_static = isinstance(temperature, (int, float))
    if temp_is_static and temperature < 0.0:
        # the tensor path clamps negatives to greedy; the static path
        # would sample the LEAST likely tokens — reject instead
        raise ValueError("temperature must be >= 0")
    if temp_is_static and temperature > 0.0 and key is None:
        raise ValueError("sampling (temperature > 0) requires a PRNG key")
    if not temp_is_static and key is None:
        raise ValueError("a traced temperature requires a PRNG key")
    greedy = key is None or (temp_is_static and temperature == 0.0)

    kv_dtype = (
        cache_dtype
        if cache_dtype is not None
        else (compute_dtype if compute_dtype is not None else torch.float32)
    )
    dev = prompt.device
    cache = init_cache(cfg, prompt.shape[0], dtype=kv_dtype, device=dev)
    logits, cache = prefill(params, cache, prompt, cfg, compute_dtype, cast_cache)

    def pick(logits, k):
        if greedy:
            return torch.argmax(logits, dim=-1).to(prompt.dtype)
        if temp_is_static:
            return prng.categorical(k, logits / temperature).to(prompt.dtype)
        # tensor temperature: a runtime zero falls back to greedy (logits
        # / 0 is NaN); one path serves every temperature including zero
        t = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
        safe_t = torch.where(t > 0.0, t, torch.ones_like(t))
        sampled = prng.categorical(k, logits / safe_t)
        return torch.where(t > 0.0, sampled, torch.argmax(logits, dim=-1)).to(prompt.dtype)

    keys = (
        prng.split(key.to(dev), n_new)
        if key is not None
        else torch.zeros((n_new, 2), dtype=torch.int64, device=dev)
    )
    tok = pick(logits, keys[0])
    out = [tok]
    for i in range(1, n_new):
        logits, cache = decode_step(params, cache, tok, cfg, compute_dtype, cast_cache)
        tok = pick(logits, keys[i])
        out.append(tok)
    return torch.stack(out, dim=1)
