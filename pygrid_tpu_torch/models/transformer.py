"""Decoder-only transformer — the federated transformer round's model.

Counterpart of :mod:`pygrid_tpu.models.transformer`, with its public
contracts: ``init`` returns the same flat param list (``embed, pos``, 12
per layer, ``ln_f_s, ln_f_b``), attention is injectable and works in
``[B, L, H, D]``, and ``make_training_step`` builds the
``(X, y, lr, *params) -> (loss, acc, *new_params)`` step.

Numerics follow the reference: layer-norm statistics in f32 with the
population variance, GELU in its tanh form (``jax.nn.gelu``'s default),
the matmul path in ``compute_dtype`` with f32 master params, and vocab
logits accumulated and returned in f32 whatever the compute dtype.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.parallel.ring_attention import attention
from pygrid_tpu_torch.utils import prng


class TransformerConfig(NamedTuple):
    vocab: int = 128
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    max_len: int = 256


PARAMS_PER_LAYER = 12  # ln1(2) + attn(4) + ln2(2) + mlp(4)
N_GLOBAL = 4  # embed, pos, ln_f scale/bias


def param_shapes(cfg: TransformerConfig) -> list[tuple[int, ...]]:
    """Shapes of the flat param list, in order."""
    d, f = cfg.d_model, cfg.d_ff
    layer = [(d,), (d,), (d, d), (d, d), (d, d), (d, d), (d,), (d,),
             (d, f), (f,), (f, d), (d,)]
    return [(cfg.vocab, d), (cfg.max_len, d)] + layer * cfg.n_layers + [(d,), (d,)]


def init(
    cfg: TransformerConfig = TransformerConfig(),
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> list[torch.Tensor]:
    """Flat f32 param list: [embed, pos, (12 per layer)*n_layers, ln_f_s,
    ln_f_b], drawn on the CPU from ``generator`` (seed 0 when None) and
    moved to ``device``. The output projection is tied to the embedding.
    The draws differ from the reference's ``jax.random`` ones; parity
    tests carry the reference's params across with :mod:`..convert`."""
    dev = resolve(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    return [p.to(dev) for p in _draw(cfg, lambda shape: torch.randn(shape, generator=g))]


def _draw(cfg: TransformerConfig, normal: Callable) -> list[torch.Tensor]:
    """The flat param list on the CPU, each weight ``normal(shape)`` times
    its scale, in the reference's order of draws."""
    d, f = cfg.d_model, cfg.d_ff
    sd = d**-0.5
    params = [normal((cfg.vocab, d)) * sd, normal((cfg.max_len, d)) * sd]
    for _ in range(cfg.n_layers):
        params += [torch.ones(d), torch.zeros(d)]  # ln1
        params += [normal((d, d)) * sd for _ in range(4)]  # wq wk wv wo
        params += [torch.ones(d), torch.zeros(d)]  # ln2
        params += [normal((d, f)) * sd, torch.zeros(f), normal((f, d)) * f**-0.5,
                   torch.zeros(d)]
    params += [torch.ones(d), torch.zeros(d)]  # final ln
    return params


def init_from_key(
    key: torch.Tensor,
    cfg: TransformerConfig = TransformerConfig(),
    device: str | torch.device = "cuda",
) -> list[torch.Tensor]:
    """The reference's ``transformer.init(key, cfg)``: the same
    ``jax.random`` draws through :mod:`pygrid_tpu_torch.utils.prng` (each
    weight within a few f32 ulps), for a threefry ``key`` ``[2]``, moved
    to ``device``."""
    dev = resolve(device)
    keys = iter(prng.split(key.cpu(), 2 + 6 * cfg.n_layers))
    return [p.to(dev) for p in _draw(cfg, lambda shape: prng.normal(next(keys), shape))]


def _dtype(compute_dtype: Any) -> torch.dtype | None:
    """None, a torch dtype, or a dtype name such as ``"bfloat16"``."""
    if compute_dtype is None or isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    return getattr(torch, str(compute_dtype))


def _cast(x: torch.Tensor, cd: torch.dtype | None) -> torch.Tensor:
    """The ONE compute-dtype cast policy (None = no cast): apply,
    features, the loss and the CE head all narrow operands through it."""
    return x.to(cd) if cd is not None else x


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 2-D operands accumulated and returned in f32 — the
    reference's ``preferred_element_type=float32``. Narrow operands go to
    the card's native-dtype product with an f32 output; on the CPU they are
    widened first, which is exact (a bf16 product fits in f32)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _ln(x, scale, bias, eps=1e-6):
    # norm statistics always in f32 — bf16 mean/variance drifts
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _save_dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the matmul outputs (the reference's
    ``dots_saveable`` policy) and recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.bmm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(block: Callable, remat: bool | str) -> Callable:
    """``remat=True`` recomputes each block's activations in the backward
    (``torch.utils.checkpoint``); ``"dots"`` keeps the matmul outputs and
    recomputes the rest; False stores everything. Memory, never math."""
    if remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        ctx_fn = partial(create_selective_checkpoint_contexts, _save_dots_policy)
        return lambda h, lp: checkpoint(block, h, *lp, use_reentrant=False, context_fn=ctx_fn)
    if remat:
        return lambda h, lp: checkpoint(block, h, *lp, use_reentrant=False)
    return lambda h, lp: block(h, *lp)


def features(
    params: Sequence[torch.Tensor],
    tokens: torch.Tensor,
    cfg: TransformerConfig = TransformerConfig(),
    attn_fn: Callable | None = None,
    remat: bool | str = False,
    compute_dtype: Any | None = None,
) -> torch.Tensor:
    """Final hidden states [B, L, d] (post ln_f, pre output projection)."""
    attn_fn = attn_fn or attention
    cd = _dtype(compute_dtype)

    def c(x):
        return _cast(x, cd)

    embed, pos = params[0], params[1]
    B, L = tokens.shape
    h = c(embed[tokens] + pos[:L])
    dh = cfg.d_model // cfg.n_heads

    def block(h, ln1_s, ln1_b, wq, wk, wv, wo, ln2_s, ln2_b, w1, b1, w2, b2):
        x = c(_ln(h, ln1_s, ln1_b))
        q = (x @ c(wq)).reshape(B, L, cfg.n_heads, dh)
        k = (x @ c(wk)).reshape(B, L, cfg.n_heads, dh)
        v = (x @ c(wv)).reshape(B, L, cfg.n_heads, dh)
        a = attn_fn(q, k, v, causal=True).reshape(B, L, cfg.d_model)
        h = h + c(a) @ c(wo)
        x = c(_ln(h, ln2_s, ln2_b))
        mlp = F.gelu(x @ c(w1) + c(b1), approximate="tanh")
        return h + c(mlp) @ c(w2) + c(b2)

    block_fn = _remat(block, remat)
    idx = 2
    for _ in range(cfg.n_layers):
        h = block_fn(h, tuple(params[idx: idx + PARAMS_PER_LAYER]))
        idx += PARAMS_PER_LAYER
    return _ln(h, params[idx], params[idx + 1])


def apply(
    params: Sequence[torch.Tensor],
    tokens: torch.Tensor,
    cfg: TransformerConfig = TransformerConfig(),
    attn_fn: Callable | None = None,
    remat: bool | str = False,
    compute_dtype: Any | None = None,
) -> torch.Tensor:
    """Logits [B, L, vocab] in f32 for int tokens [B, L]; causal."""
    cd = _dtype(compute_dtype)
    h = features(params, tokens, cfg, attn_fn, remat=remat, compute_dtype=compute_dtype)
    B, L, d = h.shape
    # logits accumulate in f32 regardless of the compute dtype — vocab
    # softmax is where bf16 resolution actually bites
    logits = _dot_f32(_cast(h, cd).reshape(B * L, d), _cast(params[0], cd).T)
    return logits.reshape(B, L, -1)


class _CEHead(torch.autograd.Function):
    """Tied-embedding CE head with a narrow-dtype backward.

    Forward: operands cast to ``fwd_cd`` (the model's compute dtype),
    logits f32-accumulated, f32 log-sum-exp — the plain path's numerics.
    Backward: the logits are RECOMPUTED (the f32 [N, vocab] tensor is never
    saved; 537 MB at the flagship shape), and ``dlogits = softmax - onehot``
    and both gradient-matmul operands are cast to ``bwd_cd`` so the two
    products run in the native dtype. Returns ``(loss_sum, hit_sum)``."""

    @staticmethod
    def forward(ctx, h2, embed, y1, fwd_cd, bwd_cd):
        logits = _dot_f32(_cast(h2, fwd_cd), _cast(embed, fwd_cd).T)
        lse = torch.logsumexp(logits, dim=-1)
        logit_y = logits.gather(1, y1[:, None])[:, 0]
        hits = (logits.argmax(-1) == y1).float().sum()
        ctx.save_for_backward(h2, embed, y1, lse)
        ctx.fwd_cd, ctx.bwd_cd = fwd_cd, bwd_cd
        ctx.mark_non_differentiable(hits)
        return (lse - logit_y).sum(), hits

    @staticmethod
    def backward(ctx, g_loss, _g_hits):
        h2, embed, y1, lse = ctx.saved_tensors
        fwd_cd, bwd_cd = ctx.fwd_cd, ctx.bwd_cd
        logits = _dot_f32(_cast(h2, fwd_cd), _cast(embed, fwd_cd).T)
        p = torch.exp(logits - lse[:, None])
        # softmax - onehot, in place on the recomputed tensor: no second
        # [N, vocab] buffer for the one-hot
        p[torch.arange(p.shape[0], device=p.device), y1] -= 1.0
        dlogits = (p * g_loss).to(bwd_cd)
        dh = _dot_f32(dlogits, embed.to(bwd_cd))
        dembed = _dot_f32(dlogits.T, h2.to(bwd_cd))
        return dh.to(h2.dtype), dembed.to(embed.dtype), None, None, None


def loss_and_acc(
    params: Sequence[torch.Tensor],
    X: torch.Tensor,
    y: torch.Tensor,
    cfg: TransformerConfig = TransformerConfig(),
    attn_fn: Callable | None = None,
    remat: bool | str = False,
    compute_dtype: Any | None = None,
    ce_chunk: int | None = None,
    ce_grad_dtype: Any | None = None,
):
    """Token-level CE (int targets y [B, L]) and accuracy.

    ``ce_chunk``: the vocab projection and softmax-CE run in chunks of
    that many tokens, each checkpointed, so the [B·L, vocab] logits never
    exist whole in either direction; ``B·L`` must divide by it.
    ``ce_grad_dtype``: the CE head's narrow-dtype backward (:class:`_CEHead`)."""
    cd = _dtype(compute_dtype)
    embed = params[0]
    if ce_grad_dtype is not None:
        if ce_chunk is not None:
            raise ValueError(
                "ce_chunk and ce_grad_dtype are mutually exclusive — "
                "the narrow-backward head materializes full logits "
                "transiently, which is exactly what ce_chunk avoids; "
                "pick the one whose constraint (HBM vs matmul rate) "
                "binds"
            )
        h = features(params, X, cfg, attn_fn, remat=remat, compute_dtype=compute_dtype)
        N = h.shape[0] * h.shape[1]
        loss_sum, hit_sum = _CEHead.apply(
            h.reshape(N, cfg.d_model), embed, y.reshape(N), cd, _dtype(ce_grad_dtype)
        )
        return loss_sum / N, hit_sum / N
    if ce_chunk is None:
        logits = apply(params, X, cfg, attn_fn, remat=remat, compute_dtype=compute_dtype)
        logp = torch.log_softmax(logits, dim=-1)
        loss = -logp.gather(-1, y[..., None]).mean()
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, acc

    h = features(params, X, cfg, attn_fn, remat=remat, compute_dtype=compute_dtype)
    N = h.shape[0] * h.shape[1]
    if N % ce_chunk:
        raise ValueError(f"ce_chunk={ce_chunk} must divide the token count {N}")
    hf = h.reshape(N // ce_chunk, ce_chunk, cfg.d_model)
    yf = y.reshape(N // ce_chunk, ce_chunk)

    def chunk_stats(h_blk, y_blk, embed):
        logits = _dot_f32(_cast(h_blk, cd), _cast(embed, cd).T)
        lse = torch.logsumexp(logits, dim=-1)
        logit_y = logits.gather(1, y_blk[:, None])[:, 0]
        hits = (logits.argmax(-1) == y_blk).float()
        return (lse - logit_y).sum(), hits.sum()

    loss_sum = hit_sum = 0.0
    for i in range(hf.shape[0]):
        dl, dh = checkpoint(chunk_stats, hf[i], yf[i], embed, use_reentrant=False)
        loss_sum = loss_sum + dl
        hit_sum = hit_sum + dh
    return loss_sum / N, hit_sum / N


def make_training_step(
    cfg: TransformerConfig = TransformerConfig(),
    attn_fn: Callable | None = None,
    remat: bool | str = False,
    compute_dtype: Any | None = None,
    ce_chunk: int | None = None,
    ce_grad_dtype: Any | None = None,
) -> Callable:
    """SGD step: ``(X, y, lr, *params) -> (loss, acc, *new_params)``.

    Mixed precision with ``compute_dtype``: f32 master params, the matmul
    path narrowed at use, f32 gradients (the casts are differentiable)."""

    def training_step(X, y, lr, *params):
        leaves = [p.detach().requires_grad_() for p in params]
        loss, acc = loss_and_acc(
            leaves, X, y, cfg, attn_fn, remat=remat,
            compute_dtype=compute_dtype, ce_chunk=ce_chunk,
            ce_grad_dtype=ce_grad_dtype,
        )
        grads = torch.autograd.grad(loss, leaves)
        new_params = [p.detach() - lr * g for p, g in zip(params, grads)]
        return (loss.detach(), acc.detach(), *new_params)

    return training_step


#: default-config step, as the reference module has
training_step = make_training_step()
