"""What every decoder of the port shares between its last hidden state and
its loss.

A decoder (:mod:`.transformer`, :mod:`.deepseek_v3`) ends in a ``[V, d]``
head matrix (GPT-2's tied embedding, DeepSeek-V3's untied head) and a
token-level cross-entropy. This module holds that decision once:

- the compute-dtype policy (:func:`resolve_dtype`, :func:`cast`): f32
  master params, operands narrowed at use;
- the f32-accumulated product (:func:`dot_f32`) and the vocabulary logits
  (:func:`logits`);
- the remat wrapper of a decoder block (:func:`remat_block`);
- the CE head with a narrow-dtype backward (:class:`CEHead`) at the padded
  vocabulary width (:data:`VOCAB_ALIGN`), with its counters and its spans
  ``pgt.model.head.fwd`` and ``pgt.model.head.bwd``;
- the loss through its three heads (:func:`head_loss`) and the SGD step
  built from a model's ``loss_and_acc`` (:func:`make_sgd_step`).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from pygrid_tpu_torch.utils.profiling import region


def resolve_dtype(compute_dtype: Any) -> torch.dtype | None:
    """None, a torch dtype, or a dtype name such as ``"bfloat16"``."""
    if compute_dtype is None or isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    return getattr(torch, str(compute_dtype))


def cast(x: torch.Tensor, cd: torch.dtype | None) -> torch.Tensor:
    """The ONE compute-dtype cast policy (None = no cast): the decoders'
    features, the logits and the CE head all narrow operands through it."""
    return x.to(cd) if cd is not None else x


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 2-D operands accumulated and returned in f32 — the
    reference's ``preferred_element_type=float32``. Narrow operands go to
    the card's native-dtype product with an f32 output; on the CPU they are
    widened first, which is exact (a bf16 product fits in f32)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def logits(h: torch.Tensor, w: torch.Tensor, cd: torch.dtype | None) -> torch.Tensor:
    """f32 logits [N, V] of ``h`` [N, d] against the head matrix ``w``
    [V, d], both cast to ``cd``: logits accumulate in f32 regardless of the
    compute dtype — vocab softmax is where bf16 resolution actually bites."""
    return dot_f32(cast(h, cd), cast(w, cd).T)


def _save_dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the matmul outputs (the reference's
    ``dots_saveable`` policy) and recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.bmm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_block(block: Callable, remat: bool | str) -> Callable:
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


#: the CE head runs its vocabulary axis at a multiple of this many columns:
#: rows of 16 bytes in bf16 and in f32, which cuBLAS's Hopper (TMA-fed
#: ``wgmma``) GEMMs need. At an odd width (GPT-2's 50,257) all four head
#: products fall back to sm75 ``mma`` kernels of 1-element alignment.
VOCAB_ALIGN = 8

#: :class:`CEHead` forwards since the last :func:`reset_head_counts`: all,
#: those at a padded width, and the pad columns those added
head_calls = 0
head_padded_calls = 0
head_pad_columns = 0


def head_counts() -> dict[str, int]:
    return {
        "calls": head_calls,
        "padded_calls": head_padded_calls,
        "pad_columns": head_pad_columns,
    }


def reset_head_counts() -> None:
    global head_calls, head_padded_calls, head_pad_columns
    head_calls = head_padded_calls = head_pad_columns = 0


def _padded_embed(embed: torch.Tensor, cd: torch.dtype | None) -> torch.Tensor:
    """``embed`` [V, d] cast to ``cd`` at [Vp, d], Vp the next multiple of
    :data:`VOCAB_ALIGN`, with zero rows past V; the plain cast when V is
    a multiple already."""
    V, d = embed.shape
    Vp = -(-V // VOCAB_ALIGN) * VOCAB_ALIGN
    if Vp == V:
        return cast(embed, cd)
    out = embed.new_empty((Vp, d), dtype=cd or embed.dtype)
    out[:V].copy_(embed)
    out[V:].zero_()
    return out


def _head_logits(
    h2: torch.Tensor, embed: torch.Tensor, cd: torch.dtype | None
) -> torch.Tensor:
    """f32 logits [N, Vp] of ``h2`` against the padded head matrix, both
    cast to ``cd``, with the pad columns at -inf: they add exp(-inf) = 0 to
    the log-sum-exp and never win the argmax. The padded cast lives only
    for the product, so it is not held across the head's [N, Vp]
    temporaries."""
    logits = dot_f32(cast(h2, cd), _padded_embed(embed, cd).T)
    logits[:, embed.shape[0]:].fill_(float("-inf"))
    return logits


class CEHead(torch.autograd.Function):
    """CE head over a [V, d] head matrix with a narrow-dtype backward.

    Forward: operands cast to ``fwd_cd`` (the model's compute dtype),
    logits f32-accumulated, f32 log-sum-exp — the plain path's numerics.
    Backward: the logits are RECOMPUTED (the f32 [N, vocab] tensor is never
    saved; 6.59 GB at GPT-2 small's 32,768 tokens a round), and
    ``dlogits = softmax - onehot`` and both gradient-matmul operands are
    cast to ``bwd_cd`` so the two products run in the native dtype.
    Both directions run at the padded width Vp (:data:`VOCAB_ALIGN`): the
    head matrix's cast copy gets zero rows past V, the pad logits are -inf,
    so their softmax and ``dlogits`` are exactly 0, and the head matrix's
    gradient keeps its first V rows. Returns ``(loss_sum, hit_sum)``."""

    @staticmethod
    def forward(ctx, h2, embed, y1, fwd_cd, bwd_cd):
        global head_calls, head_padded_calls, head_pad_columns
        with region("pgt.model.head.fwd"):
            logits = _head_logits(h2, embed, fwd_cd)
            pad = logits.shape[1] - embed.shape[0]
            head_calls += 1
            head_padded_calls += int(pad > 0)
            head_pad_columns += pad
            lse = torch.logsumexp(logits, dim=-1)
            logit_y = logits.gather(1, y1[:, None])[:, 0]
            hits = (logits.argmax(-1) == y1).float().sum()
            ctx.save_for_backward(h2, embed, y1, lse)
            ctx.fwd_cd, ctx.bwd_cd = fwd_cd, bwd_cd
            ctx.mark_non_differentiable(hits)
            return (lse - logit_y).sum(), hits

    @staticmethod
    def backward(ctx, g_loss, _g_hits):
        with region("pgt.model.head.bwd"):
            h2, embed, y1, lse = ctx.saved_tensors
            fwd_cd, bwd_cd = ctx.fwd_cd, ctx.bwd_cd
            logits = _head_logits(h2, embed, fwd_cd)
            p = torch.exp(logits - lse[:, None])
            # softmax - onehot, in place on the recomputed tensor: no second
            # [N, vocab] buffer for the one-hot
            p[torch.arange(p.shape[0], device=p.device), y1] -= 1.0
            dlogits = (p * g_loss).to(bwd_cd)
            dh = dot_f32(dlogits, _padded_embed(embed, bwd_cd))
            dembed = dot_f32(dlogits.T, h2.to(bwd_cd))[: embed.shape[0]]
            return dh.to(h2.dtype), dembed.to(embed.dtype), None, None, None


def head_loss(
    h: torch.Tensor,
    w: torch.Tensor,
    y: torch.Tensor,
    cd: torch.dtype | None = None,
    ce_grad_dtype: Any | None = None,
    ce_chunk: int | None = None,
):
    """Token-level CE and accuracy of final hidden states ``h`` [B, L, d]
    against the head matrix ``w`` [V, d] for int targets ``y`` [B, L],
    with the matmul operands in ``cd``.

    Three heads: the plain f32 log-softmax over the whole [B, L, V] logits;
    ``ce_chunk``, the vocab projection and softmax-CE in chunks of that
    many tokens, each checkpointed, so the [B·L, vocab] logits never exist
    whole in either direction (``B·L`` must divide by it); and
    ``ce_grad_dtype``, :class:`CEHead`'s narrow-dtype backward."""
    B, L, d = h.shape
    N = B * L
    if ce_grad_dtype is not None:
        if ce_chunk is not None:
            raise ValueError(
                "ce_chunk and ce_grad_dtype are mutually exclusive — "
                "the narrow-backward head materializes full logits "
                "transiently, which is exactly what ce_chunk avoids; "
                "pick the one whose constraint (HBM vs matmul rate) "
                "binds"
            )
        loss_sum, hit_sum = CEHead.apply(
            h.reshape(N, d), w, y.reshape(N), cd, resolve_dtype(ce_grad_dtype)
        )
        return loss_sum / N, hit_sum / N
    if ce_chunk is None:
        z = logits(h.reshape(N, d), w, cd).reshape(B, L, -1)
        logp = torch.log_softmax(z, dim=-1)
        loss = -logp.gather(-1, y[..., None]).mean()
        acc = (z.argmax(-1) == y).float().mean()
        return loss, acc

    if N % ce_chunk:
        raise ValueError(f"ce_chunk={ce_chunk} must divide the token count {N}")
    hf = h.reshape(N // ce_chunk, ce_chunk, d)
    yf = y.reshape(N // ce_chunk, ce_chunk)

    def chunk_stats(h_blk, y_blk, w):
        z = logits(h_blk, w, cd)
        lse = torch.logsumexp(z, dim=-1)
        logit_y = z.gather(1, y_blk[:, None])[:, 0]
        hits = (z.argmax(-1) == y_blk).float()
        return (lse - logit_y).sum(), hits.sum()

    loss_sum = hit_sum = 0.0
    for i in range(hf.shape[0]):
        dl, dh = checkpoint(chunk_stats, hf[i], yf[i], w, use_reentrant=False)
        loss_sum = loss_sum + dl
        hit_sum = hit_sum + dh
    return loss_sum / N, hit_sum / N


def make_sgd_step(loss_and_acc: Callable) -> Callable:
    """SGD step ``(X, y, lr, *params) -> (loss, acc, *new_params)`` from
    ``loss_and_acc(params, X, y) -> (loss, acc)``: the gradient at detached
    f32 leaves (the compute-dtype casts are differentiable, so gradients
    come back in f32), then ``p - lr * g``."""

    def training_step(X, y, lr, *params):
        leaves = [p.detach().requires_grad_() for p in params]
        loss, acc = loss_and_acc(leaves, X, y)
        grads = torch.autograd.grad(loss, leaves)
        new_params = [p.detach() - lr * g for p, g in zip(params, grads)]
        return (loss.detach(), acc.detach(), *new_params)

    return training_step
