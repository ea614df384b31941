"""Decoder-only transformer — the federated transformer round's model.

Counterpart of :mod:`pygrid_tpu.models.transformer`, with its public
contracts: ``init`` returns the same flat param list (``embed, pos``, 12
per layer, ``ln_f_s, ln_f_b``), attention is injectable and works in
``[B, L, H, D]``, and ``make_training_step`` builds the
``(X, y, lr, *params) -> (loss, acc, *new_params)`` step.

Numerics follow the reference: layer-norm statistics in f32 with the
population variance, GELU in its tanh form (``jax.nn.gelu``'s default),
the matmul path in ``compute_dtype`` with f32 master params, and vocab
logits accumulated and returned in f32 whatever the compute dtype. The
head, the loss and the SGD step are :mod:`.lm`'s, which every decoder of
the port shares.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.models import lm
from pygrid_tpu_torch.parallel.ring_attention import attention
from pygrid_tpu_torch.utils import prng
from pygrid_tpu_torch.utils.profiling import region


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


def layer_norm(x, scale, bias, eps=1e-6):
    # norm statistics always in f32 — bf16 mean/variance drifts
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


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
    cd = lm.resolve_dtype(compute_dtype)

    def c(x):
        return lm.cast(x, cd)

    embed, pos = params[0], params[1]
    B, L = tokens.shape
    with region("pgt.model.embed"):
        h = c(embed[tokens] + pos[:L])
    dh = cfg.d_model // cfg.n_heads

    def block(h, ln1_s, ln1_b, wq, wk, wv, wo, ln2_s, ln2_b, w1, b1, w2, b2):
        # inside the remat wrapper, so its recompute in the backward is one too
        with region("pgt.model.block"):
            x = c(layer_norm(h, ln1_s, ln1_b))
            q = (x @ c(wq)).reshape(B, L, cfg.n_heads, dh)
            k = (x @ c(wk)).reshape(B, L, cfg.n_heads, dh)
            v = (x @ c(wv)).reshape(B, L, cfg.n_heads, dh)
            a = attn_fn(q, k, v, causal=True).reshape(B, L, cfg.d_model)
            h = h + c(a) @ c(wo)
            x = c(layer_norm(h, ln2_s, ln2_b))
            mlp = F.gelu(x @ c(w1) + c(b1), approximate="tanh")
            return h + c(mlp) @ c(w2) + c(b2)

    block_fn = lm.remat_block(block, remat)
    idx = 2
    for _ in range(cfg.n_layers):
        h = block_fn(h, tuple(params[idx: idx + PARAMS_PER_LAYER]))
        idx += PARAMS_PER_LAYER
    return layer_norm(h, params[idx], params[idx + 1])


def apply(
    params: Sequence[torch.Tensor],
    tokens: torch.Tensor,
    cfg: TransformerConfig = TransformerConfig(),
    attn_fn: Callable | None = None,
    remat: bool | str = False,
    compute_dtype: Any | None = None,
) -> torch.Tensor:
    """Logits [B, L, vocab] in f32 for int tokens [B, L]; causal."""
    h = features(params, tokens, cfg, attn_fn, remat=remat, compute_dtype=compute_dtype)
    B, L, d = h.shape
    cd = lm.resolve_dtype(compute_dtype)
    return lm.logits(h.reshape(B * L, d), params[0], cd).reshape(B, L, -1)


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
    """Token-level CE (int targets y [B, L]) and accuracy through the tied
    embedding: :func:`.lm.head_loss`, whose head ``ce_chunk`` (checkpointed
    chunks of that many tokens) or ``ce_grad_dtype`` (:class:`.lm.CEHead`'s
    narrow-dtype backward) picks."""
    h = features(params, X, cfg, attn_fn, remat=remat, compute_dtype=compute_dtype)
    return lm.head_loss(
        h, params[0], y, lm.resolve_dtype(compute_dtype), ce_grad_dtype, ce_chunk
    )


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
    return lm.make_sgd_step(partial(
        loss_and_acc, cfg=cfg, attn_fn=attn_fn, remat=remat, compute_dtype=compute_dtype,
        ce_chunk=ce_chunk, ce_grad_dtype=ce_grad_dtype,
    ))


#: default-config step, as the reference module has
training_step = make_training_step()
