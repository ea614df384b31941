"""AFMoE decoder (Arcee's Trinity-Mini block) for the FedAvg round.

No counterpart in the JAX package. The layer equations are those of the
published ``afmoe`` configurations and their modeling code (Arcee's, and
``transformers``' ``AfmoeForCausalLM``):

- ``h₀ = embed[tokens] · √d`` (muP's input scale, ``mup``); an untied head
  ``[vocab, d]`` after a final RMSNorm.
- Sandwich norms: each layer ``h += RMSNorm_post_attn(Attn(RMSNorm_in(h)))``,
  then ``h += RMSNorm_post_mlp(MLP(RMSNorm_pre_mlp(h)))``; every RMSNorm in
  f32, and the residual stream ``h`` in f32 with only the products'
  operands in the compute dtype: on the card a bf16 stream sets off more
  routing flips against an f32 reference, and its casts cost more time
  than the f32 adds.
- Attention: ``q = x W_q`` at ``n_heads``, ``k = x W_k`` and ``v = x W_v``
  at ``n_kv_heads`` (grouped-query attention: query head h reads K/V head
  ``h // (n_heads / n_kv_heads)``), ``g = x W_gate`` at ``n_heads · hd``;
  RMSNorm over each head of q and k (QK-norm); on the sliding layers RoPE
  in the rotate-half layout (pairs ``(i, i + hd/2)``) and a causal window of
  ``sliding_window`` keys, on the full layers no positional encoding
  (NoPE) and full causal attention; scale ``hd^-½``; then
  ``(attn ⊙ sigmoid(g)) W_o``. ``layer_types`` names each layer's kind.
- The first ``n_dense`` layers' MLP is a SwiGLU of width ``d_ff``; every
  later layer's is the shared expert (a SwiGLU of ``n_shared · moe_ff``)
  plus the routed experts this card holds
  (:func:`pygrid_tpu_torch.models.moe.topk_expert_layer`: sigmoid scores,
  top-k by ``s + bias``, weights ``s / Σ s · routed_scale``).

The contract is :mod:`.deepseek_v3`'s: a flat f32 parameter list,
``features``/``apply``/``loss_and_acc`` with the same options, and
``make_training_step``; the head, loss and step come from :mod:`.lm`, the
RMSNorm and the RoPE tables from :mod:`.deepseek_v3`. Attention runs
through ``attn_fn`` (default: the flash kernels), which must take k and v
at ``n_kv_heads`` and a ``window``. The routers' bias is a buffer
(``bias`` [MoE layers, n_experts]), never a gradient leaf.

Each attention sublayer's forward (the projections, QK-norm, RoPE, flash,
the gate and ``W_o``) runs inside the span ``pgt.attn.sliding`` or
``pgt.attn.full``; a recompute in a backward (``remat``) opens none.

Layout of the flat list (matrices ``[in, out]``, as ``x @ W``):
``embed [V, d]``; per layer ``in_norm [d], W_q [d, H·hd], W_k [d, Hkv·hd],
W_v [d, Hkv·hd], W_gate [d, H·hd], q_norm [hd], k_norm [hd], W_o [H·hd, d],
post_attn_norm [d], pre_mlp_norm [d], post_mlp_norm [d]``, then for a
dense layer ``W_gu [d, 2·d_ff], W_down [d_ff, d]`` and for an MoE layer
``W_router [n_experts, d], shared W_gu [d, 2·n_shared·moe_ff], shared
W_down [n_shared·moe_ff, d], experts W_gu [held, d, 2·moe_ff], experts
W_down [held, moe_ff, d]`` (gate columns before up columns);
``final_norm [d], head [V, d]``.
"""

from __future__ import annotations

import contextlib
import inspect
from functools import partial
from typing import Any, Callable, NamedTuple, Sequence

import torch

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.models import lm
from pygrid_tpu_torch.models.deepseek_v3 import rms_norm, rope_tables, swiglu_mlp
from pygrid_tpu_torch.models.moe import topk_expert_layer
from pygrid_tpu_torch.parallel.flash_attention import flash_attention
from pygrid_tpu_torch.utils.profiling import region

SLIDING, FULL = "sliding_attention", "full_attention"


class AfmoeConfig(NamedTuple):
    vocab: int = 96
    d_model: int = 64
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 16
    d_ff: int = 128  # the dense layers' SwiGLU width
    moe_ff: int = 32  # one routed expert's width
    n_shared: int = 1
    n_experts: int = 16  # the router's width
    experts_held: range = range(0, 4)
    top_k: int = 4
    routed_scale: float = 2.826
    n_dense: int = 1
    n_layers: int = 4
    layer_types: tuple = (SLIDING, SLIDING, SLIDING, FULL)
    sliding_window: int = 8
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    mup: bool = True


ATTN_PARAMS = 11  # in_norm, W_q, W_k, W_v, W_gate, q_norm, k_norm, W_o, 3 norms
DENSE_PARAMS = ATTN_PARAMS + 2
MOE_PARAMS = ATTN_PARAMS + 5


def config_from_dict(port: dict) -> AfmoeConfig:
    """A configuration file's ``port`` block (``experts_held`` as
    ``[first, end]``, ``layer_types`` as a list)."""
    kw = dict(port)
    kw["experts_held"] = range(*kw["experts_held"])
    kw["layer_types"] = tuple(kw["layer_types"])
    return AfmoeConfig(**kw)


def _check(cfg: AfmoeConfig) -> None:
    held = cfg.experts_held
    if held.step != 1 or not 0 <= held.start < held.stop <= cfg.n_experts:
        raise ValueError(f"experts_held {held} is no run of the {cfg.n_experts} experts")
    if cfg.n_heads % cfg.n_kv_heads:
        raise ValueError(f"{cfg.n_kv_heads} K/V heads do not divide {cfg.n_heads} query heads")
    if cfg.head_dim % 2:
        raise ValueError("head_dim must be even: RoPE rotates pairs")
    if len(cfg.layer_types) != cfg.n_layers or set(cfg.layer_types) - {SLIDING, FULL}:
        raise ValueError(f"layer_types must name {cfg.n_layers} layers, each {SLIDING!r} or "
                         f"{FULL!r}, got {cfg.layer_types}")


def param_shapes(cfg: AfmoeConfig) -> list[tuple[int, ...]]:
    """Shapes of the flat param list, in order."""
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = len(cfg.experts_held)
    attn = [(d,), (d, H * hd), (d, Hk * hd), (d, Hk * hd), (d, H * hd), (hd,), (hd,),
            (H * hd, d), (d,), (d,), (d,)]
    dense = attn + [(d, 2 * cfg.d_ff), (cfg.d_ff, d)]
    fs = cfg.n_shared * cfg.moe_ff
    moe = attn + [(cfg.n_experts, d), (d, 2 * fs), (fs, d), (G, d, 2 * cfg.moe_ff),
                  (G, cfg.moe_ff, d)]
    layers = [dense if i < cfg.n_dense else moe for i in range(cfg.n_layers)]
    return [(cfg.vocab, d)] + [s for lay in layers for s in lay] + [(d,), (cfg.vocab, d)]


#: the ``afmoe`` modeling code's default ``initializer_range``
INIT_STD = 0.02


def init(
    cfg: AfmoeConfig = AfmoeConfig(),
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> list[torch.Tensor]:
    """Flat f32 param list: every matrix normal(0, :data:`INIT_STD`), every
    norm 1, drawn on the CPU from ``generator`` (seed 0 when None) and
    moved to ``device``."""
    _check(cfg)
    dev = resolve(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    return [(torch.ones(s) if len(s) == 1 else torch.randn(s, generator=g) * INIT_STD).to(dev)
            for s in param_shapes(cfg)]


def init_bias(cfg: AfmoeConfig = AfmoeConfig(),
              device: str | torch.device = "cuda") -> torch.Tensor:
    """The routers' biases, [MoE layers, n_experts] f32 zeros: a buffer that
    steers the choice of experts and takes no gradient."""
    return torch.zeros((cfg.n_layers - cfg.n_dense, cfg.n_experts), device=resolve(device))


def rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE of ``x`` [B, L, heads, dim] in f32 in the rotate-half layout:
    the pair (i, i + dim/2) turned by angle i, so output column i is
    ``x_i cos - x_{i+dim/2} sin`` and column dim/2 + i is
    ``x_{i+dim/2} cos + x_i sin``."""
    x = x.float()
    a, b = x.chunk(2, -1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([a * c - b * s, b * c + a * s], -1)


def layer_attention(cfg: AfmoeConfig, kind: str) -> tuple[bool, int | None]:
    """(RoPE, window) of a layer of ``kind``: a sliding layer turns q and k
    and keeps ``sliding_window`` keys, a full layer neither (NoPE, every
    earlier key)."""
    return (True, cfg.sliding_window) if kind == SLIDING else (False, None)


def _takes_band(attn_fn: Callable) -> bool:
    try:
        return "window" in inspect.signature(attn_fn).parameters
    except (TypeError, ValueError):
        return False


def _forward_span(name: str):
    """The span ``name``, or none inside a backward's recompute (remat), so
    that a traced round reads each sublayer's forward once."""
    if torch._C._current_graph_task_id() != -1:
        return contextlib.nullcontext()
    return region(name)


def features(
    params: Sequence[torch.Tensor],
    tokens: torch.Tensor,
    cfg: AfmoeConfig = AfmoeConfig(),
    attn_fn: Callable | None = None,
    remat: bool | str = False,
    compute_dtype: Any | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Final hidden states [B, L, d] in f32 (post final norm, pre head)."""
    _check(cfg)
    attn_fn = attn_fn or flash_attention
    if not _takes_band(attn_fn):
        raise ValueError("an AFMoE attn_fn must take k and v at n_kv_heads and a `window` "
                         f"argument; {getattr(attn_fn, '__name__', attn_fn)} takes no window")
    cd = lm.resolve_dtype(compute_dtype)

    def c(x):
        return lm.cast(x, cd)

    B, L = tokens.shape
    d, H, Hk, hd, eps = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.rms_eps
    if bias is None:
        bias = init_bias(cfg, tokens.device)
    cos, sin = rope_tables(L, hd, cfg.rope_theta, tokens.device)
    with region("pgt.model.embed"):
        h = params[0][tokens]
        h = h * d**0.5 if cfg.mup else h

    def attention(h, kind, norm, wq, wk, wv, wg, q_norm, k_norm, wo, post):
        rotary, window = layer_attention(cfg, kind)
        with _forward_span("pgt.attn.sliding" if kind == SLIDING else "pgt.attn.full"):
            x = c(rms_norm(h, norm, eps))
            q = rms_norm((x @ c(wq)).view(B, L, H, hd), q_norm, eps)
            k = rms_norm((x @ c(wk)).view(B, L, Hk, hd), k_norm, eps)
            v = (x @ c(wv)).view(B, L, Hk, hd)
            g = x @ c(wg)
            if rotary:
                q, k = rope_half(q, cos, sin), rope_half(k, cos, sin)
            a = attn_fn(c(q), c(k), v, causal=True, scale=hd**-0.5, window=window)
            a = c(a.reshape(B, L, H * hd) * torch.sigmoid(g))
            return rms_norm(a @ c(wo), post, eps)

    def dense_block(h, kind, *lp):
        with region("pgt.model.block"):
            h = h + attention(h, kind, *lp[:9])
            x = c(rms_norm(h, lp[9], eps))
            return h + rms_norm(swiglu_mlp(x, c(lp[11]), c(lp[12])), lp[10], eps)

    def moe_block(h, kind, b, *lp):
        with region("pgt.model.block"):
            h = h + attention(h, kind, *lp[:9])
            x32 = rms_norm(h, lp[9], eps).reshape(B * L, d)
            x = c(x32)
            wg, s_gu, s_down, e_gu, e_down = lp[11:]
            routed = topk_expert_layer(x, x32, wg, b, c(e_gu), c(e_down), cfg.experts_held,
                                       cfg.top_k, cfg.routed_scale)
            with region("pgt.moe.shared"):
                shared = swiglu_mlp(x, c(s_gu), c(s_down))
            m = (routed + shared).view(B, L, d)
            return h + rms_norm(m, lp[10], eps)

    dense_fn, moe_fn = lm.remat_block(dense_block, remat), lm.remat_block(moe_block, remat)
    idx = 1
    for i, kind in enumerate(cfg.layer_types):
        if i < cfg.n_dense:
            h = dense_fn(h, (kind,) + tuple(params[idx: idx + DENSE_PARAMS]))
            idx += DENSE_PARAMS
        else:
            h = moe_fn(h, (kind, bias[i - cfg.n_dense]) + tuple(params[idx: idx + MOE_PARAMS]))
            idx += MOE_PARAMS
    return rms_norm(h, params[idx], eps)


def apply(
    params: Sequence[torch.Tensor],
    tokens: torch.Tensor,
    cfg: AfmoeConfig = AfmoeConfig(),
    attn_fn: Callable | None = None,
    remat: bool | str = False,
    compute_dtype: Any | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Logits [B, L, vocab] in f32 for int tokens [B, L]; causal."""
    h = features(params, tokens, cfg, attn_fn, remat, compute_dtype, bias)
    B, L, d = h.shape
    cd = lm.resolve_dtype(compute_dtype)
    return lm.logits(h.reshape(B * L, d), params[-1], cd).reshape(B, L, -1)


def loss_and_acc(
    params: Sequence[torch.Tensor],
    X: torch.Tensor,
    y: torch.Tensor,
    cfg: AfmoeConfig = AfmoeConfig(),
    attn_fn: Callable | None = None,
    remat: bool | str = False,
    compute_dtype: Any | None = None,
    ce_grad_dtype: Any | None = None,
    bias: torch.Tensor | None = None,
):
    """Token-level CE (int targets y [B, L]) and accuracy through the
    untied head (:func:`.lm.head_loss`). With ``ce_grad_dtype`` the head is
    :class:`.lm.CEHead` (f32 logits recomputed in its narrow-dtype
    backward); without, the plain f32 log-softmax."""
    h = features(params, X, cfg, attn_fn, remat, compute_dtype, bias)
    return lm.head_loss(h, params[-1], y, lm.resolve_dtype(compute_dtype), ce_grad_dtype)


def make_training_step(
    cfg: AfmoeConfig = AfmoeConfig(),
    attn_fn: Callable | None = None,
    remat: bool | str = False,
    compute_dtype: Any | None = None,
    ce_grad_dtype: Any | None = None,
    bias: torch.Tensor | None = None,
) -> Callable:
    """SGD step: ``(X, y, lr, *params) -> (loss, acc, *new_params)``, f32
    master params with the matmul path in ``compute_dtype``."""
    return lm.make_sgd_step(partial(
        loss_and_acc, cfg=cfg, attn_fn=attn_fn, remat=remat, compute_dtype=compute_dtype,
        ce_grad_dtype=ce_grad_dtype, bias=bias,
    ))
