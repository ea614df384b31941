"""DeepSeek-V3 decoder (Moonlight-16B-A3B's block) for the FedAvg round.

No counterpart in the JAX package. The layer equations are DeepSeek-V2's
(arXiv:2405.04434) for multi-head latent attention and DeepSeek-V3's
(arXiv:2412.19437) for sigmoid routing with bias-corrected selection, as the
published ``deepseek_v3`` configurations run them without a query LoRA
(``q_lora_rank`` null), YaRN (``rope_scaling`` null) or expert groups
(``n_group`` 1):

- RMSNorm in f32 before attention and before the MLP, and on the final
  hidden state; an untied head ``[vocab, d]``.
- MLA: ``q = x W_q`` gives each head ``q_nope ‖ q_pe``; ``x W_kva`` gives a
  latent ``c`` and one ``k_pe`` for all heads; ``RMSNorm(c) W_kvb`` gives
  each head ``k_nope ‖ v``; RoPE rotates ``q_pe`` and ``k_pe``; attention
  runs causal at ``D_qk = nope + rope`` with scale ``D_qk^-½`` on ``v`` at
  its own width ``D_v`` (the flash kernels' narrow-V path), then ``W_o``.
- The first ``n_dense`` layers' MLP is a SwiGLU of width ``d_ff``; every
  later layer's is the shared experts (one SwiGLU of ``n_shared · moe_ff``)
  plus the routed experts that this card holds
  (:func:`pygrid_tpu_torch.models.moe.topk_expert_layer`).

The contract is :mod:`.transformer`'s: a flat f32 parameter list,
``features``/``apply``/``loss_and_acc`` with the same options, and
``make_training_step``, the head, loss and step both take from
:mod:`.lm`; ``loss_and_acc`` runs unchanged under
``parallel.fedavg_fused.make_fused_round``. The router's correction bias
is a buffer (``bias`` [MoE layers, n_experts]), never a gradient leaf.

Layout of the flat list (matrices ``[in, out]``, as ``x @ W``):
``embed [V, d]``; per layer ``attn_norm [d], W_q [d, H·(nope+rope)],
W_kva [d, kv_lora+rope], kv_norm [kv_lora], W_kvb [kv_lora, H·(nope+v)],
W_o [H·v, d], mlp_norm [d]``, then for a dense layer ``W_gu [d, 2·d_ff],
W_down [d_ff, d]`` and for an MoE layer ``W_router [n_experts, d],
shared W_gu [d, 2·n_shared·moe_ff], shared W_down [n_shared·moe_ff, d],
experts W_gu [held, d, 2·moe_ff], experts W_down [held, moe_ff, d]``
(gate columns before up columns); ``final_norm [d], head [V, d]``.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.models import lm
from pygrid_tpu_torch.models.moe import topk_expert_layer
from pygrid_tpu_torch.parallel.ring_attention import attention
from pygrid_tpu_torch.utils.profiling import region


class DeepseekV3Config(NamedTuple):
    vocab: int = 96
    d_model: int = 64
    n_heads: int = 4
    qk_nope: int = 16
    qk_rope: int = 8
    v_head: int = 16
    kv_lora: int = 32
    d_ff: int = 128  # the dense layers' SwiGLU width
    moe_ff: int = 32  # one routed expert's width
    n_shared: int = 2
    n_experts: int = 16  # the router's width
    experts_held: range = range(0, 4)
    top_k: int = 4
    routed_scale: float = 2.446
    n_dense: int = 1
    n_layers: int = 3
    rope_theta: float = 50000.0
    rms_eps: float = 1e-5
    kv_norm_eps: float = 1e-6


ATTN_PARAMS = 7  # attn_norm, W_q, W_kva, kv_norm, W_kvb, W_o, mlp_norm
DENSE_PARAMS = ATTN_PARAMS + 2
MOE_PARAMS = ATTN_PARAMS + 5


def config_from_dict(port: dict) -> DeepseekV3Config:
    """A configuration file's ``port`` block (``experts_held`` as
    ``[first, end]``)."""
    kw = dict(port)
    kw["experts_held"] = range(*kw["experts_held"])
    return DeepseekV3Config(**kw)


def _check(cfg: DeepseekV3Config) -> None:
    held = cfg.experts_held
    if held.step != 1 or not 0 <= held.start < held.stop <= cfg.n_experts:
        raise ValueError(f"experts_held {held} is no run of the {cfg.n_experts} experts")
    if cfg.v_head > cfg.qk_nope + cfg.qk_rope:
        raise ValueError("v_head wider than the query-key head is not supported")
    if cfg.qk_rope % 2:
        raise ValueError("qk_rope must be even: RoPE rotates pairs")


def param_shapes(cfg: DeepseekV3Config) -> list[tuple[int, ...]]:
    """Shapes of the flat param list, in order."""
    d, H, G = cfg.d_model, cfg.n_heads, len(cfg.experts_held)
    attn = [(d,), (d, H * (cfg.qk_nope + cfg.qk_rope)), (d, cfg.kv_lora + cfg.qk_rope),
            (cfg.kv_lora,), (cfg.kv_lora, H * (cfg.qk_nope + cfg.v_head)),
            (H * cfg.v_head, d), (d,)]
    dense = attn + [(d, 2 * cfg.d_ff), (cfg.d_ff, d)]
    fs = cfg.n_shared * cfg.moe_ff
    moe = attn + [(cfg.n_experts, d), (d, 2 * fs), (fs, d), (G, d, 2 * cfg.moe_ff),
                  (G, cfg.moe_ff, d)]
    layers = [dense if i < cfg.n_dense else moe for i in range(cfg.n_layers)]
    return [(cfg.vocab, d)] + [s for lay in layers for s in lay] + [(d,), (cfg.vocab, d)]


#: the published configurations' ``initializer_range``
INIT_STD = 0.02


def init(
    cfg: DeepseekV3Config = DeepseekV3Config(),
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


def init_bias(cfg: DeepseekV3Config = DeepseekV3Config(),
              device: str | torch.device = "cuda") -> torch.Tensor:
    """The routers' correction biases, [MoE layers, n_experts] f32 zeros: a
    buffer that steers the choice of experts and takes no gradient."""
    return torch.zeros((cfg.n_layers - cfg.n_dense, cfg.n_experts), device=resolve(device))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with its statistics and output in f32."""
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope_tables(L: int, dim: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [L, dim/2] f32 of the angles ``p · theta^(-2i/dim)``."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=device, dtype=torch.float32) / dim)
    ang = torch.arange(L, device=device, dtype=torch.float32)[:, None] * inv[None, :]
    return ang.cos(), ang.sin()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE of ``x`` [B, L, heads, dim] in f32, as DeepSeek's code applies
    it: the pairs (2i, 2i+1) de-interleaved into halves, then rotated by
    the rotate-half form, so output column i is ``x_2i cos - x_2i+1 sin``
    and column dim/2 + i is ``x_2i+1 cos + x_2i sin``."""
    x = x.float()
    even, odd = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([even * c - odd * s, odd * c + even * s], -1)


def swiglu_mlp(x: torch.Tensor, w_gu: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """``(silu(x W_gate) · x W_up) W_down`` with gate‖up in one matrix."""
    f = w_down.shape[0]
    gu = x @ w_gu
    return (F.silu(gu[..., :f]) * gu[..., f:]) @ w_down


def features(
    params: Sequence[torch.Tensor],
    tokens: torch.Tensor,
    cfg: DeepseekV3Config = DeepseekV3Config(),
    attn_fn: Callable | None = None,
    remat: bool | str = False,
    compute_dtype: Any | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Final hidden states [B, L, d] in f32 (post final norm, pre head)."""
    _check(cfg)
    attn_fn = attn_fn or attention
    cd = lm.resolve_dtype(compute_dtype)

    def c(x):
        return lm.cast(x, cd)

    B, L = tokens.shape
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope, cfg.qk_rope, cfg.v_head
    dqk = dn + dr
    if bias is None:
        bias = init_bias(cfg, tokens.device)
    cos, sin = rope_tables(L, dr, cfg.rope_theta, tokens.device)
    with region("pgt.model.embed"):
        h = c(params[0][tokens])

    def mla(h, norm, wq, wkva, kv_norm, wkvb, wo):
        with region("pgt.mla"):
            x = c(rms_norm(h, norm, cfg.rms_eps))
            q_nope, q_pe = (x @ c(wq)).view(B, L, H, dqk).split([dn, dr], -1)
            latent, k_pe = (x @ c(wkva)).split([cfg.kv_lora, dr], -1)
            kv = c(rms_norm(latent, kv_norm, cfg.kv_norm_eps)) @ c(wkvb)
            k_nope, v = kv.view(B, L, H, dn + dv).split([dn, dv], -1)
            q = torch.cat([q_nope, c(rope(q_pe, cos, sin))], -1)
            k_pe = c(rope(k_pe[:, :, None, :], cos, sin)).expand(B, L, H, dr)
            k = torch.cat([k_nope, k_pe], -1)
            a = attn_fn(q, k, v, causal=True, scale=dqk**-0.5)
            return c(a.reshape(B, L, H * dv)) @ c(wo)

    def dense_block(h, *lp):
        with region("pgt.model.block"):
            h = h + mla(h, *lp[:6])
            x = c(rms_norm(h, lp[6], cfg.rms_eps))
            return h + swiglu_mlp(x, c(lp[7]), c(lp[8]))

    def moe_block(h, b, *lp):
        with region("pgt.model.block"):
            h = h + mla(h, *lp[:6])
            x32 = rms_norm(h, lp[6], cfg.rms_eps).reshape(B * L, d)
            x = c(x32)
            wg, s_gu, s_down, e_gu, e_down = lp[7:]
            routed = topk_expert_layer(x, x32, wg, b, c(e_gu), c(e_down), cfg.experts_held,
                                       cfg.top_k, cfg.routed_scale)
            with region("pgt.moe.shared"):
                shared = swiglu_mlp(x, c(s_gu), c(s_down))
            return h + (routed + shared).view(B, L, d)

    dense_fn, moe_fn = lm.remat_block(dense_block, remat), lm.remat_block(moe_block, remat)
    idx = 1
    for i in range(cfg.n_layers):
        if i < cfg.n_dense:
            h = dense_fn(h, tuple(params[idx: idx + DENSE_PARAMS]))
            idx += DENSE_PARAMS
        else:
            h = moe_fn(h, (bias[i - cfg.n_dense],) + tuple(params[idx: idx + MOE_PARAMS]))
            idx += MOE_PARAMS
    return rms_norm(h, params[idx], cfg.rms_eps)


def apply(
    params: Sequence[torch.Tensor],
    tokens: torch.Tensor,
    cfg: DeepseekV3Config = DeepseekV3Config(),
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
    cfg: DeepseekV3Config = DeepseekV3Config(),
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
    cfg: DeepseekV3Config = DeepseekV3Config(),
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
