"""Plain float32 DeepSeek-V3 decoder (Moonlight-16B-A3B's block) and its
FedAvg training rounds.

The equations, written out from DeepSeek-V2 (arXiv:2405.04434) for
multi-head latent attention and DeepSeek-V3 (arXiv:2412.19437) for the
routed experts, as the published ``deepseek_v3`` configurations run them
with ``q_lora_rank`` null, ``rope_scaling`` null and ``n_group`` 1:

- ``h = embed[x]``; each layer ``h += attn(rms(h))``, then
  ``h += mlp(rms(h))``; the logits ``rms(h) headᵀ``, the loss the mean
  token cross-entropy. ``rms(x) = x / sqrt(mean(x²) + eps) · scale``.
- attention: ``q = x W_q`` (heads of ``nope + rope``); ``x W_kva`` gives the
  latent ``c`` (``kv_lora``) and ``k_pe`` (``rope``, one for all heads);
  ``rms(c) W_kvb`` gives each head ``k_nope ‖ v``. RoPE turns each pair
  (2i, 2i+1) of ``q_pe`` and ``k_pe`` at position p by
  ``p · theta^(-2i/rope)``, the pair kept in its place (DeepSeek's code
  moves the evens first; both sides of every dot product move alike, so
  no score depends on it). Causal softmax over ``[q_nope ‖ q_pe] ·
  [k_nope ‖ k_pe] · (nope + rope)^-½``, times ``v``, then ``W_o``.
- the first ``n_dense`` layers' MLP: ``(silu(x W_gate) · x W_up) W_down``.
  Every later layer's: the shared experts (one such SwiGLU) plus the routed
  experts: ``s = sigmoid(x W_routerᵀ)`` over all ``n_experts``, the
  ``top_k`` chosen by ``s + bias``, each weighted by ``s_i / Σ_chosen s``
  times ``routed_scale``.

The parameters come as one flat list: ``embed [V, d]``; per layer
``attn_norm, W_q, W_kva, kv_norm, W_kvb, W_o, mlp_norm``, then for a dense
layer ``W_gu [d, 2·d_ff], W_down`` and for an expert layer ``W_router
[n_experts, d], shared W_gu, shared W_down, experts W_gu [held, d, 2·moe_ff],
experts W_down [held, moe_ff, d]`` (gate columns before up columns);
``final_norm, head [V, d]``. ``cfg`` is a configuration file's ``port``
block.

Departures from the published model (each also in the configuration file):

- only the experts ``experts_held`` = [first, end) are computed, each on
  the tokens that chose it, gathered by plain indexing: one card's share of
  an expert-parallel deployment, without the exchange;
- the correction bias is an input (zeros unless given), never trained; no
  sequence-wise balance loss, no multi-token prediction.

Departures from a one-pass computation, for memory alone (sums taken in
another order): the merged batch goes ``block_rows`` sequences at a time,
each layer is recomputed in the backward (``torch.utils.checkpoint``), and
attention takes ``q_block`` queries at a time against the keys up to the
block's last. Every matrix product goes through ``mm`` (``torch.matmul``
unless a caller hands another, as a lower-precision control does), with
TF32 switched off. No kernel, cache or batching; nothing but ``torch``.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

ATTN = 7
DENSE = ATTN + 2
MOE = ATTN + 5


@contextlib.contextmanager
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _silu(x):
    return x * torch.sigmoid(x)


def _swiglu(x, w_gu, w_down, mm):
    f = w_down.shape[0]
    gu = mm(x, w_gu)
    return mm(_silu(gu[..., :f]) * gu[..., f:], w_down)


def rope(x, theta):
    """``x`` [n, L, heads, dim]: each pair (2i, 2i+1) at position p turned
    by the angle p · theta^(-2i/dim), computed in f32 as the published code
    does."""
    n, L, h, dim = x.shape
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=x.device, dtype=torch.float32) / dim)
    ang = torch.arange(L, device=x.device, dtype=torch.float32)[:, None] * inv[None, :]
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    pairs = x.reshape(n, L, h, dim // 2, 2)
    a, b = pairs[..., 0], pairs[..., 1]
    return torch.stack([a * cos - b * sin, b * cos + a * sin], -1).reshape(n, L, h, dim)


def attention(q, k, v, scale, q_block, mm):
    """Causal softmax attention, q and k [n, L, H, Dqk], v [n, L, H, Dv],
    ``q_block`` queries at a time against the keys up to the block's last."""
    L = q.shape[1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    out = []
    for s in range(0, L, q_block):
        e = min(s + q_block, L)
        scores = mm(qh[:, :, s:e], kh[:, :, :e].transpose(-1, -2)) * scale
        mask = torch.arange(s, e, device=q.device)[:, None] >= torch.arange(e, device=q.device)
        p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(mm(p, vh[:, :, :e]))
    return torch.cat(out, 2).transpose(1, 2)


def routed_and_shared(x, lp, bias, cfg, mm):
    """An expert layer's MLP on ``x`` [T, d] (normed): the shared experts
    plus the held routed experts' part. ``lp``: W_router, shared W_gu,
    shared W_down, experts W_gu, experts W_down."""
    wg, s_gu, s_down, e_gu, e_down = lp
    s = torch.sigmoid(mm(x, wg.t()))
    sel = torch.topk(s.detach() + bias, cfg["top_k"], dim=-1).indices
    w = s.gather(1, sel)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scale"]
    out = _swiglu(x, s_gu, s_down, mm)
    first, end = cfg["experts_held"]
    for i, e in enumerate(range(first, end)):
        tok, slot = torch.nonzero(sel == e, as_tuple=True)
        if tok.numel():
            part = w[tok, slot][:, None] * _swiglu(x[tok], e_gu[i], e_down[i], mm)
            out = out.index_add(0, tok, part)
    return out


def layer(h, lp, bias, cfg, mm, q_block):
    """One decoder layer on ``h`` [n, L, d]."""
    n, L, d = h.shape
    H, dn, dr, dv = cfg["n_heads"], cfg["qk_nope"], cfg["qk_rope"], cfg["v_head"]
    norm, wq, wkva, kv_norm, wkvb, wo, mlp_norm = lp[:ATTN]
    x = _rms(h, norm, cfg["rms_eps"])
    q = mm(x, wq).reshape(n, L, H, dn + dr)
    kva = mm(x, wkva)
    latent, k_pe = kva[..., :cfg["kv_lora"]], kva[..., cfg["kv_lora"]:]
    kv = mm(_rms(latent, kv_norm, cfg["kv_norm_eps"]), wkvb).reshape(n, L, H, dn + dv)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], cfg["rope_theta"])], -1)
    k_pe = rope(k_pe[:, :, None, :], cfg["rope_theta"]).expand(n, L, H, dr)
    k = torch.cat([kv[..., :dn], k_pe], -1)
    a = attention(q, k, kv[..., dn:], (dn + dr) ** -0.5, q_block, mm)
    h = h + mm(a.reshape(n, L, H * dv), wo)
    x = _rms(h, mlp_norm, cfg["rms_eps"])
    if len(lp) == DENSE:
        return h + _swiglu(x, lp[ATTN], lp[ATTN + 1], mm)
    return h + routed_and_shared(x.reshape(n * L, d), lp[ATTN:], bias, cfg, mm).reshape(n, L, d)


def _zero_bias(cfg, device):
    return torch.zeros(cfg["n_layers"] - cfg["n_dense"], cfg["n_experts"], device=device)


def hidden(params, X, cfg, mm=torch.matmul, q_block=1024, bias=None, recompute=True):
    """Final normed hidden states [n, L, d] of the tokens ``X`` [n, L]."""
    bias = _zero_bias(cfg, X.device) if bias is None else bias
    h = params[0][X]
    i = 1
    for j in range(cfg["n_layers"]):
        dense = j < cfg["n_dense"]
        lp = tuple(params[i:i + (DENSE if dense else MOE)])
        i += len(lp)
        b = None if dense else bias[j - cfg["n_dense"]]

        def step(h, *lp, b=b):
            return layer(h, lp, b, cfg, mm, q_block)

        h = checkpoint(step, h, *lp, use_reentrant=False) if recompute else step(h, *lp)
    return _rms(h, params[i], cfg["rms_eps"])


def logits(params, X, cfg, mm=torch.matmul, q_block=1024, bias=None):
    """Logits [n, L, V] of the tokens ``X`` [n, L], f32, TF32 off."""
    with _no_tf32():
        return mm(hidden(params, X, cfg, mm, q_block, bias, recompute=False), params[-1].t())


def loss_sum(params, X, y, cfg, mm=torch.matmul, q_block=1024, bias=None):
    """Sum over the tokens of ``X`` [n, L] of the cross-entropy of ``y``."""
    h = hidden(params, X, cfg, mm, q_block, bias)
    z = mm(h.reshape(-1, h.shape[-1]), params[-1].t())
    return (torch.logsumexp(z, -1) - z.gather(1, y.reshape(-1, 1))[:, 0]).sum()


def loss_and_grad(params, X, y, cfg, mm=torch.matmul, block_rows=1, q_block=1024, bias=None):
    """Mean token loss over the merged batch ``X`` [N, L] and its gradient,
    ``block_rows`` sequences at a time."""
    leaves = [p.detach().requires_grad_() for p in params]
    grads = [torch.zeros_like(p) for p in params]
    loss = 0.0
    with _no_tf32():
        for r in range(0, X.shape[0], block_rows):
            part = loss_sum(leaves, X[r:r + block_rows], y[r:r + block_rows], cfg, mm, q_block,
                            bias) / X.numel()
            for acc, g in zip(grads, torch.autograd.grad(part, leaves)):
                acc += g
            loss += float(part.detach())
    return loss, grads


def fedavg_rounds(params0, batches, lr, cfg, mm=torch.matmul, block_rows=1, q_block=1024,
                  bias=None):
    """FedAvg rounds of one local step: every client at the round's params,
    so a round is one SGD step on the clients' merged batch. ``batches``:
    (X [K, B, L], y [K, B, L]) of each round. Returns the params after
    each round and each round's mean loss."""
    p = [t.detach().float() for t in params0]
    states, losses = [], []
    for X, y in batches:
        Xm, ym = X.reshape(-1, X.shape[-1]), y.reshape(-1, y.shape[-1])
        loss, g = loss_and_grad(p, Xm, ym, cfg, mm, block_rows, q_block, bias)
        p = [pi - lr * gi for pi, gi in zip(p, g)]
        states.append(p)
        losses.append(loss)
    return states, losses
