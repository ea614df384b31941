"""Plain float32 AFMoE decoder (Arcee's Trinity-Mini block) and its FedAvg
training rounds.

The equations, written out from the published ``afmoe`` configuration and
its modeling code (Arcee's, and ``transformers``' ``AfmoeForCausalLM``):

- ``h = embed[x] · √d`` (muP's input scale); each layer
  ``h += rms(attn(rms(h)))``, then ``h += rms(mlp(rms(h)))``, each ``rms``
  with its own scale (sandwich norms); the logits ``rms(h) headᵀ``, the loss
  the mean token cross-entropy. ``rms(x) = x / sqrt(mean(x²) + eps) ·
  scale``.
- attention: ``q = x W_q`` (``n_heads`` of ``head_dim``), ``k = x W_k`` and
  ``v = x W_v`` (``n_kv_heads``), ``g = x W_gate``; ``rms`` over each head
  of q and of k (QK-norm); on a ``sliding_attention`` layer RoPE turns each
  pair ``(i, i + head_dim/2)`` at position p by ``p · theta^(-2i/head_dim)``
  and query i sees the keys j with ``0 <= i - j < sliding_window``; on a
  ``full_attention`` layer no positional encoding and every key j <= i.
  Query head h reads K/V head ``h // (n_heads / n_kv_heads)``: k and v are
  indexed out to every query head. Softmax of the scores times
  ``head_dim^-½``, times v, then ``(a · sigmoid(g)) W_o``.
- the first ``n_dense`` layers' MLP: ``(silu(x W_gate) · x W_up) W_down``.
  Every later layer's: the shared expert (one such SwiGLU) plus the routed
  experts: ``s = sigmoid(x W_routerᵀ)`` over all ``n_experts``, the
  ``top_k`` chosen by ``s + bias``, each weighted by ``s_i / (Σ_chosen s +
  1e-20)`` times ``routed_scale``.

The parameters come as one flat list: ``embed [V, d]``; per layer
``in_norm, W_q, W_k, W_v, W_gate, q_norm, k_norm, W_o, post_attn_norm,
pre_mlp_norm, post_mlp_norm``, then for a dense layer ``W_gu [d, 2·d_ff],
W_down`` and for an expert layer ``W_router [n_experts, d], shared W_gu,
shared W_down, experts W_gu [held, d, 2·moe_ff], experts W_down [held,
moe_ff, d]`` (gate columns before up columns); ``final_norm, head [V, d]``.
``cfg`` is a configuration file's ``port`` block.

Departures from the published model (each also in the configuration file):

- only the experts ``experts_held`` = [first, end) are computed, each on
  the tokens that chose it, gathered by plain indexing: one card's share of
  an expert-parallel deployment, without the exchange;
- the routers' bias is an input (zeros unless given), never trained: no
  load-balance update; no dropout.

Departures from a one-pass computation, for memory alone (sums taken in
another order): the merged batch goes ``block_rows`` sequences at a time,
each layer is recomputed in the backward (``torch.utils.checkpoint``), and
attention takes ``q_block`` queries at a time against the keys the block's
queries can see. Every matrix product goes through ``mm`` (``torch.matmul``
unless a caller hands another, as a lower-precision control does), with
TF32 switched off. No kernel, cache or batching; nothing but ``torch``.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

ATTN = 11
DENSE = ATTN + 2
MOE = ATTN + 5
SLIDING = "sliding_attention"


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
    """``x`` [n, L, heads, dim]: each pair (i, i + dim/2) at position p
    turned by the angle p · theta^(-2i/dim), in f32."""
    n, L, h, dim = x.shape
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=x.device, dtype=torch.float32) / dim)
    ang = torch.arange(L, device=x.device, dtype=torch.float32)[:, None] * inv[None, :]
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    a, b = x[..., :dim // 2], x[..., dim // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def attention(q, k, v, scale, window, q_block, mm):
    """Causal softmax attention, q [n, L, H, hd], k and v [n, L, Hkv, hd]
    (each query head's K/V head indexed out), ``q_block`` queries at a time
    against the keys they can see; ``window`` W keeps the keys with
    ``0 <= i - j < W`` (None: every key j <= i)."""
    n, L, H, hd = q.shape
    idx = torch.arange(H, device=q.device) // (H // k.shape[2])
    qh, kh, vh = q.transpose(1, 2), k[:, :, idx].transpose(1, 2), v[:, :, idx].transpose(1, 2)
    out = []
    for s in range(0, L, q_block):
        e = min(s + q_block, L)
        lo = 0 if window is None else max(0, s - window + 1)
        scores = mm(qh[:, :, s:e], kh[:, :, lo:e].transpose(-1, -2)) * scale
        i = torch.arange(s, e, device=q.device)[:, None]
        j = torch.arange(lo, e, device=q.device)[None, :]
        keep = (i >= j) if window is None else (i >= j) & (i - j < window)
        p = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
        out.append(mm(p, vh[:, :, lo:e]))
    return torch.cat(out, 2).transpose(1, 2)


def routed_and_shared(x, lp, bias, cfg, mm):
    """An expert layer's MLP on ``x`` [T, d] (normed): the shared expert
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


def layer(h, lp, kind, bias, cfg, mm, q_block):
    """One decoder layer on ``h`` [n, L, d]."""
    n, L, d = h.shape
    H, Hk, hd, eps = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["rms_eps"]
    norm, wq, wk, wv, wg, q_norm, k_norm, wo, post_attn, pre_mlp, post_mlp = lp[:ATTN]
    x = _rms(h, norm, eps)
    q = _rms(mm(x, wq).reshape(n, L, H, hd), q_norm, eps)
    k = _rms(mm(x, wk).reshape(n, L, Hk, hd), k_norm, eps)
    v = mm(x, wv).reshape(n, L, Hk, hd)
    g = mm(x, wg)
    window = None
    if kind == SLIDING:
        q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
        window = cfg["sliding_window"]
    a = attention(q, k, v, hd**-0.5, window, q_block, mm).reshape(n, L, H * hd)
    h = h + _rms(mm(a * torch.sigmoid(g), wo), post_attn, eps)
    x = _rms(h, pre_mlp, eps)
    if len(lp) == DENSE:
        m = _swiglu(x, lp[ATTN], lp[ATTN + 1], mm)
    else:
        m = routed_and_shared(x.reshape(n * L, d), lp[ATTN:], bias, cfg, mm).reshape(n, L, d)
    return h + _rms(m, post_mlp, eps)


def _zero_bias(cfg, device):
    return torch.zeros(cfg["n_layers"] - cfg["n_dense"], cfg["n_experts"], device=device)


def hidden(params, X, cfg, mm=torch.matmul, q_block=1024, bias=None, recompute=True):
    """Final normed hidden states [n, L, d] of the tokens ``X`` [n, L]."""
    bias = _zero_bias(cfg, X.device) if bias is None else bias
    h = params[0][X]
    if cfg["mup"]:
        h = h * cfg["d_model"] ** 0.5
    i = 1
    for j, kind in enumerate(cfg["layer_types"]):
        dense = j < cfg["n_dense"]
        lp = tuple(params[i:i + (DENSE if dense else MOE)])
        i += len(lp)
        b = None if dense else bias[j - cfg["n_dense"]]

        def step(h, *lp, kind=kind, b=b):
            return layer(h, lp, kind, b, cfg, mm, q_block)

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
