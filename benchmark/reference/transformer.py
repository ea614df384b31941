"""Plain float32 decoder-only transformer and its FedAvg training rounds.

The block is the port's (the layout of the flat parameter list too):
pre-LayerNorm with the population variance, learned positions, q/k/v/o
without biases, causal softmax attention, a tanh-GELU MLP with biases, a
final LayerNorm and the output head tied to the token embedding. The loss
is the mean token cross-entropy. No kernel, no cache, no mixed precision:
every product in the precision the caller names (``precision.py``), and
the merged client batch in blocks of rows so that it fits on one card.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.precision import matmul, products

PER_LAYER = 12


def _ln(x, s, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * s + b


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def loss_sum(params, X, y, cfg: dict, precision: str) -> torch.Tensor:
    """Sum over the tokens of ``X`` [N, L] of the cross-entropy of ``y``."""
    mm = lambda a, b: matmul(a, b, precision)  # noqa: E731
    N, L = X.shape
    d, H = cfg["d_model"], cfg["n_heads"]
    dh, eps = d // H, cfg["ln_eps"]
    embed, pos = params[0], params[1]
    h = embed[X] + pos[:L]
    mask = torch.ones(L, L, dtype=torch.bool, device=X.device).tril()
    i = 2
    for _ in range(cfg["n_layers"]):
        ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2, b2 = params[i:i + PER_LAYER]
        i += PER_LAYER
        x = _ln(h, ln1s, ln1b, eps)
        q, k, v = ((mm(x, w)).reshape(N, L, H, dh).transpose(1, 2) for w in (wq, wk, wv))
        s = mm(q, k.transpose(-1, -2)) * dh ** -0.5
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        a = mm(p, v).transpose(1, 2).reshape(N, L, d)
        h = h + mm(a, wo)
        x = _ln(h, ln2s, ln2b, eps)
        h = h + mm(_gelu_tanh(mm(x, w1) + b1), w2) + b2
    h = _ln(h, params[i], params[i + 1], eps)
    logits = mm(h.reshape(N * L, d), embed.t())
    return (torch.logsumexp(logits, -1) - logits.gather(1, y.reshape(-1, 1))[:, 0]).sum()


def loss_and_grad(params, X, y, cfg, precision, block_rows):
    """Mean token loss over the merged batch and its gradient, computed
    ``block_rows`` sequences at a time."""
    leaves = [p.detach().requires_grad_() for p in params]
    total = X.numel()
    loss = 0.0
    grads = [torch.zeros_like(p) for p in params]
    for r in range(0, X.shape[0], block_rows):
        part = loss_sum(leaves, X[r:r + block_rows], y[r:r + block_rows], cfg, precision) / total
        g = torch.autograd.grad(part, leaves)
        for acc, gi in zip(grads, g):
            acc += gi
        loss += float(part.detach())
    return loss, grads


def fedavg_rounds(params0, batches, lr, cfg, precision="f32", block_rows=8):
    """FedAvg rounds with one local step each: every client at the round's
    params, so the round is one SGD step on the clients' merged batch.
    ``batches``: (X [K, B, L], y [K, B, L]) of each round. Returns the
    params after each round (float32) and each round's mean loss."""
    p = [t.detach().float() for t in params0]
    states, losses = [], []
    with products(precision):
        for X, y in batches:
            Xm, ym = X.reshape(-1, X.shape[-1]), y.reshape(-1, y.shape[-1])
            loss, g = loss_and_grad(p, Xm, ym, cfg, precision, block_rows)
            p = [pi - lr * gi for pi, gi in zip(p, g)]
            states.append(p)
            losses.append(loss)
    return states, losses
