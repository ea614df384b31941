"""Plain float32 MLP (ReLU, softmax cross-entropy on one-hot labels) and its
FedAvg rounds with per-client local SGD steps.

A round: every client starts at the round's params, takes ``local_steps``
SGD steps on its own batch, and the new params are the clients' mean.
The round's loss is the clients' mean loss before their last step. The
clients run side by side as batched products, a block of them at a time.
"""

from __future__ import annotations

import torch

from benchmark.reference.precision import matmul, products


def _client_losses(P, X, Y, precision):
    """Each client's mean loss; ``P`` leaves carry a leading client axis."""
    h = X
    n = len(P) // 2
    for i in range(n):
        h = matmul(h, P[2 * i], precision) + P[2 * i + 1][:, None, :]
        if i < n - 1:
            h = torch.relu(h)
    logp = torch.log_softmax(h, dim=-1)
    return -(Y * logp).sum(-1).mean(-1)


def fedavg_round(params, X, Y, lr, local_steps, precision, block_clients):
    """One round over clients ``X`` [K, B, n_in], ``Y`` [K, B, n_out]."""
    K = X.shape[0]
    sums = [torch.zeros_like(p) for p in params]
    loss_total = 0.0
    for c in range(0, K, block_clients):
        Xb, Yb = X[c:c + block_clients], Y[c:c + block_clients]
        k = Xb.shape[0]
        P = [p.detach().unsqueeze(0).expand(k, *p.shape).clone() for p in params]
        for step in range(local_steps):
            leaves = [t.requires_grad_() for t in P]
            losses = _client_losses(leaves, Xb, Yb, precision)
            g = torch.autograd.grad(losses.sum(), leaves)
            P = [t.detach() - lr * gi for t, gi in zip(leaves, g)]
            if step == local_steps - 1:
                loss_total += float(losses.detach().sum())
        for s, t in zip(sums, P):
            s += t.sum(0)
    return [s / K for s in sums], loss_total / K


def fedavg_rounds(params0, batches, lr, local_steps, precision="f32", block_clients=256):
    """The rounds over ``batches`` [(X, Y), ...]; returns the params after
    each round and each round's loss."""
    p = [t.detach().float() for t in params0]
    states, losses = [], []
    with products(precision):
        for X, Y in batches:
            p, loss = fedavg_round(p, X, Y, lr, local_steps, precision, block_clients)
            states.append(p)
            losses.append(loss)
    return states, losses
