"""Loss-driven FedAvg rounds with a fused final-step aggregation.

Counterpart of :mod:`pygrid_tpu.parallel.fedavg_fused`. The round is built
from the model's loss function instead of its opaque update step, which
exposes the reassociation::

    mean_k(p_k - lr * grad L(p_k, X_k))
      = mean_k(p_k) - lr * grad_q [ (1/K) * sum_k L(p_k + q, X_k) ] at q=0

With ``local_steps = 1`` every client holds the round's params, so the
mean of the clients' mean losses (equal token counts per client) is ONE
forward and backward over the merged ``[K·B, ...]`` batch: each layer's
weight gradient is one matmul whose contraction runs over all K·B rows —
the folded shape the reference reaches through its shared zero offset
``q`` under ``vmap``. No per-client gradient or parameter tensor exists.

With ``local_steps = N > 1`` the first ``N-1`` steps carry true per-client
params (that traffic is the algorithm once clients diverge), run client by
client; the final step's gradients are summed client by client into one
mean gradient. ``loss_fn`` must be a mean over its batch rows (every
bundled model's is) for the merged batch to equal the client mean.

Scope as in the reference: plain SGD, the update rule linear in the
gradient. ``make_sharded_fused_round`` waits for the multi-device slice.
"""

from __future__ import annotations

from typing import Callable

import torch


def _grad(loss_fn: Callable, params, X, y):
    """(loss, acc, grads) of ``loss_fn`` at ``params`` (detached leaves)."""
    leaves = [p.detach().requires_grad_() for p in params]
    loss, acc = loss_fn(leaves, X, y)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), acc.detach(), grads


def _sgd_steps(
    loss_fn: Callable, params, X, y, lr, n_steps: int, carry_dtype=None,
):
    """``n_steps`` SGD steps of one client; returns its updated params.

    With ``carry_dtype`` the client's params are carried as a
    narrow-dtype DELTA against the shared round-start ``params``: each
    step recomputes ``p = base + delta`` in f32 before the gradient, so
    only the accumulated ``-lr * sum(grads)`` term sees the cast."""
    if carry_dtype is None:
        p = list(params)
        for _ in range(n_steps):
            _, _, grads = _grad(loss_fn, p, X, y)
            p = [pi.detach() - lr * g for pi, g in zip(p, grads)]
        return p

    deltas = [torch.zeros_like(p, dtype=carry_dtype) for p in params]
    for _ in range(n_steps):
        p = [base + d.to(base.dtype) for base, d in zip(params, deltas)]
        _, _, grads = _grad(loss_fn, p, X, y)
        deltas = [
            (pi - lr * g - base).to(carry_dtype)
            for pi, g, base in zip(p, grads, params)
        ]
    return [base + d.to(base.dtype) for base, d in zip(params, deltas)]


def _fused_grad_and_metrics(loss_fn, p_k, batched, client_X, client_y):
    """The gradient-semantics core: the client-mean loss, acc and
    gradient at the clients' params.

    ``p_k``: per-client params (a list of K param lists) when ``batched``,
    else the shared params. Unbatched, the K client batches merge into
    one ``[K·B, ...]`` batch and one backward gives the folded gradient;
    batched, each client's gradient adds into the running mean in turn."""
    K = client_X.shape[0]
    if not batched:
        X = client_X.reshape((-1,) + tuple(client_X.shape[2:]))
        y = client_y.reshape((-1,) + tuple(client_y.shape[2:]))
        return _grad(loss_fn, p_k, X, y)
    loss_sum = acc_sum = 0.0
    g_sum = None
    for i in range(K):
        loss, acc, g = _grad(loss_fn, p_k[i], client_X[i], client_y[i])
        loss_sum = loss_sum + loss
        acc_sum = acc_sum + acc
        g_sum = list(g) if g_sum is None else [s + gi for s, gi in zip(g_sum, g)]
    return loss_sum / K, acc_sum / K, [s / K for s in g_sum]


def make_fused_rounds(
    loss_fn: Callable,
    n_rounds: int,
    local_steps: int = 1,
    carry_dtype: torch.dtype | None = None,
) -> Callable:
    """FedAvg rounds from a loss function, final step fused.

    ``loss_fn(params, X, y) -> (loss, acc)``, the shape every bundled
    model exposes (``models.{mlp,transformer}.loss_and_acc``).

    Returns ``rounds_fn(params, client_X [K,...], client_y [K,...], lr)
    -> (final_params, losses[n_rounds], accs[n_rounds])``: losses and accs
    are the per-round client means of the final local step's pre-update
    loss and acc.

    ``carry_dtype`` (e.g. ``torch.bfloat16``) carries the per-client
    deltas between local steps in a narrower dtype; it only touches
    ``local_steps > 1``."""
    if local_steps < 1:
        raise ValueError("local_steps must be >= 1")

    def one_round(p, client_X, client_y, lr):
        if local_steps == 1:
            p_k, batched = p, False
        else:
            p_k = [
                _sgd_steps(
                    loss_fn, p, client_X[i], client_y[i], lr,
                    local_steps - 1, carry_dtype=carry_dtype,
                )
                for i in range(client_X.shape[0])
            ]
            batched = True
        loss, acc, g = _fused_grad_and_metrics(
            loss_fn, p_k, batched, client_X, client_y
        )
        if batched:
            mean_p = [torch.stack(ps).mean(0) for ps in zip(*p_k)]
        else:
            mean_p = p_k
        new_p = [mp.detach() - lr * gi for mp, gi in zip(mean_p, g)]
        return new_p, loss, acc

    def rounds_fn(params, client_X, client_y, lr):
        p = [t.detach() for t in params]
        losses, accs = [], []
        for _ in range(n_rounds):
            p, loss, acc = one_round(p, client_X, client_y, lr)
            losses.append(loss)
            accs.append(acc)
        return p, torch.stack(losses), torch.stack(accs)

    return rounds_fn


def make_fused_round(
    loss_fn: Callable,
    local_steps: int = 1,
    carry_dtype: torch.dtype | None = None,
) -> Callable:
    """A single fused round with :func:`fedavg.make_round`'s contract:
    ``round_fn(params, client_X, client_y, lr) -> (new_params,
    mean_loss, mean_acc)``."""
    rounds = make_fused_rounds(
        loss_fn, n_rounds=1, local_steps=local_steps, carry_dtype=carry_dtype,
    )

    def round_fn(params, client_X, client_y, lr):
        final, losses, accs = rounds(params, client_X, client_y, lr)
        return final, losses[0], accs[0]

    return round_fn
