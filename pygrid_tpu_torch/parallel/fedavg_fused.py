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
gradient.

:func:`make_sharded_fused_round` splits the client axis over a mesh axis:
each rank runs its block's local steps and fused final gradient, and the
aggregation is one all-reduce of the already-reduced gradients (and of
the block-mean params when ``local_steps > 1``): O(|params|) bytes on the
wire, never O(K·|params|).

A round names its parts for ``torch.profiler``
(:func:`pygrid_tpu_torch.utils.profiling.region`, no-ops when no profiler
records): ``pgt.round.forward`` and ``pgt.round.backward`` around every
loss and its gradient, and in the round of :func:`make_fused_round`
(which :func:`make_fused_rounds` loops) ``pgt.round`` around the round
and ``pgt.round.update`` around the param mean and the master update.
"""

from __future__ import annotations

from typing import Callable

import torch

from pygrid_tpu_torch.parallel import collectives as C
from pygrid_tpu_torch.utils.profiling import region


def _grad(loss_fn: Callable, params, X, y):
    """(loss, acc, grads) of ``loss_fn`` at ``params`` (detached leaves)."""
    leaves = [p.detach().requires_grad_() for p in params]
    with region("pgt.round.forward"):
        loss, acc = loss_fn(leaves, X, y)
    with region("pgt.round.backward"):
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


def _client_step(loss_fn, p, client_X, client_y, lr, local_steps, carry_dtype):
    """A round's client work from the round-start params ``p``: ``(loss,
    acc, grads, mean_params)``, the client means of the final local step's
    pre-update loss, acc and gradient, and the params to update.

    At ``local_steps == 1`` every client holds ``p``, so the K client
    batches merge into one ``[K·B, ...]`` batch and one backward gives the
    folded gradient; ``mean_params`` is ``p``. Above 1, each client runs
    its first ``local_steps - 1`` steps (:func:`_sgd_steps`), then its
    gradient adds into the running mean in turn; ``mean_params`` is then
    an iterator that takes the clients' param mean leaf by leaf as the
    caller reads it, so that the caller's update range holds that work."""
    if local_steps == 1:
        X = client_X.reshape((-1,) + tuple(client_X.shape[2:]))
        y = client_y.reshape((-1,) + tuple(client_y.shape[2:]))
        loss, acc, g = _grad(loss_fn, p, X, y)
        return loss, acc, g, p
    K = client_X.shape[0]
    p_k = [
        _sgd_steps(loss_fn, p, client_X[i], client_y[i], lr, local_steps - 1,
                   carry_dtype=carry_dtype)
        for i in range(K)
    ]
    loss_sum = acc_sum = 0.0
    g_sum = None
    for i in range(K):
        loss, acc, g = _grad(loss_fn, p_k[i], client_X[i], client_y[i])
        loss_sum = loss_sum + loss
        acc_sum = acc_sum + acc
        g_sum = list(g) if g_sum is None else [s + gi for s, gi in zip(g_sum, g)]
    mean_p = (torch.stack(ps).mean(0) for ps in zip(*p_k))
    return loss_sum / K, acc_sum / K, [s / K for s in g_sum], mean_p


def make_fused_round(
    loss_fn: Callable,
    local_steps: int = 1,
    carry_dtype: torch.dtype | None = None,
) -> Callable:
    """A single fused round with :func:`fedavg.make_round`'s contract:
    ``round_fn(params, client_X, client_y, lr) -> (new_params,
    mean_loss, mean_acc)``; :func:`make_fused_rounds` loops it."""
    if local_steps < 1:
        raise ValueError("local_steps must be >= 1")

    def one_round(params, client_X, client_y, lr):
        p = [t.detach() for t in params]
        with region("pgt.round"):
            loss, acc, g, mean_p = _client_step(
                loss_fn, p, client_X, client_y, lr, local_steps, carry_dtype
            )
            with region("pgt.round.update"):
                new_p = [mp.detach() - lr * gi for mp, gi in zip(mean_p, g)]
        return new_p, loss, acc

    return one_round


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
    one_round = make_fused_round(loss_fn, local_steps, carry_dtype)

    def rounds_fn(params, client_X, client_y, lr):
        p, losses, accs = params, [], []
        for _ in range(n_rounds):
            p, loss, acc = one_round(p, client_X, client_y, lr)
            losses.append(loss)
            accs.append(acc)
        return p, torch.stack(losses), torch.stack(accs)

    return rounds_fn


def make_sharded_fused_round(
    loss_fn: Callable,
    mesh,
    local_steps: int = 1,
    axis: str = "clients",
    carry_dtype: torch.dtype | None = None,
) -> Callable:
    """Fused-aggregation FedAvg round with the client axis split over
    ``axis`` of ``mesh``: :func:`make_fused_round`'s contract, the whole
    client batch on every rank (K must divide by the axis size) and the
    replicated ``(new_params, mean_loss, mean_acc)`` back.

    Each rank's autograd sees only its block of clients (no implicit sum
    of gradients across ranks); the block-mean gradients, loss and acc,
    and with ``local_steps > 1`` the block-mean params, cross ranks in one
    ``pmean``. The final combine uses the replicated params and lr."""
    if local_steps < 1:
        raise ValueError("local_steps must be >= 1")

    def round_fn(params, client_X, client_y, lr):
        X, y = C.shard(mesh, axis, client_X, client_y)
        p = [t.detach() for t in params]
        loss, acc, g, mean_p = _client_step(loss_fn, p, X, y, lr, local_steps, carry_dtype)
        local = list(g) + [loss, acc]
        if local_steps > 1:
            local += list(mean_p)
        mean = C.pmean_many(local, mesh, axis)
        n = len(p)
        # copies: a view would keep the whole all-reduced buffer (every
        # gradient) alive for as long as the caller keeps the loss
        g, (loss, acc) = mean[:n], (t.clone() for t in mean[n: n + 2])
        mean_p = mean[n + 2:] if local_steps > 1 else p
        new_p = [mp - lr * gi for mp, gi in zip(mean_p, g)]
        return new_p, loss, acc

    return round_fn
