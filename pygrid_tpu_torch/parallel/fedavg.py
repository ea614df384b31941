"""FedAvg simulation engine on one device: a client axis, a mean.

Counterpart of :mod:`pygrid_tpu.parallel.fedavg`. The K simulated clients
are the leading axis of the client data; each client's local training runs
the opaque ``training_step`` in a loop written out over that axis (the
reference ``vmap``s it), and the new global params are the mean of the
clients' new params — the reference's reassociation of
``params - mean_k(diff_k)``, so no per-client diff tensor exists. A JAX
``scan`` over local steps or rounds is a Python loop here.

``make_sharded_round`` (the client axis over a mesh) waits for the
multi-device slice.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def _client_update(
    training_step: Callable, params: Sequence, X, y, lr, local_steps: int
):
    """One client's local training: ``local_steps`` SGD steps; returns
    (new params, last step's loss, last step's acc)."""
    p = list(params)
    loss = acc = None
    for _ in range(local_steps):
        out = training_step(X, y, lr, *p)
        loss, acc, p = out[0], out[1], list(out[2:])
    return p, loss, acc


def _mean_round(training_step, params, client_X, client_y, lr, local_steps):
    """mean_k of each client's new params, loss and acc. The sum runs
    client by client, so only one client's new params exist at a time
    beside the running sum."""
    K = client_X.shape[0]
    sums = None
    losses, accs = [], []
    for i in range(K):
        new_p, loss, acc = _client_update(
            training_step, params, client_X[i], client_y[i], lr, local_steps
        )
        sums = new_p if sums is None else [s + n for s, n in zip(sums, new_p)]
        losses.append(loss)
        accs.append(acc)
    return (
        [s / K for s in sums],
        torch.stack(losses).mean(),
        torch.stack(accs).mean(),
    )


def make_round(training_step: Callable, local_steps: int = 1) -> Callable:
    """A FedAvg round over the client axis.

    Returns ``round_fn(params, client_X [K,...], client_y [K,...], lr) ->
    (new_params, mean_loss, mean_acc)``; the new global params equal
    ``params - mean_k(diff_k)`` (reference cycle_manager.py:295-298),
    computed as ``mean_k(new_p_k)``."""

    def round_fn(params, client_X, client_y, lr):
        return _mean_round(
            training_step, params, client_X, client_y, lr, local_steps
        )

    return round_fn


def make_scanned_rounds(
    training_step: Callable,
    n_rounds: int,
    local_steps: int = 1,
    fold_clients: bool = False,
) -> Callable:
    """``n_rounds`` FedAvg rounds in one call. Returns
    ``rounds_fn(params, client_X, client_y, lr) -> (final_params,
    losses[n_rounds], accs[n_rounds])``.

    ``fold_clients=True`` (requires ``local_steps == 1``) runs each round
    as one step on the K·B merged batch: with one local step of a
    mean-loss gradient update, ``mean_k(new_p_k) = step(params,
    concat_k(data))`` — the same update for plain SGD on equal client
    batches."""
    if fold_clients and local_steps != 1:
        raise ValueError(
            "fold_clients requires local_steps=1 (the FedAvg identity "
            "breaks once per-client params diverge between local steps)"
        )

    def rounds_fn(params, client_X, client_y, lr):
        p = list(params)
        losses, accs = [], []
        if fold_clients:
            X = client_X.reshape((-1,) + tuple(client_X.shape[2:]))
            y = client_y.reshape((-1,) + tuple(client_y.shape[2:]))
        for _ in range(n_rounds):
            if fold_clients:
                out = training_step(X, y, lr, *p)
                loss, acc, p = out[0], out[1], list(out[2:])
            else:
                p, loss, acc = _mean_round(
                    training_step, p, client_X, client_y, lr, local_steps
                )
            losses.append(loss)
            accs.append(acc)
        return p, torch.stack(losses), torch.stack(accs)

    return rounds_fn


def run_rounds(
    round_fn: Callable,
    params: Sequence,
    client_X,
    client_y,
    lr,
    n_rounds: int,
):
    """Drive ``n_rounds`` rounds of ``round_fn``; returns (params,
    [(loss, acc) per round])."""
    metrics = []
    for _ in range(n_rounds):
        params, loss, acc = round_fn(params, client_X, client_y, lr)
        metrics.append((loss, acc))
    return params, metrics
