"""ZeRO-style fully-sharded data parallelism (FSDP) over a mesh axis.

Counterpart of :mod:`pygrid_tpu.parallel.fsdp`, with its layout:
parameters, gradients and optimizer state live as flat shards over an
``"fsdp"`` mesh axis, each rank holding 1/N of every tensor, and the full
parameters exist only inside a step:

- one all-gather (``all_gather_into_tensor`` of all the rank's shards,
  concatenated) materialises the full parameters before the forward;
- the backward's full-size gradients go back to shards in one
  reduce-scatter (``reduce_scatter_tensor``), which sums the ranks'
  local-batch gradients and leaves each rank its own shard; ``/ n`` turns
  the sum of local means into the global-batch mean;
- the optimizer update (SGD, momentum, Adam) runs on the local shard
  against local moments that are never gathered.

Every leaf is flattened and zero-padded to a multiple of the axis size:
uneven leaves (biases, layer-norm scales) shard evenly, and the padding is
inert (its gradients are zero, and :func:`unshard_params` slices it away).
torch's own ``fully_shard`` is not used: its per-parameter dim-0 shards do
not keep this shard-size and padding contract.

The state is local to each rank: ``state["shards"]`` and the moments hold
the rank's ``[1, shard_len]`` rows (the reference's ``[n, shard_len]``
arrays sharded on their leading axis).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from pygrid_tpu_torch.parallel import collectives as C


def _flat_padded(leaf: torch.Tensor, n: int) -> torch.Tensor:
    flat = leaf.reshape(-1)
    pad = (-flat.numel()) % n
    return F.pad(flat, (0, pad)) if pad else flat


def shard_params(params: Sequence[torch.Tensor], mesh, axis: str = "fsdp") -> list[torch.Tensor]:
    """This rank's row of each leaf laid out as ``[n, ceil(size/n)]``:
    a ``[1, ceil(size/n)]`` tensor, 1/N of the zero-padded leaf."""
    n, i = C.axis_size(mesh, axis), C.axis_index(mesh, axis)
    return [_flat_padded(p.detach(), n).reshape(n, -1)[i: i + 1].clone() for p in params]


def _gather_full(shards: Sequence[torch.Tensor], shapes, mesh, axis: str) -> list[torch.Tensor]:
    """The full leaves from every rank's shards: one all-gather of the
    rank's shards concatenated."""
    n = C.axis_size(mesh, axis)
    lens = [s.shape[-1] for s in shards]
    flat = torch.cat([s.reshape(-1) for s in shards])
    rows = C.all_gather(flat, mesh, axis).view(n, -1)  # [n, sum(lens)]
    full, off = [], 0
    for ln, (shape, size) in zip(lens, shapes):
        full.append(rows[:, off: off + ln].reshape(-1)[:size].reshape(shape))
        off += ln
    return full


def unshard_params(
    shards: Sequence[torch.Tensor],
    params_like: Sequence[torch.Tensor],
    mesh,
    axis: str = "fsdp",
) -> list[torch.Tensor]:
    """The full parameters (for eval, checkpoints, serde) from every rank's
    shards; ``params_like`` gives the shapes and dtypes (e.g. the init
    output). A collective: every rank calls it."""
    full = _gather_full(shards, [(p.shape, p.numel()) for p in params_like], mesh, axis)
    return [f.to(p.dtype) for f, p in zip(full, params_like)]


def _sgd(shard, grad, lr, state, _count, _hp):
    return shard - lr * grad, state


def _momentum(shard, grad, lr, state, _count, hp):
    (m,) = state
    m = hp["beta1"] * m + grad
    return shard - lr * m, (m,)


def _adam(shard, grad, lr, state, count, hp):
    m, v = state
    b1, b2, eps = hp["beta1"], hp["beta2"], hp["eps"]
    m = b1 * m + (1.0 - b1) * grad
    v = b2 * v + (1.0 - b2) * grad * grad
    t = torch.tensor(count, dtype=torch.float32, device=shard.device)
    mhat = m / (1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t))
    vhat = v / (1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t))
    return shard - lr * mhat / (torch.sqrt(vhat) + eps), (m, v)


_OPTIMIZERS: dict[str, tuple[Callable, int]] = {
    "sgd": (_sgd, 0),  # (update_fn, number of moment buffers)
    "momentum": (_momentum, 1),
    "adam": (_adam, 2),
}


def make_fsdp_training_step(
    loss_fn: Callable,
    params_like: Sequence[torch.Tensor],
    mesh,
    axis: str = "fsdp",
    optimizer: str = "sgd",
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[Callable, Callable]:
    """Build the sharded training step.

    ``loss_fn(params, X, y) -> (loss, aux)``, differentiable in ``params``
    (``models.mlp.loss_and_acc``, or ``models.transformer.loss_and_acc``
    through ``functools.partial``); ``params_like`` fixes the leaf shapes.

    Returns ``(init_state, step)``:

    - ``init_state(params) -> state``: this rank's shards and zeroed
      optimizer moments;
    - ``step(state, X, y, lr) -> (state, loss, aux)``: gather → grad →
      reduce-scatter → sharded update. ``X``/``y`` are the whole global
      batches on every rank (the leading axis divides by the axis size);
      each rank takes its block, and loss/aux come back as the
      global-batch mean."""
    if optimizer not in _OPTIMIZERS:
        raise ValueError(f"optimizer {optimizer!r} not in {sorted(_OPTIMIZERS)}")
    update_fn, n_moments = _OPTIMIZERS[optimizer]
    hp = {"beta1": beta1, "beta2": beta2, "eps": eps}
    shapes = [(tuple(p.shape), p.numel()) for p in params_like]

    def init_state(params: Sequence[torch.Tensor]) -> dict:
        shards = shard_params(params, mesh, axis)
        return {
            "shards": shards,
            "moments": [[torch.zeros_like(s) for s in shards] for _ in range(n_moments)],
            "count": 0,
        }

    def step(state: dict, X, y, lr):
        n = C.axis_size(mesh, axis)
        X, y = C.shard(mesh, axis, X, y)
        count = state["count"] + 1
        full = [f.requires_grad_() for f in _gather_full(state["shards"], shapes, mesh, axis)]
        loss, aux = loss_fn(full, X, y)
        grads = torch.autograd.grad(loss, full)
        # reduce-scatter of every leaf at once: row r of the [n, sum(lens)]
        # input holds rank r's share of each padded gradient
        rows = torch.cat([_flat_padded(g, n).view(n, -1) for g in grads], dim=1)
        local = C.psum_scatter(rows.reshape(-1), mesh, axis) / n
        new_shards, new_moments = [], [[] for _ in range(n_moments)]
        off = 0
        for i, s in enumerate(state["shards"]):
            ln = s.shape[-1]
            g = local[off: off + ln]
            off += ln
            new_s, new_state = update_fn(s[0], g, lr, tuple(m[i][0] for m in state["moments"]),
                                         count, hp)
            new_shards.append(new_s[None])
            for k in range(n_moments):
                new_moments[k].append(new_state[k][None])
        loss, aux = C.pmean_many([loss.detach(), aux.detach()], mesh, axis)
        return {"shards": new_shards, "moments": new_moments, "count": count}, loss, aux

    return init_state, step
