"""Pipeline parallelism: stage-sharded layers, a microbatched GPipe schedule.

Counterpart of :mod:`pygrid_tpu.parallel.pipeline`, over a ``"stage"``
mesh axis (:mod:`.collectives`):

- the stacked per-stage parameters (leading axis P) are cut so that each
  rank holds its stage's slice;
- the batch splits into M microbatches; at tick t stage s works on
  microbatch t − s, so all stages run at once once the pipeline fills
  (T = M + P − 1 ticks);
- activations hop stage → stage + 1 each tick by ``ppermute``, and the
  last stage's outputs reach every rank through a masked psum;
- the tick loop is Python, and autograd runs the schedule backward:
  ``ppermute``'s backward is the reverse hop, the psum's the identity, and
  the stage slice's an all-gather, so every rank ends with the whole
  stacked gradient.

Every rank-dependent choice (first stage, last stage, an idle tick) is a
``torch.where`` on a 0-d mask, so the graph has the same shape on every
rank and the collectives run backward in the same order everywhere.
``stage_fn`` must keep the activation's shape.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from pygrid_tpu_torch.parallel import collectives as C


def pipeline_apply(
    stage_fn: Callable,
    stacked_params,
    x: torch.Tensor,
    mesh,
    axis: str = "stage",
    n_microbatches: int | None = None,
) -> torch.Tensor:
    """Run ``x`` through the P pipelined stages; exact against
    :func:`sequential_apply`.

    ``stacked_params``: a pytree whose leaves have leading axis P (one
    slice per stage); ``x``: ``[B, ...]`` with B divisible by
    ``n_microbatches`` (default P). Returns the last stage's activations,
    replicated on every rank."""
    p_sz, s = C.axis_size(mesh, axis), C.axis_index(mesh, axis)
    M = n_microbatches or p_sz
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    x_micro = x.reshape((M, B // M) + tuple(x.shape[1:]))
    leaves, spec = pytree.tree_flatten(stacked_params)
    *blocks, x_micro = C.shard(mesh, axis, *leaves, x_micro, dims=(0,) * len(leaves) + (None,))
    params = pytree.tree_unflatten([b[0] for b in blocks], spec)  # this rank's stage
    fwd = [(i, i + 1) for i in range(p_sz - 1)]  # stage s -> s + 1

    def flag(cond: bool) -> torch.Tensor:
        return torch.tensor(cond, device=x.device)

    is_first, is_last = flag(s == 0), flag(s == p_sz - 1)
    act = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(M + p_sz - 1):
        recv = C.ppermute(act, mesh, axis, fwd)
        inp = torch.where(is_first, x_micro[min(max(t, 0), M - 1)], recv)
        h = stage_fn(params, inp)
        active = flag(s <= t < s + M)
        h = torch.where(active, h, torch.zeros_like(h))
        emit = min(max(t - s, 0), M - 1)
        row = torch.where(active & is_last, h, outs[emit])
        outs = torch.cat([outs[:emit], row[None], outs[emit + 1:]])
        act = h
    # only the last stage holds real outputs; the psum brings them to all
    out = C.psum(torch.where(is_last, outs, torch.zeros_like(outs)), mesh, axis)
    return out.reshape((B,) + tuple(x.shape[1:]))


def sequential_apply(stage_fn: Callable, stacked_params, x: torch.Tensor) -> torch.Tensor:
    """Single-device reference: fold the stages in order."""
    leaves, spec = pytree.tree_flatten(stacked_params)
    h = x
    for s in range(leaves[0].shape[0]):
        h = stage_fn(pytree.tree_unflatten([leaf[s] for leaf in leaves], spec), h)
    return h


def make_pipeline_training_step(
    stage_fn: Callable,
    loss_fn: Callable,
    mesh,
    axis: str = "stage",
    n_microbatches: int | None = None,
):
    """SGD step on a pipelined trunk: the gradient through the schedule.

    ``loss_fn(y_hat, y) -> scalar``. Returns ``step(stacked_params, X, y,
    lr) -> (loss, new_stacked_params)``, replicated on every rank."""
    apply = partial(pipeline_apply, stage_fn, mesh=mesh, axis=axis,
                    n_microbatches=n_microbatches)

    def step(stacked_params, X, y, lr):
        leaves, spec = pytree.tree_flatten(stacked_params)
        leaves = [p.detach().requires_grad_() for p in leaves]
        loss = loss_fn(apply(pytree.tree_unflatten(leaves, spec), x=X), y)
        grads = torch.autograd.grad(loss, leaves)
        new = [p.detach() - lr * g for p, g in zip(leaves, grads)]
        return loss.detach(), pytree.tree_unflatten(new, spec)

    return step
