"""MNIST MLP — the reference's model-centric example model.

Counterpart of :mod:`pygrid_tpu.models.mlp`: the 784→392→10 two-layer MLP
of the reference training plan (``examples/model-centric/01-Create-plan.ipynb``
cells 10 and 16: softmax-CE + SGD with an accuracy output). ``init`` gives
the flat param list ``[w1, b1, w2, b2, ...]`` and ``training_step`` the plan
signature ``(X, y, lr, *params) -> (loss, acc, *new_params)``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.utils import prng


def param_shapes(sizes: Sequence[int] = (784, 392, 10)) -> list[tuple[int, ...]]:
    """Shapes of the flat param list, in order."""
    shapes: list[tuple[int, ...]] = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        shapes += [(n_in, n_out), (n_out,)]
    return shapes


def init(
    sizes: Sequence[int] = (784, 392, 10),
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> list[torch.Tensor]:
    """He-normal weights and zero biases, drawn on the CPU from
    ``generator`` (seed 0 when None) and moved to ``device``."""
    dev = resolve(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    draws = (lambda shape: torch.randn(shape, generator=g) for _ in sizes[1:])
    return [p.to(dev) for p in _draw(sizes, draws)]


def _draw(sizes: Sequence[int], normals) -> list[torch.Tensor]:
    """He-normal weights (layer ``i`` from the ``i``-th of ``normals``,
    each a ``normal(shape)``) and zero biases, on the CPU."""
    params: list[torch.Tensor] = []
    for normal, n_in, n_out in zip(normals, sizes[:-1], sizes[1:]):
        params.append(normal((n_in, n_out)) * (2.0 / n_in) ** 0.5)
        params.append(torch.zeros(n_out))
    return params


def init_from_key(
    key: torch.Tensor,
    sizes: Sequence[int] = (784, 392, 10),
    device: str | torch.device = "cuda",
) -> list[torch.Tensor]:
    """The reference's ``mlp.init(key, sizes)``: the same ``jax.random``
    draws through :mod:`pygrid_tpu_torch.utils.prng` (each weight within a
    few f32 ulps), for a threefry ``key`` ``[2]``, moved to ``device``."""
    dev = resolve(device)
    keys = prng.split(key.cpu(), len(sizes) - 1)
    draws = (lambda shape, k=k: prng.normal(k, shape) for k in keys)
    return [p.to(dev) for p in _draw(sizes, draws)]


def apply(params: Sequence[torch.Tensor], X: torch.Tensor) -> torch.Tensor:
    h = X
    for i in range(0, len(params) - 2, 2):
        h = torch.relu(h @ params[i] + params[i + 1])
    return h @ params[-2] + params[-1]


def loss_and_acc(params: Sequence[torch.Tensor], X: torch.Tensor, y: torch.Tensor):
    """Softmax cross-entropy (y one-hot) and accuracy."""
    logits = apply(params, X)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -(y * logp).sum(-1).mean()
    acc = (logits.argmax(-1) == y.argmax(-1)).float().mean()
    return loss, acc


def training_step(X, y, lr, *params):
    """One SGD step (reference plan signature)."""
    leaves = [p.detach().requires_grad_() for p in params]
    loss, acc = loss_and_acc(leaves, X, y)
    grads = torch.autograd.grad(loss, leaves)
    new_params = [p.detach() - lr * g for p, g in zip(params, grads)]
    return (loss.detach(), acc.detach(), *new_params)
