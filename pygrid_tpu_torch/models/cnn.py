"""MNIST CNN — the reference's data-centric example model, in PyTorch.

Counterpart of :mod:`pygrid_tpu.models.cnn`: conv(1→32, 3x3) → conv(32→64,
3x3) → maxpool 2 → fc(9216→128) → fc(128→10), from reference
``examples/data-centric/mnist/02-FL-mnist-train-model.ipynb`` cell 11.

The parameter list is the JAX package's, exactly: HWIO conv weights, a
``[9216, 128]`` and a ``[128, 10]`` fc weight, so params cross through
:mod:`pygrid_tpu_torch.convert` and the wire with no reordering, and ``X``
is NHWC ``[N, 28, 28, 1]``. The convolutions run in NCHW (cuDNN's layout);
the pooled activation goes back to NHWC before the flatten, because the
reference flattens in H, W, C order and ``w3``'s rows follow it.

ReLU is ``torch.maximum(h, 0)``, not ``torch.relu``: its gradient at an
exact 0 is 1/2, as ``jnp.maximum``'s is. Max-pool ties (a window of
post-ReLU zeros) route the gradient to the first element in row-major
window order, as XLA's select-and-scatter does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from pygrid_tpu_torch.device import resolve

PARAM_SHAPES = [(3, 3, 1, 32), (32,), (3, 3, 32, 64), (64,), (9216, 128), (128,),
                (128, 10), (10,)]


def init(
    generator: torch.Generator | None = None, device: str | torch.device = "cuda"
) -> list[torch.Tensor]:
    """He-normal weights and zero biases, drawn on the CPU from
    ``generator`` (seed 0 when None) and moved to ``device``."""
    dev = resolve(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    fan_in = {0: 9, 2: 9 * 32, 4: 9216, 6: 128}
    params = []
    for i, shape in enumerate(PARAM_SHAPES):
        if i in fan_in:
            params.append(torch.randn(shape, generator=g) * (2.0 / fan_in[i]) ** 0.5)
        else:
            params.append(torch.zeros(shape))
    return [p.to(dev) for p in params]


def _conv(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """VALID 3x3 convolution of an NCHW activation by an HWIO weight."""
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1))


def apply(params: Sequence[torch.Tensor], X: torch.Tensor) -> torch.Tensor:
    """X: [N, 28, 28, 1] → logits [N, 10]."""
    w1, b1, w2, b2, w3, b3, w4, b4 = params
    zero = X.new_zeros(())
    h = X.permute(0, 3, 1, 2)                                     # NCHW
    h = torch.maximum(_conv(h, w1) + b1[:, None, None], zero)     # [N,32,26,26]
    h = torch.maximum(_conv(h, w2) + b2[:, None, None], zero)     # [N,64,24,24]
    h = F.max_pool2d(h, 2)                                        # [N,64,12,12]
    # NHWC flatten; the explicit copy keeps a traced plan's view valid
    # whatever layout the pool's output has on the device it runs on
    h = h.permute(0, 2, 3, 1).clone(memory_format=torch.contiguous_format)
    h = h.view(h.shape[0], -1)
    h = torch.maximum(h @ w3 + b3, zero)
    return h @ w4 + b4


def loss_and_acc(params: Sequence[torch.Tensor], X: torch.Tensor, y: torch.Tensor):
    """Softmax cross-entropy (y one-hot) and accuracy."""
    logits = apply(params, X)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -(y * logp).sum(-1).mean()
    acc = (logits.argmax(-1) == y.argmax(-1)).to(torch.float32).mean()
    return loss, acc


def training_step(X, y, lr, *params):
    """One SGD step (reference plan signature ``(X, y, lr, *params) ->
    (loss, acc, *new_params)``), its gradient by ``torch.func`` so the
    step traces into a Plan as plain ATen ops."""
    grads, (loss, acc) = torch.func.grad_and_value(
        lambda ps: loss_and_acc(ps, X, y), has_aux=True
    )(list(params))
    new_params = [p - lr * g for p, g in zip(params, grads)]
    return (loss, acc, *new_params)
