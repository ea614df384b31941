"""The port's MLP (``models/mlp.py``) at a configuration's ``sizes``, and
its float32 reference."""

from __future__ import annotations

import torch

from benchmark.harness import sub_seed
from benchmark.reference import mlp as ref

#: clients the reference steps side by side at a time
REFERENCE_BLOCK_CLIENTS = 256


def init(config: dict, seed: int, device, bias: float = 0.0) -> list[torch.Tensor]:
    """He-normal weights drawn on the device in one call, float32; biases
    0, or uniform in [-bias, bias] from a second call."""
    sizes = config["sizes"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    pairs = list(zip(sizes[:-1], sizes[1:]))
    flat = torch.randn(sum(a * b for a, b in pairs), generator=g, device=device)
    biases = (torch.rand(sum(b for _, b in pairs), generator=g, device=device) * 2 - 1) * bias
    out, off, boff = [], 0, 0
    for a, b in pairs:
        out.append(flat[off:off + a * b].view(a, b).mul_((2.0 / a) ** 0.5))
        out.append(biases[boff:boff + b].clone())
        off, boff = off + a * b, boff + b
    return out


def port_loss(config: dict, spec: dict):
    from pygrid_tpu_torch.models import mlp

    if config["activation"] != "relu" or spec.get("compute_dtype") is not None:
        raise ValueError("the port's MLP loss is ReLU in float32")
    return mlp.loss_and_acc


def reference_rounds(config: dict, spec: dict, params0, batches, precision: str):
    return ref.fedavg_rounds(params0, batches, spec["lr"], spec["local_steps"], precision,
                             block_clients=REFERENCE_BLOCK_CLIENTS)

