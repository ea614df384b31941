"""pygrid_tpu_torch — the PyTorch/CUDA port of pygrid_tpu.

A second package beside the JAX one, written for an NVIDIA H100: plain
tensor code is PyTorch, and every Pallas kernel of the reference becomes a
hand-written CUDA kernel for ``sm_90a`` (``csrc/``, built at first use by
:mod:`pygrid_tpu_torch.kernels.build`). It imports neither ``jax`` nor
anything of ``pygrid_tpu``.

Ported so far: the federated transformer round — the transformer and MLP
models, the FedAvg round builders (opaque and fused) and flash attention
with its forward, dK/dV and dQ kernels — and the SMPC compute plane
(:mod:`pygrid_tpu_torch.smpc`) with its Z_2^64 ring-matmul kernel, the
node's wire and storage plane (``serde``, ``native``, ``storage``), the
model-centric FL cycle (``federated``, ``plans``, ``telemetry``), the
data-centric plane (``runtime``, ``smpc.remote``, ``smpc.encrypted_model``,
``datacentric``), generation serving (``models.decode``, ``serving``,
``utils.prng``, ``telemetry.profiler``/``recorder``), and the Node app with
its clients (``node``, ``client``, ``users``, ``telemetry.slo``/``promtext``)
over the port's own HTTP and WebSocket layer (``web``). Entry points take
``device`` and default to ``"cuda"``; without a GPU they raise unless the
caller passes ``device="cpu"``.
"""

from pygrid_tpu_torch.device import resolve

__all__ = ["resolve"]
