"""On-device SecAgg simulation — the kernel-plane twin of the protocol in
:mod:`pygrid_tpu_torch.federated.secagg` / :mod:`pygrid_tpu_torch.client.secagg`:
the port's counterpart of the single-chip half of
:mod:`pygrid_tpu.parallel.secagg_sim`.

Simulated clients do not ride sockets: their masked reports are tensors on
the card and the server's "receive" is a sum over the client axis. Masks
are expanded on the device by the port's threefry
(:mod:`pygrid_tpu_torch.utils.prng`), so client *i* and client *j* derive
the identical pairwise stream from the shared pair key and the uint32 sums
cancel identically: the masks are bit for bit ``jax.random.bits``' of the
same keys, and the sum is the plain quantised sum. uint32 values are
carried in int64 tensors, masked with ``& 0xFFFFFFFF`` after every add and
subtract (wraparound is the group operation).

Self-masks (``b_i``) are omitted, as in the reference: simulated clients
cannot drop between the mask and the sum.

The mesh path (:func:`make_sharded_masked_sum`,
``simulate_secagg_round(mesh=...)``) splits the clients over a mesh axis:
each rank masks its own block of clients (the pair keys derive from the
clients' global indices, so building the masks needs no communication) and
the server's "receive" is one collective sum, in which the masks cancel.
The sum runs on the int64 words (gloo has no uint32 reduction), then
``& 0xFFFFFFFF``: bit for bit the single-device :func:`masked_sum`.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.parallel import collectives as C
from pygrid_tpu_torch.parallel.mesh import mesh_device
from pygrid_tpu_torch.utils import prng

_MASK = 0xFFFFFFFF


def _pair_keys(key: torch.Tensor, i: int, js: torch.Tensor) -> torch.Tensor:
    """Symmetric pair keys ``[len(js), 2]``: fold in (min, max) so both
    ends agree."""
    lo, hi = torch.clamp(js, max=i), torch.clamp(js, min=i)
    return prng.fold_in(prng.fold_in(key.expand(len(js), 2), lo), hi)


def client_mask(
    key: torch.Tensor, i: int, n_clients: int, shape: Sequence[int]
) -> torch.Tensor:
    """Client i's total pairwise mask ``Σ_{j>i} PRG(k_ij) − Σ_{j<i} PRG(k_ij)``
    mod 2^32, int64 on the key's device: one batched draw over all pairs."""
    js = torch.arange(n_clients, dtype=torch.int64, device=key.device)
    bits = prng.random_bits(_pair_keys(key, i, js), shape)     # [K, *shape]
    sign = (js > i).long() - (js < i).long()
    sign = sign.reshape((n_clients,) + (1,) * len(tuple(shape)))
    return (sign * bits).sum(dim=0) & _MASK


def mask_clients(key: torch.Tensor, quantized: torch.Tensor) -> torch.Tensor:
    """Mask a stacked ``[K, ...]`` batch of uint32 values (int64). The masked
    batch sums (mod 2^32) to exactly the unmasked sum."""
    K, shape = quantized.shape[0], tuple(quantized.shape[1:])
    masks = torch.stack([client_mask(key, i, K, shape) for i in range(K)])
    return (quantized + masks) & _MASK


def _as_words(quantized: Any, device: torch.device) -> torch.Tensor:
    """A uint32 batch (numpy, or a tensor of uint32 values) as int64 on
    ``device``."""
    if isinstance(quantized, torch.Tensor):
        return quantized.to(device=device, dtype=torch.int64)
    arr = np.asarray(quantized, dtype=np.uint32).astype(np.int64)
    return torch.from_numpy(arr).to(device)


def masked_sum(
    key: torch.Tensor, quantized: Any, device: str | torch.device = "cuda"
) -> torch.Tensor:
    """Mask every client of ``quantized [K, ...]`` (uint32 values) on
    ``device`` (default ``"cuda"``; without a GPU that raises unless the
    caller passes ``device="cpu"``), then sum mod 2^32: int64 ``[...]``."""
    dev = resolve(device)
    masked = mask_clients(key.to(dev), _as_words(quantized, dev))
    return masked.sum(dim=0) & _MASK


def make_sharded_masked_sum(mesh: Any, axis: str = "clients"):
    """The mesh path: the clients of the whole batch ``quantized [K, ...]``
    split over ``axis`` (K must divide by its size); each rank masks and
    sums its own block, and one collective sum adds the blocks.

    Returns ``fn(key, quantized) -> sum [...]`` (int64 words in
    [0, 2^32)), replicated on every rank."""

    def run(key: torch.Tensor, quantized: Any) -> torch.Tensor:
        dev = mesh_device(mesh)
        q = _as_words(quantized, dev)
        K, shape = q.shape[0], tuple(q.shape[1:])
        n = C.axis_size(mesh, axis)
        if K % n:
            raise ValueError(f"{K} clients do not split over {n} ranks of axis {axis!r}")
        per, base = K // n, C.axis_index(mesh, axis) * (K // n)
        key = key.to(dev)
        block = q[base: base + per]
        masks = torch.stack([client_mask(key, base + i, K, shape) for i in range(per)])
        local = (block + masks).sum(dim=0) & _MASK
        return C.psum(local, mesh, axis) & _MASK

    return run


def simulate_secagg_round(
    key: torch.Tensor,
    diffs: Any,
    clip_range: float,
    mesh: Any = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """End-to-end simulated round for a ``[K, ...]`` float diff batch:
    quantise (host, shared scale) → mask + sum on ``device`` → dequantise
    the mean. Bit-identical to summing the plaintext quantised diffs — the
    masks never meet the result. With ``mesh``, the clients split over its
    ``"clients"`` axis (:func:`make_sharded_masked_sum`) on the mesh's
    device, which must be ``device``."""
    from pygrid_tpu_torch.federated import secagg

    dev = resolve(device)
    if isinstance(diffs, torch.Tensor):
        diffs = diffs.detach().cpu().numpy()
    diffs = np.asarray(diffs)
    K = diffs.shape[0]
    quantized = np.stack([secagg.quantize([d], clip_range, K)[0] for d in diffs])
    if mesh is None:
        total = masked_sum(key, quantized, device=dev)
    else:
        if mesh_device(mesh).type != dev.type:
            raise ValueError(f"the mesh lives on {mesh.device_type}, not on {dev}")
        total = make_sharded_masked_sum(mesh)(key, quantized)
    words = total.cpu().numpy().astype(np.uint32)
    return secagg.dequantize_sum([words], clip_range, K, K)[0]
