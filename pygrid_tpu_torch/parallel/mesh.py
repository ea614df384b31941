"""Device meshes for the simulated grid, on ``torch.distributed``.

Counterpart of :mod:`pygrid_tpu.parallel.mesh`. The reference's mesh is a
``jax.sharding.Mesh`` over the devices of one program; the port's is a
``torch.distributed`` ``DeviceMesh`` over the ranks of an initialised
world, one process per rank (one GPU each on the card), whose named axes
carry the grid's parallel dimensions as the reference's do: ``"clients"``
(federated participants, aggregated by a collective), ``"model"``,
``"seq"``, ``"stage"``, ``"expert"``, ``"fsdp"``, ``"parties"``.

The mesh programs (:mod:`.collectives`) take whole inputs on every rank:
:func:`client_sharding` and :func:`replicated` give the :class:`Sharding`
that cuts a rank's block out of a whole input, or passes it, as
``NamedSharding(mesh, P(axis))`` and ``P()`` place the reference's.

``initialize_distributed`` starts the world from torch's ``env://``
variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as
``torchrun`` sets them): NCCL for the card, gloo for the CPU. Without
them it does nothing, as the reference does without ``JAX_COORDINATOR``.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.parallel import collectives as C


def make_mesh(
    n_devices: int | None = None,
    axes: tuple[str, ...] = ("clients",),
    shape: tuple[int, ...] | None = None,
    device: str | torch.device = "cuda",
):
    """A ``DeviceMesh`` over all ranks of the initialised world.

    Default: every rank on one ``"clients"`` axis. ``shape`` splits them
    over several axes, e.g. ``axes=("clients", "model"), shape=(2, 2)``.
    ``n_devices`` must be the world size (the port's mesh spans the whole
    world); a shape that does not multiply to it raises. On the card each
    rank takes GPU ``rank % device_count``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialised: call initialize_distributed() "
            "or torch.distributed.init_process_group first"
        )
    world = dist.get_world_size()
    n = n_devices or world
    if shape is None:
        shape = (n,)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a world of {world} ranks")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} does not name its axes {tuple(axes)}")
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on for ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class Sharding(NamedTuple):
    """Where a whole input lives on a mesh: split over ``axis`` on its
    leading dimension, or replicated (``axis=None``)."""

    mesh: object
    axis: str | None

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole ``x`` (its own part of the
        leading dimension), or ``x`` itself when replicated."""
        if self.axis is None:
            return x
        return C.shard(self.mesh, self.axis, x)

    def whole(self, block: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (the inverse of
        :meth:`block`)."""
        if self.axis is None:
            return block
        return C.all_gather(block, self.mesh, self.axis)


def client_sharding(mesh, axis: str = "clients") -> Sharding:
    """Leading-axis sharding: one block of clients per rank."""
    return Sharding(mesh, axis)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, None)


def initialize_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    device: str | torch.device = "cuda",
) -> None:
    """Start the multi-process world: ``init_method`` (default ``env://``
    when ``MASTER_ADDR`` is set), ``WORLD_SIZE`` and ``RANK`` from the
    arguments or the environment. NCCL for ``device="cuda"``, gloo for the
    CPU. A no-op without ``MASTER_ADDR`` or ``init_method``, and when the
    world is already up."""
    dev = resolve(device)
    if init_method is None:
        if not os.environ.get("MASTER_ADDR"):
            return
        init_method = "env://"
    if dist.is_initialized():
        return
    world_size = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", 1))
    rank = rank if rank is not None else int(os.environ.get("RANK", 0))
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
