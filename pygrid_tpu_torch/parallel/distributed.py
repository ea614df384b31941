"""Multi-host meshes: an outer axis over hosts, inner axes over a host's GPUs.

Counterpart of :mod:`pygrid_tpu.parallel.distributed`. The reference's
``hybrid_mesh`` puts hosts on an outer axis (collectives over the data-centre
network) and each host's chips on the inner axes (collectives over the chip
interconnect), so data parallelism lands on the slow links and
tensor/sequence/expert parallelism stays on the fast ones. The port builds
the same 2-D ``DeviceMesh`` over the ranks of the world, one process per
GPU, with ranks of one host contiguous (as ``torchrun`` numbers them):
NCCL then runs an inner-axis collective over NVLink and an outer-axis one
across hosts.

``local_batch_slice`` carves this rank's rows of a batch split over the
host axis; ``host_array`` all-gathers the ranks' blocks into the whole
tensor (the reference's ``jax.make_array_from_process_local_data``).
"""

from __future__ import annotations

import math
import socket

import numpy as np
import torch
import torch.distributed as dist

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.parallel import collectives as C
from pygrid_tpu_torch.parallel.mesh import Sharding, make_mesh, mesh_device


def _hosts() -> int:
    """Number of distinct hosts among the world's ranks."""
    names: list = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return len(set(names))


def hybrid_mesh(
    dcn_axis: str = "data",
    ici_axes: tuple[str, ...] = ("model",),
    ici_shape: tuple[int, ...] | None = None,
    num_hosts: int | None = None,
    device: str | torch.device = "cuda",
):
    """Mesh with a host-count outer axis × per-host inner axes.

    ``num_hosts`` overrides the count of hosts the ranks run on (a single
    host then splits its ranks in enumeration order, as the reference does
    for virtual devices). One host degenerates to ``dcn_axis`` of size 1,
    so the same program runs from one GPU to many hosts."""
    dev = resolve(device)
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call initialize_distributed()")
    world = dist.get_world_size()
    if dev.type == "cuda":  # all_gather_object over NCCL runs on the current GPU
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    n_hosts = num_hosts or _hosts()
    per_host = world // n_hosts
    if n_hosts * per_host != world:
        raise ValueError(f"{world} devices don't split over {n_hosts} hosts")
    if ici_shape is None:
        ici_shape = (per_host,) if len(ici_axes) == 1 else None
    if ici_shape is None or math.prod(ici_shape) != per_host:
        raise ValueError(f"ici_shape {ici_shape} must multiply to {per_host} devices per host")
    return make_mesh(world, axes=(dcn_axis,) + tuple(ici_axes),
                     shape=(n_hosts,) + tuple(ici_shape), device=device)


def data_sharding(mesh, dcn_axis: str = "data") -> Sharding:
    """Batch split over hosts (the outer axis), replicated over the inner axes."""
    return Sharding(mesh, dcn_axis)


def local_batch_slice(global_batch: int, mesh, dcn_axis: str = "data") -> slice:
    """This rank's rows of a batch split over the host axis."""
    n = C.axis_size(mesh, dcn_axis)
    if global_batch % n:
        raise ValueError(f"batch {global_batch} not divisible by {n} hosts")
    per = global_batch // n
    idx = C.axis_index(mesh, dcn_axis)
    return slice(idx * per, (idx + 1) * per)


def host_array(local_data, mesh, axis: str | None) -> torch.Tensor:
    """The whole tensor from every rank's block along ``axis`` (the
    leading dimension), on this rank's device; ``axis=None`` means the
    data is replicated and comes back as it is."""
    x = torch.as_tensor(np.asarray(local_data)).to(mesh_device(mesh))
    return Sharding(mesh, axis).whole(x)
