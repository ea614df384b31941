"""Rank side of tests/test_torch_mesh.py: the collectives, make_mesh,
parallel/distributed.py and ring_psum on a world of 4."""

import numpy as np
import pytest
import torch

from pygrid_tpu_torch.parallel import collectives as C
from pygrid_tpu_torch.parallel import distributed as D
from pygrid_tpu_torch.parallel import make_mesh
from pygrid_tpu_torch.smpc import ring as R
from torch_world import registry

CASES, case = registry()


def _mesh():
    return make_mesh(4, axes=("i",), device="cpu")


def _value_and_grad(fn, x, cot):
    """fn's whole output and the gradient of sum(cot * output) w.r.t. x."""
    x = torch.from_numpy(x).requires_grad_()
    out = fn(x)
    (g,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), x)
    return {"out": out.detach().numpy(), "grad": g.numpy()}


def _sharded(body, dim=0):
    """A mesh program with in_specs and out_specs P("i") on ``dim``."""
    mesh = _mesh()
    return lambda x: C.all_gather(body(C.shard(mesh, "i", x, dims=dim), mesh), mesh, "i", dim)


@case
def psum(inp):
    mesh = _mesh()
    return _value_and_grad(lambda x: C.psum(C.shard(mesh, "i", x), mesh, "i"),
                           inp["x"], inp["cot_block"])


@case
def pmean(inp):
    mesh = _mesh()
    return _value_and_grad(lambda x: C.pmean(C.shard(mesh, "i", x), mesh, "i"),
                           inp["x"], inp["cot_block"])


@case
def replicated_input(inp):
    mesh = _mesh()
    scale = C.axis_index(mesh, "i") + 1.0
    return _value_and_grad(lambda x: C.psum(C.shard(mesh, "i", x, dims=None) * scale, mesh, "i"),
                           inp["x"], inp["cot"])


@case
def all_gather(inp):
    mesh = _mesh()
    # each rank scales its block by its index + 1, then gathers it whole:
    # the output is replicated, so sum(cot * out) is every rank's objective
    return _value_and_grad(
        lambda x: C.all_gather(C.shard(mesh, "i", x) * (C.axis_index(mesh, "i") + 1.0), mesh, "i"),
        inp["x"], inp["cot"])


@case
def psum_scatter(inp):
    return _value_and_grad(_sharded(lambda b, mesh: C.psum_scatter(b, mesh, "i")),
                           inp["x_wide"], inp["cot_scatter"])


@case
def all_to_all(inp):
    return _value_and_grad(
        _sharded(lambda b, mesh: C.all_to_all(b, mesh, "i", split_axis=1, concat_axis=0)),
        inp["x_a2a"], inp["cot_a2a"])


@case
def ppermute_ring(inp):
    ring = [(i, (i + 1) % 4) for i in range(4)]
    return _value_and_grad(_sharded(lambda b, mesh: C.ppermute(b, mesh, "i", ring) * 2.0),
                           inp["x"], inp["cot"])


@case
def ppermute_chain(inp):
    chain = [(0, 1), (1, 2), (2, 3)]  # rank 0 receives nothing: zeros
    return _value_and_grad(_sharded(lambda b, mesh: C.ppermute(b, mesh, "i", chain) * 2.0),
                           inp["x"], inp["cot"])


@case
def axis_index(inp):
    mesh = make_mesh(4, axes=("a", "b"), shape=(2, 2), device="cpu")
    return {"index": np.array([C.axis_index(mesh, "a"), C.axis_index(mesh, "b")]),
            "size": np.array([C.axis_size(mesh, "a"), C.axis_size(mesh, "b")]),
            "rank": np.array(torch.distributed.get_rank())}


@case
def make_mesh_checks(inp):
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh(4, axes=("a", "b"), shape=(3, 2), device="cpu")
    with pytest.raises(ValueError, match="world"):
        make_mesh(2, axes=("a",), device="cpu")
    with pytest.raises(ValueError, match="permutation"):
        C.ppermute(torch.zeros(2), _mesh(), "i", [(0, 1), (1, 1)])
    with pytest.raises(ValueError, match="no axis"):
        C.axis_size(_mesh(), "seq")
    mesh = make_mesh(device="cpu")
    return {"names": np.array(mesh.mesh_dim_names), "shape": np.array(mesh.shape)}


@case
def hybrid_single_host(inp):
    mesh = D.hybrid_mesh(ici_axes=("model",), device="cpu")
    return {"names": np.array(mesh.mesh_dim_names), "shape": np.array(mesh.shape)}


@case
def hybrid_simulated_multihost(inp):
    mesh = D.hybrid_mesh(ici_axes=("model",), ici_shape=(2,), num_hosts=2, device="cpu")
    return {"shape": np.array(mesh.shape), "ranks": mesh.mesh.numpy()}


@case
def hybrid_rejects_bad_split(inp):
    with pytest.raises(ValueError):
        D.hybrid_mesh(ici_axes=("model",), ici_shape=(3,), num_hosts=2, device="cpu")
    with pytest.raises(ValueError):
        D.hybrid_mesh(ici_axes=("model",), num_hosts=3, device="cpu")
    return {}


@case
def local_batch_slice(inp):
    mesh = D.hybrid_mesh(ici_axes=("model",), ici_shape=(2,), num_hosts=2, device="cpu")
    sl = D.local_batch_slice(32, mesh)
    with pytest.raises(ValueError):
        D.local_batch_slice(31, mesh)
    return {"slice": np.array([sl.start, sl.stop])}


@case
def data_sharding_psum_over_dcn_axis(inp):
    mesh = D.hybrid_mesh(dcn_axis="hosts", ici_axes=("clients",), ici_shape=(2,), num_hosts=2,
                         device="cpu")
    x = torch.from_numpy(inp["x_hosts"])  # [hosts, clients]
    block = C.shard(mesh, "clients", D.data_sharding(mesh, "hosts").block(x), dims=1)
    total = C.psum(block, mesh, "hosts")
    return {"out": C.all_gather(total, mesh, "clients", dim=1).numpy()}


@case
def host_array(inp):
    single = D.hybrid_mesh(ici_axes=("model",), device="cpu")
    local = inp["local"]
    one = D.host_array(local, single, "data")
    two_hosts = D.hybrid_mesh(ici_axes=("model",), ici_shape=(2,), num_hosts=2, device="cpu")
    rows = D.local_batch_slice(local.shape[0], two_hosts)
    whole = D.host_array(local[rows], two_hosts, "data")
    replicated = D.host_array(local, two_hosts, None)
    return {"one": one.numpy(), "whole": whole.numpy(), "replicated": replicated.numpy()}


@case
def ring_psum(inp):
    mesh = _mesh()
    rank = torch.distributed.get_rank()
    per_rank = R.to_ring(inp["ring_vals"][rank], device="cpu")  # [16]
    stacked = R.to_ring(inp["ring_parties"][2 * rank: 2 * rank + 2], device="cpu")  # [2, 16]
    seeds = [R.ring_psum(R.to_ring(v[2 * rank: 2 * rank + 2], device="cpu"), mesh, "i")
             for v in inp["ring_seeds"]]
    return {"no_local": R.from_ring(R.ring_psum(per_rank, mesh, "i", local_axis=None)),
            "local": R.from_ring(R.ring_psum(stacked, mesh, "i")),
            "seeds": np.stack([R.from_ring(s) for s in seeds])}
