"""Rank side of tests/test_torch_moe.py: the expert-parallel MoE over an
"expert" axis of 4 ranks."""

import pytest
import torch

from pygrid_tpu_torch import convert
from pygrid_tpu_torch.models import moe
from pygrid_tpu_torch.parallel import make_mesh
from torch_world import registry

CASES, case = registry()

D, FF, E, T = 8, 16, 8, 32


def _mesh():
    return make_mesh(4, axes=("expert",), device="cpu")


def _params(inp):
    return convert.params_from_numpy([inp[f"p{i}"] for i in range(5)], "cpu", moe=(D, FF, E))


@case
def matches_dense(inp):
    params, x = _params(inp), torch.from_numpy(inp["x1"])
    return {"ep": moe.apply_expert_parallel(params, x, _mesh(), capacity_factor=float(E)).numpy(),
            "dense": moe.apply_dense(params, x).numpy()}


@case
def capacity_drops(inp):
    params, x = _params(inp), torch.from_numpy(inp["x2"])
    return {"ep": moe.apply_expert_parallel(params, x, _mesh(), capacity_factor=0.125).numpy(),
            "dense": moe.apply_dense(params, x).numpy()}


@case
def gradients(inp):
    x = torch.from_numpy(inp["x3"])
    out = {}
    for name, fn in (("ep", lambda p: moe.apply_expert_parallel(p, x, _mesh(),
                                                                capacity_factor=float(E))),
                     ("dense", lambda p: moe.apply_dense(p, x))):
        params = [p.requires_grad_() for p in _params(inp)]
        grads = torch.autograd.grad((fn(params) ** 2).mean(), params)
        out.update({f"{name}_g{i}": g.numpy() for i, g in enumerate(grads)})
    return out


@case
def shape_validation(inp):
    params = _params(inp)
    with pytest.raises(ValueError, match="tokens"):
        moe.apply_expert_parallel(params, torch.zeros(T + 1, D), _mesh())
    bad = moe.init(D, FF, E + 1, device="cpu")
    with pytest.raises(ValueError, match="experts"):
        moe.apply_expert_parallel(bad, torch.zeros(T, D), _mesh())
    return {}
