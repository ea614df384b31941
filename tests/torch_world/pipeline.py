"""Rank side of tests/test_torch_pipeline.py: a GPipe schedule over a
"stage" axis of 4 ranks."""

import pytest
import torch

from pygrid_tpu_torch.parallel import make_mesh, make_pipeline_training_step, pipeline_apply
from torch_world import registry

CASES, case = registry()


def stage_fn(params, h):
    w, b = params
    return torch.tanh(h @ w + b)


def _mesh():
    return make_mesh(4, axes=("stage",), device="cpu")


def _params(inp, prefix):
    return (torch.from_numpy(inp[f"{prefix}_w"]), torch.from_numpy(inp[f"{prefix}_b"]))


def _matches(n_micro):
    def run(inp):
        out = pipeline_apply(stage_fn, _params(inp, "m"), torch.from_numpy(inp["m_x"]), _mesh(),
                             n_microbatches=n_micro)
        return {"out": out.numpy()}
    return run


for n in (None, 2, 8):
    CASES[f"matches_{n}"] = _matches(n)


@case
def rejects_indivisible_batch(inp):
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(stage_fn, _params(inp, "m"), torch.zeros(6, 16), _mesh(), n_microbatches=4)
    return {}


@case
def gradients(inp):
    params = [p.requires_grad_() for p in _params(inp, "g")]
    x, y = torch.from_numpy(inp["g_x"]), torch.from_numpy(inp["g_y"])
    loss = ((pipeline_apply(stage_fn, tuple(params), x, _mesh()) - y) ** 2).mean()
    gw, gb = torch.autograd.grad(loss, params)
    return {"w": gw.numpy(), "b": gb.numpy()}


@case
def training_step_learns(inp):
    step = make_pipeline_training_step(stage_fn, lambda yh, yy: ((yh - yy) ** 2).mean(), _mesh())
    params, x = _params(inp, "t"), torch.from_numpy(inp["t_x"])
    y = torch.zeros(16, 16)
    loss0, params = step(params, x, y, 0.5)
    losses = [float(loss0)]
    for _ in range(5):
        loss, params = step(params, x, y, 0.5)
        losses.append(float(loss))
    return {"losses": torch.tensor(losses).numpy(), "w": params[0].numpy()}
