"""Rank side of tests/test_torch_sharded_rounds.py: the FedAvg round
builders and the SecAgg simulation with the clients split over 4 ranks."""

import torch

from pygrid_tpu_torch.models import mlp
from pygrid_tpu_torch.parallel import (
    make_mesh,
    make_sharded_fused_round,
    make_sharded_masked_sum,
    make_sharded_round,
    masked_sum,
    run_rounds,
    simulate_secagg_round,
)
from torch_world import registry

CASES, case = registry()


def _mesh():
    return make_mesh(4, axes=("clients",), device="cpu")


def _t(a):
    return torch.from_numpy(a)


def _params(inp, prefix):
    return [_t(inp[f"{prefix}_p{i}"]) for i in range(4)]


def _out(params, loss, acc):
    return {**{f"p{i}": p.numpy() for i, p in enumerate(params)},
            "loss": loss.numpy(), "acc": acc.numpy()}


@case
def sharded_round(inp):
    fn = make_sharded_round(mlp.training_step, _mesh(), local_steps=1)
    return _out(*fn(_params(inp, "r"), _t(inp["r_X"]), _t(inp["r_y"]), 0.1))


@case
def sharded_round_learns(inp):
    fn = make_sharded_round(mlp.training_step, _mesh(), local_steps=2)
    params, metrics = run_rounds(fn, _params(inp, "l"), _t(inp["l_X"]), _t(inp["l_y"]), 0.5, 4)
    return {**{f"p{i}": p.numpy() for i, p in enumerate(params)},
            "accs": torch.stack([a for _, a in metrics]).numpy(),
            "losses": torch.stack([l for l, _ in metrics]).numpy()}


def _fused(inp, local_steps, carry_dtype):
    fn = make_sharded_fused_round(mlp.loss_and_acc, _mesh(), local_steps=local_steps,
                                  carry_dtype=carry_dtype)
    return _out(*fn(_params(inp, "f"), _t(inp["f_X"]), _t(inp["f_y"]), 0.2))


@case
def fused_1(inp):
    return _fused(inp, 1, None)


@case
def fused_2(inp):
    return _fused(inp, 2, None)


@case
def fused_3_bf16(inp):
    return _fused(inp, 3, torch.bfloat16)


def _key(inp, name):
    return torch.from_numpy(inp[name].astype("int64"))


@case
def masked_sum_on_mesh(inp):
    key = _key(inp, "sum_key")
    total = make_sharded_masked_sum(_mesh())(key, inp["sum_q"])
    return {"total": total.numpy(), "single": masked_sum(key, inp["sum_q"], device="cpu").numpy()}


@case
def secagg_round_on_mesh(inp):
    key = _key(inp, "round_key")
    return {"mesh": simulate_secagg_round(key, inp["round_diffs"], 0.1, mesh=_mesh(), device="cpu"),
            "single": simulate_secagg_round(key, inp["round_diffs"], 0.1, device="cpu")}
