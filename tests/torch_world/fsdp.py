"""Rank side of tests/test_torch_fsdp.py: FSDP over an "fsdp" axis of 4
ranks (parameters, gradients and moments as flat shards)."""

from functools import partial

import numpy as np
import torch

from pygrid_tpu_torch.models import mlp, transformer
from pygrid_tpu_torch.parallel import collectives as C
from pygrid_tpu_torch.parallel import make_fsdp_training_step, make_mesh, shard_params
from pygrid_tpu_torch.parallel import unshard_params
from torch_world import registry

CASES, case = registry()

TF_CFG = transformer.TransformerConfig(vocab=29, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                                       max_len=8)


def _mesh():
    return make_mesh(4, axes=("fsdp",), device="cpu")


def _params(inp, prefix):
    return [torch.from_numpy(inp[f"{prefix}_p{i}"]) for i in range(int(inp[f"{prefix}_n"]))]


def _train(inp, optimizer, prefix, data, n_steps, lr):
    mesh, params = _mesh(), _params(inp, prefix)
    init_state, step = make_fsdp_training_step(mlp.loss_and_acc, params, mesh, optimizer=optimizer)
    state = init_state(params)
    X, y = torch.from_numpy(inp[f"{data}_X"]), torch.from_numpy(inp[f"{data}_y"])
    losses, accs = [], []
    for _ in range(n_steps):
        state, loss, acc = step(state, X, y, lr)
        losses.append(float(loss))
        accs.append(float(acc))
    return mesh, params, state, losses, accs


def _matches(optimizer):
    def run(inp):
        mesh, params, state, losses, _ = _train(inp, optimizer, "m", "d0", 3, 0.1)
        full = unshard_params(state["shards"], params, mesh)
        return {"losses": np.array(losses), **{f"p{i}": p.numpy() for i, p in enumerate(full)}}
    return run


for opt in ("sgd", "momentum", "adam"):
    CASES[f"matches_{opt}"] = _matches(opt)


@case
def state_is_sharded(inp):
    mesh, params, state, _, _ = _train(inp, "adam", "m", "d0", 1, 0.1)
    buffers = list(state["shards"]) + [s for group in state["moments"] for s in group]
    whole = [C.all_gather(b, mesh, "fsdp").numpy() for b in buffers]  # [4, shard_len] each
    return {"n_buffers": np.array(len(buffers)), "n_params": np.array(len(params)),
            "row_shapes": np.array([b.shape for b in buffers]),
            "rows_differ": np.array([len({w[r].tobytes() for r in range(4)}) for w in whole])}


@case
def padding_is_inert(inp):
    mesh, params = _mesh(), _params(inp, "pad")
    back = unshard_params(shard_params(params, mesh), params, mesh)
    init_state, step = make_fsdp_training_step(mlp.loss_and_acc, params, mesh, optimizer="sgd")
    state, _, _ = step(init_state(params), torch.from_numpy(inp["d0_X"]),
                       torch.from_numpy(inp["d0_y"]), 0.1)
    last = C.all_gather(state["shards"][-1], mesh, "fsdp").reshape(-1)  # 10 real + 2 pad
    return {**{f"back{i}": b.numpy() for i, b in enumerate(back)},
            "tail": last[params[-1].numel():].numpy()}


@case
def learns(inp):
    _, _, _, losses, accs = _train(inp, "adam", "learn", "d7", 31, 0.01)
    return {"first": np.array(losses[0]), "loss": np.array(losses[-1]), "acc": np.array(accs[-1])}


@case
def transformer_fsdp(inp):
    mesh, params = _mesh(), _params(inp, "tf")
    loss_fn = partial(transformer.loss_and_acc, cfg=TF_CFG)
    init_state, step = make_fsdp_training_step(loss_fn, params, mesh)
    tok = torch.from_numpy(inp["tf_tok"])
    state, loss, _ = step(init_state(params), tok, torch.roll(tok, -1, dims=1), 0.1)
    full = unshard_params(state["shards"], params, mesh)
    return {"loss": loss.numpy(), **{f"p{i}": p.numpy() for i, p in enumerate(full)}}
