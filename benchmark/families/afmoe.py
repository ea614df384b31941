"""The port's AFMoE decoder (``models/afmoe.py``) at a configuration's
``port`` sizes, and its float32 reference."""

from __future__ import annotations

import torch

from benchmark.harness import sub_seed
from benchmark.reference import afmoe as ref
from benchmark.reference.precision import matmul, products

#: sequences of the merged client batch the reference takes at a time, and
#: queries of a sequence its attention takes at a time, so that its f32
#: activations of one layer fit beside the round's states
REFERENCE_BLOCK_ROWS = 1
REFERENCE_Q_BLOCK = 1024


def _shapes(c: dict) -> list:
    """(kind, shape) of the flat list in the port's order: "w" a matrix
    drawn normal, "1" a norm's scale."""
    d, H, Hk, hd = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"]
    G = c["experts_held"][1] - c["experts_held"][0]
    attn = [("1", (d,)), ("w", (d, H * hd)), ("w", (d, Hk * hd)), ("w", (d, Hk * hd)),
            ("w", (d, H * hd)), ("1", (hd,)), ("1", (hd,)), ("w", (H * hd, d)),
            ("1", (d,)), ("1", (d,)), ("1", (d,))]
    dense = attn + [("w", (d, 2 * c["d_ff"])), ("w", (c["d_ff"], d))]
    fs = c["n_shared"] * c["moe_ff"]
    moe = attn + [("w", (c["n_experts"], d)), ("w", (d, 2 * fs)), ("w", (fs, d)),
                  ("w", (G, d, 2 * c["moe_ff"])), ("w", (G, c["moe_ff"], d))]
    layers = [dense if i < c["n_dense"] else moe for i in range(c["n_layers"])]
    return ([("w", (c["vocab"], d))] + [s for lay in layers for s in lay]
            + [("1", (d,)), ("w", (c["vocab"], d))])


def init(config: dict, seed: int, device) -> list[torch.Tensor]:
    """Every matrix normal(0, ``initializer_range``), every norm's scale 1,
    drawn on the device in one call. Float32, the master weights' type.
    The port's reading of the ``port`` block comes first, so that a program
    without this family stops before anything is drawn."""
    from pygrid_tpu_torch.models import afmoe

    afmoe.config_from_dict(config["port"])
    plan = _shapes(config["port"])
    std = config["initializer_range"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    total = sum(torch.Size(s).numel() for k, s in plan if k == "w")
    flat = torch.randn(total, generator=g, device=device)
    out, off = [], 0
    for kind, shape in plan:
        if kind == "1":
            out.append(torch.ones(shape, device=device))
        else:
            m = torch.Size(shape).numel()
            out.append(flat[off:off + m].view(shape).mul_(std))
            off += m
    return out


def port_loss(config: dict, spec: dict):
    """The round's loss as the port builds it: the flash kernels with the
    window and the grouped K/V heads, the compute dtype, the CE head's
    narrow-dtype backward and the recompute the cell names; the routers'
    bias at 0."""
    from functools import partial

    from pygrid_tpu_torch.models import afmoe
    from pygrid_tpu_torch.parallel import flash_attention as fa

    cfg = afmoe.config_from_dict(config["port"])
    return partial(afmoe.loss_and_acc, cfg=cfg, attn_fn=fa.flash_attention,
                   remat=spec.get("remat", False), compute_dtype=spec.get("compute_dtype"),
                   ce_grad_dtype=spec.get("ce_grad_dtype"))


def reference_rounds(config: dict, spec: dict, params0, batches, precision: str):
    if spec["local_steps"] != 1:
        raise ValueError("the AFMoE reference runs one local step a round")
    with products(precision):
        return ref.fedavg_rounds(params0, batches, spec["lr"], config["port"],
                                 mm=lambda a, b: matmul(a, b, precision),
                                 block_rows=REFERENCE_BLOCK_ROWS, q_block=REFERENCE_Q_BLOCK)


def round_flops(config: dict, traffic: dict) -> float:
    from benchmark.work.afmoe_flops import round_flops as flops

    tokens = traffic["clients"] * traffic["batch"] * traffic["seq_len"]
    return flops(config["port"], tokens, traffic["seq_len"])
