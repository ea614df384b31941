"""The port's decoder-only transformer (``models/transformer.py``) at a
configuration's ``port`` sizes, and its float32 reference."""

from __future__ import annotations

import torch

from benchmark.harness import sub_seed
from benchmark.reference import transformer as ref

#: sequences of the merged client batch the reference takes at a time, so
#: that its f32 logits over the 50,257-wide vocabulary fit beside nothing else
REFERENCE_BLOCK_ROWS = 8
#: the LayerNorm eps that the port's ``_ln`` fixes
PORT_LN_EPS = 1e-6


def init(config: dict, seed: int, device) -> list[torch.Tensor]:
    """GPT-2's initialisation, drawn on the device in one call: every
    matrix and embedding normal with std ``initializer_range``, the two
    residual projections (o and the MLP's second) scaled down by
    sqrt(2 · n_layers), LayerNorms at 1 and 0, biases 0. Float32, the
    master weights' type."""
    c = config["port"]
    d, f, n = c["d_model"], c["d_ff"], c["n_layers"]
    std = config["initializer_range"]
    res = std / (2 * n) ** 0.5
    layer = [("1", (d,)), ("0", (d,)), (std, (d, d)), (std, (d, d)), (std, (d, d)),
             (res, (d, d)), ("1", (d,)), ("0", (d,)), (std, (d, f)), ("0", (f,)),
             (res, (f, d)), ("0", (d,))]
    plan = [(std, (c["vocab"], d)), (std, (c["max_len"], d))] + layer * n + [("1", (d,)), ("0", (d,))]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    total = sum(torch.Size(s).numel() for k, s in plan if not isinstance(k, str))
    flat = torch.randn(total, generator=g, device=device)
    out, off = [], 0
    for k, shape in plan:
        if k == "1":
            out.append(torch.ones(shape, device=device))
        elif k == "0":
            out.append(torch.zeros(shape, device=device))
        else:
            m = torch.Size(shape).numel()
            out.append(flat[off:off + m].view(shape).mul_(k))
            off += m
    return out


def port_loss(config: dict, spec: dict):
    """The round's loss as the port builds it (``chip_smoke.py`` phase
    rounds): flash attention, the compute dtype and the CE head's
    narrow-dtype backward that the cell names."""
    from functools import partial

    from pygrid_tpu_torch.models import transformer
    from pygrid_tpu_torch.parallel import flash_attention as fa

    c = config["port"]
    if c["ln_eps"] != PORT_LN_EPS:
        raise ValueError(f"the port's LayerNorm eps is fixed at {PORT_LN_EPS}")
    cfg = transformer.TransformerConfig(vocab=c["vocab"], d_model=c["d_model"],
                                        n_heads=c["n_heads"], n_layers=c["n_layers"],
                                        d_ff=c["d_ff"], max_len=c["max_len"])
    return partial(transformer.loss_and_acc, cfg=cfg, attn_fn=fa.flash_attention,
                   compute_dtype=spec.get("compute_dtype"), ce_grad_dtype=spec.get("ce_grad_dtype"))


def reference_rounds(config: dict, spec: dict, params0, batches, precision: str):
    c = config["port"]
    if spec["local_steps"] != 1:
        raise ValueError("the transformer reference runs one local step a round")
    return ref.fedavg_rounds(params0, batches, spec["lr"], c, precision,
                             block_rows=REFERENCE_BLOCK_ROWS)


def round_flops(config: dict, traffic: dict) -> float:
    from benchmark.work.model_flops import transformer_round_flops

    c = config["port"]
    tokens = traffic["clients"] * traffic["batch"] * traffic["seq_len"]
    return transformer_round_flops(c["vocab"], c["d_model"], c["d_ff"], c["n_layers"],
                                   tokens, traffic["seq_len"])
