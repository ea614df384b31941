"""Rank side of tests/test_torch_seq_parallel.py: ring and Ulysses
attention over a "seq" axis of 4 ranks, alone and inside the transformer."""

from functools import partial

import pytest
import torch

from pygrid_tpu_torch.models import transformer
from pygrid_tpu_torch.parallel import make_mesh, ring_attention, ulysses_attention
from pygrid_tpu_torch.parallel.flash_attention import flash_attention
from torch_world import registry

CASES, case = registry()

CFG = transformer.TransformerConfig(vocab=31, d_model=32, n_heads=8, n_layers=2, d_ff=64,
                                    max_len=64)


def _mesh():
    return make_mesh(4, axes=("seq",), device="cpu")


def _qkv(inp, prefix="qkv"):
    return [torch.from_numpy(inp[f"{prefix}_{n}"]) for n in "qkv"]


def _attn(inp, fn, causal, **kw):
    return {"out": fn(*_qkv(inp), _mesh(), causal=causal, **kw).numpy()}


for causal in (False, True):
    tag = "causal" if causal else "full"
    CASES[f"ring_{tag}"] = partial(_attn, fn=ring_attention, causal=causal)
    CASES[f"ulysses_{tag}"] = partial(_attn, fn=ulysses_attention, causal=causal)
    CASES[f"ulysses_flash_{tag}"] = partial(_attn, fn=ulysses_attention, causal=causal,
                                            attn_fn=flash_attention)


@case
def ulysses_rejects_indivisible_heads(inp):
    q = torch.zeros(2, 32, 6, 4)
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(q, q, q, _mesh())
    return {}


def _grads(inp, fn, prefix):
    qkv = [t.requires_grad_() for t in _qkv(inp, prefix)]
    loss = (fn(*qkv, _mesh(), causal=True) ** 2).sum()
    return {n: g.numpy() for n, g in zip("qkv", torch.autograd.grad(loss, qkv))}


@case
def ring_grads(inp):
    return _grads(inp, ring_attention, "g")


@case
def ulysses_grads(inp):
    return _grads(inp, ulysses_attention, "u")


def _params(inp):
    return [torch.from_numpy(inp[f"tf_p{i}"]) for i in range(int(inp["tf_n"]))]


@case
def transformer_sp(inp):
    mesh, params, tokens = _mesh(), _params(inp), torch.from_numpy(inp["tf_tokens"])
    return {name: transformer.apply(params, tokens, CFG, attn_fn=partial(fn, mesh=mesh)).numpy()
            for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention))}


@case
def transformer_sp_training_step(inp):
    step = transformer.make_training_step(CFG, attn_fn=partial(ring_attention, mesh=_mesh()))
    X = torch.from_numpy(inp["tf_X"])
    out = step(X, torch.roll(X, -1, dims=1), 0.1, *_params(inp))
    return {"loss": out[0].numpy(), **{f"p{i}": p.numpy() for i, p in enumerate(out[2:])}}


@case
def ring_bf16(inp):
    q, k, v = (t.to(torch.bfloat16) for t in _qkv(inp, "b"))
    out = ring_attention(q, k, v, _mesh(), causal=True)
    return {"dtype": str(out.dtype), "out": out.float().numpy()}
