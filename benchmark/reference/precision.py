"""The reference's products in the precision asked for.

``"f32"``: float32 with TF32 off. ``"tf32"``: float32 products on the
TF32 tensor cores (the control below float32). ``"fp8"``: every operand of
every product, forward and backward, rounded to float8 e4m3 under a
per-tensor scale set by its largest magnitude (the control below bf16).
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    amax = x.detach().abs().max().float().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        # a broadcast operand (a weight against a batch) sums over the batch
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _Fp8MatMul.apply(a, b)
    return torch.matmul(a, b)


@contextlib.contextmanager
def products(precision: str):
    """TF32 switched on only for ``"tf32"``, off otherwise; restored after."""
    if precision not in ("f32", "tf32", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
