"""Dense attention, the single-device yardstick of the flash kernels.

Counterpart of :func:`pygrid_tpu.parallel.ring_attention.attention`. The
ring and Ulysses sequence-parallel schemes of that module are multi-device
programs and are not ported yet.
"""

from __future__ import annotations

import torch

_NEG = -1e30  # finite "-inf": keeps fully-masked rows NaN-free in exp()


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain full attention, [B, L, H, D].

    Scores and softmax accumulate in float32 whatever the input dtype;
    the probabilities are cast to v's dtype before the value product (as
    the reference does) and the output returns in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        Lq, Lk = s.shape[-2], s.shape[-1]
        mask = (
            torch.arange(Lq, device=s.device)[:, None]
            >= torch.arange(Lk, device=s.device)[None, :]
        )
        s = torch.where(mask, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
