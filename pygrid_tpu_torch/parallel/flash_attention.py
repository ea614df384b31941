"""Flash attention with hand-written Hopper kernels in both directions.

Counterpart of :mod:`pygrid_tpu.parallel.pallas_attention`: the forward
(``_flash_kernel``) and the two backward passes (``_bwd_dkv_kernel``,
``_bwd_dq_kernel``) are CUDA kernels for ``sm_90a`` in ``csrc/flash_fwd.cu``
and ``csrc/flash_bwd.cu``; :class:`_Flash` joins them as the
``torch.autograd.Function`` that mirrors the reference's ``custom_vjp``.

Each kernel has a plain PyTorch version beside it (``flash_fwd_reference``,
``flash_bwd_dkv_reference``, ``flash_bwd_dq_reference``) with the same
math: P is recomputed from the saved log-sum-exp, pad queries and pad keys
are masked, and ``exp(min(s - lse, 0))`` is clamped. A wrapper runs the
plain version only for tensors on the CPU; for a CUDA tensor it launches
its kernel or raises.

Tensors stay in the reference's ``[B, L, H, D]`` layout: the kernels read
q, k, v and dO through their strides (last dimension contiguous), so no
``[B·H, L, D]`` transpose copy is made. In bf16 all three kernels run on
the tensor cores and copy 16-byte chunks: where a view's head
dim or strides are not multiples of 8 elements, or its base is not 16-byte
aligned, the wrapper hands them a zero-padded contiguous copy
(:func:`_tc_layout`, the counterpart of the reference's ``_pad_to``) and
slices the outputs; the main path's q, k, v need none.
"""

from __future__ import annotations

import torch

from pygrid_tpu_torch.kernels import build

#: launches of each kernel since the last :func:`reset_launch_counts`;
#: a wrapper adds one where it launches its kernel and nowhere else
fwd_launches = 0
bwd_dkv_launches = 0
bwd_dq_launches = 0

#: widest head dim the kernels hold in registers (csrc/flash_common.cuh)
MAX_D = 128

_NEG = -1e30


def launch_counts() -> dict[str, int]:
    return {
        "flash_fwd": fwd_launches,
        "flash_bwd_dkv": bwd_dkv_launches,
        "flash_bwd_dq": bwd_dq_launches,
    }


def reset_launch_counts() -> None:
    global fwd_launches, bwd_dkv_launches, bwd_dq_launches
    fwd_launches = bwd_dkv_launches = bwd_dq_launches = 0


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the yardstick on the card)
# --------------------------------------------------------------------------


def _mask(Lq: int, Lk: int, causal: bool, device) -> torch.Tensor:
    """Validity of each (query, key) pair, [Lq, Lk]. The kernels also mask
    pad queries and pad keys (positions past the true lengths inside a
    tile); nothing is padded here, so only causality removes pairs."""
    q_pos = torch.arange(Lq, device=device)[:, None]
    k_pos = torch.arange(Lk, device=device)[None, :]
    if causal:
        return q_pos >= k_pos
    return torch.ones((Lq, Lk), dtype=torch.bool, device=device)


def _scores(q, k, scale):
    """f32 scores [B, H, Lq, Lk] of the input-dtype operands."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def _probs(q, k, lse, causal, scale):
    """P = exp(min(s - lse, 0)) on valid lanes, 0 elsewhere, [B, H, Lq, Lk]."""
    B, Lq, H, _ = q.shape
    s = _scores(q, k, scale)
    valid = _mask(Lq, k.shape[1], causal, q.device)
    lse4 = lse.reshape(B, H, Lq, 1)
    p = torch.exp(torch.clamp(s - lse4, max=0.0))
    return torch.where(valid, p, torch.zeros_like(p))


def _dscores(q, k, v, do, lse, delta, causal, scale):
    """(P, dS) with dS = P ∘ (dO vᵀ − Δ) · scale, both [B, H, Lq, Lk] f32."""
    B, Lq, H, _ = q.shape
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta.reshape(B, H, Lq, 1)) * scale
    return p, ds


def flash_fwd_reference(q, k, v, causal: bool, scale: float):
    """(out [B, Lq, H, D] in q's dtype, lse f32 [B·H, Lq]) — the forward
    kernel's function: the row max and sum over valid keys, P cast to v's
    dtype before the value product, rows with no valid key guarded."""
    B, Lq, H, _ = q.shape
    s = _scores(q, k, scale)
    valid = _mask(Lq, k.shape[1], causal, q.device)
    m = torch.where(valid, s, torch.full_like(s, _NEG)).amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = out / l.squeeze(-1).permute(0, 2, 1)[..., None]
    lse = (m + torch.log(l)).reshape(B * H, Lq)
    return out.to(q.dtype), lse


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool, scale: float):
    """(dk, dv) in k's and v's dtypes: dV = Pᵀ dO, dK = dSᵀ Q, with P and
    dS cast to the operand dtype before the products (as the kernel does)."""
    p, ds = _dscores(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dq in q's dtype: dQ = dS K."""
    _, ds = _dscores(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _strides(x: torch.Tensor) -> list[int]:
    return [x.stride(0), x.stride(1), x.stride(2)]


def _check_cuda(*xs: torch.Tensor) -> None:
    """What the kernels take: CUDA tensors of one dtype (f32 or bf16), one
    device, [B, L, H, D] with a contiguous last dimension, D ≤ MAX_D."""
    dtype, dev = xs[0].dtype, xs[0].device
    if dev.type != "cuda":
        raise ValueError(f"flash kernels run on CUDA tensors, got {dev}")
    if dtype not in _DTYPES:
        raise TypeError(f"flash kernels take float32 or bfloat16, got {dtype}")
    for x in xs:
        if x.device != dev or x.dtype != dtype:
            raise TypeError("flash kernels need q, k, v (and dO) on one device in one dtype")
        if x.dim() != 4 or x.stride(-1) != 1:
            raise ValueError("flash kernels take [B, L, H, D] with a contiguous last dim")
        if x.numel() >= 2**31:
            raise ValueError("flash kernels index with 32-bit strides")
    D = xs[0].shape[-1]
    if D > MAX_D:
        raise ValueError(f"the CUDA flash kernels take D <= {MAX_D}, got {D}")


def _contig_last(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def _tc_layout(*xs: torch.Tensor) -> tuple[list[torch.Tensor], int]:
    """The [B, L, H, D] views as the bf16 tensor-core kernels read them,
    and the head dim they run at: D rounded up to a multiple of 8, every
    stride a multiple of 8 elements and a 16-byte-aligned base, for their
    16-byte copies. A view that already is so passes as it is; any other is
    copied into a contiguous buffer zero-filled past D (zeros add nothing to
    q·k and give output columns the caller slices off)."""
    D = xs[0].shape[-1]
    Dp = -(-D // 8) * 8
    out = []
    for x in xs:
        if D == Dp and all(s % 8 == 0 for s in x.stride()[:3]) and x.data_ptr() % 16 == 0:
            out.append(x)
        else:
            padded = x.new_zeros((*x.shape[:3], Dp))
            padded[..., :D] = x
            out.append(padded)
    return out, Dp


def flash_fwd(q, k, v, causal: bool, scale: float):
    """Forward kernel: (out [B, Lq, H, D], lse f32 [B·H, Lq])."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal, scale)
    global fwd_launches
    q, k, v = map(_contig_last, (q, k, v))
    _check_cuda(q, k, v)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    Dp = D
    if q.dtype == torch.bfloat16:
        (q, k, v), Dp = _tc_layout(q, k, v)
    out = torch.empty((B, Lq, H, Dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, Lq), dtype=torch.float32, device=q.device)
    build.launch(
        "flash_fwd", "pgt_flash_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, H, Lq, Lk, Dp, *_strides(q), *_strides(k), *_strides(v),
        float(scale), int(causal), _DTYPES[q.dtype],
    )
    fwd_launches += 1
    return out[..., :D], lse


def _bwd_args(q, k, v, do):
    q, k, v, do = map(_contig_last, (q, k, v, do))
    _check_cuda(q, k, v, do)
    return q, k, v, do


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dK/dV kernel: (dk, dv), each [B, Lk, H, D] in the input dtype."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    global bwd_dkv_launches
    q, k, v, do = _bwd_args(q, k, v, do)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    Dp = D
    if q.dtype == torch.bfloat16:
        (q, k, v, do), Dp = _tc_layout(q, k, v, do)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dk = torch.empty((B, Lk, H, Dp), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    build.launch(
        "flash_bwd", "pgt_flash_bwd_dkv", q.device,
        q.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        k.data_ptr(), v.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, Lq, Lk, Dp, *_strides(q), *_strides(do), *_strides(k), *_strides(v),
        float(scale), int(causal), _DTYPES[q.dtype],
    )
    bwd_dkv_launches += 1
    return dk[..., :D], dv[..., :D]


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dQ kernel: dq [B, Lq, H, D] in the input dtype."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale)
    global bwd_dq_launches
    q, k, v, do = _bwd_args(q, k, v, do)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    Dp = D
    if q.dtype == torch.bfloat16:
        (q, k, v, do), Dp = _tc_layout(q, k, v, do)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dq = torch.empty((B, Lq, H, Dp), dtype=q.dtype, device=q.device)
    build.launch(
        "flash_bwd", "pgt_flash_bwd_dq", q.device,
        q.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        k.data_ptr(), v.data_ptr(), dq.data_ptr(),
        B, H, Lq, Lk, Dp, *_strides(q), *_strides(do), *_strides(k), *_strides(v),
        float(scale), int(causal), _DTYPES[q.dtype],
    )
    bwd_dq_launches += 1
    return dq[..., :D]


def softmax_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO ∘ O) in f32, [B·H, Lq] — the softmax-jacobian
    diagonal term, one plain torch op outside the kernels."""
    B, Lq, H, _ = out.shape
    delta = (do.float() * out.float()).sum(-1)  # [B, Lq, H]
    return delta.permute(0, 2, 1).reshape(B * H, Lq)


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: the forward saves
    (q, k, v, out, lse); the backward computes Δ, then runs the dK/dV
    pass and the dQ pass."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        delta = softmax_delta(out, do)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """Fused attention, [B, L, H, D] (the layout :func:`attention` uses).

    Any (Lq, Lk) and, on the CPU, any D; the CUDA kernels take D ≤ 128.
    ``causal`` requires Lq == Lk (self-attention alignment). The default
    scale is D^-0.5. The output comes back in the input dtype.
    Differentiable through the dK/dV and dQ kernels."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if causal and Lq != Lk:
        raise ValueError("causal flash_attention requires Lq == Lk")
    scale_ = scale if scale is not None else D**-0.5
    return _Flash.apply(q, k, v, causal, scale_)
