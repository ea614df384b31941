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
(:func:`_fit`, the counterpart of the reference's ``_pad_to``) and
slices the outputs; the main path's q, k, v need none. Head dims past 128
(up to :data:`MAX_D`) run through the same three C entries, which launch
the wide kernels: a grid axis over 128-wide slices of the output columns,
with the full-D products streamed through shared memory in chunks.

The values may be narrower than the queries and keys (multi-head latent
attention: D_qk = 192, D_v = 128). In bf16 the path follows from the two
widths alone (:func:`_widths`): D_v = D_qk takes the kernels above; D_v ≤
128 < D_qk ≤ :data:`NARROW_V_MAX_DQK` takes the narrow-V path, where each
block owns all of its outputs (O and dV at D_v, dK and dQ at D_qk) and
forms S and dP once per tile pair, with no slice axis and no zero-padded V;
any other pair runs at one width, the narrower side zero-padded. The f32
kernels take one width, so in f32 the narrower of v and q, k (and dO) is
padded and the outputs sliced.
"""

from __future__ import annotations

import torch

from pygrid_tpu_torch.kernels import build
from pygrid_tpu_torch.utils.profiling import region

#: launches of each kernel since the last :func:`reset_launch_counts`;
#: a wrapper adds one where it launches its kernel and nowhere else
fwd_launches = 0
bwd_dkv_launches = 0
bwd_dq_launches = 0
#: of those, the launches that took the narrow-V path (D_v < D_qk)
fwd_narrow_v = 0
bwd_dkv_narrow_v = 0
bwd_dq_narrow_v = 0

#: widest head dim the CUDA kernels take (csrc/flash_common.cuh): past
#: 128 they split D into 128-wide slices, and at 512 the wide dQ kernel's
#: resident Q and dO chunks fill 170 KB of a block's shared memory
MAX_D = 512

#: widest value dim (and slice) a block owns (csrc/flash_common.cuh: DC)
_DC = 128

#: widest D_qk of the narrow-V path (csrc/flash_common.cuh: NV_DQK): a
#: dK/dV block holds dK at D_qk and dV at D_v in f32 registers, 160 a
#: thread at 192/128
NARROW_V_MAX_DQK = 192

_NEG = -1e30


def launch_counts() -> dict[str, int]:
    return {
        "flash_fwd": fwd_launches,
        "flash_bwd_dkv": bwd_dkv_launches,
        "flash_bwd_dq": bwd_dq_launches,
    }


def narrow_v_counts() -> dict[str, int]:
    """Of the launches :func:`launch_counts` counts, those that took the
    narrow-V path, by kernel."""
    return {
        "flash_fwd": fwd_narrow_v,
        "flash_bwd_dkv": bwd_dkv_narrow_v,
        "flash_bwd_dq": bwd_dq_narrow_v,
    }


def reset_launch_counts() -> None:
    global fwd_launches, bwd_dkv_launches, bwd_dq_launches
    global fwd_narrow_v, bwd_dkv_narrow_v, bwd_dq_narrow_v
    fwd_launches = bwd_dkv_launches = bwd_dq_launches = 0
    fwd_narrow_v = bwd_dkv_narrow_v = bwd_dq_narrow_v = 0


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
    """(out [B, Lq, H, D_v] in q's dtype, lse f32 [B·H, Lq]) — the forward
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
    device, [B, L, H, D] with a contiguous last dimension, D ≤ MAX_D. The
    first two are q and k (one width), the rest v (and dO)."""
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
        if x.shape[-1] > MAX_D:
            raise ValueError(
                f"the CUDA flash kernels take head dims up to D = {MAX_D}, got {x.shape[-1]}")
    if xs[1].shape[-1] != xs[0].shape[-1]:
        raise ValueError("flash kernels need q and k of one head dim")


def _contig_last(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def _fit(x: torch.Tensor, width: int, bf16: bool) -> torch.Tensor:
    """``x`` as a kernel reads it at head dim ``width`` (≥ its own): as it
    is where its D is ``width`` (and, for the bf16 tensor-core kernels'
    16-byte copies, every stride a multiple of 8 elements and the base
    16-byte aligned); else a contiguous copy zero-filled past its D (zeros
    add nothing to q·k and give output columns the caller slices off)."""
    D = x.shape[-1]
    aligned = all(s % 8 == 0 for s in x.stride()[:3]) and x.data_ptr() % 16 == 0
    if D == width and (aligned or not bf16):
        return x
    padded = x.new_zeros((*x.shape[:3], width))
    padded[..., :D] = x
    return padded


def _widths(Dqk: int, Dv: int, bf16: bool) -> tuple[int, int]:
    """The (D_qk, D_v) the kernels run at, from the tensors' widths alone.
    bf16: each rounded up to a multiple of 8; kept apart on the narrow-V
    path (D_v ≤ 128 < D_qk ≤ NARROW_V_MAX_DQK), else both at the wider.
    f32: both at the wider (the f32 kernels take one D)."""
    if bf16:
        Dqk, Dv = -(-Dqk // 8) * 8, -(-Dv // 8) * 8
        if Dv <= _DC < Dqk <= NARROW_V_MAX_DQK:
            return Dqk, Dv
    w = max(Dqk, Dv)
    return w, w


def _layout(q, k, v, do=None):
    """(q, k, v, do, D_qk, D_v) as the kernels take them: q and k at
    D_qk, v and dO at D_v (:func:`_widths`), each passed as it is where it
    already fits and else zero-padded (:func:`_fit`)."""
    bf16 = q.dtype == torch.bfloat16
    Dqk, Dv = _widths(q.shape[-1], v.shape[-1], bf16)
    q, k = (_fit(x, Dqk, bf16) for x in (q, k))
    v = _fit(v, Dv, bf16)
    do = None if do is None else _fit(do, Dv, bf16)
    return q, k, v, do, Dqk, Dv


def flash_fwd(q, k, v, causal: bool, scale: float):
    """Forward kernel: (out [B, Lq, H, D_v], lse f32 [B·H, Lq])."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal, scale)
    global fwd_launches, fwd_narrow_v
    q, k, v = map(_contig_last, (q, k, v))
    _check_cuda(q, k, v)
    B, Lq, H, _ = q.shape
    Dv = v.shape[-1]
    Lk = k.shape[1]
    q, k, v, _, Dqk_k, Dv_k = _layout(q, k, v)
    out = torch.empty((B, Lq, H, Dv_k), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, Lq), dtype=torch.float32, device=q.device)
    build.launch(
        "flash_fwd", "pgt_flash_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, H, Lq, Lk, Dqk_k, Dv_k, *_strides(q), *_strides(k), *_strides(v),
        float(scale), int(causal), _DTYPES[q.dtype],
    )
    fwd_launches += 1
    fwd_narrow_v += Dv_k != Dqk_k
    return out[..., :Dv], lse


def _bwd_args(q, k, v, do):
    q, k, v, do = map(_contig_last, (q, k, v, do))
    _check_cuda(q, k, v, do)
    if do.shape[-1] != v.shape[-1]:
        raise ValueError("flash kernels need dO of v's head dim")
    return _layout(q, k, v, do)


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dK/dV kernel: (dk [B, Lk, H, D_qk], dv [B, Lk, H, D_v]) in the
    input dtype."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    global bwd_dkv_launches, bwd_dkv_narrow_v
    Dqk, Dv = q.shape[-1], v.shape[-1]
    q, k, v, do, Dqk_k, Dv_k = _bwd_args(q, k, v, do)
    B, Lq, H, _ = q.shape
    Lk = k.shape[1]
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dk = torch.empty((B, Lk, H, Dqk_k), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Lk, H, Dv_k), dtype=v.dtype, device=v.device)
    build.launch(
        "flash_bwd", "pgt_flash_bwd_dkv", q.device,
        q.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        k.data_ptr(), v.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, Lq, Lk, Dqk_k, Dv_k, *_strides(q), *_strides(do), *_strides(k), *_strides(v),
        float(scale), int(causal), _DTYPES[q.dtype],
    )
    bwd_dkv_launches += 1
    bwd_dkv_narrow_v += Dv_k != Dqk_k
    return dk[..., :Dqk], dv[..., :Dv]


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dQ kernel: dq [B, Lq, H, D_qk] in the input dtype."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale)
    global bwd_dq_launches, bwd_dq_narrow_v
    Dqk = q.shape[-1]
    q, k, v, do, Dqk_k, Dv_k = _bwd_args(q, k, v, do)
    B, Lq, H, _ = q.shape
    Lk = k.shape[1]
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dq = torch.empty((B, Lq, H, Dqk_k), dtype=q.dtype, device=q.device)
    build.launch(
        "flash_bwd", "pgt_flash_bwd_dq", q.device,
        q.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        k.data_ptr(), v.data_ptr(), dq.data_ptr(),
        B, H, Lq, Lk, Dqk_k, Dv_k, *_strides(q), *_strides(do), *_strides(k), *_strides(v),
        float(scale), int(causal), _DTYPES[q.dtype],
    )
    bwd_dq_launches += 1
    bwd_dq_narrow_v += Dv_k != Dqk_k
    return dq[..., :Dqk]


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
        with region("pgt.flash.fwd"):
            out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        with region("pgt.flash.bwd"):
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

    Any (Lq, Lk) and, on the CPU, any D; the CUDA kernels take D ≤ 512
    (past 128 in 128-wide slices of the output columns). v may be narrower
    or wider than q and k: the output is [B, Lq, H, D_v] (in bf16 at D_v ≤
    128 < D_qk ≤ 192 on the narrow-V path, see the module's docstring).
    ``causal`` requires Lq == Lk (self-attention alignment). The default
    scale is D_qk^-0.5. The output comes back in the input dtype.
    Differentiable through the dK/dV and dQ kernels."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if causal and Lq != Lk:
        raise ValueError("causal flash_attention requires Lq == Lk")
    scale_ = scale if scale is not None else D**-0.5
    return _Flash.apply(q, k, v, causal, scale_)
