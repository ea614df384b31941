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

k and v may hold fewer heads than q (grouped-query attention: query head h
reads K/V head ``h // (H / H_kv)``), and a causal launch may keep only a
band of width W (a sliding window: query i sees key j where
``0 <= i - j < W``). Both run in bf16 at ``D = D_v <= 128``, through the
tensor-core kernels' band instantiation: the forward and dQ blocks start
their key loop at the first tile the band meets and mask only the tiles that
straddle its edges; a dK/dV block owns a (b, K/V head, key tile), loops over
its group's query heads and the query tiles the band reaches, and writes dK
and dV once at H_kv heads. No copy of k or v at H heads is made, and no
per-query-head dK/dV is summed afterwards. Every other path (f32, the wide
and narrow-V kernels) raises for either; the plain versions take both.
"""

from __future__ import annotations

import torch

from pygrid_tpu_torch.kernels import build
from pygrid_tpu_torch.utils.profiling import region

_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")

#: the wrappers' counters since the last :func:`reset_launch_counts`: by
#: kernel, its launches (a wrapper adds one where it launches its kernel and
#: nowhere else) and, of those, the launches that took the narrow-V path
#: (D_v < D_qk), those with a window and those with fewer K/V heads than
#: query heads; and the 64 x 64 (query, key) tile pairs that the causal
#: forwards visit beside those full causal attention visits at the same
#: shapes: host integers from the shapes (:func:`tile_pairs`), counted on
#: every path, the plain versions' too, and not in a backward's recompute
_counts: dict = {}


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
    return dict(_counts["launches"])


def narrow_v_counts() -> dict[str, int]:
    """Of the launches :func:`launch_counts` counts, those that took the
    narrow-V path, by kernel."""
    return dict(_counts["narrow_v"])


def band_counts() -> dict:
    """Of the launches :func:`launch_counts` counts, those with a window
    and those with H_kv < H, by kernel; and the causal forwards' tile pairs
    against full causal attention's at the same shapes."""
    return {"window": dict(_counts["window"]), "grouped": dict(_counts["grouped"]),
            "tile_pairs": _counts["tile_pairs"],
            "causal_tile_pairs": _counts["causal_tile_pairs"]}


def reset_launch_counts() -> None:
    for kind in ("launches", "narrow_v", "window", "grouped"):
        _counts[kind] = dict.fromkeys(_KERNELS, 0)
    _counts["tile_pairs"] = _counts["causal_tile_pairs"] = 0


reset_launch_counts()


#: query and key rows of the forward kernel's tiles (csrc/flash_common.cuh)
TILE = 64


def tile_pairs(L: int, window: int | None) -> tuple[int, int]:
    """(tile pairs a causal forward with ``window`` visits, tile pairs full
    causal attention visits) for one (batch, head) slice of length ``L``,
    in :data:`TILE` x :data:`TILE` tiles: the query tile at q0 visits the key
    tiles from that of key ``q0 - W + 1`` to its own."""
    n = -(-L // TILE)
    causal = n * (n + 1) // 2
    if window is None:
        return causal, causal
    visited = sum(qt - max(0, qt * TILE - window + 1) // TILE + 1 for qt in range(n))
    return visited, causal


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the yardstick on the card)
# --------------------------------------------------------------------------


def _mask(Lq: int, Lk: int, causal: bool, device, window: int | None = None) -> torch.Tensor:
    """Validity of each (query, key) pair, [Lq, Lk]. The kernels also mask
    pad queries and pad keys (positions past the true lengths inside a
    tile); nothing is padded here, so only causality and the window remove
    pairs."""
    q_pos = torch.arange(Lq, device=device)[:, None]
    k_pos = torch.arange(Lk, device=device)[None, :]
    valid = q_pos >= k_pos if causal else torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    if window is not None:
        valid = valid & (q_pos - k_pos < window)
    return valid


# The products of the plain versions, with k and v at H_kv heads: query head
# h pairs with K/V head h // (H / H_kv), and a K/V head's gradient sums its
# group. At H_kv = H each is the one-head-per-head einsum.


def _qk(x, y):
    """[B, Lq, H, D] · [B, Lk, H_kv, D] -> [B, H, Lq, Lk] in f32."""
    B, Lq, H, D = x.shape
    Hk = y.shape[2]
    if Hk == H:
        return torch.einsum("bqhd,bkhd->bhqk", x.float(), y.float())
    xg = x.float().reshape(B, Lq, Hk, H // Hk, D)
    return torch.einsum("bqhgd,bkhd->bhgqk", xg, y.float()).reshape(B, H, Lq, -1)


def _pv(p, y):
    """[B, H, Lq, Lk] · [B, Lk, H_kv, D] -> [B, Lq, H, D] in f32."""
    B, H, Lq, Lk = p.shape
    Hk = y.shape[2]
    if Hk == H:
        return torch.einsum("bhqk,bkhd->bqhd", p.float(), y.float())
    pg = p.float().reshape(B, Hk, H // Hk, Lq, Lk)
    return torch.einsum("bhgqk,bkhd->bqhgd", pg, y.float()).reshape(B, Lq, H, -1)


def _ptx(p, x, Hk: int):
    """[B, H, Lq, Lk]ᵀ · [B, Lq, H, D] -> [B, Lk, H_kv, D] in f32, summed
    over each group of query heads."""
    B, H, Lq, Lk = p.shape
    if Hk == H:
        return torch.einsum("bhqk,bqhd->bkhd", p.float(), x.float())
    pg = p.float().reshape(B, Hk, H // Hk, Lq, Lk)
    xg = x.float().reshape(B, Lq, Hk, H // Hk, -1)
    return torch.einsum("bhgqk,bqhgd->bkhd", pg, xg)


def _probs(q, k, lse, causal, scale, window=None):
    """P = exp(min(s - lse, 0)) on valid lanes, 0 elsewhere, [B, H, Lq, Lk]."""
    B, Lq, H, _ = q.shape
    s = _qk(q, k) * scale
    valid = _mask(Lq, k.shape[1], causal, q.device, window)
    lse4 = lse.reshape(B, H, Lq, 1)
    p = torch.exp(torch.clamp(s - lse4, max=0.0))
    return torch.where(valid, p, torch.zeros_like(p))


def _dscores(q, k, v, do, lse, delta, causal, scale, window=None):
    """(P, dS) with dS = P ∘ (dO vᵀ − Δ) · scale, both [B, H, Lq, Lk] f32."""
    B, Lq, H, _ = q.shape
    p = _probs(q, k, lse, causal, scale, window)
    dp = _qk(do, v)
    ds = p * (dp - delta.reshape(B, H, Lq, 1)) * scale
    return p, ds


def flash_fwd_reference(q, k, v, causal: bool, scale: float, window: int | None = None):
    """(out [B, Lq, H, D_v] in q's dtype, lse f32 [B·H, Lq]) — the forward
    kernel's function: the row max and sum over valid keys, P cast to v's
    dtype before the value product, rows with no valid key guarded."""
    B, Lq, H, _ = q.shape
    s = _qk(q, k) * scale
    valid = _mask(Lq, k.shape[1], causal, q.device, window)
    m = torch.where(valid, s, torch.full_like(s, _NEG)).amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = _pv(p.to(v.dtype), v)
    out = out / l.squeeze(-1).permute(0, 2, 1)[..., None]
    lse = (m + torch.log(l)).reshape(B * H, Lq)
    return out.to(q.dtype), lse


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool, scale: float,
                            window: int | None = None):
    """(dk, dv) in k's and v's dtypes, at k's heads: dV = Pᵀ dO, dK = dSᵀ Q,
    with P and dS cast to the operand dtype before the products (as the
    kernel does)."""
    p, ds = _dscores(q, k, v, do, lse, delta, causal, scale, window)
    Hk = k.shape[2]
    dv = _ptx(p.to(do.dtype), do, Hk)
    dk = _ptx(ds.to(q.dtype), q, Hk)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool, scale: float,
                           window: int | None = None):
    """dq in q's dtype: dQ = dS K."""
    _, ds = _dscores(q, k, v, do, lse, delta, causal, scale, window)
    return _pv(ds.to(k.dtype), k).to(q.dtype)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _strides(x: torch.Tensor) -> list[int]:
    return [x.stride(0), x.stride(1), x.stride(2)]


def _check_cuda(*xs: torch.Tensor) -> None:
    """What the kernels take: CUDA tensors of one dtype (f32 or bf16), one
    device, [B, L, H, D] with a contiguous last dimension, D ≤ MAX_D. The
    first two are q and k (one width), the rest v (and dO); k and v hold a
    divisor of q's heads."""
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
    _check_heads(xs[0], xs[1], xs[2])


def _check_heads(q, k, v) -> None:
    H, Hk = q.shape[2], k.shape[2]
    if v.shape[2] != Hk or H % Hk:
        raise ValueError(f"k and v need one head count that divides q's {H}, got "
                         f"{Hk} and {v.shape[2]}")


def _check_band(q, k, v, window) -> None:
    """A band (a window, or H_kv < H) runs only where the kernels have one:
    bf16 at D = D_v ≤ 128; anywhere else this raises."""
    band = window is not None or k.shape[2] != q.shape[2]
    if band and not (q.dtype == torch.bfloat16 and q.shape[-1] == v.shape[-1] <= _DC):
        raise ValueError(
            "a window or fewer K/V heads than query heads runs only on the bf16 kernels at "
            f"D = D_v <= {_DC}, got {q.dtype} at D = {q.shape[-1]}, D_v = {v.shape[-1]}")


def _count_launch(kernel: str, q, k, window, Dqk: int, Dv: int) -> None:
    _counts["launches"][kernel] += 1
    _counts["narrow_v"][kernel] += Dv != Dqk
    _counts["window"][kernel] += window is not None
    _counts["grouped"][kernel] += k.shape[2] != q.shape[2]


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


def _count_tiles(q, causal: bool, window: int | None) -> None:
    if torch._C._current_graph_task_id() != -1:  # a recompute in a backward
        return
    slices = q.shape[0] * q.shape[2] * int(causal)  # a causal launch's (b, h) slices
    visited, full = tile_pairs(q.shape[1], window)
    _counts["tile_pairs"] += slices * visited
    _counts["causal_tile_pairs"] += slices * full


def flash_fwd(q, k, v, causal: bool, scale: float, window: int | None = None):
    """Forward kernel: (out [B, Lq, H, D_v], lse f32 [B·H, Lq])."""
    _count_tiles(q, causal, window)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal, scale, window)
    q, k, v = map(_contig_last, (q, k, v))
    _check_cuda(q, k, v)
    _check_band(q, k, v, window)
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
        float(scale), int(causal), _DTYPES[q.dtype], k.shape[2], window or 0,
    )
    _count_launch("flash_fwd", q, k, window, Dqk_k, Dv_k)
    return out[..., :Dv], lse


def _bwd_args(q, k, v, do, window):
    q, k, v, do = map(_contig_last, (q, k, v, do))
    _check_cuda(q, k, v, do)
    if do.shape[-1] != v.shape[-1]:
        raise ValueError("flash kernels need dO of v's head dim")
    _check_band(q, k, v, window)
    return _layout(q, k, v, do)


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
                  window: int | None = None):
    """dK/dV kernel: (dk [B, Lk, H_kv, D_qk], dv [B, Lk, H_kv, D_v]) in the
    input dtype."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale, window)
    Dqk, Dv = q.shape[-1], v.shape[-1]
    q, k, v, do, Dqk_k, Dv_k = _bwd_args(q, k, v, do, window)
    B, Lq, H, _ = q.shape
    Lk, Hk = k.shape[1], k.shape[2]
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dk = torch.empty((B, Lk, Hk, Dqk_k), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Lk, Hk, Dv_k), dtype=v.dtype, device=v.device)
    build.launch(
        "flash_bwd", "pgt_flash_bwd_dkv", q.device,
        q.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        k.data_ptr(), v.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, Lq, Lk, Dqk_k, Dv_k, *_strides(q), *_strides(do), *_strides(k), *_strides(v),
        float(scale), int(causal), _DTYPES[q.dtype], Hk, window or 0,
    )
    _count_launch("flash_bwd_dkv", q, k, window, Dqk_k, Dv_k)
    return dk[..., :Dqk], dv[..., :Dv]


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
                 window: int | None = None):
    """dQ kernel: dq [B, Lq, H, D_qk] in the input dtype."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale, window)
    Dqk = q.shape[-1]
    q, k, v, do, Dqk_k, Dv_k = _bwd_args(q, k, v, do, window)
    B, Lq, H, _ = q.shape
    Lk = k.shape[1]
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dq = torch.empty((B, Lq, H, Dqk_k), dtype=q.dtype, device=q.device)
    build.launch(
        "flash_bwd", "pgt_flash_bwd_dq", q.device,
        q.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        k.data_ptr(), v.data_ptr(), dq.data_ptr(),
        B, H, Lq, Lk, Dqk_k, Dv_k, *_strides(q), *_strides(do), *_strides(k), *_strides(v),
        float(scale), int(causal), _DTYPES[q.dtype], k.shape[2], window or 0,
    )
    _count_launch("flash_bwd_dq", q, k, window, Dqk_k, Dv_k)
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
    def forward(ctx, q, k, v, causal, scale, window):
        with region("pgt.flash.fwd"):
            out, lse = flash_fwd(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        return out

    @staticmethod
    def backward(ctx, do):
        with region("pgt.flash.bwd"):
            q, k, v, out, lse = ctx.saved_tensors
            do = do.to(q.dtype)
            delta = softmax_delta(out, do)
            args = (lse, delta, ctx.causal, ctx.scale, ctx.window)
            dk, dv = flash_bwd_dkv(q, k, v, do, *args)
            dq = flash_bwd_dq(q, k, v, do, *args)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Fused attention, [B, L, H, D] (the layout :func:`attention` uses).

    Any (Lq, Lk) and, on the CPU, any D; the CUDA kernels take D ≤ 512
    (past 128 in 128-wide slices of the output columns). v may be narrower
    or wider than q and k: the output is [B, Lq, H, D_v] (in bf16 at D_v ≤
    128 < D_qk ≤ 192 on the narrow-V path, see the module's docstring).
    k and v may hold H_kv heads, a divisor of q's H (grouped-query
    attention), and ``window`` W keeps the pairs ``0 <= i - j < W`` of a
    causal launch (a sliding window); on the card both take the bf16
    kernels at D = D_v ≤ 128, and any other path raises.
    ``causal`` requires Lq == Lk (self-attention alignment). The default
    scale is D_qk^-0.5. The output comes back in the input dtype.
    Differentiable through the dK/dV and dQ kernels."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if causal and Lq != Lk:
        raise ValueError("causal flash_attention requires Lq == Lk")
    if window is not None and (not causal or int(window) < 1):
        raise ValueError(f"a window needs causal attention and W >= 1, got {window}")
    _check_heads(q, k, v)
    scale_ = scale if scale is not None else D**-0.5
    return _Flash.apply(q, k, v, causal, scale_, None if window is None else int(window))
