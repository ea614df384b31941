"""Dense attention, and the ring and Ulysses sequence-parallel schemes.

Counterpart of :mod:`pygrid_tpu.parallel.ring_attention`. :func:`attention`
is the single-device yardstick of the flash kernels. The two schemes split
the sequence over a ``"seq"`` mesh axis (:mod:`.collectives`; every rank
passes the whole ``[B, L, H, D]`` inputs and gets the whole output back):

- **Ring attention** (:func:`ring_attention`): each rank keeps its query
  block; the K/V blocks rotate around the ring by ``ppermute`` while each
  rank accumulates its queries' attention with an online softmax in f32.
  Causal blocks that lie wholly above the diagonal are skipped, and the
  last block needs no rotation. Its block step is plain PyTorch, as the
  reference's is plain ``jnp``.
- **Ulysses** (:func:`ulysses_attention`): an all-to-all turns each rank's
  ``[B, L/P, H, D]`` into ``[B, L, H/P, D]`` (the full sequence, a group of
  heads), ``attn_fn`` runs on it (pass
  :func:`pygrid_tpu_torch.parallel.flash_attention.flash_attention` to run
  the flash kernels), and a second all-to-all restores the split.

Both are exact, and differentiable through the collectives' backward.
"""

from __future__ import annotations

import torch

from pygrid_tpu_torch.parallel import collectives as C

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


def _block_accumulate(q, k_blk, v_blk, o, l, m, scale, q_pos, k_pos, causal):
    """Online-softmax accumulation of one K/V block into (o, l, m): o
    ``[B,H,Lq,D]`` the running unnormalised output, l ``[B,H,Lq]`` the
    running denominator, m ``[B,H,Lq]`` the running max, all f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask[None, None], s, torch.full_like(s, _NEG))
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p.to(v_blk.dtype).float(), v_blk.float())
    return o_new, l_new, m_new


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis: str = "seq",
    causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """Exact attention with the length dim of whole ``[B, L, H, D]`` inputs
    split over ``axis`` (L must divide by its size).

    At ring step t the rank holds the K/V block first owned by rank
    (i − t) mod P, which keeps the causal block positions local. K and V
    rotate as one stacked tensor, so each step is one ``ppermute``."""
    p_sz, my = C.axis_size(mesh, axis), C.axis_index(mesh, axis)
    scale_ = scale if scale is not None else q.shape[-1] ** -0.5
    perm = [(i, (i + 1) % p_sz) for i in range(p_sz)]
    q, k, v = C.shard(mesh, axis, q, k, v, dims=1)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    dev = q.device
    q_pos = my * Lq + torch.arange(Lq, device=dev)
    o = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Lq), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Lq), _NEG, dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])
    for t in range(p_sz):
        kv_idx = (my - t) % p_sz
        # blocks wholly after the query block contribute nothing: skipped
        if not causal or kv_idx <= my:
            k_pos = kv_idx * Lk + torch.arange(Lk, device=dev)
            o, l, m = _block_accumulate(q, kv[0], kv[1], o, l, m, scale_, q_pos, k_pos, causal)
        elif t == p_sz - 1:
            o = C.keep(o, kv)  # the last rotation's block, unused on this rank
        if t < p_sz - 1:
            kv = C.ppermute(kv, mesh, axis, perm)
    out = (o / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    return C.all_gather(out, mesh, axis, dim=1)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis: str = "seq",
    causal: bool = False,
    scale: float | None = None,
    attn_fn=None,
) -> torch.Tensor:
    """Exact attention by head↔sequence all-to-all re-sharding.

    Whole ``[B, L, H, D]`` inputs, L split over ``axis``; requires
    H % axis size == 0. ``attn_fn`` replaces the per-head-group dense
    attention (``flash_attention`` runs the flash kernels there, on the
    full sequence of each head group)."""
    p_sz = C.axis_size(mesh, axis)
    if q.shape[2] % p_sz != 0:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by mesh axis "
            f"{axis!r} ({p_sz}); use ring_attention instead"
        )
    attn = attn_fn or attention
    blocks = C.shard(mesh, axis, q, k, v, dims=1)
    q, k, v = (C.all_to_all(x, mesh, axis, split_axis=2, concat_axis=1) for x in blocks)
    out = attn(q, k, v, causal=causal, scale=scale)
    out = C.all_to_all(out, mesh, axis, split_axis=1, concat_axis=2)
    return C.all_gather(out, mesh, axis, dim=1)
