"""Flash attention with a sliding window and grouped K/V heads: the plain
versions against a dense masked softmax written out, the band counters, and
the paths that take no band.

The written-out attention expands k and v to every query head by indexing
(query head h reads K/V head h // (H / H_kv)), writes the band's mask
``0 <= i - j < W`` out in full and takes torch's softmax and autograd. The
plain versions reach the same numbers by another route (grouped products,
the saved log-sum-exp, the kernels' formula for dS), so f32 outputs and
gradients agree to 2e-5 absolute: sums of about a hundred unit-scale terms
taken in another order.
"""

import pytest
import torch

from pygrid_tpu_torch.parallel import flash_attention as fa

torch.set_num_threads(1)

TOL = 2e-5


def _dense(q, k, v, scale, window):
    """Causal softmax attention written out: k, v expanded to q's heads, the
    band's mask in full."""
    H, Hk = q.shape[2], k.shape[2]
    idx = torch.arange(H) // (H // Hk)
    kx, vx = k[:, :, idx], v[:, :, idx]
    s = torch.einsum("bqhd,bkhd->bhqk", q, kx) * scale
    L = q.shape[1]
    i, j = torch.arange(L)[:, None], torch.arange(L)[None, :]
    keep = (i >= j) & (i - j < (window if window is not None else L + 1))
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vx)


def _inputs(B, L, H, Hk, D, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, L, n, D, generator=g, requires_grad=True) for n in (H, Hk, Hk)]


@pytest.mark.parametrize(
    "B,L,H,Hk,D,window",
    [
        (1, 80, 4, 4, 16, 200),   # W >= L: causal
        (1, 80, 4, 4, 16, 80),    # W = L: causal
        (2, 70, 4, 2, 16, 1),     # W = 1: each query sees itself alone
        (1, 130, 8, 1, 24, 33),   # L and W off the 64-row tiles, one K/V head
        (1, 129, 8, 4, 32, 70),
        (2, 97, 4, 4, 16, 64),    # H_kv = H
        (1, 97, 8, 2, 16, None),  # grouped, no window
    ],
)
def test_plain_versions_match_written_out_softmax(B, L, H, Hk, D, window):
    q, k, v = _inputs(B, L, H, Hk, D, seed=L + H + Hk)
    scale = D**-0.5
    out = fa.flash_attention(q, k, v, causal=True, scale=scale, window=window)
    want = _dense(q, k, v, scale, window)
    torch.testing.assert_close(out, want, atol=TOL, rtol=0)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    ref = torch.autograd.grad((want * w).sum(), (q, k, v))
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=TOL, rtol=0)


def test_window_at_least_the_length_is_causal():
    q, k, v = _inputs(1, 96, 4, 2, 16, seed=3)
    a = fa.flash_attention(q, k, v, causal=True, window=96)
    b = fa.flash_attention(q, k, v, causal=True)
    assert torch.equal(a, b)


def test_window_needs_causal_and_heads_must_divide():
    q, k, v = _inputs(1, 64, 4, 2, 16, seed=4)
    with pytest.raises(ValueError, match="window needs causal"):
        fa.flash_attention(q, k, v, causal=False, window=8)
    with pytest.raises(ValueError, match="window needs causal"):
        fa.flash_attention(q, k, v, causal=True, window=0)
    q3, k3, v3 = _inputs(1, 64, 4, 3, 16, seed=5)
    with pytest.raises(ValueError, match="divides"):
        fa.flash_attention(q3, k3, v3, causal=True)


def test_tile_pairs_at_the_cell_shape():
    """At the Trinity cell's [4, 8192, 32 / 4, 128] and W = 2,048 a sliding
    forward visits 3,696 of a slice's 8,256 causal 64 x 64 tile pairs: 0.448
    of causal, under 0.46; a window at least L visits them all."""
    visited, causal = fa.tile_pairs(8192, 2048)
    assert (visited, causal) == (3696, 8256)
    assert visited / causal <= 0.46
    assert fa.tile_pairs(8192, 8192) == (causal, causal)
    assert fa.tile_pairs(100, None) == (3, 3)
    assert fa.tile_pairs(128, 1) == (2, 3)


def _meta(B, L, H, D, dtype=torch.bfloat16):
    return torch.empty((B, L, H, D), device="meta", dtype=dtype)


def _record_launches(monkeypatch):
    calls = {}
    monkeypatch.setattr(fa, "_check_cuda", lambda *xs: None)
    monkeypatch.setattr(fa.build, "launch",
                        lambda lib, entry, device, *args: calls.setdefault(entry, args))
    return calls


def test_band_counters_and_entries_at_the_cell_shape(monkeypatch):
    """The wrappers' kernel path at the cell's shape on meta tensors, the C
    entries recorded: each launch counts once by kind, the entries get H_kv
    and W after the dtype flag, dK and dV come back at H_kv heads, and each
    causal forward adds its slice's tile pairs for every (b, h)."""
    calls = _record_launches(monkeypatch)
    B, L, H, Hk, D = 4, 8192, 32, 4, 128
    q, do = _meta(B, L, H, D), _meta(B, L, H, D)
    k, v = _meta(B, L, Hk, D), _meta(B, L, Hk, D)
    lse = delta = torch.empty((B * H, L), device="meta")
    fa.reset_launch_counts()
    for window in (2048, None):
        out, _ = fa.flash_fwd(q, k, v, True, D**-0.5, window)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, D**-0.5, window)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True, D**-0.5, window)
        assert [tuple(x.shape) for x in (out, dk, dv, dq)] == [
            (B, L, H, D), (B, L, Hk, D), (B, L, Hk, D), (B, L, H, D)]
        for entry, at in (("pgt_flash_fwd", 23), ("pgt_flash_bwd_dkv", 29),
                          ("pgt_flash_bwd_dq", 28)):
            assert calls.pop(entry)[at:at + 2] == (Hk, window or 0)
    counts = fa.band_counts()
    assert counts["window"] == dict.fromkeys(fa.launch_counts(), 1)
    assert counts["grouped"] == dict.fromkeys(fa.launch_counts(), 2)
    assert fa.launch_counts() == dict.fromkeys(fa.launch_counts(), 2)
    # the sliding launch's pairs, then the full launch's: all of causal
    assert counts["tile_pairs"] == B * H * (3696 + 8256)
    assert counts["causal_tile_pairs"] == B * H * 2 * 8256
    fa.reset_launch_counts()
    assert fa.band_counts()["tile_pairs"] == 0


@pytest.mark.parametrize(
    "dtype,D,Dv,Hk,window",
    [
        (torch.bfloat16, 192, 128, 2, None),   # narrow-V
        (torch.bfloat16, 192, 128, 4, 64),
        (torch.bfloat16, 256, 256, 4, 64),     # wide
        (torch.bfloat16, 256, 256, 2, None),
        (torch.float32, 64, 64, 4, 64),        # the f32 kernels
        (torch.float32, 64, 64, 2, None),
    ],
)
def test_paths_without_a_band_raise(monkeypatch, dtype, D, Dv, Hk, window):
    """A window or H_kv < H on the wide, narrow-V or f32 kernels raises in
    every wrapper, before anything is launched: no silent fallback."""
    calls = _record_launches(monkeypatch)
    B, L, H = 1, 64, 4
    q, do = _meta(B, L, H, D, dtype), _meta(B, L, H, Dv, dtype)
    k, v = _meta(B, L, Hk, D, dtype), _meta(B, L, Hk, Dv, dtype)
    lse = delta = torch.empty((B * H, L), device="meta")
    with pytest.raises(ValueError, match="runs only on the bf16 kernels"):
        fa.flash_fwd(q, k, v, True, 0.1, window)
    with pytest.raises(ValueError, match="runs only on the bf16 kernels"):
        fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, 0.1, window)
    with pytest.raises(ValueError, match="runs only on the bf16 kernels"):
        fa.flash_bwd_dq(q, k, v, do, lse, delta, True, 0.1, window)
    assert calls == {}
