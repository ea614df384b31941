"""Port parity: pygrid_tpu_torch flash attention against the JAX package's
Pallas kernel, which runs in interpret mode on the CPU (as
tests/unit/test_pallas_attention.py runs it). The port runs on the CPU
too, so its wrappers take the kernels' plain PyTorch versions. Inputs are
drawn once with numpy and handed to both.

Tolerances: f32 outputs atol 3e-5 and f32 gradients atol 1e-4 (the same
math summed in another order); bf16 inputs atol 2e-2 (P is rounded to bf16
at points that differ between the blocked and the one-pass computation),
and bf16 gradients also rtol 1e-2 (one bf16 ulp is 2^-8 to 2^-7 relative).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygrid_tpu.parallel.pallas_attention import BLOCK_K, BLOCK_Q, _fwd_impl
from pygrid_tpu.parallel.pallas_attention import flash_attention as jax_flash
from pygrid_tpu_torch.parallel import flash_attention as fa
from pygrid_tpu_torch.parallel.ring_attention import attention

torch.set_num_threads(1)


def _qkv(B, Lq, Lk, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((B, L, H, D), dtype=np.float32)
        for L in (Lq, Lk, Lk)
    ]


def _jax(xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype=dtype) for x in xs]


def _torch(xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


@pytest.mark.parametrize(
    "B,Lq,Lk,H,D,causal",
    [
        (2, 128, 128, 2, 64, False),
        (1, 256, 256, 4, 64, True),
        (2, 200, 200, 2, 32, True),    # ragged lengths, tiny head dim
        (1, 100, 300, 2, 64, False),   # cross-attention, ragged
        (1, 384, 384, 1, 128, True),   # full-width head dim
        # the bf16 tensor-core kernels' tile edges on the card (64-row
        # tiles; head dims padded to 48, 64 and 128), at the D each has there
        (1, 64, 64, 1, 40, True),
        (1, 65, 65, 2, 128, True),
        (1, 127, 127, 1, 64, True),
        (1, 128, 128, 1, 40, False),
        (1, 129, 129, 1, 36, True),    # D=36: the wrapper's padded copy
        (1, 65, 129, 2, 128, False),   # Lq != Lk
        # past D = 128 the CUDA kernels split D into 128-wide slices
        (1, 65, 65, 2, 256, True),
        (1, 64, 97, 1, 256, False),
    ],
)
def test_forward_and_lse_match_pallas(B, Lq, Lk, H, D, causal):
    xs = _qkv(B, Lq, Lk, H, D)
    out_j, lse_j = _fwd_impl(
        *_jax(xs), causal, D**-0.5, True, BLOCK_Q, BLOCK_K, None
    )
    out_t, lse_t = fa.flash_fwd(*_torch(xs), causal, D**-0.5)
    assert out_t.shape == (B, Lq, H, D) and lse_t.shape == (B * H, Lq)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=3e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=3e-5)
    # the autograd entry point gives the same forward
    got = fa.flash_attention(*_torch(xs), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(out_j), atol=3e-5)


@pytest.mark.parametrize(
    "Lq,Lk,causal,D",
    [
        pytest.param(128, 128, False, 64, id="128-128-False"),
        pytest.param(200, 200, True, 64, id="200-200-True"),
        pytest.param(100, 300, False, 64, id="100-300-False"),
        # tile edges of the bf16 tensor-core kernels on the card
        pytest.param(65, 65, True, 40, id="65-65-True-D40"),
        pytest.param(129, 129, True, 128, id="129-129-True-D128"),
        pytest.param(64, 127, False, 36, id="64-127-False-D36"),
        pytest.param(65, 65, True, 256, id="65-65-True-D256"),
    ],
)
def test_gradients_match_pallas(Lq, Lk, causal, D):
    """The autograd Function's backward (Δ, then the dK/dV and dQ passes)
    agrees with jax.grad through the interpret-mode Pallas VJP."""
    xs = _qkv(1, Lq, Lk, 2, D, seed=3)
    g_j = jax.grad(
        lambda q, k, v: jnp.sum(
            jnp.tanh(jax_flash(q, k, v, causal=causal, interpret=True))
        ),
        argnums=(0, 1, 2),
    )(*_jax(xs))
    ts = [t.requires_grad_() for t in _torch(xs)]
    loss = torch.tanh(fa.flash_attention(*ts, causal=causal)).sum()
    g_t = torch.autograd.grad(loss, ts)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


# values narrower than queries and keys (multi-head latent attention): the
# Pallas kernel takes one D, so the JAX side runs with v zero-padded to D_qk
# and its output sliced back, as the model ran it before the narrow-V path
NARROW_V = [
    pytest.param(1, 65, 65, 2, 192, 128, True, id="L65-192-128-causal"),
    pytest.param(1, 64, 97, 1, 192, 128, False, id="Lq64-Lk97-192-128"),
    pytest.param(1, 100, 100, 2, 160, 96, True, id="L100-160-96-causal"),
]


def _pad_v(v, Dqk):
    return jnp.pad(v, [(0, 0)] * 3 + [(0, Dqk - v.shape[-1])])


@pytest.mark.parametrize("B,Lq,Lk,H,Dqk,Dv,causal", NARROW_V)
def test_narrow_v_forward_and_lse_match_pallas(B, Lq, Lk, H, Dqk, Dv, causal):
    q, k, v = _qkv(B, Lq, Lk, H, Dqk, seed=7)
    xs = [q, k, v[..., :Dv]]
    qj, kj, vj = _jax(xs)
    out_j, lse_j = _fwd_impl(
        qj, kj, _pad_v(vj, Dqk), causal, Dqk**-0.5, True, BLOCK_Q, BLOCK_K, None
    )
    out_t, lse_t = fa.flash_fwd(*_torch(xs), causal, Dqk**-0.5)
    assert out_t.shape == (B, Lq, H, Dv)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j)[..., :Dv], atol=3e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=3e-5)
    got = fa.flash_attention(*_torch(xs), causal=causal)  # default scale D_qk^-0.5
    np.testing.assert_allclose(got.numpy(), np.asarray(out_j)[..., :Dv], atol=3e-5)


@pytest.mark.parametrize("B,Lq,Lk,H,Dqk,Dv,causal", NARROW_V)
def test_narrow_v_gradients_match_pallas(B, Lq, Lk, H, Dqk, Dv, causal):
    """dQ, dK at D_qk and dV at D_v through the autograd Function against
    jax.grad through the Pallas VJP with v zero-padded and sliced back."""
    q, k, v = _qkv(B, Lq, Lk, H, Dqk, seed=8)
    xs = [q, k, v[..., :Dv]]
    g_j = jax.grad(
        lambda q, k, v: jnp.sum(jnp.tanh(
            jax_flash(q, k, _pad_v(v, Dqk), causal=causal, interpret=True)[..., :Dv])),
        argnums=(0, 1, 2),
    )(*_jax(xs))
    ts = [t.requires_grad_() for t in _torch(xs)]
    g_t = torch.autograd.grad(torch.tanh(fa.flash_attention(*ts, causal=causal)).sum(), ts)
    assert [g.shape[-1] for g in g_t] == [Dqk, Dqk, Dv]
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize(
    "dtype,Dqk,Dv,narrow",
    [
        (torch.bfloat16, 192, 128, True),
        (torch.bfloat16, 160, 96, True),
        (torch.bfloat16, 192, 192, False),
        (torch.bfloat16, 256, 128, False),
        (torch.bfloat16, 64, 64, False),
        (torch.float32, 192, 128, False),
    ],
)
def test_narrow_v_counter_engages_only_on_its_shape(monkeypatch, dtype, Dqk, Dv, narrow):
    """The wrappers' kernel path, on meta tensors with the C entries
    recorded instead of launched: each wrapper counts one launch, and one
    narrow-V launch only at D_v <= 128 < D_qk <= 192 in bf16; the C
    entries get the widths the kernels run at, and the outputs come back
    at the tensors' own widths."""
    calls = {}
    monkeypatch.setattr(fa, "_check_cuda", lambda *xs: None)
    monkeypatch.setattr(fa.build, "launch",
                        lambda lib, entry, device, *args: calls.setdefault(entry, args))
    B, L, H = 1, 64, 2

    def meta(width, dt=dtype):
        return torch.empty((B, L, H, width), device="meta", dtype=dt)

    q, k, v, do = meta(Dqk), meta(Dqk), meta(Dv), meta(Dv)
    lse = delta = torch.empty((B * H, L), device="meta")
    fa.reset_launch_counts()
    out, _ = fa.flash_fwd(q, k, v, True, 0.1)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, 0.1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True, 0.1)
    assert [x.shape[-1] for x in (out, dk, dv, dq)] == [Dv, Dqk, Dv, Dqk]
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
    assert fa.narrow_v_counts() == dict.fromkeys(fa.launch_counts(), int(narrow))
    widths = fa._widths(Dqk, Dv, dtype == torch.bfloat16)
    assert (widths[0] != widths[1]) == narrow
    # after the pointers (5, 8 and 7): B, H, Lq, Lk, D_qk, D_v
    assert calls["pgt_flash_fwd"][9:11] == widths
    assert calls["pgt_flash_bwd_dkv"][12:14] == widths
    assert calls["pgt_flash_bwd_dq"][11:13] == widths
    fa.reset_launch_counts()


def test_bf16_inputs_match_pallas():
    xs = _qkv(1, 256, 256, 2, 64, seed=5)
    out_j = jax_flash(*_jax(xs, jnp.bfloat16), causal=True, interpret=True)
    ts = [t.requires_grad_() for t in _torch(xs, torch.bfloat16)]
    out_t = fa.flash_attention(*ts, causal=True)
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out_t.float().detach().numpy(),
        np.asarray(out_j, dtype=np.float32), atol=2e-2,
    )
    g_j = jax.grad(
        lambda q, k, v: jnp.sum(
            jnp.tanh(jax_flash(q, k, v, causal=True, interpret=True))
            .astype(jnp.float32)
        ),
        argnums=(0, 1, 2),
    )(*_jax(xs, jnp.bfloat16))
    g_t = torch.autograd.grad(torch.tanh(out_t).float().sum(), ts)
    for a, b in zip(g_t, g_j):
        assert a.dtype == torch.bfloat16
        # gradients reach ~7 here, where one bf16 ulp is 0.03: rtol 1e-2
        # admits a one-ulp rounding difference, atol 2e-2 the small values
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(b, dtype=np.float32),
            atol=2e-2, rtol=1e-2,
        )


def test_scale_override_and_dense_yardstick():
    xs = _qkv(1, 128, 128, 1, 64, seed=6)
    ref = jax_flash(*_jax(xs), scale=0.5, interpret=True)
    got = fa.flash_attention(*_torch(xs), scale=0.5)
    dense = attention(*_torch(xs), scale=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5)
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref), atol=3e-5)


def test_causal_requires_square():
    q, k, v = _torch(_qkv(1, 128, 256, 1, 64))
    with pytest.raises(ValueError, match="Lq == Lk"):
        fa.flash_attention(q, k, v, causal=True)


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers take the plain versions, which are not
    kernel launches: the counts stay 0."""
    fa.reset_launch_counts()
    ts = [t.requires_grad_() for t in _torch(_qkv(1, 64, 64, 2, 16))]
    fa.flash_attention(*ts, causal=True).sum().backward()
    assert fa.launch_counts() == {
        "flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
    }
    assert fa.narrow_v_counts() == fa.launch_counts()


def test_tensor_core_layout_step():
    """What the bf16 tensor-core kernels are handed: a view whose head dim
    and strides are multiples of 8 elements passes as it is; any other is
    copied, zero-filled past D up to a multiple of 8."""
    qkv = torch.randn((2, 5, 3, 2, 64)).to(torch.bfloat16)
    views = [qkv[:, :, i] for i in range(3)]
    *same, _, Dqk, Dv = fa._layout(*views)
    assert (Dqk, Dv) == (64, 64) and all(a is b for a, b in zip(same, views))
    x = torch.randn((2, 5, 3, 2, 36)).to(torch.bfloat16)[:, :, 1]
    padded = fa._fit(x, 40, True)
    assert padded.shape == (2, 5, 2, 40) and padded.is_contiguous()
    assert torch.equal(padded[..., :36], x) and not padded[..., 36:].any()
    odd = torch.randn((2, 5, 3, 40)).to(torch.bfloat16)[:, :, 1:]  # head stride 40, base +80 B
    copied = fa._fit(odd, 40, True)
    assert torch.equal(copied, odd)
    assert copied.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in copied.stride()[:3])


@pytest.mark.parametrize(
    "dtype,Dqk,Dv,want",
    [
        (torch.bfloat16, 192, 128, (192, 128)),  # multi-head latent attention
        (torch.bfloat16, 160, 96, (160, 96)),
        (torch.bfloat16, 190, 126, (192, 128)),  # each rounded up to a multiple of 8
        (torch.bfloat16, 256, 128, (256, 256)),  # D_qk past 192: one width
        (torch.bfloat16, 128, 64, (128, 128)),   # D_qk within 128: one width
        (torch.bfloat16, 64, 192, (192, 192)),   # v wider: one width
        (torch.float32, 192, 128, (192, 192)),   # the f32 kernels take one D
    ],
)
def test_kernel_widths_follow_the_shapes(dtype, Dqk, Dv, want):
    """The kernels' (D_qk, D_v) come from the tensors' widths alone: the
    narrow-V path keeps them apart where D_v <= 128 < D_qk <= 192 in bf16,
    any other pair runs at one width with the narrower side zero-padded.
    q and k of the MLA shape pass as they are (a view of v too), never
    padded to each other's width."""
    assert fa._widths(Dqk, Dv, dtype == torch.bfloat16) == want
    kv = torch.randn((1, 5, 2, 64 + Dv)).to(dtype)
    q, k = torch.randn((2, 1, 5, 2, Dqk)).to(dtype)
    v, do = kv[..., 64:], torch.randn((1, 5, 2, Dv)).to(dtype)
    q2, k2, v2, do2, *widths = fa._layout(q, k, v, do)
    assert tuple(widths) == want
    assert [x.shape[-1] for x in (q2, k2, v2, do2)] == [want[0]] * 2 + [want[1]] * 2
    for a, b in zip((q2, k2, v2, do2), (q, k, v, do)):
        assert torch.equal(a[..., :b.shape[-1]], b) and not a[..., b.shape[-1]:].any()
    if want == (Dqk, Dv) and Dv % 8 == 0 and (64 + Dv) % 8 == 0:
        assert v2 is v  # the strided view of the kv projection is read in place


@pytest.mark.cuda
def test_narrow_v_kernels_match_plain_versions_on_card():
    """The narrow-V path on the card at [1, 512, 2, 192/128] bf16, causal
    and not: each kernel against its plain version, one narrow-V launch
    each, and dK/dV and dQ the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    B, L, H, Dqk, Dv = 1, 512, 2, 192, 128
    for causal in (True, False):
        g = torch.Generator(device="cuda").manual_seed(1)
        q, k = (torch.randn((B, L, H, Dqk), generator=g, device="cuda").bfloat16()
                for _ in range(2))
        v, do = (torch.randn((B, L, H, Dv), generator=g, device="cuda").bfloat16()
                 for _ in range(2))
        s = Dqk**-0.5
        fa.reset_launch_counts()
        out, lse = fa.flash_fwd(q, k, v, causal, s)
        out_r, lse_r = fa.flash_fwd_reference(q, k, v, causal, s)
        delta = fa.softmax_delta(out_r, do)
        got = [out, lse, *fa.flash_bwd_dkv(q, k, v, do, lse_r, delta, causal, s),
               fa.flash_bwd_dq(q, k, v, do, lse_r, delta, causal, s)]
        ref = [out_r, lse_r,
               *fa.flash_bwd_dkv_reference(q, k, v, do, lse_r, delta, causal, s),
               fa.flash_bwd_dq_reference(q, k, v, do, lse_r, delta, causal, s)]
        torch.cuda.synchronize()
        assert [x.shape[-1] for x in got] == [Dv, L, Dqk, Dv, Dqk]  # lse: [B·H, L]
        for a, b in zip(got, ref):
            torch.testing.assert_close(a.float(), b.float(), atol=1e-2, rtol=1e-2)
        assert fa.launch_counts() == {"flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
        assert fa.narrow_v_counts() == fa.launch_counts()
        again = fa.flash_bwd_dkv(q, k, v, do, lse_r, delta, causal, s)
        assert all(torch.equal(a, b) for a, b in zip(again, got[2:4]))
        assert torch.equal(fa.flash_bwd_dq(q, k, v, do, lse_r, delta, causal, s), got[4])


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """Each CUDA kernel against its plain version on the card (bf16 and
    f32, causal and ragged), then the bf16 tensor-core kernels' tile and
    layout edges (L around the 64-row tiles, D of 40, 64 and 128, a D=36
    padded copy, Lq != Lk, q/k/v as views of one [B, L, 3, H, D] tensor),
    and head dims past 128 (160, 256, 512) in both dtypes;
    counts one launch per kernel call, and dK/dV and dQ give the same bits
    twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    cases = [(torch.float32, 1e-4, (2, 200, 3, 64), 200, True, False),
             (torch.float32, 1e-4, (1, 100, 2, 64), 300, False, False),
             (torch.bfloat16, 1e-2, (2, 200, 3, 64), 200, True, False),
             (torch.bfloat16, 1e-2, (1, 100, 2, 64), 300, False, False)]
    cases += [(torch.bfloat16, 1e-2, (2, L, 2, D), L, True, False)
              for L in (64, 65, 127, 128, 129) for D in (40, 64, 128)]
    cases += [(torch.bfloat16, 1e-2, shape, Lk, causal, views)
              for shape, Lk, causal, views in (
                  ((2, 129, 2, 36), 129, True, False),
                  ((2, 65, 2, 128), 129, False, False),
                  ((1, 129, 2, 40), 64, False, False),
                  ((2, 127, 2, 64), 127, True, True),
                  ((2, 65, 2, 36), 65, True, True))]
    # head dims past 128: the wide kernels, both dtypes
    cases += [(dtype, tol, (1, L, 2, D), L, causal, False)
              for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4))
              for L, D, causal in ((65, 160, True), (127, 256, False), (129, 512, True))]
    for dtype, atol, (B, Lq, H, D), Lk, causal, views in cases:
        g = torch.Generator(device="cuda").manual_seed(0)
        if views:
            qkv = torch.randn((B, Lq, 3, H, D), generator=g, device="cuda").to(dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            do = torch.randn((B, Lq, H, D), generator=g, device="cuda").to(dtype)
        else:
            q, do = (torch.randn((B, Lq, H, D), generator=g, device="cuda").to(dtype)
                     for _ in range(2))
            k, v = (torch.randn((B, Lk, H, D), generator=g, device="cuda").to(dtype)
                    for _ in range(2))
        s = D**-0.5
        fa.reset_launch_counts()
        out, lse = fa.flash_fwd(q, k, v, causal, s)
        out_r, lse_r = fa.flash_fwd_reference(q, k, v, causal, s)
        delta = fa.softmax_delta(out_r, do)
        got = [out, lse, *fa.flash_bwd_dkv(q, k, v, do, lse_r, delta, causal, s),
               fa.flash_bwd_dq(q, k, v, do, lse_r, delta, causal, s)]
        ref = [out_r, lse_r,
               *fa.flash_bwd_dkv_reference(q, k, v, do, lse_r, delta, causal, s),
               fa.flash_bwd_dq_reference(q, k, v, do, lse_r, delta, causal, s)]
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=atol)
        assert fa.launch_counts() == {
            "flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1,
        }
        again = fa.flash_bwd_dkv(q, k, v, do, lse_r, delta, causal, s)
        assert all(torch.equal(a, b) for a, b in zip(again, got[2:4]))
        assert torch.equal(fa.flash_bwd_dq(q, k, v, do, lse_r, delta, causal, s), got[4])
