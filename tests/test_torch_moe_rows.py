"""The expert layer's row passes (``models/moe.py``: ``gather_rows``,
``swiglu``, ``combine``, ``rows_bwd``, ``swiglu_bwd``, ``combine_bwd``)
against their plain versions.

On the CPU the wrappers take the plain versions and launch nothing. On the
card (marked ``cuda``, skipped without one) each wrapper launches its
kernel of ``csrc/moe_rows.cu``: every row it reads past the held count
``offs[-1]`` is NaN, so the rows before it must equal the plain version's
and the per-token outputs (y, dx, dw) must be finite and equal to it
everywhere; at a held count of 0 those are exactly 0. The whole layer,
forward and gradients, runs through the kernels with the card's caching
allocator poisoned with NaN first, so that its ``torch.empty`` buffers
start as NaN, and is held to the same layer built from the plain versions
around the same grouped products. The plain versions round bf16
intermediates where the kernels keep f32: bf16 is held at 1e-2 (atol and
rtol), f32 at 1e-5; the layer in bf16 at 3e-2 of each output's largest
entry.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from pygrid_tpu_torch.models import moe

# id: (tokens T, experts E, top-k, held experts, d, f, dtype, routing);
# routing as in test_torch_moe_rows_emulated.py: "random", "none held"
# (a held count of 0), "all held" (every token's top-k inside the held
# experts: n = M; with one held expert every assignment lands on it)
CASES = {
    "d64-f32-bf16": (96, 16, 4, 4, 64, 32, "bfloat16", "random"),
    "d64-f32-f32": (96, 16, 4, 4, 64, 32, "float32", "random"),
    "d60-f36-bf16-odd-widths": (75, 16, 4, 4, 60, 36, "bfloat16", "random"),
    "d60-f36-f32-odd-widths": (75, 16, 4, 4, 60, 36, "float32", "random"),
    "none-held-bf16": (32, 16, 4, 4, 64, 32, "bfloat16", "none held"),
    "all-held-bf16": (32, 16, 4, 4, 64, 32, "bfloat16", "all held"),
    "one-held-expert-takes-all-bf16": (32, 16, 4, 1, 64, 32, "bfloat16", "all held"),
}
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def _plan(T, E, k, held, d, routing, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x32 = torch.randn(T, d, generator=g).to(device)
    wg = (torch.randn(E, d, generator=g) * 0.3).to(device)
    bias = torch.zeros(E, device=device)
    if routing == "none held":
        bias[held:held + k] = 100.0
    elif routing == "all held":
        bias[:k] = 100.0
    sel, w = moe.route_topk(x32, wg, bias, k, 2.5)
    return x32, w, moe.dispatch(sel, 0, held)


def _experts(held, d, f, dtype, device, seed=1):
    g = torch.Generator().manual_seed(seed)
    w13 = torch.randn(held, d, 2 * f, generator=g) * d ** -0.5
    w2 = torch.randn(held, f, d, generator=g) * f ** -0.5
    return w13.to(device, dtype), w2.to(device, dtype)


def _plain_layer(x, w, w13, w2, order, offs, pos, held):
    """``_HeldExperts`` written with the plain versions around the same
    grouped products, differentiable by autograd. The rows past the held
    count are cut from the graph: ``grouped_mm``'s input gradient leaves
    them unwritten, and the gather's gradient would add them to x's."""
    k = pos.shape[1]
    xs = moe.gather_reference(x, order, k)
    live = torch.arange(xs.shape[0], device=x.device)[:, None] < offs[-1]
    xs = torch.where(live, xs, torch.zeros_like(xs))
    o = F.grouped_mm(moe.swiglu_reference(F.grouped_mm(xs, w13, offs=offs)), w2, offs=offs)
    return torch.bmm(w[:, None, :], moe._gather_rows(o, pos, held).float())[:, 0].to(x.dtype)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    T, E, k, held, d, f = 96, 16, 4, 4, 64, 32
    x32, w, plan = _plan(T, E, k, held, d, "random", "cpu")
    order, offs, pos, mask = plan
    w13, w2 = _experts(held, d, f, torch.float32, "cpu")
    moe.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (x32, w, w13, w2)]
    y = moe._HeldExperts.apply(*leaves, *plan)
    got = torch.autograd.grad(y.square().sum(), leaves)
    assert moe.launch_counts() == dict.fromkeys(moe.ROW_KERNELS, 0)
    rleaves = [t.clone().requires_grad_() for t in (x32, w, w13, w2)]
    want_y = _plain_layer(*rleaves, *plan)
    want = torch.autograd.grad(want_y.square().sum(), rleaves)
    assert torch.equal(y, want_y)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    h = F.grouped_mm(moe.gather_rows(x32, order, offs, k), w13, offs=offs)
    assert torch.equal(moe.gather_rows(x32, order, offs, k), moe.gather_reference(x32, order, k))
    assert torch.equal(moe.swiglu(h, offs), moe.swiglu_reference(h))
    assert moe.launch_counts() == dict.fromkeys(moe.ROW_KERNELS, 0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, tol, what):
    got, want = got.float(), want.float()
    bad = ~torch.isfinite(got) | ((got - want).abs() > tol + tol * want.abs())
    assert not bad.any(), (f"{what}: {int(bad.sum())} of {got.numel()} entries off by more "
                           f"than {tol}, max {float((got - want).abs().max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_row_kernels_equal_the_plain_versions_on_the_held_rows(case):
    dev = _card()
    T, E, k, held, d, f, dt, routing = CASES[case]
    dtype = getattr(torch, dt)
    x32, w, (order, offs, pos, mask) = _plan(T, E, k, held, d, routing, dev)
    x = x32.to(dtype)
    M, n = order.shape[0], int(offs[-1])
    g = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape):
        t = torch.randn(*shape, generator=g, device=dev).to(dtype)
        t[n:] = float("nan")
        return t

    h, o, da, dxs = rnd(M, 2 * f), rnd(M, d), rnd(M, f), rnd(M, d)
    gy = torch.randn(T, d, generator=g, device=dev).to(dtype)
    dws_in = torch.randn(M, generator=g, device=dev)
    dws_in[n:] = float("nan")
    moe.reset_launch_counts()
    got = {"xs": moe.gather_rows(x, order, offs, k), "a": moe.swiglu(h, offs),
           "y": moe.combine(o, w, pos, mask), "dh": moe.swiglu_bwd(h, da, offs)}
    got["dws"], got["do"] = moe.rows_bwd(gy, o, w, order, offs, k)
    got["dx"], got["dw"] = moe.combine_bwd(dxs, dws_in, pos, mask)
    torch.cuda.synchronize()
    assert moe.launch_counts() == dict.fromkeys(moe.ROW_KERNELS, 1)
    dws_r, do_r = moe.rows_bwd_reference(gy, o, w, order, k)
    dx_r, dw_r = moe.combine_bwd_reference(dxs, dws_in, pos, mask)
    want = {"xs": moe.gather_reference(x, order, k), "a": moe.swiglu_reference(h),
            "y": moe.combine_reference(o, w, pos, mask), "dws": dws_r, "do": do_r,
            "dh": moe.swiglu_bwd_reference(h, da), "dx": dx_r, "dw": dw_r}
    for name, t in got.items():
        rows = slice(None) if name in ("y", "dx", "dw") else slice(0, n)
        _close(t[rows], want[name][rows], TOL[dtype], f"{case}: {name}")
    if routing == "none held":
        assert n == 0
        for name in ("y", "dx", "dw"):
            assert torch.equal(got[name], torch.zeros_like(got[name])), name
    if routing == "all held":
        assert n == M


def _poison_allocator(dev, blocks=16, nbytes=1 << 20):
    """Fill the caching allocator's cached small blocks with NaN, so that
    the next small ``torch.empty`` buffers start as NaN."""
    held = [torch.full((nbytes // 4,), float("nan"), device=dev) for _ in range(blocks)]
    torch.cuda.synchronize()
    del held


@pytest.mark.cuda
@pytest.mark.parametrize("routing,held", [("random", 4), ("none held", 4), ("all held", 1)])
def test_the_layer_and_its_gradients_equal_the_plain_layer_on_the_card(routing, held):
    dev = _card()
    T, E, k, d, f = 96, 16, 4, 64, 32
    x32, w, plan = _plan(T, E, k, held, d, routing, dev, seed=3)
    w13, w2 = _experts(held, d, f, torch.bfloat16, dev)
    x = x32.to(torch.bfloat16)
    gy = torch.randn(T, d, generator=torch.Generator(device=dev).manual_seed(4),
                     device=dev).to(torch.bfloat16)
    outs = []
    for layer in (moe._HeldExperts.apply, _plain_layer):
        leaves = [t.clone().requires_grad_() for t in (x, w, w13, w2)]
        _poison_allocator(dev)
        moe.reset_launch_counts()
        y = layer(*leaves, *plan)
        grads = torch.autograd.grad(y, leaves, gy)
        torch.cuda.synchronize()
        outs.append((y, *grads, moe.launch_counts()))
    (y, *grads, counts), (y_r, *grads_r, counts_r) = outs
    assert counts == {"moe_gather": 2, "moe_swiglu_fwd": 2, "moe_combine_fwd": 1,
                      "moe_rows_bwd": 1, "moe_swiglu_bwd": 1, "moe_combine_bwd": 1}
    assert counts_r == dict.fromkeys(moe.ROW_KERNELS, 0)
    # with no held row the weight gradients are grouped products over
    # empty groups alone, which this layer's row passes never touch
    names = ("y", "dx", "dw") if routing == "none held" else ("y", "dx", "dw", "dw13", "dw2")
    for name, a, b in zip(names, (y, *grads), (y_r, *grads_r)):
        assert torch.isfinite(a).all(), name
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=3e-2, atol=3e-2 * scale + 1e-6,
                                   msg=lambda m, name=name: f"{routing}: {name}: {m}")
        if routing == "none held":
            assert torch.equal(a, torch.zeros_like(a)), name
