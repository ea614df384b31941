"""The port's DeepSeek-V3 decoder (``models/deepseek_v3.py``) and its
dropless top-k expert layer (``models/moe.py``) against the plain float32
reference (``benchmark/reference/deepseek_v3.py``), at a tiny size on the CPU:
d 64, 4 heads of nope 16 + rope 8 (v 16), a kv latent of 32, 16 routed
experts of which 4 are held, top-4, 2 shared, one dense and two expert
layers, vocab 96, sequences of 32.

Tolerances. f32: the two sides make the same products in another order
(the grouped products, the experts' sums), so logits are held at 1e-5 of
their largest, the loss at 1e-6 relative, each gradient leaf at 1e-4 of its
largest entry, one round's params at 1e-4 relative. bf16: every product
rounds its operands to 8 bits of mantissa (relative 4e-3), so the loss is
held at 5e-4 relative and each leaf's gradient norm at 3e-2; the expert
layers' routing side (their MLP norm, router and routed experts) at 0.3,
because at this size a rounding moves a few of 96 tokens across the top-4
boundary, and a token moved takes 1/24 of an expert's rows with it.
"""

from __future__ import annotations

import json
import subprocess
import sys
from functools import partial
from pathlib import Path

import pytest
import torch

from pygrid_tpu_torch.models import deepseek_v3 as dv
from pygrid_tpu_torch.models import moe
from pygrid_tpu_torch.parallel import make_fused_round
from benchmark.reference import deepseek_v3 as rd

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CFG = dv.DeepseekV3Config()
PORT = {k: ([v.start, v.stop] if isinstance(v, range) else v) for k, v in CFG._asdict().items()}
B, L = 3, 32
SHAPES = dv.param_shapes(CFG)


def _setup(seed=0):
    params = dv.init(CFG, generator=torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(1000 + seed)
    X = torch.randint(0, CFG.vocab, (B, L), generator=g)
    return params, X, torch.roll(X, -1, 1)


def _grads(params, X, y, **kw):
    leaves = [p.clone().requires_grad_() for p in params]
    loss, _ = dv.loss_and_acc(leaves, X, y, CFG, **kw)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def _routing_side() -> set:
    """Leaves whose gradient moves with the expert layers' choice of
    experts: each expert layer's MLP norm, router and routed experts."""
    out, i = set(), 1
    for layer in range(CFG.n_layers):
        if layer < CFG.n_dense:
            i += dv.DENSE_PARAMS
            continue
        out |= {i + 6, i + 7, i + 10, i + 11}
        i += dv.MOE_PARAMS
    return out


def test_param_layout_and_count():
    params = dv.init(CFG, device="cpu")
    assert [tuple(p.shape) for p in params] == SHAPES
    assert len(params) == 1 + dv.DENSE_PARAMS + 2 * dv.MOE_PARAMS + 2
    assert dv.init_bias(CFG, "cpu").shape == (2, 16)


@pytest.mark.parametrize("biased", [False, True])
def test_f32_logits_loss_and_every_gradient_equal_the_reference(biased):
    """With the routers' bias at 0 and at a draw that changes the choice."""
    params, X, y = _setup()
    bias = (torch.randn(2, CFG.n_experts, generator=torch.Generator().manual_seed(3)) * 0.1
            if biased else None)
    got = dv.apply(params, X, CFG, bias=bias)
    want = rd.logits(params, X, PORT, q_block=8, bias=bias)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    loss, grads = _grads(params, X, y, bias=bias)
    ref_loss, ref_grads = rd.loss_and_grad(params, X, y, PORT, block_rows=2, q_block=8,
                                           bias=bias)
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    for i, (a, b) in enumerate(zip(grads, ref_grads)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-12, (i, SHAPES[i])


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_path_within_its_tolerance(seed):
    params, X, y = _setup(seed)
    loss, grads = _grads(params, X, y, compute_dtype="bfloat16", ce_grad_dtype="bfloat16")
    ref_loss, ref_grads = rd.loss_and_grad(params, X, y, PORT, block_rows=3, q_block=32)
    assert loss == pytest.approx(ref_loss, rel=5e-4)
    routing = _routing_side()
    for i, (a, b) in enumerate(zip(grads, ref_grads)):
        err = float((a - b).norm() / b.norm())
        assert err <= (0.3 if i in routing else 3e-2), (i, SHAPES[i], err)


def _moe_layer_inputs(seed=0, T=96):
    g = torch.Generator().manual_seed(seed)
    d, E, f = CFG.d_model, CFG.n_experts, CFG.moe_ff
    x = torch.randn(T, d, generator=g)
    wg = torch.randn(E, d, generator=g) * 0.2
    s_gu = torch.randn(d, 2 * CFG.n_shared * f, generator=g) * 0.1
    s_down = torch.randn(CFG.n_shared * f, d, generator=g) * 0.1
    e_gu = torch.randn(E, d, 2 * f, generator=g) * 0.1
    e_down = torch.randn(E, f, d, generator=g) * 0.1
    return x, wg, s_gu, s_down, e_gu, e_down


def _port_share(x, wg, bias, e_gu, e_down, held: range):
    return moe.topk_expert_layer(x, x, wg, bias, e_gu[held.start:held.stop],
                                 e_down[held.start:held.stop], held, CFG.top_k,
                                 CFG.routed_scale)


def test_shares_add_up_to_the_uncut_layer():
    """The four disjoint shares of 4 experts each, with the shared experts
    counted once, give the reference's layer over all 16 experts."""
    x, wg, s_gu, s_down, e_gu, e_down = _moe_layer_inputs()
    bias = torch.zeros(CFG.n_experts)
    parts = sum(_port_share(x, wg, bias, e_gu, e_down, range(i, i + 4)) for i in (0, 4, 8, 12))
    shared = dv._swiglu(x, s_gu, s_down)
    whole = rd.routed_and_shared(x, (wg, s_gu, s_down, e_gu, e_down), bias,
                                 dict(PORT, experts_held=[0, 16]), torch.matmul)
    torch.testing.assert_close(parts + shared, whole, rtol=1e-5, atol=1e-5)


def test_a_share_equals_the_reference_share_and_its_gradients():
    x, wg, s_gu, s_down, e_gu, e_down = _moe_layer_inputs(1)
    bias = torch.zeros(CFG.n_experts)
    held = CFG.experts_held
    leaves = [t.clone().requires_grad_() for t in (x, wg, e_gu[:4], e_down[:4])]
    out = moe.topk_expert_layer(leaves[0], leaves[0], leaves[1], bias, leaves[2], leaves[3],
                                held, CFG.top_k, CFG.routed_scale)
    rleaves = [t.clone().requires_grad_() for t in (x, wg, e_gu[:4], e_down[:4])]
    zero_shared = (torch.zeros_like(s_gu), torch.zeros_like(s_down))
    want = rd.routed_and_shared(rleaves[0], (rleaves[1], *zero_shared, rleaves[2], rleaves[3]),
                                bias, PORT, torch.matmul)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    got = torch.autograd.grad((out * w).sum(), leaves)
    ref = torch.autograd.grad((want * w).sum(), rleaves)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_a_token_with_no_held_expert_gets_only_the_shared_experts():
    x, wg, s_gu, s_down, e_gu, e_down = _moe_layer_inputs(2, T=8)
    bias = torch.zeros(CFG.n_experts)
    bias[4:8] = 100.0  # every token's top 4: experts 4..7, none held here
    out = _port_share(x, wg, bias, e_gu, e_down, range(0, 4))
    assert torch.equal(out, torch.zeros_like(out))


def test_a_forced_imbalance_drops_nothing():
    """Every token's top 4 inside the held range: every assignment is
    computed (the dispatch bound's worst case), none dropped."""
    x, wg, s_gu, s_down, e_gu, e_down = _moe_layer_inputs(3)
    bias = torch.zeros(CFG.n_experts)
    bias[:4] = 100.0
    moe.reset_moe_counts()
    out = _port_share(x, wg, bias, e_gu, e_down, range(0, 4))
    zero_shared = (torch.zeros_like(s_gu), torch.zeros_like(s_down))
    want = rd.routed_and_shared(x, (wg, *zero_shared, e_gu[:4], e_down[:4]), bias, PORT,
                                torch.matmul)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    assert moe.moe_counts() == {"calls": 1, "held_assignments": 96 * 4, "max_load": 96}


def test_the_bias_steers_the_choice_and_the_weights_stay_on_the_scores():
    x, wg, *_ = _moe_layer_inputs(4)
    bias = torch.randn(CFG.n_experts, generator=torch.Generator().manual_seed(9))
    sel0, _ = moe.route_topk(x, wg, torch.zeros(CFG.n_experts), CFG.top_k, CFG.routed_scale)
    sel, w = moe.route_topk(x, wg, bias, CFG.top_k, CFG.routed_scale)
    s = torch.sigmoid(x @ wg.t())
    want_sel = torch.topk(s + bias, CFG.top_k, dim=-1).indices
    assert torch.equal(sel.sort(-1).values, want_sel.sort(-1).values)
    assert not torch.equal(sel.sort(-1).values, sel0.sort(-1).values)
    picked = s.gather(1, sel)
    torch.testing.assert_close(w, picked / picked.sum(-1, keepdim=True) * CFG.routed_scale)
    torch.testing.assert_close(w.sum(-1), torch.full((x.shape[0],), CFG.routed_scale))


@pytest.mark.parametrize("p", [0, 1, 7, 31])
def test_rope_at_a_position_is_the_rotation_written_out(p):
    dim = CFG.qk_rope
    x = torch.randn(1, p + 1, 2, dim, generator=torch.Generator().manual_seed(p))
    cos, sin = dv.rope_tables(p + 1, dim, CFG.rope_theta, "cpu")
    got = dv.rope(x, cos, sin)[0, p].double()
    xp = x[0, p].double()
    for i in range(dim // 2):
        ang = torch.tensor(p * CFG.rope_theta ** (-2 * i / dim), dtype=torch.float64)
        a, b = xp[:, 2 * i], xp[:, 2 * i + 1]
        torch.testing.assert_close(got[:, i], a * ang.cos() - b * ang.sin(), rtol=0, atol=1e-5)
        torch.testing.assert_close(got[:, dim // 2 + i], b * ang.cos() + a * ang.sin(),
                                   rtol=0, atol=1e-5)


def test_rope_layouts_give_the_same_scores():
    """The port keeps DeepSeek's evens-first layout, the reference each
    pair in place: the scores between two positions are the same."""
    q = torch.randn(1, 16, 2, CFG.qk_rope, generator=torch.Generator().manual_seed(1))
    k = torch.randn(1, 16, 2, CFG.qk_rope, generator=torch.Generator().manual_seed(2))
    cos, sin = dv.rope_tables(16, CFG.qk_rope, CFG.rope_theta, "cpu")
    port = torch.einsum("bqhd,bkhd->bhqk", dv.rope(q, cos, sin), dv.rope(k, cos, sin))
    ref = torch.einsum("bqhd,bkhd->bhqk", rd.rope(q, CFG.rope_theta), rd.rope(k, CFG.rope_theta))
    torch.testing.assert_close(port, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_v_at_its_own_width_equals_the_former_padded_call(compute_dtype):
    """``features`` hands v to attention at D_v; before the flash kernels'
    narrow-V path it padded v with zeros to D_qk and sliced the output back
    to D_v. Both give the same hidden states and parameter gradients, with
    the flash wrapper and with the plain attention."""
    import torch.nn.functional as F

    from pygrid_tpu_torch.parallel import flash_attention as fa
    from pygrid_tpu_torch.parallel.ring_attention import attention

    params, X, _ = _setup(4)
    dqk, dv_ = CFG.qk_nope + CFG.qk_rope, CFG.v_head

    def padded(attn):
        return lambda q, k, v, **kw: attn(q, k, F.pad(v, (0, dqk - dv_)), **kw)[..., :dv_]

    def run(attn):
        leaves = [p.clone().requires_grad_() for p in params]
        h = dv.features(leaves, X, CFG, attn_fn=attn, compute_dtype=compute_dtype)
        return h.detach(), torch.autograd.grad(h.square().mean(), leaves[:-1])  # not the head

    for attn in (fa.flash_attention, attention):
        (h, g), (h_pad, g_pad) = run(attn), run(padded(attn))
        torch.testing.assert_close(h, h_pad, rtol=1e-6, atol=1e-6)
        for a, b in zip(g, g_pad):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("remat", [False, True])
def test_counters_read_the_round_and_not_its_recompute(monkeypatch, remat):
    params, X, y = _setup(3)
    seen = []
    real = moe.route_topk

    def spy(*args):
        sel, w = real(*args)
        seen.append(sel.detach().clone())
        return sel, w

    monkeypatch.setattr(moe, "route_topk", spy)
    moe.reset_moe_counts()
    round_fn = make_fused_round(partial(dv.loss_and_acc, cfg=CFG, remat=remat))
    round_fn(params, X[:, None], y[:, None], 0.1)
    first = seen[: CFG.n_layers - CFG.n_dense]  # the forward's; a recompute's follow
    held = [((s >= 0) & (s < 4)) for s in first]
    loads = [torch.bincount(s[h], minlength=4) for s, h in zip(first, held)]
    assert moe.moe_counts() == {"calls": 2, "held_assignments": int(sum(h.sum() for h in held)),
                                "max_load": int(max(ld.max() for ld in loads))}


def test_one_fused_round_equals_the_references_round_and_the_training_step():
    params, X, y = _setup(4)
    round_fn = make_fused_round(partial(dv.loss_and_acc, cfg=CFG))
    new, loss, _ = round_fn(params, X[:, None], y[:, None], 0.1)
    states, losses = rd.fedavg_rounds(params, [(X[:, None], y[:, None])], 0.1, PORT,
                                      block_rows=2, q_block=16)
    assert float(loss) == pytest.approx(losses[0], rel=1e-6)
    for a, b in zip(new, states[0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
    step_loss, _, *stepped = dv.make_training_step(CFG)(X, y, 0.1, *params)
    assert float(step_loss) == pytest.approx(float(loss), rel=1e-6)
    for a, b in zip(stepped, new):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-8)


def test_the_cut_configuration_holds_what_the_card_runs():
    sys.path.insert(0, str(ROOT))
    from benchmark.work import flash, mla_flash, moe_flops

    doc = json.loads((ROOT / "benchmark" / "configs" / "moonlight-16b-a3b-ep8.json").read_text())
    cfg = dv.config_from_dict(doc["port"])
    shapes = dv.param_shapes(cfg)
    assert sum(torch.Size(s).numel() for s in shapes) == doc["parameters"] == 1_371_730_432
    assert doc["n_routed_experts"] == len(cfg.experts_held) == 8
    assert doc["num_hidden_layers"] == cfg.n_layers and doc["vocab_size"] == cfg.vocab
    assert (doc["hidden_size"], doc["moe_intermediate_size"], doc["intermediate_size"]) == (
        cfg.d_model, cfg.moe_ff, cfg.d_ff)
    assert (doc["qk_nope_head_dim"], doc["qk_rope_head_dim"], doc["v_head_dim"],
            doc["kv_lora_rank"]) == (cfg.qk_nope, cfg.qk_rope, cfg.v_head, cfg.kv_lora)
    assert (doc["num_experts_per_tok"], doc["routed_scaling_factor"]) == (cfg.top_k,
                                                                          cfg.routed_scale)
    assert moe_flops.matmul_params(doc["port"]) == 577_110_016
    assert moe_flops.round_flops(doc["port"], 32768, 8192) == pytest.approx(167.07e12, rel=1e-4)
    assert mla_flash.bounds((4, 512, 4, 128, 128)) == flash.bounds((4, 512, 4, 128))


def test_expert_launch_work_counts_each_product():
    sys.path.insert(0, str(ROOT))
    from benchmark.work import moe_flops

    n, d, f, G = 1000, 64, 32, 4
    work = moe_flops.expert_launches(n, d, f, G)
    layer_flops = sum(work[k][1] for k in moe_flops.FWD + moe_flops.BWD)
    assert layer_flops == 24 * n * d * f  # forward 6, its recompute 6, the gradients 12
    assert work["gu"][2] == 2 * (n * d + G * d * 2 * f + n * 2 * f)


def test_experts_roofline_reads_the_product_launches(monkeypatch):
    """On a synthetic trace: a forward span with two grouped products and a
    backward span with six, each after a ``prepare_grouped_gemm_data``."""
    sys.path.insert(0, str(ROOT))
    from benchmark import harness as H
    from benchmark.trace import TraceData
    from benchmark.work import moe_flops

    reader = H.load_module(ROOT / "benchmark" / "metrics" / "experts_roofline.moonlight.py",
                           "experts_roofline_probe")
    monkeypatch.setattr(moe, "moe_counts", lambda: {"calls": 1, "held_assignments": 2048,
                                                    "max_load": 300})
    host = [(1, "pgt.moe.experts.fwd", 0, 100), (2, "pgt.moe.experts.bwd", 200, 400)]
    device, t = [], 1000
    launches = [(1, 10 + 10 * i) for i in range(4)] + [(2, 210 + 10 * i) for i in range(12)]
    for j, (thread, at) in enumerate(launches):
        host.append((thread, "cudaLaunchKernel", at, at + 1))
        name = "prepare_grouped_gemm_data" if j % 2 == 0 else "cutlass_grouped_kernel"
        device.append((name, t, t + (1 if j % 2 == 0 else 100)))
        t += 200
    trace = TraceData(window=(0, 10**6), device_ops=device, host_ops=host)
    cfg = {"d_model": 64, "moe_ff": 32, "experts_held": [0, 4]}
    got = reader.read({"trace": trace, "config": {"port": cfg}})
    work = moe_flops.expert_launches(2048, 64, 32, 4)
    bound = sum(work[k][0] for k in moe_flops.FWD + moe_flops.BWD)
    assert got == pytest.approx(100.0 * bound / (8 * 100e-6))


#: one round on the host (µs from its start): spans, and the launches
#: ``(thread, time, device kernel)`` made inside them
ROUND_SPANS = [(1, "bench.round", 0, 900), (1, "pgt.round", 0, 890),
               (1, "pgt.round.forward", 0, 400), (1, "pgt.mla", 10, 100),
               (1, "pgt.moe.experts.fwd", 200, 300), (1, "pgt.round.backward", 400, 800),
               (2, "pgt.moe.experts.bwd", 500, 700), (1, "pgt.round.update", 800, 890)]
ROUND_LAUNCHES = [(1, 20, "flash_fwd"), (1, 210, "prepare_grouped_gemm_data"),
                  (1, 220, "grouped_gemm"), (2, 510, "prepare_grouped_gemm_data"),
                  (2, 520, "grouped_gemm"), (2, 600, "elementwise"), (1, 850, "mul")]
SPAN_READERS = {"experts_ms": ("pgt.moe.experts.fwd", "pgt.moe.experts.bwd"),
                "mla_ms": ("pgt.mla",), "fwd_ms": ("pgt.round.forward",),
                "bwd_ms": ("pgt.round.backward",), "update_ms": ("pgt.round.update",),
                "experts_roofline": None}


def _rounds_trace(rounds: int, lost: int = 0):
    """A reduced trace of ``rounds`` rounds back to back, each op run long
    after its launch and lasting its own time; the window's last ``lost``
    ops are missing, as when the card's clock puts them past its end."""
    from benchmark.trace import TraceData

    host, device, run = [], [], 50_000
    for r in range(rounds):
        t0 = 1_000 * r
        host += [(th, name, t0 + s, t0 + e) for th, name, s, e in ROUND_SPANS]
        for i, (th, at, kernel) in enumerate(ROUND_LAUNCHES):
            host.append((th, "cudaLaunchKernel", t0 + at, t0 + at + 1))
            run += 10 + 3 * i + 7 * r
            device.append((kernel, run, run + 2 + i + 5 * r))
    return TraceData(window=(0, 10**6), device_ops=device[:len(device) - lost], host_ops=host)


@pytest.mark.parametrize("metric", sorted(SPAN_READERS))
@pytest.mark.parametrize("lost", [0, 2])
def test_span_metrics_read_the_whole_rounds_of_a_clipped_window(monkeypatch, metric, lost):
    """Three rounds whose last ops the window lost read as the two rounds
    that came whole; a window that lost nothing reads as ``spans.py`` does."""
    sys.path.insert(0, str(ROOT))
    from benchmark import harness as H
    from benchmark import spans as S

    monkeypatch.setattr(moe, "moe_counts", lambda: {"calls": 1, "held_assignments": 2048,
                                                    "max_load": 300})
    reader = H.load_module(ROOT / "benchmark" / "metrics" / f"{metric}.moonlight.py",
                           f"{metric}_rounds_probe")

    def ctx(trace, units):
        return {"trace": trace, "units": units,
                "config": {"port": {"d_model": 64, "moe_ff": 32, "experts_held": [0, 4]}}}

    got = reader.read(ctx(_rounds_trace(3, lost), 3))
    assert got is not None and got > 0
    if lost:
        assert got == pytest.approx(reader.read(ctx(_rounds_trace(2), 2)))
        assert S.launched_ops(_rounds_trace(3, lost)) is None
    elif SPAN_READERS[metric]:
        assert got == pytest.approx(S.ms_per_unit(ctx(_rounds_trace(3), 3),
                                                  *SPAN_READERS[metric]))
    else:
        from benchmark.work.moe_flops import expert_launches

        work = expert_launches(2048, 64, 32, 4)
        bound = sum(work[k][0] for k in ("gu", "down", "gu", "gu", "down", "d_a"))
        busy = sum((4 + 5 * r) + (6 + 5 * r) for r in range(3)) * 1e-6
        assert got == pytest.approx(100.0 * bound / busy)


def test_round_pairing_refuses_a_window_it_cannot_pair():
    """More ops than launches, or a copy where a kernel was launched: nothing."""
    sys.path.insert(0, str(ROOT))
    from benchmark.round_spans import paired_ops
    from benchmark.trace import TraceData

    t = _rounds_trace(2)
    assert paired_ops(t)[1] == 2
    extra = TraceData(window=t.window, device_ops=t.device_ops + [("k", 10**5, 10**5 + 1)],
                      host_ops=t.host_ops)
    assert paired_ops(extra) is None
    copy = TraceData(window=t.window, host_ops=t.host_ops,
                     device_ops=[("Memcpy DtoD", *t.device_ops[0][1:])] + t.device_ops[1:])
    assert paired_ops(copy) is None
    assert paired_ops(_rounds_trace(1, lost=1)) is None


TINY ={"name": "tiny-moon", "source": "test", "family": "deepseek_v3",
        "initializer_range": 0.02, "port": PORT}
TINY_SPEC = {"entry": "fedavg_round", "local_steps": 1, "lr": 0.1, "compute_dtype": "bfloat16",
             "ce_grad_dtype": "bfloat16", "trace_units": 2,
             "limits": {"loss_gap": 1e-3, "grad_gap": 0.05, "change_gap": 0.05}}


@pytest.fixture(scope="module")
def moon_tree(tmp_path_factory):
    """A throwaway checkout with a tiny DeepSeek-V3 cell beside the
    benchmark's code (``benchmark/tests/tiny.py``)."""
    sys.path.insert(0, str(ROOT))
    from benchmark.tests.tiny import make_tree

    dest = make_tree(tmp_path_factory.mktemp("moon_tree"), cells=("tiny-gpt-fedavg",))
    bench = dest / "benchmark"
    (bench / "configs" / "tiny-moon.json").write_text(json.dumps(TINY))
    (bench / "traffic" / "tiny-moon-tokens.json").write_text(
        json.dumps({"kind": "tokens", "clients": 4, "batch": 1, "seq_len": L}))
    (bench / "workloads" / "tiny-moon-fedavg.json").write_text(json.dumps(TINY_SPEC))
    doc = json.loads((dest / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny-moon", "source": "test",
                           "file": "benchmark/configs/tiny-moon.json", "reduced": [], "why": "t"})
    doc["workloads"] = [{"name": "tiny-moon-fedavg", "config": "tiny-moon",
                         "traffic": "tiny-moon-tokens", "chips": 1, "why": "a CPU test"}]
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["end_to_end"] = [dict(m, workloads=["tiny-moon-fedavg"]) if "workloads" in m else m
                         for m in real["end_to_end"] if m["name"] in ("train_tokens_per_s",
                                                                      "setup_s")]
    doc["per_layer"] = [dict(m, workloads=["tiny-moon-fedavg"]) for m in real["per_layer"]
                        if m["name"].endswith(".moonlight")]
    (dest / "BENCHMARK.json").write_text(json.dumps(doc))
    return dest


SHARED_FAULT = '''
import pygrid_tpu_torch.models.deepseek_v3 as M
_real = M._swiglu
def _no_shared(x, w_gu, w_down):
    out = _real(x, w_gu, w_down)
    return out * 0 if w_down.shape[0] == {width} else out
M._swiglu = _no_shared
'''


def _run(tree, tmp=None, patch=None, trace=0):
    import os

    env = dict(os.environ)
    if patch is not None:
        (tmp / "sitecustomize.py").write_text(patch)
        env["PYTHONPATH"] = os.pathsep.join([str(tmp), str(ROOT)])
    r = subprocess.run([sys.executable, str(tree / "benchmark" / "run.py"), "--workload",
                        "tiny-moon-fedavg", "--seed", "3000000019", "--seconds", "0.3",
                        "--trace", str(trace), "--device", "cpu"],
                       capture_output=True, text=True, env=env, timeout=600)
    last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    return r.returncode, (json.loads(last) if last.startswith("{") else None), r.stderr


def test_the_cell_runs_its_rounds_through_the_benchmark_and_agrees(moon_tree):
    rc, res, err = _run(moon_tree)
    assert rc == 0 and res is not None, err[-3000:]
    assert res["correct"] is True and res["attempted"] >= 1, err[-2000:]
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_the_cell_without_its_shared_experts_is_not_correct(moon_tree, tmp_path):
    patch = SHARED_FAULT.format(width=CFG.n_shared * CFG.moe_ff)
    rc, res, err = _run(moon_tree, tmp_path, patch)
    assert rc == 0 and res is not None, err[-3000:]
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
def test_the_round_makes_no_host_sync_on_the_card():
    """On the card: a round of the tiny model in bf16 through the flash
    kernels runs with CUDA's sync debug mode set to error."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pygrid_tpu_torch.parallel import flash_attention as fa

    params, X, y = _setup(5)
    params = [p.cuda() for p in params]
    round_fn = make_fused_round(partial(dv.loss_and_acc, cfg=CFG, attn_fn=fa.flash_attention,
                                        compute_dtype="bfloat16", ce_grad_dtype="bfloat16"))
    Xc, yc = X[:, None].cuda(), y[:, None].cuda()
    round_fn(params, Xc, yc, 0.1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, loss, _ = round_fn(params, Xc, yc, 0.1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(loss.cpu())
