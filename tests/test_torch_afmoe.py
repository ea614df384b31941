"""The port's AFMoE decoder (``models/afmoe.py``, Trinity-Mini's block)
against the plain float32 reference (``benchmark/reference/afmoe.py``), at a
tiny size on the CPU: d 64, 4 query heads and 2 K/V heads of 16, a window of
8 keys, layers sliding, sliding, sliding, full, 16 routed experts of which 4
are held, top-4, 1 shared, one dense and three expert layers, vocab 96,
sequences of 32 (so the window removes most of a sliding layer's pairs).

Tolerances. f32: the two sides make the same products in another order
(grouped attention against K/V indexed out to every head, the grouped
expert products, the experts' sums), so logits are held at 1e-5 of their
largest, the loss at 1e-6 relative, each gradient leaf at 1e-4 of its
largest entry, one round's params at 1e-4 relative. bf16: every product
rounds its operands to 8 bits of mantissa (relative 4e-3), so the loss is
held at 5e-4 relative (2.3e-4 the largest of 8 seeds). A leaf's gradient is
held by the benchmark's measure, the norm of its error over the larger of
its own norm and the median leaf's: QK-norm's backward takes q's and k's
bf16 gradients through RMSNorm, which keeps only their part across the
normed vector, so W_q and W_k lose most of their relative precision there
(0.091 the largest of 8 seeds), held at 0.15; the expert layers' routing side
(their pre-MLP norm, router and routed experts) at 0.5 (0.41 the largest),
because at this size a rounding moves a few of 96 tokens across the top-4
boundary, and a token moved takes 1/24 of an expert's rows with it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from functools import partial
from pathlib import Path

import pytest
import torch

from pygrid_tpu_torch.models import afmoe as af
from pygrid_tpu_torch.models import moe
from pygrid_tpu_torch.parallel import flash_attention as fa
from pygrid_tpu_torch.parallel import make_fused_round
from benchmark.reference import afmoe as ra

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CFG = af.AfmoeConfig()
PORT = {k: ([v.start, v.stop] if isinstance(v, range) else list(v) if isinstance(v, tuple)
            else v) for k, v in CFG._asdict().items()}
B, L = 3, 32
SHAPES = af.param_shapes(CFG)


def _setup(seed=0):
    params = af.init(CFG, generator=torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(1000 + seed)
    X = torch.randint(0, CFG.vocab, (B, L), generator=g)
    return params, X, torch.roll(X, -1, 1)


def _grads(params, X, y, **kw):
    leaves = [p.clone().requires_grad_() for p in params]
    loss, _ = af.loss_and_acc(leaves, X, y, CFG, **kw)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def _routing_side() -> set:
    """Leaves whose gradient moves with the expert layers' choice of
    experts: each expert layer's pre-MLP norm, router and routed experts."""
    out, i = set(), 1
    for layer in range(CFG.n_layers):
        if layer < CFG.n_dense:
            i += af.DENSE_PARAMS
            continue
        out |= {i + 9, i + 11, i + 14, i + 15}
        i += af.MOE_PARAMS
    return out


def test_param_layout_and_count():
    params = af.init(CFG, device="cpu")
    assert [tuple(p.shape) for p in params] == SHAPES
    assert len(params) == 1 + af.DENSE_PARAMS + 3 * af.MOE_PARAMS + 2
    assert af.init_bias(CFG, "cpu").shape == (3, 16)


@pytest.mark.parametrize("biased", [False, True])
def test_f32_logits_loss_and_every_gradient_equal_the_reference(biased):
    """With the routers' bias at 0 and at a draw that changes the choice."""
    params, X, y = _setup()
    bias = (torch.randn(3, CFG.n_experts, generator=torch.Generator().manual_seed(3)) * 0.1
            if biased else None)
    got = af.apply(params, X, CFG, bias=bias)
    want = ra.logits(params, X, PORT, q_block=8, bias=bias)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    loss, grads = _grads(params, X, y, bias=bias)
    ref_loss, ref_grads = ra.loss_and_grad(params, X, y, PORT, block_rows=2, q_block=8,
                                           bias=bias)
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    for i, (a, b) in enumerate(zip(grads, ref_grads)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-12, (i, SHAPES[i])


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_path_within_its_tolerance(seed):
    params, X, y = _setup(seed)
    loss, grads = _grads(params, X, y, compute_dtype="bfloat16", ce_grad_dtype="bfloat16")
    ref_loss, ref_grads = ra.loss_and_grad(params, X, y, PORT, block_rows=3, q_block=32)
    assert loss == pytest.approx(ref_loss, rel=5e-4)
    routing = _routing_side()
    median = statistics.median(float(b.norm()) for b in ref_grads)
    for i, (a, b) in enumerate(zip(grads, ref_grads)):
        err = float((a - b).norm()) / max(float(b.norm()), median)
        assert err <= (0.5 if i in routing else 0.15), (i, SHAPES[i], err)


@pytest.mark.parametrize("fault", ["window dropped", "RoPE on the full layers",
                                   "RoPE on no layer"])
def test_each_layer_kind_matters(monkeypatch, fault):
    """The reference's logits tell the sliding layers' window and RoPE and
    the full layers' NoPE apart: each fault moves them far past the f32
    tolerance."""
    params, X, _ = _setup(2)
    want = ra.logits(params, X, PORT, q_block=8)
    plan = {"window dropped": lambda cfg, kind: (kind == af.SLIDING, None),
            "RoPE on the full layers": lambda cfg, kind: (
                True, cfg.sliding_window if kind == af.SLIDING else None),
            "RoPE on no layer": lambda cfg, kind: (
                False, cfg.sliding_window if kind == af.SLIDING else None)}[fault]
    monkeypatch.setattr(af, "layer_attention", plan)
    got = af.apply(params, X, CFG)
    assert float((got - want).abs().max()) > 1e-2 * float(want.abs().max())


def test_an_attention_without_a_window_is_refused():
    from pygrid_tpu_torch.parallel.ring_attention import attention

    params, X, _ = _setup()
    with pytest.raises(ValueError, match="takes no window"):
        af.apply(params, X, CFG, attn_fn=attention)


@pytest.mark.parametrize("p", [0, 1, 7, 31])
def test_rope_at_a_position_is_the_rotate_half_rotation_written_out(p):
    dim = CFG.head_dim
    x = torch.randn(1, p + 1, 2, dim, generator=torch.Generator().manual_seed(p))
    cos, sin = af.rope_tables(p + 1, dim, CFG.rope_theta, "cpu")
    got = af.rope_half(x, cos, sin)[0, p].double()
    xp = x[0, p].double()
    for i in range(dim // 2):
        ang = torch.tensor(p * CFG.rope_theta ** (-2 * i / dim), dtype=torch.float64)
        a, b = xp[:, i], xp[:, dim // 2 + i]
        torch.testing.assert_close(got[:, i], a * ang.cos() - b * ang.sin(), rtol=0, atol=1e-5)
        torch.testing.assert_close(got[:, dim // 2 + i], b * ang.cos() + a * ang.sin(),
                                   rtol=0, atol=1e-5)
    torch.testing.assert_close(af.rope_half(x, cos, sin), ra.rope(x, CFG.rope_theta),
                               rtol=0, atol=1e-6)


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


def test_sixteen_shares_add_up_to_the_uncut_layer():
    """The deployment's 16 disjoint shares, here of one expert each, with
    the shared expert counted once, give the reference's layer over all 16
    experts: what each card computes of the routed experts adds up."""
    x, wg, s_gu, s_down, e_gu, e_down = _moe_layer_inputs()
    bias = torch.zeros(CFG.n_experts)
    parts = sum(moe.topk_expert_layer(x, x, wg, bias, e_gu[i:i + 1], e_down[i:i + 1],
                                      range(i, i + 1), CFG.top_k, CFG.routed_scale)
                for i in range(16))
    shared = af.swiglu_mlp(x, s_gu, s_down)
    whole = ra.routed_and_shared(x, (wg, s_gu, s_down, e_gu, e_down), bias,
                                 dict(PORT, experts_held=[0, 16]), torch.matmul)
    torch.testing.assert_close(parts + shared, whole, rtol=1e-5, atol=1e-5)


def _profiled_round(params, X, y, remat):
    from torch.profiler import ProfilerActivity, profile

    round_fn = make_fused_round(partial(af.loss_and_acc, cfg=CFG, remat=remat))
    fa.reset_launch_counts()
    moe.reset_moe_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        round_fn(params, X[:, None], y[:, None], 0.1)
    names = [e.name for e in prof.events()]
    return {n: names.count(n) for n in ("pgt.attn.sliding", "pgt.attn.full",
                                         "pgt.moe.experts.fwd", "pgt.moe.experts.bwd")}


@pytest.mark.parametrize("remat", [False, True])
def test_counters_and_spans_read_one_round_and_not_its_recompute(remat):
    """With or without each block's recompute in the backward, a round opens
    each attention span once a layer of its kind, and the flash wrapper's
    tile-pair counters count each layer's forward once: three sliding
    layers' band pairs and one full layer's causal pairs a (b, h) slice.
    The held experts' forward span is the layer's work wherever it runs, so
    a recompute opens it again."""
    params, X, y = _setup(3)
    spans = _profiled_round(params, X, y, remat)
    assert spans == {"pgt.attn.sliding": 3, "pgt.attn.full": 1,
                     "pgt.moe.experts.fwd": 3 * (1 + remat), "pgt.moe.experts.bwd": 3}
    visited, causal = fa.tile_pairs(L, CFG.sliding_window)
    band = fa.band_counts()
    assert band["tile_pairs"] == B * CFG.n_heads * (3 * visited + causal)
    assert band["causal_tile_pairs"] == B * CFG.n_heads * 4 * causal
    assert moe.moe_counts()["calls"] == 3
    fa.reset_launch_counts()


def test_one_fused_round_equals_the_references_round_and_the_training_step():
    params, X, y = _setup(4)
    round_fn = make_fused_round(partial(af.loss_and_acc, cfg=CFG))
    new, loss, _ = round_fn(params, X[:, None], y[:, None], 0.1)
    states, losses = ra.fedavg_rounds(params, [(X[:, None], y[:, None])], 0.1, PORT,
                                      block_rows=2, q_block=16)
    assert float(loss) == pytest.approx(losses[0], rel=1e-6)
    for a, b in zip(new, states[0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
    step_loss, _, *stepped = af.make_training_step(CFG)(X, y, 0.1, *params)
    assert float(step_loss) == pytest.approx(float(loss), rel=1e-6)
    for a, b in zip(stepped, new):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-8)


def test_the_cut_configuration_holds_what_the_card_runs():
    sys.path.insert(0, str(ROOT))
    from benchmark.work import afmoe_flops, flash, window_flash

    doc = json.loads((ROOT / "benchmark" / "configs" / "trinity-mini-ep16.json").read_text())
    cfg = af.config_from_dict(doc["port"])
    shapes = af.param_shapes(cfg)
    assert sum(torch.Size(s).numel() for s in shapes) == doc["parameters"] == 1_074_107_392
    assert doc["num_experts"] == len(cfg.experts_held) == 8 and cfg.n_experts == 128
    assert doc["num_hidden_layers"] == cfg.n_layers == 12 and doc["vocab_size"] == cfg.vocab
    assert cfg.layer_types == tuple(doc["layer_types"][:12])
    assert cfg.layer_types.count(af.SLIDING) == 9
    assert (doc["hidden_size"], doc["moe_intermediate_size"], doc["intermediate_size"]) == (
        cfg.d_model, cfg.moe_ff, cfg.d_ff)
    assert (doc["num_attention_heads"], doc["num_key_value_heads"], doc["head_dim"]) == (
        cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    assert (doc["num_experts_per_tok"], doc["route_scale"], doc["sliding_window"]) == (
        cfg.top_k, cfg.routed_scale, cfg.sliding_window)
    assert (doc["num_dense_layers"], doc["num_shared_experts"]) == (cfg.n_dense, cfg.n_shared)
    assert (doc["rms_norm_eps"], doc["rope_theta"], doc["mup_enabled"]) == (
        cfg.rms_eps, cfg.rope_theta, cfg.mup)
    # an attention sublayer (its input and output norms too), a dense layer,
    # an expert layer and its 8 experts
    assert sum(torch.Size(s).numel() for s in shapes[1:1 + 9]) == 27_267_328
    dense = sum(torch.Size(s).numel() for s in shapes[1:1 + af.DENSE_PARAMS])
    assert dense == 65_020_160
    at = 1 + 2 * af.DENSE_PARAMS
    assert sum(torch.Size(s).numel() for s in shapes[at:at + af.MOE_PARAMS]) == 84_156_672
    assert sum(torch.Size(s).numel() for s in shapes[at + 14:at + 16]) == 50_331_648
    assert afmoe_flops.matmul_params(doc["port"]) == 550_895_616
    assert afmoe_flops.attention_pairs(doc["port"], 8192) == 9 * 14_681_088 + 3 * 33_558_528
    assert afmoe_flops.round_flops(doc["port"], 32768, 8192) == pytest.approx(154.08e12,
                                                                              rel=1e-4)
    assert window_flash.bounds((4, 512, 4, 4, 128), None) == flash.bounds((4, 512, 4, 128))
    assert afmoe_flops.band_pairs(8192, 2048) / afmoe_flops.band_pairs(8192, None) < 0.44


def _band_trace(rounds: int, kinds):
    """A reduced trace of ``rounds`` rounds whose flash kernels each run 1 ms
    a launch, one launch of each a layer."""
    from benchmark.trace import TraceData

    device, t = [], 0
    for _ in range(rounds):
        for name in ("flash_fwd_tc_kernel<128,1>", "flash_bwd_dkv_tc_kernel<128,1>",
                     "flash_bwd_dq_tc_kernel<128,1>"):
            for _ in kinds:
                device.append((f"void pgt::{name}(...)", t, t + 1000))
                t += 2000
    return TraceData(window=(0, 10**9), device_ops=device, host_ops=[])


def test_flash_roofline_counts_the_bands_pairs():
    """Each launch counts the mean bound over the layers' kinds: 3 of 4 at the
    band's pairs, 1 of 4 causal."""
    sys.path.insert(0, str(ROOT))
    from benchmark import harness as H
    from benchmark.work.window_flash import bounds

    reader = H.load_module(ROOT / "benchmark" / "metrics" / "flash_roofline.trinity.py",
                           "flash_roofline_trinity_probe")
    port = dict(PORT, n_heads=32, n_kv_heads=4, head_dim=128, sliding_window=2048)
    ctx = {"trace": _band_trace(2, port["layer_types"]), "chips": 1,
           "traffic": {"clients": 4, "batch": 1, "seq_len": 8192},
           "config": {"port": port}, "spec": {"compute_dtype": "bfloat16"}}
    shape = (4, 8192, 32, 4, 128)
    sw, full = bounds(shape, 2048), bounds(shape, None)
    per_round = sum(3 * sw[k][0] + full[k][0] for k in sw)  # ms a round
    got = reader.read(ctx)
    assert got == pytest.approx(100.0 * 2 * per_round / (2 * 12 * 1.0))
    assert reader.read(dict(ctx, trace=None)) is None


@pytest.mark.parametrize("metric,spans", [("swa_ms", ("pgt.attn.sliding",)),
                                          ("full_attn_ms", ("pgt.attn.full",)),
                                          ("experts_ms", ("pgt.moe.experts.fwd",
                                                          "pgt.moe.experts.bwd"))])
def test_span_metrics_read_their_spans(metric, spans):
    """Two rounds, each with a sliding and a full sublayer and the expert
    spans, each launching one 1 ms kernel: a metric reads its spans' ms a
    round."""
    sys.path.insert(0, str(ROOT))
    from benchmark import harness as H
    from benchmark.trace import TraceData

    reader = H.load_module(ROOT / "benchmark" / "metrics" / f"{metric}.trinity.py",
                           f"{metric}_trinity_probe")
    host, device, run = [], [], 10_000
    names = ("pgt.attn.sliding", "pgt.attn.full", "pgt.moe.experts.fwd", "pgt.moe.experts.bwd")
    for r in range(2):
        t0 = 1_000 * r
        host.append((1, "bench.round", t0, t0 + 900))
        for i, name in enumerate(names):
            host.append((1, name, t0 + 100 * i, t0 + 100 * i + 50))
            host.append((1, "cudaLaunchKernel", t0 + 100 * i + 10, t0 + 100 * i + 11))
            device.append((f"k{i}", run, run + 1000))
            run += 2000
    got = reader.read({"trace": TraceData(window=(0, 10**6), device_ops=device, host_ops=host)})
    assert got == pytest.approx(1.0 * len(spans))
    assert reader.read({"trace": None}) is None


TINY = {"name": "tiny-trinity", "source": "test", "family": "afmoe",
        "initializer_range": 0.02, "port": PORT}
TINY_SPEC = {"entry": "fedavg_round", "local_steps": 1, "lr": 0.1, "compute_dtype": "bfloat16",
             "ce_grad_dtype": "bfloat16", "trace_units": 2,
             "limits": {"grad_gap": 0.05, "change_gap": 0.05}}


@pytest.fixture(scope="module")
def trinity_tree(tmp_path_factory):
    """A throwaway checkout with a tiny AFMoE cell beside the benchmark's
    code (``benchmark/tests/tiny.py``)."""
    sys.path.insert(0, str(ROOT))
    from benchmark.tests.tiny import make_tree

    dest = make_tree(tmp_path_factory.mktemp("trinity_tree"), cells=("tiny-gpt-fedavg",))
    bench = dest / "benchmark"
    (bench / "configs" / "tiny-trinity.json").write_text(json.dumps(TINY))
    (bench / "traffic" / "tiny-trinity-tokens.json").write_text(
        json.dumps({"kind": "tokens", "clients": 4, "batch": 1, "seq_len": L}))
    (bench / "workloads" / "tiny-trinity-fedavg.json").write_text(json.dumps(TINY_SPEC))
    doc = json.loads((dest / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny-trinity", "source": "test",
                           "file": "benchmark/configs/tiny-trinity.json", "reduced": [],
                           "why": "t"})
    doc["workloads"] = [{"name": "tiny-trinity-fedavg", "config": "tiny-trinity",
                         "traffic": "tiny-trinity-tokens", "chips": 1, "why": "a CPU test"}]
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["end_to_end"] = [dict(m, workloads=["tiny-trinity-fedavg"]) if "workloads" in m else m
                         for m in real["end_to_end"] if m["name"] in ("train_tokens_per_s",
                                                                      "setup_s")]
    doc["per_layer"] = [dict(m, workloads=["tiny-trinity-fedavg"]) for m in real["per_layer"]
                        if m["name"].endswith(".trinity")]
    (dest / "BENCHMARK.json").write_text(json.dumps(doc))
    return dest


LAYER_FAULT = '''
import pygrid_tpu_torch.models.afmoe as M
M.layer_attention = lambda cfg, kind: {plan}
'''
FAULTS = {
    "window dropped": "(kind == M.SLIDING, None)",
    "RoPE on the full layers": "(True, cfg.sliding_window if kind == M.SLIDING else None)",
}


def _run(tree, tmp=None, patch=None, trace=0):
    import os

    env = dict(os.environ)
    if patch is not None:
        (tmp / "sitecustomize.py").write_text(patch)
        env["PYTHONPATH"] = os.pathsep.join([str(tmp), str(ROOT)])
    r = subprocess.run([sys.executable, str(tree / "benchmark" / "run.py"), "--workload",
                        "tiny-trinity-fedavg", "--seed", "3000000019", "--seconds", "0.3",
                        "--trace", str(trace), "--device", "cpu"],
                       capture_output=True, text=True, env=env, timeout=600)
    last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    return r.returncode, (json.loads(last) if last.startswith("{") else None), r.stderr


def test_the_cell_runs_its_rounds_through_the_benchmark_and_agrees(trinity_tree):
    rc, res, err = _run(trinity_tree)
    assert rc == 0 and res is not None, err[-3000:]
    assert res["correct"] is True and res["attempted"] >= 1, err[-2000:]
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_the_cell_with_a_layer_kind_fault_is_not_correct(trinity_tree, tmp_path, fault):
    rc, res, err = _run(trinity_tree, tmp_path, LAYER_FAULT.format(plan=FAULTS[fault]))
    assert rc == 0 and res is not None, err[-3000:]
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
def test_the_round_makes_no_host_sync_on_the_card():
    """On the card: a round of the tiny model in bf16 through the flash
    kernels' band instantiations runs with CUDA's sync debug mode set to
    error, and launches each kernel once a layer, all grouped, the sliding
    layers' with their window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params, X, y = _setup(5)
    params = [p.cuda() for p in params]
    round_fn = make_fused_round(partial(af.loss_and_acc, cfg=CFG, attn_fn=fa.flash_attention,
                                        compute_dtype="bfloat16", ce_grad_dtype="bfloat16"))
    Xc, yc = X[:, None].cuda(), y[:, None].cuda()
    round_fn(params, Xc, yc, 0.1)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, loss, _ = round_fn(params, Xc, yc, 0.1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(loss.cpu())
    four = dict.fromkeys(fa.launch_counts(), 4)
    assert fa.launch_counts() == four and fa.band_counts()["grouped"] == four
    assert fa.band_counts()["window"] == dict.fromkeys(four, 3)
