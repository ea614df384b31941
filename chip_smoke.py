#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pygrid_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

It takes no arguments and runs every phase, in order; any failure raises
and the script exits non-zero:

1. build    — compile the CUDA kernels from pygrid_tpu_torch/csrc (nvcc,
              sm_90a, one process per source) and print ptxas' report; the
              tensor-core kernels must not spill;
2. kernels  — hold each kernel (flash forward, dK/dV, dQ) against its plain
              PyTorch version on the card: bf16 and f32, causal and not,
              aligned and ragged shapes, and in bf16 the tensor-core
              kernels' tile and layout edges (L around the 64-row tiles,
              D of 40, 64 and 128, a D=36 padded copy, Lq != Lk, q/k/v as
              strided views of one [B, L, 3, H, D] tensor); dK/dV and dQ
              must be bit-identical across two launches;
3. timing   — each kernel's median time at the main path's shape, beside
              its bound (with its multiple of it and its TFLOP/s), its
              plain version and the PyTorch library call (SDPA, timed by
              device time under torch.profiler);
4. rounds   — the main path: fused FedAvg rounds of the federated
              transformer at full width (bench_fed_transformer's config),
              with each kernel's launches counted;
5. small    — one opaque make_round round, one local_steps=2 fused round
              and the MLP FedAvg round, each with its launches counted;
6. parity   — small fused rounds on the card against the same rounds on
              the CPU through the plain versions, in f32 and in the main
              path's bf16 (bf16 compute, bf16 CE backward), and the CE
              head's f32-output bf16 product at the main path's three
              shapes against the f64 product;
7. ring     — the Z_2^64 ring-matmul kernel against its plain version
              (torch.equal: ring arithmetic is exact) and numpy uint64:
              ragged, all-ones (one with K = 20000, past several of the
              kernel's folds of its s32 partials), batched, stride-0 and
              two-batch-axis operands and the SMPC path's two shapes;
8. ring timing — its median time (events and device time) at those two
              shapes, beside its bound, the replaced u64 kernel's time, its
              plain version and torch.matmul on int64 CUDA tensors;
9. smpc     — the SMPC path: batched_beaver at bench_smpc's two
              configurations (B=512 of 3-party 64x64, B=8 of 512x512),
              rounds held to the exact product, 4 ring launches a round;
10. mlp     — the encrypted 784-392-10 MLP (affine, square, affine) at
              batch 256 through fix_prec(...).share(...): decoded against
              the float64 forward, and its shares bit-identical to a CPU
              run given the same shares, triples and truncation pairs.

Then it prints the kernels line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. It imports nothing of JAX
or of pygrid_tpu, and exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# bf16 results are compared at atol 1e-2 + rtol 1e-2: P and dS are rounded
# to bf16 at points that differ between the online-softmax kernel and the
# one-pass plain version, and one bf16 ulp is 2^-8 to 2^-7 relative. On an
# H100 the worst errors seen were 3.9e-3 (forward out), 7.8e-3 (dK/dV, on
# elements of magnitude >= 1, where the bound is >= 2e-2) and 3.9e-3 (dQ on
# the tensor cores; 2.0e-3 on the CUDA cores), all at the main path's shape. f32 at atol 1e-4 + rtol 1e-4 (f32 sums over
# up to 512 terms in another order; worst seen 9.5e-7).
TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-4)}

# the main path's attention shape: bench_fed_transformer's config, K=8
# clients x B=4 sequences folded into 32 rows, L=512, 4 heads of 128
MAIN_SHAPE = (32, 512, 4, 128)

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, f32 CUDA-core
# rate, HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12


# dynamic shared memory of the tensor-core kernels, as their launchers size
# it. The bf16 flash kernels at padded head dim dp: bf16 tiles of pitch
# dp + 8 (forward: 64 rows of Q and two buffers each of 64 rows of K and V;
# dK/dV: 64 rows each of K and V and two buffers each of 32 rows of Q and
# dO, plus two buffers of 32 f32 lse and Delta; dQ: 64 rows each of Q and dO
# and two buffers each of 64 rows of K and V). The ring matmul, one size:
# two buffers of a staged K slice, 128 rows (A's 64, B's 64) of 34 u64, and
# two of its eight u8 limb planes of 128 rows x 48 bytes.
TC_SMEM = {
    "flash_fwd": lambda dp: 2 * (64 + 4 * 64) * (dp + 8),
    "flash_bwd_dkv": lambda dp: 2 * (2 * 64 + 4 * 32) * (dp + 8) + 4 * 4 * 32,
    "flash_bwd_dq": lambda dp: 2 * (2 * 64 + 4 * 64) * (dp + 8),
    "ring_matmul": 2 * 8 * 128 * 34 + 2 * 8 * 128 * 48,
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 1: build
# --------------------------------------------------------------------------


def phase_build() -> None:
    from pygrid_tpu_torch.kernels import build

    t0 = time.perf_counter()
    per_lib = build.build_all()
    total = time.perf_counter() - t0
    print(f"[build] {total:.2f} s wall; per source: "
          + ", ".join(f"{n} {s:.2f} s" for n, s in per_lib.items()))
    for name in build.LIBRARIES:
        build.library(name)
        entry = None
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {name}: {line.strip()}")
            if "Compiling entry" in line:
                entry = line
            elif "spill stores" in line and entry is not None and "_tc_kernel" in entry:
                check(line.split()[4] == "0" and line.split()[8] == "0",
                      f"a tensor-core kernel spills registers: {entry.strip()}: {line.strip()}")
    for name, smem in TC_SMEM.items():
        sizes = (", ".join(f"D<={dp} {smem(dp)} B" for dp in (48, 64, 128)) if callable(smem)
                 else f"{smem} B")
        print(f"[build] {name} tensor-core kernel, dynamic shared memory a block: {sizes}")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def _inputs(shape_q, Lk, dtype, seed, views=False):
    """q, k, v, dO; with ``views``, q, k and v are the strided slices of one
    [B, L, 3, H, D] tensor, as a fused qkv projection gives them."""
    B, Lq, H, D = shape_q
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    if views:
        qkv = rnd(B, Lq, 3, H, D)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], rnd(B, Lq, H, D)
    return rnd(B, Lq, H, D), rnd(B, Lk, H, D), rnd(B, Lk, H, D), rnd(B, Lq, H, D)


def _err(got, ref, dtype, what):
    atol, rtol = TOL[dtype]
    got, ref = got.float(), ref.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} elements outside atol {atol} rtol {rtol}, "
          f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def _poison() -> None:
    """Leave NaN in the allocator's free blocks, so an output element a
    kernel fails to write cannot pass by holding an earlier result."""
    torch.full((64 * 2**20,), float("nan"), device="cuda")
    torch.cuda.synchronize()


def compare_case(shape_q, Lk, dtype, causal, seed=0, views=False):
    """Each kernel against its plain version on the same inputs; returns
    the max abs error of each. The dK/dV and dQ kernels run twice and must
    give the same bits (they write each tile once, with no atomics)."""
    from pygrid_tpu_torch.parallel import flash_attention as fa

    q, k, v, do = _inputs(shape_q, Lk, dtype, seed, views)
    scale = shape_q[-1] ** -0.5
    out_r, lse_r = fa.flash_fwd_reference(q, k, v, causal, scale)
    _poison()
    out_k, lse_k = fa.flash_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    tag = (f"{tuple(shape_q)} Lk={Lk} {str(dtype)[6:]} causal={causal}"
           + (" qkv views" if views else ""))
    errs = {
        "flash_fwd": max(
            _err(out_k, out_r, dtype, f"fwd out {tag}"),
            _err(lse_k, lse_r, torch.float32, f"fwd lse {tag}"),
        )
    }
    delta = fa.softmax_delta(out_r, do)
    dk_r, dv_r = fa.flash_bwd_dkv_reference(q, k, v, do, lse_r, delta, causal, scale)
    _poison()
    dk_k, dv_k = fa.flash_bwd_dkv(q, k, v, do, lse_r, delta, causal, scale)
    _poison()
    dk_2, dv_2 = fa.flash_bwd_dkv(q, k, v, do, lse_r, delta, causal, scale)
    torch.cuda.synchronize()
    check(torch.equal(dk_k, dk_2) and torch.equal(dv_k, dv_2),
          f"dk/dv {tag}: two launches on the same inputs gave different bits")
    errs["flash_bwd_dkv"] = max(
        _err(dk_k, dk_r, dtype, f"dk {tag}"), _err(dv_k, dv_r, dtype, f"dv {tag}")
    )
    dq_r = fa.flash_bwd_dq_reference(q, k, v, do, lse_r, delta, causal, scale)
    _poison()
    dq_k = fa.flash_bwd_dq(q, k, v, do, lse_r, delta, causal, scale)
    _poison()
    dq_2 = fa.flash_bwd_dq(q, k, v, do, lse_r, delta, causal, scale)
    torch.cuda.synchronize()
    check(torch.equal(dq_k, dq_2), f"dq {tag}: two launches on the same inputs gave different bits")
    errs["flash_bwd_dq"] = _err(dq_k, dq_r, dtype, f"dq {tag}")
    print(f"[kernels] {tag}: " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))
    return errs


def phase_kernels() -> dict:
    cases = [
        ((2, 512, 4, 128), 512, True),
        ((2, 512, 4, 128), 512, False),
        ((2, 200, 3, 64), 200, True),
        ((1, 100, 2, 64), 300, False),
        ((1, 77, 2, 40), 77, True),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for shape_q, Lk, causal in cases:
            compare_case(shape_q, Lk, dtype, causal)
    # the bf16 tensor-core kernels' edges: L on both sides of the 64-row
    # tiles at each padded head dim they are built for (48, 64, 128), a
    # D=36 that takes the wrapper's zero-padded copy, Lq != Lk, and q/k/v
    # as strided views of one [B, L, 3, H, D] tensor (strides of 3·H·D)
    for L in (64, 65, 127, 128, 129):
        for D in (40, 64, 128):
            compare_case((2, L, 2, D), L, torch.bfloat16, True, seed=L + D)
        compare_case((1, L, 3, 128), L, torch.bfloat16, False, seed=L)
    for shape_q, Lk, causal, views in (
        ((2, 129, 2, 36), 129, True, False),
        ((1, 65, 2, 36), 127, False, False),
        ((2, 65, 2, 128), 129, False, False),
        ((1, 129, 2, 40), 64, False, False),
        ((2, 127, 2, 64), 127, True, True),
        ((1, 129, 4, 128), 129, False, True),
        ((2, 65, 2, 36), 65, True, True),
    ):
        compare_case(shape_q, Lk, torch.bfloat16, causal, views=views)
    # the main path's own shape and dtype: these errors go into the JSON line
    return compare_case(MAIN_SHAPE, MAIN_SHAPE[1], torch.bfloat16, True, seed=1)


# --------------------------------------------------------------------------
# phase 3: timing
# --------------------------------------------------------------------------


def time_ms(fn, iters=20, repeats=5) -> float:
    """Median over ``repeats`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def device_ms(fn, calls=5) -> float:
    """Median over ``calls`` of the device time of one call of ``fn``: the
    self device time torch.profiler reports, summed over the CUDA kernels
    the call launched. Unlike events around back-to-back calls, this leaves
    out the time the device waits for the host between kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # a session that reports no device activity at all (seen on an H100 for
    # a session of one short call) is not a sample: it is retried, up to
    # 3 * calls sessions in all, and the empty ones are printed
    fn()
    torch.cuda.synchronize()
    samples, empty = [], 0
    while len(samples) < calls and empty < 2 * calls:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            samples.append(us / 1e3)
        else:
            empty += 1
    check(len(samples) == calls, f"the profiler saw no device time in {empty} sessions")
    if empty:
        print(f"[timing] device_ms: {empty} profiler sessions saw no device time, retried")
    return statistics.median(samples)


def causal_pairs(Lq, Lk, causal):
    return Lq * (Lq + 1) // 2 if causal else Lq * Lk


def bounds(shape, dtype, causal):
    """Least time (ms) of each kernel's work on these inputs: each input
    read once and each output written once over the HBM rate, and the
    products the mask leaves live over the peak rate of the dtype."""
    B, L, H, D = shape
    pairs = B * H * causal_pairs(L, L, causal)
    t = B * L * H * D * torch.tensor([], dtype=dtype).element_size()  # one [B,L,H,D]
    row = B * H * L * 4  # one f32 [B*H, L] vector (lse or delta)
    work = {
        # S = QK^T, O = PV
        "flash_fwd": (4 * D * pairs, 3 * t + t + row),
        # S^T, dP^T, dV = P^T dO, dK = dS^T Q; reads q, dO, k, v, lse, delta
        "flash_bwd_dkv": (8 * D * pairs, 4 * t + 2 * row + 2 * t),
        # S, dP, dQ = dS K
        "flash_bwd_dq": (6 * D * pairs, 4 * t + 2 * row + t),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        tf, tb = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = (max(tf, tb), "operations" if tf > tb else "bytes", flops, nbytes)
    return out


def phase_timing() -> dict:
    import torch.nn.functional as F

    from pygrid_tpu_torch.parallel import flash_attention as fa

    dtype, causal = torch.bfloat16, True
    q, k, v, do = _inputs(MAIN_SHAPE, MAIN_SHAPE[1], dtype, seed=2)
    scale = MAIN_SHAPE[-1] ** -0.5
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    delta = fa.softmax_delta(out, do)
    ms = {
        "flash_fwd": (
            time_ms(lambda: fa.flash_fwd(q, k, v, causal, scale)),
            time_ms(lambda: fa.flash_fwd_reference(q, k, v, causal, scale), iters=5),
        ),
        "flash_bwd_dkv": (
            time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)),
            time_ms(lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale),
                    iters=5),
        ),
        "flash_bwd_dq": (
            time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)),
            time_ms(lambda: fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale),
                    iters=5),
        ),
    }
    dev_ms = {
        "flash_fwd": device_ms(lambda: fa.flash_fwd(q, k, v, causal, scale)),
        "flash_bwd_dkv": device_ms(
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)),
        "flash_bwd_dq": device_ms(
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)),
    }
    # the library yardstick: scaled_dot_product_attention in [B, H, L, D],
    # timed here only; the port never calls it. Its backward is one
    # autograd.grad call whose host work is on the scale of its device
    # work, so library_ms is its device time; the event time is printed too
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    o_sdpa = sdpa_fwd()

    def sdpa_bwd():
        return torch.autograd.grad(o_sdpa, (qt, kt, vt), dot, retain_graph=True)

    lib_fwd = (device_ms(sdpa_fwd), time_ms(sdpa_fwd))
    lib_bwd = (device_ms(sdpa_bwd), time_ms(sdpa_bwd))
    library = {"flash_fwd": lib_fwd, "flash_bwd_dkv": lib_bwd, "flash_bwd_dq": lib_bwd}
    result = {}
    for name, (bound, by, flops, nbytes) in bounds(MAIN_SHAPE, dtype, causal).items():
        kernel_ms, plain_ms = ms[name]
        lib_dev, lib_ev = library[name]
        result[name] = {
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_dev,
        }
        print(f"[timing] {name} {MAIN_SHAPE} bf16 causal: kernel {kernel_ms:.4f} ms "
              f"(device time {dev_ms[name]:.4f} ms), bound {bound:.4f} ms ({by}; "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), {kernel_ms / bound:.1f}x the "
              f"bound, {flops / kernel_ms / 1e9:.1f} TFLOP/s, plain {plain_ms:.4f} ms, library "
              f"{lib_dev:.4f} ms device time ({lib_ev:.4f} ms by events; "
              + ("SDPA backward, all of dq/dk/dv)" if name != "flash_fwd" else "SDPA forward)")
              + f", kernel / library by device time {dev_ms[name] / lib_dev:.2f}, device time "
              f"{dev_ms[name] / bound:.1f}x the bound")
    return result


# --------------------------------------------------------------------------
# phases 4-6: the rounds
# --------------------------------------------------------------------------

KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "flash_fwd": ("pygrid_tpu_torch/csrc/flash_fwd.cu",
                  "pygrid_tpu/parallel/pallas_attention.py:61"),
    "flash_bwd_dkv": ("pygrid_tpu_torch/csrc/flash_bwd.cu",
                      "pygrid_tpu/parallel/pallas_attention.py:275"),
    "flash_bwd_dq": ("pygrid_tpu_torch/csrc/flash_bwd.cu",
                     "pygrid_tpu/parallel/pallas_attention.py:355"),
    "ring_matmul": ("pygrid_tpu_torch/csrc/ring_matmul.cu",
                    "pygrid_tpu/smpc/pallas_kernels.py:66"),
}


def full_config(n_layers=4):
    """bench_fed_transformer's configuration (bench.py): vocab 8192,
    d_model 512, 4 heads of 128, d_ff 2048, max_len 512."""
    from pygrid_tpu_torch.models import transformer

    return transformer.TransformerConfig(
        vocab=8192, d_model=512, n_heads=4, n_layers=n_layers, d_ff=2048, max_len=512,
    )


def transformer_setup(cfg, K, B, device, seed=0):
    from pygrid_tpu_torch.models import transformer

    g = torch.Generator().manual_seed(seed)
    params = transformer.init(cfg, generator=g, device=device)
    X = torch.randint(0, cfg.vocab, (K, B, cfg.max_len), generator=g).to(device)
    return params, X, torch.roll(X, -1, dims=-1)


def _counters():
    from pygrid_tpu_torch.parallel import flash_attention as fa
    from pygrid_tpu_torch.smpc import ring_matmul as rm

    return {"flash": fa, "ring": rm}


def counted(fn, path="flash"):
    """Run ``fn`` with every kernel's launch count set to 0 just before;
    returns (its result, the counts of ``path``'s kernels just after, wall
    seconds). The other kernels must not have launched."""
    counters = _counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    others = {k: n for name, c in counters.items() if name != path
              for k, n in c.launch_counts().items()}
    check(not any(others.values()), f"the {path} path launched other kernels: {others}")
    return out, counters[path].launch_counts(), secs


def _finite(*xs) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in xs)


def phase_rounds(n_rounds=3) -> dict:
    """The main path: ``make_fused_rounds`` over the flash transformer at
    full width, K=8 clients x B=4 sequences, bf16 compute and bf16 CE
    backward, local_steps=1, lr 0.1 (bench.py bench_fed_transformer)."""
    from functools import partial

    from pygrid_tpu_torch.models import transformer
    from pygrid_tpu_torch.parallel import flash_attention as fa
    from pygrid_tpu_torch.parallel import make_fused_rounds

    cfg, K, B = full_config(), 8, 4
    params, X, y = transformer_setup(cfg, K, B, "cuda")
    loss_fn = partial(
        transformer.loss_and_acc, cfg=cfg, attn_fn=fa.flash_attention,
        compute_dtype="bfloat16", ce_grad_dtype="bfloat16",
    )
    make_fused_rounds(loss_fn, n_rounds=1)(params, X, y, 0.1)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    (final, losses, accs), counts, secs = counted(
        lambda: make_fused_rounds(loss_fn, n_rounds=n_rounds)(params, X, y, 0.1)
    )
    losses_l = [float(x) for x in losses]
    ms_round = secs / n_rounds * 1e3
    tok_s = K * B * cfg.max_len * n_rounds / secs
    print(f"[rounds] {n_rounds} fused rounds, {cfg}, K={K} B={B}: losses {losses_l}, "
          f"accs {[float(a) for a in accs]}")
    print(f"[rounds] {ms_round:.3f} ms/round, {tok_s:.1f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches {counts}")
    check(_finite(losses, accs, *final), "main path: non-finite loss, acc or params")
    check(losses_l[-1] < losses_l[0], f"main path: loss did not fall: {losses_l}")
    for name, n in counts.items():
        check(n == cfg.n_layers * n_rounds,
              f"main path: {name} launched {n} times, expected {cfg.n_layers} per round")
    # the host clock varies between calls (the host's cores are shared):
    # single rounds timed one by one show the spread inside this call
    one_round = make_fused_rounds(loss_fn, n_rounds=1)
    samples = [counted(lambda: one_round(params, X, y, 0.1))[2] * 1e3 for _ in range(5)]
    med = statistics.median(samples)
    print(f"[rounds] 5 single rounds: {[round(s, 3) for s in samples]} ms, median "
          f"{med:.3f} ms/round, {K * B * cfg.max_len / med * 1e3:.1f} tokens/s")
    profile_round(lambda: one_round(params, X, y, 0.1))
    return counts


def profile_round(fn, top=12) -> None:
    """Device time by kernel over one more round under torch.profiler (after
    the counted run, so its launches count nowhere), and the device's idle
    share of the round's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        print("[profile] the profiler saw no device time: not measured")
        return
    print(f"[profile] one round: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.4f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.self_device_time_total / busy_us:7.2%} x{e.count:<4d} {e.key[:100]}")


def phase_small() -> None:
    """One opaque ``make_round`` round and one ``local_steps=2`` fused round
    of the flash transformer at full width and depth 2, then the MLP
    FedAvg round of ``__graft_entry__.entry()`` (K=8, B=16)."""
    from functools import partial

    from pygrid_tpu_torch.models import mlp, transformer
    from pygrid_tpu_torch.parallel import flash_attention as fa
    from pygrid_tpu_torch.parallel import make_fused_round, make_round

    cfg, K, B = full_config(n_layers=2), 8, 4
    params, X, y = transformer_setup(cfg, K, B, "cuda", seed=1)
    kw = dict(cfg=cfg, attn_fn=fa.flash_attention, compute_dtype="bfloat16",
              ce_grad_dtype="bfloat16")
    paths = {
        # (round, launches of each kernel: one step per client per layer)
        "opaque make_round": (make_round(transformer.make_training_step(**kw)), K),
        "fused local_steps=2": (
            make_fused_round(partial(transformer.loss_and_acc, **kw), local_steps=2,
                             carry_dtype=torch.bfloat16), 2 * K),
    }
    for name, (round_fn, steps) in paths.items():
        (new_p, loss, acc), counts, secs = counted(lambda: round_fn(params, X, y, 0.1))
        print(f"[small] {name}, depth {cfg.n_layers}: loss {float(loss):.5f} acc "
              f"{float(acc):.5f}, {secs * 1e3:.1f} ms, launches {counts}")
        check(_finite(loss, acc, *new_p), f"{name}: non-finite result")
        for kname, n in counts.items():
            check(n == steps * cfg.n_layers,
                  f"{name}: {kname} launched {n} times, expected {steps * cfg.n_layers}")

    g = torch.Generator().manual_seed(2)
    mparams = mlp.init(generator=g, device="cuda")
    mX = torch.randn((8, 16, 784), generator=g).cuda()
    my = torch.nn.functional.one_hot(torch.randint(0, 10, (8, 16), generator=g), 10).float().cuda()
    (new_p, loss, acc), counts, secs = counted(
        lambda: make_round(mlp.training_step)(mparams, mX, my, 0.1))
    print(f"[small] MLP make_round K=8 B=16: loss {float(loss):.5f} acc {float(acc):.5f}, "
          f"{secs * 1e3:.2f} ms, launches {counts}")
    check(_finite(loss, acc, *new_p), "MLP round: non-finite result")


# card against CPU, per compute dtype: (parameter limit, losses' rtol).
# f32: the largest parameter difference, as the sums differ only in order
# (seen on an H100: 1.2e-7, losses 8.4e-8). bf16: the norm of the
# parameters' difference over the norm of the CPU's update to them. Every
# product there rounds to bf16 after an f32 sum in another order and the
# online softmax rounds P at other points, so the card's bf16 round and the
# CPU's differ at the scale of bf16's own rounding noise, which the phase
# prints beside them as bf16 against f32 on the CPU (seen on an H100:
# 5.7e-3, losses 8.1e-5). The limits are about twice those readings: they
# catch a wrong layout, a broken CE head or a broken kernel, not a quiet
# f32 run, which the f32-output product check below covers where it matters.
PARITY_TOL = {None: (1e-4, 1e-5), "bfloat16": (1.2e-2, 2e-4)}


def phase_parity() -> None:
    """Two fused rounds of a small transformer through the kernels on the
    card against the same rounds on the CPU through the plain versions,
    in f32 and in the main path's bf16 (bf16 compute, bf16 CE backward),
    whose bf16 GEMMs, f32-output products and CE head otherwise run on the
    card unchecked. Then the CE head's f32-output product on its own."""
    from functools import partial

    from pygrid_tpu_torch.models import transformer
    from pygrid_tpu_torch.parallel import flash_attention as fa
    from pygrid_tpu_torch.parallel import make_fused_rounds

    cfg = transformer.TransformerConfig(
        vocab=256, d_model=128, n_heads=2, n_layers=2, d_ff=256, max_len=96)
    params, X, y = transformer_setup(cfg, 2, 2, "cpu", seed=3)

    def update_err(got, want):
        """|got - want| over |want's update|, as norms over all params."""
        return float(torch.cat([(a - b).flatten() for a, b in zip(got, want)]).norm()
                     / torch.cat([(b - p0).flatten() for b, p0 in zip(want, params)]).norm())

    cpu = {}
    for cd, (p_tol, l_tol) in PARITY_TOL.items():
        loss_fn = partial(transformer.loss_and_acc, cfg=cfg, attn_fn=fa.flash_attention,
                          compute_dtype=cd, ce_grad_dtype=cd)
        rounds = make_fused_rounds(loss_fn, n_rounds=2)
        p_cpu, l_cpu, _ = cpu[cd] = rounds(params, X, y, 0.1)
        (p_gpu, l_gpu, _), counts, _ = counted(
            lambda: rounds([p.cuda() for p in params], X.cuda(), y.cuda(), 0.1))
        check(all(n == 2 * cfg.n_layers for n in counts.values()),
              f"parity: the card run did not go through the kernels: {counts}")
        check(_finite(l_gpu, *p_gpu), f"parity {cd}: non-finite result on the card")
        p_gpu = [p.cpu() for p in p_gpu]
        l_err = float(((l_gpu.cpu() - l_cpu).abs() / l_cpu.abs()).max())
        p_abs = max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu))
        p_rel = update_err(p_gpu, p_cpu)
        print(f"[parity] {cd or 'float32'} {cfg}: card vs CPU max loss rel err "
              f"{l_err:.3e}, max param abs err {p_abs:.3e}, update rel err {p_rel:.3e}")
        p_err = p_abs if cd is None else p_rel
        check(p_err <= p_tol and l_err <= l_tol,
              f"parity {cd}: card and CPU rounds disagree beyond ({p_tol}, {l_tol})")
    (p16, l16, _), (p32, l32, _) = cpu["bfloat16"], cpu[None]
    print(f"[parity] bf16 vs f32, both on the CPU: max loss rel diff "
          f"{float(((l16 - l32).abs() / l32.abs()).max()):.3e}, update rel diff "
          f"{update_err(p16, p32):.3e}")
    check_dot_f32(full_config())


def check_dot_f32(cfg, seed=4) -> None:
    """``_dot_f32`` on bf16 operands takes the card's native product with
    an f32 output (``torch.mm(..., out_dtype=float32)``), at the main
    path's three shapes: the logits [N, d] x [d, vocab] and the CE head's
    two gradient products, the last with a transposed left operand, as
    ``dlogits.T``. Against the f64 product its error must stay under 2^-13
    of the largest value, 1/16 of a bf16 half-ulp there: a result rounded
    through bf16 would miss that 16-fold, an f32-accumulated one meets it
    with room (seen on an H100: 9.7e-5, 4.9e-3 and 1.5e-2 at k = 512, 8192
    and 16384, against limits of 1.8e-2, 6.4e-2 and 7.9e-2; the widened
    f32 product's errors were 8.2e-5, 1.6e-3 and 1.5e-3)."""
    from pygrid_tpu_torch.models import transformer

    N = 8 * 4 * cfg.max_len  # K clients x B sequences x L tokens
    g = torch.Generator(device="cuda").manual_seed(seed)
    for m, k, n, t in ((N, cfg.d_model, cfg.vocab, False),
                       (N, cfg.vocab, cfg.d_model, False),
                       (cfg.vocab, N, cfg.d_model, True)):
        a = torch.randn((k, m) if t else (m, k), generator=g, device="cuda")
        a = (a.T if t else a).to(torch.bfloat16)
        b = torch.randn((k, n), generator=g, device="cuda").to(torch.bfloat16)
        got = transformer._dot_f32(a, b)
        exact = a.double() @ b.double()
        f32_err = float((a.float() @ b.float() - exact).abs().max())
        torch.cuda.synchronize()
        check(got.dtype == torch.float32 and got.shape == (m, n), "dot_f32: wrong result")
        err, limit = float((got - exact).abs().max()), 2**-13 * float(exact.abs().max())
        print(f"[parity] dot_f32 bf16 [{m}, {k}] x [{k}, {n}] -> f32: max abs err vs f64 "
              f"{err:.3e} (limit {limit:.3e}), the f32 product's {f32_err:.3e}")
        check(err <= limit, "dot_f32 is not an f32-accumulated product")


# --------------------------------------------------------------------------
# phases 7-10: the SMPC plane and its ring-matmul kernel
# --------------------------------------------------------------------------

# H100 SXM data sheet: dense int8 tensor-core rate. The ring matmul's least
# known work is its 36 u8 limb products (the reference's scheme) there.
PEAK_INT8_OPS = 1979e12
RING_LIMB_PRODUCTS = 36

# the main path's two Beaver configurations (bench.py bench_smpc): B rounds
# of P-party [N, N] @ [N, N] ring matmuls
SMPC_CONFIGS = ((512, 3, 64), (8, 3, 512))
PARTIES = ("alice", "bob", "charlie")

# the encrypted MLP's decoded output against the float64 plaintext forward:
# max abs error. The same inputs through the JAX package on the CPU meet
# 3.451159e-02 at worst over 5 seeds of shares and triples (3.15e-2 to
# 3.45e-2: 1e-3 encodings of 784 and 392 terms and two truncations, against
# outputs up to 5.44; the slow test test_mlp_limit_is_what_the_jax_package_meets
# in tests/test_torch_smpc.py reproduces it); the limit is twice it.
MLP_JAX_ERR = 3.451159e-02
MLP_ATOL = 2 * MLP_JAX_ERR


def _np_u64_matmul(a, b):
    with np.errstate(over="ignore"):
        return np.matmul(a, b)


def _ring_np(rng, shape):
    return rng.integers(0, 2**64, size=shape, dtype=np.uint64)


def check_ring(a, b, tag, truth, truth_at=()):
    """The kernel against its plain version on the card, bit for bit, and
    against the numpy uint64 product ``truth`` of the output slice
    ``truth_at``; returns the largest |kernel - plain| (0 when it passes)."""
    from pygrid_tpu_torch.smpc import ring as R
    from pygrid_tpu_torch.smpc import ring_matmul as rm

    ref = rm.ring_matmul_reference(a, b)
    _poison()
    got = rm.ring_matmul_kernel(a, b)
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"ring kernel {tag}: shape {tuple(got.shape)}")
    mismatches = int((got != ref).sum())
    check(mismatches == 0, f"ring kernel {tag}: {mismatches} elements differ from the plain version")
    check(np.array_equal(R.from_ring(got[truth_at]), truth),
          f"ring kernel {tag}: differs from numpy uint64")
    where = f" (batch element {truth_at})" if truth_at != () else ""
    print(f"[ring] {tag}: kernel == plain == numpy{where}")
    return int((got - ref).abs().max())


def ring_main_shapes():
    """The two main-path launch shapes: (B, M, K, N)."""
    return [(B, N, N, N) for B, _, N in SMPC_CONFIGS]


def phase_ring_kernel() -> int:
    """The ring-matmul kernel at the listed shapes: square and ragged 2-D,
    all-ones operands (the most carries), batched, a stride-0 broadcast
    batch, two batch axes with a stride-0 one (the party axis of a batched
    Beaver round), a transposed operand, and the main path's two shapes."""
    from pygrid_tpu_torch.smpc import ring as R

    rng = np.random.default_rng(7)
    dev = "cuda"
    worst = 0
    for sa, sb in (((1, 1), (1, 1)), ((4, 8), (8, 4)), ((130, 600), (600, 70)),
                   ((128, 128), (128, 128)), ((3, 8, 8), (3, 8, 8)), ((4, 9, 130), (4, 130, 5))):
        a, b = _ring_np(rng, sa), _ring_np(rng, sb)
        worst = max(worst, check_ring(R.to_ring(a, dev), R.to_ring(b, dev), f"{sa} @ {sb}",
                                      _np_u64_matmul(a, b)))
    # all-ones: the largest limbs; K = 20000 folds the kernel's s32 partials
    # four times (every 4096 of K), and unfolded they would pass 2^32
    for K in (1600, 20000):
        ones = np.full((8, K), 2**64 - 1, dtype=np.uint64)
        worst = max(worst, check_ring(R.to_ring(ones, dev), R.to_ring(ones.T.copy(), dev),
                                      f"all-ones (8, {K}) @ ({K}, 8)", _np_u64_matmul(ones, ones.T)))
    d, b = _ring_np(rng, (40, 33)), _ring_np(rng, (5, 33, 21))
    worst = max(worst, check_ring(
        R.to_ring(d, dev).expand(5, 40, 33), R.to_ring(b, dev), "stride-0 batch (5, 40, 33) @ (5, 33, 21)",
        _np_u64_matmul(np.broadcast_to(d, (5, 40, 33)), b)))
    d, b = _ring_np(rng, (2, 65, 64)), _ring_np(rng, (2, 3, 66, 64))
    worst = max(worst, check_ring(
        R.to_ring(d, dev).unsqueeze(1).expand(2, 3, 65, 64), R.to_ring(b, dev).transpose(-1, -2),
        "two batch axes, stride-0 parties, transposed b (2, 3, 65, 64) @ (2, 3, 64, 66)",
        _np_u64_matmul(np.broadcast_to(d[:, None], (2, 3, 65, 64)), b.swapaxes(-1, -2))))
    for B, M, K, N in ring_main_shapes():
        a, b = _ring_np(rng, (B, M, K)), _ring_np(rng, (B, K, N))
        # numpy's integer matmul is slow: the truth covers batch element 0
        worst = max(worst, check_ring(R.to_ring(a, dev), R.to_ring(b, dev),
                                      f"main shape ({B}, {M}, {K}) @ ({B}, {K}, {N})",
                                      _np_u64_matmul(a[0], b[0]), truth_at=0))
    return worst


def ring_bound(B, M, K, N):
    """(bound ms, what bounds it, int8 ops, bytes) of one ring matmul: the
    36 u8 limb products at the int8 tensor-core rate against 8-byte
    operands read once and the output written once."""
    ops = RING_LIMB_PRODUCTS * 2 * B * M * N * K
    nbytes = 8 * B * (M * K + K * N + M * N)
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes", ops, nbytes


def library_int64_matmul(a, b, ref):
    """torch.matmul on int64 CUDA tensors, the one PyTorch call that could
    compute the product: (its ms if it runs and is exact, else None; what
    it did). The port never calls it. A RuntimeError here is the finding
    (no int64 product on the card), not a failure of the phase."""
    try:
        out = torch.matmul(a, b)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, f"torch.matmul on int64 CUDA tensors raises: {str(e).splitlines()[0]}"
    if not torch.equal(out, ref):
        return None, "torch.matmul on int64 CUDA tensors runs but is not the exact ring product"
    return time_ms(lambda: torch.matmul(a, b)), "torch.matmul on int64 CUDA tensors (exact)"


# the u64 CUDA-core kernel that the tensor-core kernel replaced, ms per
# launch by events at each (B, M, K, N) on an NVIDIA H100 80GB HBM3 at
# 700.00 W, as PERF.md records them (0.0608-0.0616 at the smaller shape)
RING_U64_MS = {(512, 64, 64, 64): 0.0612, (8, 512, 512, 512): 0.3962}


def phase_ring_timing() -> dict:
    """Median ms per launch of the kernel at the main path's two shapes, by
    events and by device time, beside the bound, the u64 kernel's, the plain
    version and the library call. The JSON line carries the [8, 512, 512]
    launch, where the main path spends most of the kernel's time."""
    from pygrid_tpu_torch.smpc import ring as R
    from pygrid_tpu_torch.smpc import ring_matmul as rm

    g = torch.Generator(device="cuda").manual_seed(11)
    result = {}
    for B, M, K, N in ring_main_shapes():
        a = R.ring_random(g, (B, M, K))
        b = R.ring_random(g, (B, K, N))
        kernel_ms = time_ms(lambda: rm.ring_matmul_kernel(a, b))
        dev_ms = device_ms(lambda: rm.ring_matmul_kernel(a, b))
        plain_ms = time_ms(lambda: rm.ring_matmul_reference(a, b), iters=5)
        lib_ms, lib_note = library_int64_matmul(a, b, rm.ring_matmul_reference(a, b))
        bound, by, ops, nbytes = ring_bound(B, M, K, N)
        result = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                  "library_ms": lib_ms}
        print(f"[ring timing] ({B}, {M}, {K}) @ ({B}, {K}, {N}): kernel {kernel_ms:.4f} ms "
              f"(device time {dev_ms:.4f} ms; the u64 kernel's {RING_U64_MS[(B, M, K, N)]:.4f} ms, "
              f"{RING_U64_MS[(B, M, K, N)] / kernel_ms:.2f}x), "
              f"bound {bound:.4f} ms ({by}; {ops / 1e9:.2f} G int8 ops, {nbytes / 1e6:.1f} MB), "
              f"{kernel_ms / bound:.1f}x the bound ({dev_ms / bound:.1f}x by device time), "
              f"{ops / dev_ms / 1e9:.1f} T int8 ops/s, plain {plain_ms:.4f} ms, library "
              f"{'%.4f ms' % lib_ms if lib_ms is not None else 'none'} ({lib_note})")
    return result


def phase_smpc_rounds() -> int:
    """The main path: ``batched_beaver`` at bench_smpc's two configurations
    (B rounds of 3-party [N, N] @ [N, N], values in the uint32 range as
    bench.py draws them), triples dealt on the card. The first round is
    held to the plain product on the card and numpy on one element; then a
    chain of rounds (each squaring the last) is timed, counted and checked
    against the plain products. Returns the kernel's launches."""
    from pygrid_tpu_torch.smpc import ring as R
    from pygrid_tpu_torch.smpc import ring_matmul as rm
    from pygrid_tpu_torch.smpc.kernels import batched_beaver, reconstruct_kernel, share_kernel

    total = 0
    for B, P, N in SMPC_CONFIGS:
        g = torch.Generator(device="cuda").manual_seed(B)
        x = torch.randint(0, 2**32, (B, N, N), generator=g, device="cuda")
        x_sh = share_kernel(g, x, P, dim=1)
        z, counts, secs = counted(lambda: batched_beaver(g, x_sh, x_sh), "ring")
        opened = reconstruct_kernel(z, dim=1)
        check(torch.equal(opened, rm.ring_matmul_reference(x, x)),
              f"smpc B={B} N={N}: the first round does not open to x @ x mod 2^64")
        x0 = R.from_ring(x[0])
        check(np.array_equal(R.from_ring(opened[0]), _np_u64_matmul(x0, x0)),
              f"smpc B={B} N={N}: round differs from numpy uint64")
        check(counts["ring_matmul"] == 4,
              f"smpc B={B} N={N}: {counts['ring_matmul']} ring launches in a round, expected 4")
        total += counts["ring_matmul"]
        print(f"[smpc] B={B} P={P} [{N}, {N}]: first round ({secs * 1e3:.3f} ms) opens to "
              f"x @ x (plain, numpy element 0), {counts['ring_matmul']} launches")

        n_rounds = 8

        def chain():
            s = x_sh
            for _ in range(n_rounds):
                s = batched_beaver(g, s, s)
            return s

        z, counts, secs = counted(chain, "ring")
        want = x
        for _ in range(n_rounds):
            want = rm.ring_matmul_reference(want, want)
        check(torch.equal(reconstruct_kernel(z, dim=1), want),
              f"smpc B={B} N={N}: {n_rounds} chained rounds do not open to x^(2^{n_rounds})")
        check(counts["ring_matmul"] == 4 * n_rounds,
              f"smpc B={B} N={N}: {counts['ring_matmul']} launches in {n_rounds} rounds")
        total += counts["ring_matmul"]
        per = secs / n_rounds
        print(f"[smpc] B={B} P={P} [{N}, {N}]: {n_rounds} chained rounds, {per * 1e3:.3f} ms/round, "
              f"{B / per:.1f} Beaver matmuls/s, {counts['ring_matmul']} launches (4 per round)")
        profile_round(lambda: batched_beaver(g, x_sh, x_sh), top=6)
    return total


def mlp_plaintext(seed=0, batch=256, sizes=(784, 392, 10)):
    """The encrypted MLP's float64 inputs: x in [0, 1], He-normal weights,
    biases in [-0.1, 0.1] broadcast to [batch, width] (shared pre-broadcast)."""
    rng = np.random.default_rng(seed)
    out = [rng.uniform(0.0, 1.0, (batch, sizes[0]))]
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        out.append(rng.standard_normal((n_in, n_out)) * (2.0 / n_in) ** 0.5)
        out.append(np.ascontiguousarray(
            np.broadcast_to(rng.uniform(-0.1, 0.1, n_out), (batch, n_out))))
    return out


def mlp_forward(x, w1, b1, w2, b2):
    """examples/encrypted_inference.py's CryptoNets-style MLP: affine →
    square → affine; returns each step's output, the last is the MLP's."""
    h = x @ w1 + b1
    h2 = h * h
    return [h, h2, h2 @ w2 + b2]


def mlp_steps(batch=256, sizes=(784, 392, 10)):
    """(op, shape_x, shape_y, truncated shape) of each Beaver round."""
    d0, d1, d2 = sizes
    return (("matmul", (batch, d0), (d0, d1), (batch, d1)),
            ("mul", (batch, d1), (batch, d1), (batch, d1)),
            ("matmul", (batch, d1), (d1, d2), (batch, d2)))


def phase_encrypted_mlp() -> int:
    """The encrypted 784→392→10 MLP forward at batch 256 through
    ``fix_prec(...).share("alice", "bob", "charlie", crypto_provider=...)``.
    (a) On the card with triples dealt there: the decoded output against the
    float64 plaintext within MLP_ATOL, and 8 ring launches (two matmul
    rounds: the triple's c, then d∘b, a∘e, d∘e). (b) The same input shares,
    triples and truncation pairs, dealt on the CPU and injected through
    ``strict_store`` providers, on the card and on the CPU: every step's
    output shares bit-identical, and 6 launches on the card. Returns the
    launches of (a)."""
    from pygrid_tpu_torch.smpc import AdditiveSharingTensor, CryptoProvider, CryptoStore, fix_prec

    plain = mlp_plaintext()
    want = mlp_forward(*plain)[-1]
    g = torch.Generator(device="cuda").manual_seed(5)
    provider = CryptoProvider(seed=5, device="cuda")
    shared = [fix_prec(v).share(*PARTIES, crypto_provider=provider, generator=g, device="cuda")
              for v in plain]
    out, counts, secs = counted(lambda: mlp_forward(*shared)[-1], "ring")
    got = out.get()
    err = float(np.abs(got - want).max())
    print(f"[mlp] encrypted 784-392-10 forward, batch 256, 3 parties, on the card: {secs * 1e3:.3f} ms, "
          f"launches {counts}, decoded max abs err vs float64 {err:.4e} (limit {MLP_ATOL:.4e}; the "
          f"JAX package on the CPU: {MLP_JAX_ERR:.4e}), plaintext max |y| {float(np.abs(want).max()):.3f}")
    check(got.shape == want.shape and bool(np.isfinite(got).all()), "mlp: bad decoded output")
    check(err <= MLP_ATOL, f"mlp: decoded output {err:.3e} from the plaintext, limit {MLP_ATOL:.3e}")
    check(counts["ring_matmul"] == 8, f"mlp: {counts['ring_matmul']} ring launches, expected 8")

    # (b) card against CPU on injected shares, triples and truncation pairs
    scale = shared[0].encoder.scale
    dealer = CryptoProvider(seed=6, device="cpu")
    cpu_p = CryptoProvider(strict_store=True, device="cpu")
    gpu_p = CryptoProvider(strict_store=True, device="cuda")
    for op, sx, sy, ts in mlp_steps():
        triple = dealer.triple(op, sx, sy, len(PARTIES))
        pair = dealer.trunc_pair(ts, scale, len(PARTIES))
        for prov, dev in ((cpu_p, "cpu"), (gpu_p, "cuda")):
            prov.store.put(CryptoStore.key(op, sx, sy, len(PARTIES)), tuple(t.to(dev) for t in triple))
            prov.store.put(CryptoStore.key("trunc", ts, (scale,), len(PARTIES)),
                           tuple(t.to(dev) for t in pair))
    g_cpu = torch.Generator().manual_seed(6)
    cpu_in = [fix_prec(v).share(*PARTIES, crypto_provider=cpu_p, generator=g_cpu, device="cpu")
              for v in plain]
    gpu_in = [AdditiveSharingTensor(t.shares.cuda(), PARTIES, t.encoder, gpu_p) for t in cpu_in]
    t0 = time.perf_counter()
    cpu_out = mlp_forward(*cpu_in)
    cpu_s = time.perf_counter() - t0
    gpu_out, counts_b, secs_b = counted(lambda: mlp_forward(*gpu_in), "ring")
    for i, (c, d) in enumerate(zip(cpu_out, gpu_out)):
        check(torch.equal(d.shares.cpu(), c.shares),
              f"mlp parity: step {i} output shares differ between the card and the CPU")
    check(counts_b["ring_matmul"] == 6, f"mlp parity: {counts_b['ring_matmul']} launches, expected 6")
    check(np.array_equal(gpu_out[-1].get(), cpu_out[-1].get()), "mlp parity: decoded outputs differ")
    print(f"[mlp] injected shares, triples and truncation pairs: card ({secs_b * 1e3:.3f} ms, "
          f"launches {counts_b}) and CPU ({cpu_s * 1e3:.1f} ms) output shares bit-identical "
          f"at all 3 steps; decoded max abs err vs float64 "
          f"{float(np.abs(gpu_out[-1].get() - want).max()):.4e}")
    return counts["ring_matmul"]


# --------------------------------------------------------------------------


def main() -> int:
    check(torch.cuda.is_available(), "no CUDA GPU: chip_smoke.py runs on the card only")
    import pygrid_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    phase_build()
    errs = phase_kernels()
    timing = phase_timing()
    launches = phase_rounds()
    phase_small()
    phase_parity()
    errs["ring_matmul"] = phase_ring_kernel()
    timing["ring_matmul"] = phase_ring_timing()
    launches["ring_matmul"] = phase_smpc_rounds() + phase_encrypted_mlp()

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], **timing[name],
        })
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
