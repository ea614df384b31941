#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pygrid_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

With no arguments it runs every phase, in order; any failure raises and
the script exits non-zero:

1. build    — compile the CUDA kernels from pygrid_tpu_torch/csrc (nvcc,
              sm_90a, one process per source) and print ptxas' report; the
              tensor-core kernels must not spill;
2. kernels  — hold each kernel (flash forward, dK/dV, dQ) against its plain
              PyTorch version on the card: bf16 and f32, causal and not,
              aligned and ragged shapes, and in bf16 the tensor-core
              kernels' tile and layout edges (L around the 64-row tiles,
              D of 40, 64 and 128, a D=36 padded copy, Lq != Lk, q/k/v as
              strided views of one [B, L, 3, H, D] tensor), head dims
              past 128 (136, 200, 256, 512) in both dtypes, and values
              narrower than queries and keys (D_qk 192 / D_v 128 and
              160 / 96: the narrow-V path, ragged L, Lq != Lk and a
              strided view, each launch counted as narrow-V); dK/dV and
              dQ must be bit-identical across two launches;
3. timing   — each kernel's median time at the main path's shape, beside
              its bound (with its multiple of it and its TFLOP/s), its
              plain version and the PyTorch library call (SDPA, timed by
              device time under torch.profiler); then the wide (D > 128)
              kernels' device time at [32, 512, 2, 256] bf16 causal beside
              their bound and SDPA's, printed only; then the narrow-V
              kernels at the Moonlight cell's [4, 8192, 16, 192/128]: each
              launch counted as narrow-V and its outputs at two (b, h)
              slices held to the plain versions, and its device time beside
              the bound of its true work (benchmark/work/mla_flash.py's
              count), printed only;
   moe rows — the expert layer's six row kernels (csrc/moe_rows.cu) at
              the Moonlight cell's shapes (T 32,768, top-6 of 64, 8 held,
              d 2,048, f 1,408, bf16) against their plain versions on the
              held rows, then each one's time beside its bound (the bytes
              it moves at the held rows) and its plain version's;
4. rounds   — one FedAvg round of the benchmark's Moonlight cell, which
              must launch each flash kernel once a layer, every launch
              narrow-V, and each row kernel once per expert layer and
              direction, over a held share of the dispatch rows between
              0.10 and 0.16; then the main path: fused FedAvg rounds of the
              federated transformer at full width (bench_fed_transformer's
              config), with each kernel's launches counted;
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
              run given the same shares, triples and truncation pairs;
11. wire    — the node's model-hosting path on phase rounds' params: wire-v2
              State blobs in f32 and bf16 (sizes and host times), a
              Warehouse on a sqlite file, zero-copy decodes, the params
              back on the card bit for bit, 8 bf16 client diffs folded by
              the C++ native.accum_bf16 exactly, a round from the restored
              params, a checkpoint, the MLP's shares and a zlib frame;
12. fl      — the model-centric FL cycle: a port FLController on a sqlite
              file hosts the committed JAX-built CNN plan ("list"), the
              same CNN plan built by the port on the CPU ("torchscript",
              a torch.export program) and the committed JAX-built MLP plan
              ("list"), each for 2 cycles of 8 workers at batch 64 on the
              card; plan outputs held against the direct training step and
              the CPU, A against B, every checkpoint against the f64 mean
              on the card, no cycle left open, no hand-written kernel
              launched; host ms per protocol step, the step's device time
              three ways and the list's op count; then the f32 pin: the CNN
              list step with TF32 forced on (the error printed), and with
              both TF32 flags switched on beforehand through run_oplist,
              whose resolve() pins them off, against the CPU at the
              dialect tolerance;
13. datacentric — the data-centric plane: the committed JAX-built
              CryptoNets plan (784→392→10, batch 256) run by EncryptedModel
              over four in-process workers on the card (alice, bob, charlie
              hold shares, dan deals): decoded against float64 within
              MLP_ATOL with 16 ring launches a forward, host ms, device busy
              time, idle share and the ring kernel's share beside the class
              API's forward; card and CPU workers bit-identical on injected
              shares and primitives (14 launches); the pointer plane's float
              ops against the CPU, a move keeping a private tensor private,
              and the holders' shares through a sqlite file onto new workers,
              whose forward decodes to (a)'s output bit for bit.
14. serving — generation serving at the flagship width (phase rounds'
              config, random weights from a seed): (a) ``generate`` at
              bench_decode's shape (B=8, P=32, N=256, bf16 compute) with
              tokens/s, ms per step, device busy, idle share and kernels per
              step; (b) the paged engine on bench_serving's 8 concurrent
              requests (f32 cache), no program built under traffic, host ms
              per quantum; (c) 16 requests sharing a 4-page system prompt
              (block 64): prefix hits and no leaked block; (d) the engine
              per step and with speculative decode; every request's greedy
              tokens against ``generate``'s — equal, or diverging only at a
              near tie of generate's logits (top-2 gap <= 1e-4 x max
              |logit|); (e) the first prefill's and decode step's f32 logits
              against the CPU within 1e-4 and the PRNG's bits equal to the
              CPU's. The path launches none of the hand-written kernels.
15. grid    — four port nodes (alice, bob, charlie, dan), each on its own
              loop thread on 127.0.0.1 with its tensors on the card, driven
              only through the port's clients over HTTP and WebSocket: the
              committed JAX-built CNN plan hosted on alice with JWT
              authentication, 8 FLClients a cycle for 2 cycles over wire-v2
              (each checkpoint bit-identical to old - f32(f64 mean)); the
              CryptoNets forward over alice, bob and charlie with dan
              dealing, bit-identical to phase datacentric's, its 16 ring
              launches on the nodes counted; phase serving's bundle on alice
              answering 8 concurrent HTTP generations equal to generate();
              then /healthz, /metrics (strict Prometheus text),
              /telemetry/slo and GET / on every node. Then [network]: a port
              network on its own loop thread (monitor every 0.5 s) that the
              four nodes join through join_network: after a monitor sweep
              all four online with a ping, its health routes 200;
              EncryptedModel.discover of the CryptoNets plan published over
              alice, bob and charlie (dan dealing from phase datacentric's
              seed), whose predict is bit-identical to phase datacentric's
              with 16 ring launches counted; PublicGridNetwork.search
              bringing back a pointer to a tensor on bob; one cycle of 8
              threaded run_worker on the CNN plan, half through a
              sub-aggregator the network placed, the checkpoint old -
              f32(f64 mean) bit for bit. A clean stop (no thread left).
              Host ms per step beside the in-process phases.
16. secagg  — secure aggregation and port-built plans: (a) the MNIST CNN's
              and the MLP's training steps built by the port (Plan.build:
              make_fx, torch.export, fx_to_oplist), each op list run on the
              card against the direct step and the JAX-built fixture on the
              same params within rtol 2e-4 / atol 2e-5, device and event ms
              per step beside the JAX-built list's; (b) a port node on its
              loop thread hosting the port-built CNN plan with secure
              aggregation (clip 0.5, threshold 3) and four port FLClients
              with SecAggSession training on the card at batch 64, once all
              reporting and once with one leaving after the masking phase
              opens: each checkpoint within n · step of the survivors' plain
              mean, host ms per round stage; (c) simulate_secagg_round for
              16 clients over the CNN's 1.2 M params, bit-identical to the
              plain quantised sum and to the CPU's round, device ms and
              launches of a masked sum; (d) the port-built CryptoNets plan
              through EncryptedModel.predict with phase datacentric's seeds:
              16 ring launches (counted in the kernels line), within
              MLP_ATOL of float64, bit-identical to the JAX-built plan's.
17. mesh    — the multi-device plane on torch.distributed: one process
              starts NCCL at world size 1 (a FileStore in a temporary
              directory) and says so: every collective runs over one rank,
              and no number is a multi-GPU number. Each path is timed (CUDA
              events and host wall, medians) beside its single-device twin:
              (a) make_sharded_fused_round on phase rounds' transformer in
              bf16 against make_fused_round (bit-identical, else within bf16
              tolerance), 4 launches of each flash kernel; (b)
              make_sharded_round on the MLP against make_round; (c)
              ring_attention and ulysses_attention (with flash_attention) at
              [32, 512, 4, 128] bf16 causal against attention, then the
              transformer forward with each as attn_fn against the local
              forward (the ring's in f32, Ulysses' in bf16); (d) sharded_beaver
              at bench_smpc's two configurations, exact against the ring
              product, 4 ring launches a round (3 on a rank that holds no
              party 0: d∘e is party 0's); (e) make_sharded_masked_sum at
              16 clients x 1,199,882 words, bit-identical to masked_sum; (f)
              make_fsdp_training_step (Adam), 3 steps on the transformer in
              bf16 and f32 against the unsharded Adam update, with the flash
              launches; (g) pipeline_apply over one 512-wide tanh stage at
              16,384 rows in 4 microbatches against sequential_apply; (h)
              apply_expert_parallel at d_model 512, d_ff 2048, 8 experts,
              16,384 tokens, capacity factor 2.0, f32, against apply_dense.
              Every kernel must launch on the mesh path; its launches join
              the kernels line.
18. storm   — the storm harness (pygrid_tpu_torch.storm) with its nodes on
              the card: the smoke scenario (one node, one sub-aggregator,
              FL, generation and data-centric traffic, a sub-aggregator
              killed mid-cycle, the KV pool exhausted, the admission queue
              saturated), its flight dump replayed with no verdict
              mismatch, then the full scenario (64 workers, two nodes, two
              sub-aggregators, all four legs, five fault kinds, seven
              checks); every verdict must pass, and node 0's KV pool and a
              tensor it holds must be on the card. Prints each scenario's
              wall, each leg's ops by outcome, each verdict's measured
              reaction, the SLO transitions and the TTFT p50/p99 (bucket
              bounds of the SLO engine's histogram), and each kernel's
              launches during the storms (expected 0), which join the
              kernels line;
19. deploy  — the deploy plane (pygrid_tpu_torch.infra): every provider,
              deployment type and app rendered as a dry run, then
              LocalProvider.deploy(apply=True) spawning a port node on the
              card on a free port: /healthz 200 within 60 s (the seconds
              printed), a tensor through DataCentricFLClient and back on
              the card, the child among nvidia-smi's compute processes
              (its pid, or the count up by one where nvidia-smi reports
              another pid namespace), and after destroy() the child gone
              and the count back.
20. lint    — the port's gridlint on the card's machine: (a) ``python -m
              pygrid_tpu_torch.analysis pygrid_tpu_torch/ --strict-baseline``
              in a subprocess must exit 0 (files, findings by family,
              suppressions and seconds printed); (b) GL1's twin: one fused
              FedAvg round (phase rounds' config, the flash kernels
              launching; its backward on the calling thread) and one serving
              request over 3 fused quanta (phase serving's engine) under
              torch.cuda.set_sync_debug_mode("warn"): every sync must have a
              pygrid_tpu_torch frame, and one whose stack holds a program
              body must sit in a body GL1 reaches, on a line GL102
              reported, and no sync may sit inside a program at all (the
              programs' host inputs cross pinned and non-blocking); the
              same request is then sampled at temperature 0.8 under the
              same checks, and the greedy tokens are held against
              generate()'s; the syncs outside programs are printed, per
              quantum for the engine; (c) GL5's
              twin: each kernel instantiation GL5 resolves from csrc/ must be
              an entry function of ptxas' report and vice versa, and, for
              each launched under torch.profiler (bf16 D 40/64/128/256 and
              192/128, f32 D 64/256, the ring matmul), GL5's threads equal the block the
              card ran, GL5's dynamic shared memory plus ptxas' static bytes
              the profiler's, and ptxas' registers the profiler's (in a fresh
              interpreter: after the other phases the profiler returns
              launch records of only some kernels).
21. examples — the port's examples (examples_torch/, the twins of
              examples/) on the card, in this process through each script's
              main(argv) at --device cuda: each must return 0 and print its
              JAX twin's success line; fed_transformer.py must launch the
              three flash kernels and smpc_demo.py and encrypted_inference.py
              the ring kernel (their launches join the kernels line). Each
              example's wall time and launches are printed beside the card.

``python3 chip_smoke.py --mesh-world N`` builds the kernels and runs only
phase mesh, on N GPUs of one machine (one spawned process each, NCCL across
them; (d) then deals N parties and (g) runs N stages): every rank checks its
own results, rank 0 prints.

Then it prints the kernels line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. It imports nothing of JAX
or of pygrid_tpu, and exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

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


# the wide (D > 128) tensor-core kernels at n 128-wide chunks of D, bf16
# tiles of pitch 136: forward, n chunks of 64 Q rows and a ring of two
# stages of 64 K rows and 64 V rows; dK/dV, n chunks each of 64 K and V rows
# and a ring of two stages of 16 Q and 16 dO rows, plus two buffers of 16 f32
# lse and Delta; dQ, n chunks each of 64 Q and dO rows and a ring of two
# stages of 32 K and 32 V rows.
TC_WIDE_SMEM = {
    "flash_fwd": lambda n: 2 * (64 * n + 4 * 64) * 136,
    "flash_bwd_dkv": lambda n: 2 * (2 * 64 * n + 4 * 16) * 136 + 4 * 4 * 16,
    "flash_bwd_dq": lambda n: 2 * (2 * 64 * n + 4 * 32) * 136,
}

# the same kernels on the narrow-V path (D_v <= 128 < D_qk <= 192), one
# 192-wide chunk: the Q and K tiles at pitch 200, the V and dO tiles at 136.
# Forward, 64 Q rows and two stages of 64 K rows and 64 V rows; dK/dV, 64 K
# and 64 V rows and two stages of 16 Q and 16 dO rows, plus lse and Delta;
# dQ, 64 Q and 64 dO rows and two stages of 32 K and 32 V rows.
TC_NARROW_V_SMEM = {
    "flash_fwd": 2 * (3 * 64 * 200 + 2 * 64 * 136),
    "flash_bwd_dkv": 2 * (64 + 2 * 16) * (200 + 136) + 4 * 4 * 16,
    "flash_bwd_dq": 2 * (64 + 2 * 32) * (200 + 136),
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
            elif "spill stores" in line and entry is not None and (
                    "_tc_kernel" in entry or "_tc_wide_kernel" in entry):
                check(line.split()[4] == "0" and line.split()[8] == "0",
                      f"a tensor-core kernel spills registers: {entry.strip()}: {line.strip()}")
    for name, smem in TC_SMEM.items():
        sizes = (", ".join(f"D<={dp} {smem(dp)} B" for dp in (48, 64, 128)) if callable(smem)
                 else f"{smem} B")
        if name in TC_WIDE_SMEM:
            sizes += ", " + ", ".join(f"D<={128 * n} {TC_WIDE_SMEM[name](n)} B"
                                      for n in (2, 3, 4))
            sizes += f", narrow-V D_qk<=192 D_v<=128 {TC_NARROW_V_SMEM[name]} B"
        print(f"[build] {name} tensor-core kernel, dynamic shared memory a block: {sizes}")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def _inputs(shape_q, Lk, dtype, seed, views=False, Dv=None):
    """q, k, v, dO (v and dO at head dim ``Dv``, default q's D); with
    ``views``, q, k and v are the strided slices of one [B, L, 3, H, D]
    tensor, as a fused qkv projection gives them (v its first Dv columns)."""
    B, Lq, H, D = shape_q
    Dv = Dv or D
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    if views:
        qkv = rnd(B, Lq, 3, H, D)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2, :, :Dv], rnd(B, Lq, H, Dv)
    return rnd(B, Lq, H, D), rnd(B, Lk, H, D), rnd(B, Lk, H, Dv), rnd(B, Lq, H, Dv)


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


def compare_case(shape_q, Lk, dtype, causal, seed=0, views=False, Dv=None):
    """Each kernel against its plain version on the same inputs (v and dO
    at head dim ``Dv``, default q's); returns the max abs error of each.
    The dK/dV and dQ kernels run twice and must give the same bits (they
    write each tile once, with no atomics)."""
    from pygrid_tpu_torch.parallel import flash_attention as fa

    q, k, v, do = _inputs(shape_q, Lk, dtype, seed, views, Dv)
    scale = shape_q[-1] ** -0.5
    out_r, lse_r = fa.flash_fwd_reference(q, k, v, causal, scale)
    _poison()
    out_k, lse_k = fa.flash_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    tag = (f"{tuple(shape_q)}" + (f" Dv={Dv}" if Dv else "") + f" Lk={Lk} {str(dtype)[6:]} "
           f"causal={causal}" + (" qkv views" if views else ""))
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
    # head dims past 128: the wide kernels' D-slice axis and streamed chunks,
    # in both dtypes, ragged L, Lq != Lk and a strided qkv view
    for shape_q, Lk, causal, views in (
        ((2, 129, 2, 136), 129, True, False),
        ((1, 65, 2, 200), 127, False, False),
        ((2, 128, 2, 256), 128, True, False),
        ((1, 127, 2, 256), 127, True, True),
        ((1, 512, 2, 256), 512, True, False),
        ((1, 129, 1, 512), 129, True, False),
        ((1, 64, 2, 512), 64, False, True),
    ):
        compare_case(shape_q, Lk, torch.bfloat16, causal, views=views)
    for shape_q, Lk, causal in (
        ((1, 129, 2, 136), 129, True),
        ((1, 100, 2, 200), 100, True),
        ((1, 65, 2, 256), 97, False),
        ((1, 65, 1, 512), 65, True),
    ):
        compare_case(shape_q, Lk, torch.float32, causal)
    # values narrower than queries and keys: the narrow-V path (multi-head
    # latent attention's 192/128, and 160/96), ragged L, Lq != Lk and v as
    # the first D_v columns of a strided qkv view; each launch is counted
    # as narrow-V. Then 192/128 in f32 and 256/128 in bf16, which take one
    # width with v zero-padded.
    from pygrid_tpu_torch.parallel import flash_attention as fa

    bf16, f32 = torch.bfloat16, torch.float32
    for shape_q, Dv, Lk, causal, views, dtype in (
        ((2, 129, 2, 192), 128, 129, True, False, bf16),
        ((1, 65, 2, 192), 128, 127, False, False, bf16),
        ((1, 97, 3, 160), 96, 97, True, False, bf16),
        ((2, 127, 2, 192), 128, 127, True, True, bf16),
        ((1, 512, 4, 192), 128, 512, True, False, bf16),
        ((1, 100, 2, 192), 128, 100, True, False, f32),
        ((1, 65, 2, 256), 128, 65, True, False, bf16),
    ):
        fa.reset_launch_counts()
        compare_case(shape_q, Lk, dtype, causal, views=views, Dv=Dv)
        counts, narrow_v = fa.launch_counts(), fa.narrow_v_counts()
        narrow = dtype == bf16 and Dv <= 128 < shape_q[-1] <= 192
        check(all(counts.values()) and narrow_v == (counts if narrow else dict.fromkeys(counts, 0)),
              f"kernels {shape_q} Dv={Dv} {dtype}: launches {counts}, narrow-V {narrow_v}")
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


# head dims past 128 take the wide kernels; timed at the shape with the main
# shape's q bytes: [32, 512, 2, 256] bf16, causal
WIDE_SHAPE = (32, 512, 2, 256)


def phase_timing_wide() -> None:
    """The wide (D > 128) kernels' device time at WIDE_SHAPE beside their
    bound and SDPA's device time at that shape, printed only: the kernels
    line keeps the main shape's numbers."""
    import torch.nn.functional as F

    from pygrid_tpu_torch.parallel import flash_attention as fa

    dtype, causal = torch.bfloat16, True
    q, k, v, do = _inputs(WIDE_SHAPE, WIDE_SHAPE[1], dtype, seed=3)
    scale = WIDE_SHAPE[-1] ** -0.5
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    delta = fa.softmax_delta(out, do)
    dev = {
        "flash_fwd": device_ms(lambda: fa.flash_fwd(q, k, v, causal, scale)),
        "flash_bwd_dkv": device_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal,
                                                            scale)),
        "flash_bwd_dq": device_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal,
                                                          scale)),
    }
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    lib_bwd = device_ms(lambda: torch.autograd.grad(o_sdpa, (qt, kt, vt), dot, retain_graph=True))
    for name, (bound, by, flops, nbytes) in bounds(WIDE_SHAPE, dtype, causal).items():
        lib = lib_fwd if name == "flash_fwd" else lib_bwd
        print(f"[timing wide] {name} {WIDE_SHAPE} bf16 causal: device time {dev[name]:.4f} ms, "
              f"bound {bound:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), "
              f"{dev[name] / bound:.1f}x the bound, {flops / dev[name] / 1e9:.1f} TFLOP/s; "
              + ("SDPA forward" if name == "flash_fwd" else "SDPA backward, all of dq/dk/dv")
              + f" {lib:.4f} ms device time, kernel / library {dev[name] / lib:.2f}")


# the narrow-V kernels at the Moonlight cell's attention: 4 rows of 8,192
# tokens, 16 heads, D_qk 192 (128 nope + 64 rope), D_v 128, bf16, causal
NARROW_V_SHAPE = (4, 8192, 16, 192, 128)


def bounds_narrow_v(shape, dtype, causal):
    """bounds() at two head widths (benchmark/work/mla_flash.py's count):
    S = QK^T and every product with Q or K at D_qk, every product with V or
    dO at D_v; each input read once and each output written once at its own
    width."""
    B, L, H, dqk, dv = shape
    pairs = B * H * causal_pairs(L, L, causal)
    size = torch.tensor([], dtype=dtype).element_size()
    tq, tv, row = B * L * H * dqk * size, B * L * H * dv * size, B * H * L * 4
    work = {
        "flash_fwd": (2 * (dqk + dv) * pairs, 2 * tq + tv + tv + row),
        "flash_bwd_dkv": (4 * (dqk + dv) * pairs, 2 * tq + 2 * tv + 2 * row + tq + tv),
        "flash_bwd_dq": ((4 * dqk + 2 * dv) * pairs, 2 * tq + 2 * tv + 2 * row + tq),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        tf, tb = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = (max(tf, tb), "operations" if tf > tb else "bytes", flops, nbytes)
    return out


def phase_timing_narrow_v() -> None:
    """The narrow-V kernels at NARROW_V_SHAPE: one launch of each, every
    one counted as narrow-V, with its outputs (and lse) at two (b, h)
    slices of the full rows held to the plain versions (one head's score
    matrix is 256 MB); then their device time (under torch.profiler, and
    by events) beside the bound of their true work, and the same attention
    with v zero-padded to D_qk (the wide kernels' two 128-wide slices, as
    the model ran before the narrow-V path), printed only."""
    from pygrid_tpu_torch.parallel import flash_attention as fa

    B, L, H, dqk, dv = NARROW_V_SHAPE
    dtype, causal = torch.bfloat16, True
    q, k, v, do = _inputs((B, L, H, dqk), L, dtype, seed=4, Dv=dv)
    scale = dqk ** -0.5
    fa.reset_launch_counts()
    _poison()
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    delta = fa.softmax_delta(out, do)
    _poison()
    dk, dv_k = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    _poison()
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    counts, narrow_v = fa.launch_counts(), fa.narrow_v_counts()
    check(counts == dict.fromkeys(counts, 1) and narrow_v == counts,
          f"narrow-V {NARROW_V_SHAPE}: launches {counts}, narrow-V {narrow_v}")
    for b, h in ((0, 0), (B - 1, H - 1)):
        def one(x, b=b, h=h):
            return x[b:b + 1, :, h:h + 1]

        row = slice(b * H + h, b * H + h + 1)
        qs, ks, vs, dos = map(one, (q, k, v, do))
        tag = f"narrow-V {NARROW_V_SHAPE} bf16 causal at (b, h) = ({b}, {h})"
        out_r, lse_r = fa.flash_fwd_reference(qs, ks, vs, causal, scale)
        errs = {"flash_fwd": max(_err(one(out), out_r, dtype, f"fwd out {tag}"),
                                 _err(lse[row], lse_r, torch.float32, f"fwd lse {tag}"))}
        dk_r, dv_r = fa.flash_bwd_dkv_reference(qs, ks, vs, dos, lse[row], delta[row], causal,
                                                scale)
        errs["flash_bwd_dkv"] = max(_err(one(dk), dk_r, dtype, f"dk {tag}"),
                                    _err(one(dv_k), dv_r, dtype, f"dv {tag}"))
        dq_r = fa.flash_bwd_dq_reference(qs, ks, vs, dos, lse[row], delta[row], causal, scale)
        errs["flash_bwd_dq"] = _err(one(dq), dq_r, dtype, f"dq {tag}")
        print(f"[kernels] {tag}: " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))
        del out_r, lse_r, dk_r, dv_r, dq_r
    del dk, dv_k, dq
    vp, dop = (torch.nn.functional.pad(x, (0, dqk - dv)) for x in (v, do))
    outp, _ = fa.flash_fwd(q, k, vp, causal, scale)
    deltap = fa.softmax_delta(outp, dop)
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal, scale),
                      lambda: fa.flash_fwd(q, k, vp, causal, scale)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale),
                          lambda: fa.flash_bwd_dkv(q, k, vp, dop, lse, deltap, causal, scale)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale),
                         lambda: fa.flash_bwd_dq(q, k, vp, dop, lse, deltap, causal, scale)),
    }
    for name, (bound, by, flops, nbytes) in bounds_narrow_v(NARROW_V_SHAPE, dtype,
                                                            causal).items():
        narrow, padded = calls[name]
        dev, ev, dev_p = device_ms(narrow), time_ms(narrow, iters=5), device_ms(padded)
        print(f"[timing narrow-V] {name} [{B}, {L}, {H}, {dqk}/{dv}] bf16 causal: device time "
              f"{dev:.4f} ms ({ev:.4f} ms by events), bound {bound:.4f} ms ({by}; "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), {dev / bound:.2f}x the bound "
              f"({100 * bound / dev:.2f} % of it), {flops / dev / 1e9:.1f} TFLOP/s of true work; "
              f"v zero-padded to {dqk} (two 128-wide slices): {dev_p:.4f} ms device time, "
              f"{dev_p / dev:.2f}x")


# the expert layer of the Moonlight cell: T tokens a round, E routed
# experts of which the first HELD are held here, top-k, d_model, moe_ff
MOE_ROWS_SHAPE = dict(T=32768, E=64, held=8, k=6, d=2048, f=1408)


def phase_moe_rows() -> tuple[dict, dict]:
    """The expert layer's six row kernels at MOE_ROWS_SHAPE in bf16 on a
    routed batch (random tokens, a router at the model's scale, bias 0, the
    cell's routed scale; random rows at the dispatch bound M for the
    kernels that read the layer's intermediate rows), each against its
    plain version on the held rows (rows before offs[-1]; the per-token
    outputs everywhere), then its time by CUDA events and by device time
    beside its bound (the bytes it moves at the held rows over 3.35 TB/s)
    and its plain version's time (which runs over all M rows). Returns
    ({kernel: max abs error}, {kernel: timing})."""
    from pygrid_tpu_torch.models import moe

    c = MOE_ROWS_SHAPE
    T, k, d, f = c["T"], c["k"], c["d"], c["f"]
    g = torch.Generator(device="cuda").manual_seed(5)
    x32 = torch.randn(T, d, generator=g, device="cuda")
    wg = torch.randn(c["E"], d, generator=g, device="cuda") * d ** -0.5
    sel, w = moe.route_topk(x32, wg, torch.zeros(c["E"], device="cuda"), k, 2.446)
    order, offs, pos, held = moe.dispatch(sel, 0, c["held"])
    M, n, x = order.shape[0], int(offs[-1]), x32.bfloat16()

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").bfloat16()

    h, o, da, dxs, gy = rnd(M, 2 * f), rnd(M, d), rnd(M, f), rnd(M, d), rnd(T, d)
    dws = torch.randn(M, generator=g, device="cuda")
    calls = {  # kernel: (its call, its plain version's, the output rows compared)
        "moe_gather": (lambda: moe.gather_rows(x, order, offs, k),
                       lambda: moe.gather_reference(x, order, k), n),
        "moe_swiglu_fwd": (lambda: moe.swiglu(h, offs), lambda: moe.swiglu_reference(h), n),
        "moe_combine_fwd": (lambda: moe.combine(o, w, pos, held),
                            lambda: moe.combine_reference(o, w, pos, held), T),
        "moe_rows_bwd": (lambda: moe.rows_bwd(gy, o, w, order, offs, k),
                         lambda: moe.rows_bwd_reference(gy, o, w, order, k), n),
        "moe_swiglu_bwd": (lambda: moe.swiglu_bwd(h, da, offs),
                           lambda: moe.swiglu_bwd_reference(h, da), n),
        "moe_combine_bwd": (lambda: moe.combine_bwd(dxs, dws, pos, held),
                            lambda: moe.combine_bwd_reference(dxs, dws, pos, held), T),
    }
    el, tk = 2, T * k
    nbytes = {  # each input byte read once, each output byte written once, at the held rows
        "moe_gather": n * 8 + 2 * n * d * el,
        "moe_swiglu_fwd": 3 * n * f * el,
        "moe_combine_fwd": tk * (4 + 8 + 1) + n * d * el + T * d * el,
        "moe_rows_bwd": n * (8 + 4) + 3 * n * d * el + n * 4,
        "moe_swiglu_bwd": 5 * n * f * el,
        "moe_combine_bwd": tk * (8 + 1) + n * (d * el + 4) + T * d * el + tk * 4,
    }
    print(f"[moe rows] {card_line()}; T {T}, top-{k} of {c['E']}, {c['held']} held, d {d}, "
          f"f {f}, bf16: {n} held rows of the dispatch bound's {M} ({100 * n / M:.2f} %)")
    moe.reset_launch_counts()
    errs, timing = {}, {}
    for name, (kernel, plain, out_rows) in calls.items():
        got, want = kernel(), plain()
        got, want = (got if isinstance(got, tuple) else (got,)), (
            want if isinstance(want, tuple) else (want,))
        torch.cuda.synchronize()
        err = 0.0
        for a, b in zip(got, want):
            a, b = a[:out_rows].float(), b[:out_rows].float()
            check(bool(torch.isfinite(a).all()), f"moe rows: {name} wrote a non-finite value")
            bad = ((a - b).abs() > 1e-2 + 1e-2 * b.abs()).sum()
            check(int(bad) == 0, f"moe rows: {name}: {int(bad)} entries off its plain version")
            err = max(err, float((a - b).abs().max()))
        errs[name] = err
        del got, want
        bound = nbytes[name] / PEAK_BYTES * 1e3
        ms, dev = time_ms(kernel), device_ms(kernel)
        plain_ms = time_ms(plain, iters=5)
        timing[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
                        "library_ms": None}
        print(f"[timing moe rows] {name}: kernel {ms:.4f} ms (device time {dev:.4f} ms), bound "
              f"{bound:.4f} ms (bytes: {nbytes[name] / 1e6:.1f} MB at the held rows), "
              f"{dev / bound:.2f}x the bound ({nbytes[name] / dev / 1e6:.0f} GB/s), plain "
              f"{plain_ms:.4f} ms over all {M} rows ({plain_ms / ms:.1f}x); max abs error "
              f"against it {err:.3e}")
    counts = moe.launch_counts()
    check(all(v > 0 for v in counts.values()), f"moe rows: a kernel never launched: {counts}")
    del x32, x, w, order, offs, pos, held, gy, h, o, da, dxs, dws
    torch.cuda.empty_cache()
    return errs, timing


# the Moonlight cell of the benchmark, whose every attention takes the
# narrow-V path
MOONLIGHT_CELL = "moonlight-ep8-fedavg-k4-l8192"


def phase_rounds_moonlight() -> dict:
    """One FedAvg round of MOONLIGHT_CELL as the benchmark builds it (its
    configuration, traffic and port loss), after one round of warm-up,
    with the flash kernels' launches counted: one of each kernel per
    layer, every one on the narrow-V path; and the expert layer's row
    kernels: each once per expert layer and direction it runs in (the
    gather and the SwiGLU forward in both, the backward again), with
    held_assignments / bound_rows, the share of the dispatch rows they
    touch, between 0.10 and 0.16. Returns the row kernels' launches."""
    from benchmark import harness, traffic
    from pygrid_tpu_torch.models import moe
    from pygrid_tpu_torch.parallel import flash_attention as fa, make_fused_round

    root = Path(__file__).resolve().parent
    cell = harness.load_cell(root, MOONLIGHT_CELL)
    ctx = harness.RunContext(root=root, cell=cell, seed=7, seconds=1, trace=False,
                             device="cuda", t0=0.0, rank=0, world=1, store=None)
    fam = ctx.family()
    params = fam.init(cell.config, 7, "cuda")
    X, y = traffic.batch(cell.traffic, cell.config, 7, 0, "cuda")
    round_fn = make_fused_round(fam.port_loss(cell.config, cell.spec),
                                local_steps=cell.spec["local_steps"])
    round_fn(params, X, y, cell.spec["lr"])
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    moe.reset_launch_counts()
    moe.reset_moe_counts()
    round_fn(params, X, y, cell.spec["lr"])
    torch.cuda.synchronize()
    counts, narrow_v = fa.launch_counts(), fa.narrow_v_counts()
    layers = cell.config["port"]["n_layers"]
    check(counts == dict.fromkeys(counts, layers) and narrow_v == counts,
          f"{MOONLIGHT_CELL}: one round launched {counts}, narrow-V {narrow_v}, "
          f"expected {layers} of each, all narrow-V")
    print(f"[rounds] {MOONLIGHT_CELL}: one round launched {counts}, narrow-V {narrow_v} "
          f"({layers} layers)")
    rows, n_moe = moe.launch_counts(), layers - cell.config["port"]["n_dense"]
    want = {name: (2 if name in ("moe_gather", "moe_swiglu_fwd") else 1) * n_moe
            for name in moe.ROW_KERNELS}
    mc = moe.moe_counts()
    share = mc["held_assignments"] / mc["bound_rows"]
    print(f"[rounds] {MOONLIGHT_CELL}: row kernels {rows} ({n_moe} expert layers); "
          f"moe_counts {mc}: held_assignments / bound_rows {share:.4f}")
    check(rows == want, f"{MOONLIGHT_CELL}: row kernels launched {rows}, expected {want}")
    check(0.10 <= share <= 0.16, f"{MOONLIGHT_CELL}: held share of the dispatch rows {share}")
    del params, X, y, round_fn
    torch.cuda.empty_cache()
    return rows


# the Trinity cell's attention: [B, L, H query heads, H_kv K/V heads, D], bf16,
# causal, the sliding layers' window of 2,048 keys and the full layers' none
BAND_SHAPE = (4, 8192, 32, 4, 128)
BAND_WINDOW = 2048
# small band cases on the tile edges: (B, L, H, H_kv, D, window)
BAND_CASES = [(1, 161, 4, 1, 128, 70), (2, 97, 8, 2, 64, None), (1, 130, 4, 2, 40, 33),
              (1, 65, 2, 2, 64, 1), (1, 97, 8, 4, 64, 200)]


def _band_inputs(B, L, H, Hk, D, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(heads):
        return torch.randn((B, L, heads, D), generator=g, device="cuda").to(torch.bfloat16)

    return rnd(H), rnd(Hk), rnd(Hk), rnd(H)


def _band_check(q, k, v, do, window, tag, slices):
    """One launch of each kernel with the band, its outputs at the (b, K/V
    head) ``slices`` (each with its group of query heads) held to the plain
    versions; returns the outputs' max abs errors."""
    from pygrid_tpu_torch.parallel import flash_attention as fa

    B, L, H, D = q.shape
    G = H // k.shape[2]
    scale = D ** -0.5
    _poison()
    out, lse = fa.flash_fwd(q, k, v, True, scale, window)
    delta = fa.softmax_delta(out, do)
    _poison()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale, window)
    _poison()
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True, scale, window)
    torch.cuda.synchronize()
    errs = {}
    for b, hk in slices:
        hq = slice(hk * G, hk * G + G)
        rows = slice(b * H + hk * G, b * H + hk * G + G)
        qs, dos = q[b:b + 1, :, hq], do[b:b + 1, :, hq]
        ks, vs = k[b:b + 1, :, hk:hk + 1], v[b:b + 1, :, hk:hk + 1]
        at = f"{tag} at (b, K/V head) = ({b}, {hk})"
        out_r, lse_r = fa.flash_fwd_reference(qs, ks, vs, True, scale, window)
        dk_r, dv_r = fa.flash_bwd_dkv_reference(qs, ks, vs, dos, lse[rows], delta[rows], True,
                                                scale, window)
        dq_r = fa.flash_bwd_dq_reference(qs, ks, vs, dos, lse[rows], delta[rows], True, scale,
                                         window)
        for name, got, ref, dt in (
                ("out", out[b:b + 1, :, hq], out_r, torch.bfloat16),
                ("lse", lse[rows], lse_r, torch.float32),
                ("dk", dk[b:b + 1, :, hk:hk + 1], dk_r, torch.bfloat16),
                ("dv", dv[b:b + 1, :, hk:hk + 1], dv_r, torch.bfloat16),
                ("dq", dq[b:b + 1, :, hq], dq_r, torch.bfloat16)):
            errs[name] = max(errs.get(name, 0.0), _err(got, ref, dt, f"{name} {at}"))
        del out_r, lse_r, dk_r, dv_r, dq_r
    return errs


def phase_timing_band() -> None:
    """The band instantiations (a sliding window, grouped K/V heads): the
    small cases on the tile edges, then BAND_SHAPE with BAND_WINDOW and
    without a window, one launch of each kernel counted by kind, with two
    (b, K/V head) slices held to the plain versions (a group's score
    matrices are 2 GB in f32); then their device time beside
    benchmark/work/window_flash.py's bound."""
    from benchmark.work.window_flash import bounds
    from pygrid_tpu_torch.parallel import flash_attention as fa

    for i, (B, L, H, Hk, D, window) in enumerate(BAND_CASES):
        q, k, v, do = _band_inputs(B, L, H, Hk, D, seed=20 + i)
        tag = f"band [{B}, {L}, {H}/{Hk}, {D}] W {window}"
        errs = _band_check(q, k, v, do, window, tag, [(b, hk) for b in range(B)
                                                      for hk in range(Hk)])
        print(f"[kernels] {tag}: " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))
    B, L, H, Hk, D = BAND_SHAPE
    q, k, v, do = _band_inputs(B, L, H, Hk, D, seed=5)
    scale = D ** -0.5
    for window in (BAND_WINDOW, None):
        tag = f"band {list(BAND_SHAPE)} bf16 causal W {window}"
        fa.reset_launch_counts()
        errs = _band_check(q, k, v, do, window, tag, [(0, 0), (B - 1, Hk - 1)])
        band = fa.band_counts()
        one = dict.fromkeys(fa.launch_counts(), 1)
        check(fa.launch_counts() == one and band["grouped"] == one
              and band["window"] == dict.fromkeys(one, int(window is not None)),
              f"{tag}: launches {fa.launch_counts()}, band {band}")
        print(f"[kernels] {tag}: " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
              + f"; tile pairs {band['tile_pairs']} of causal {band['causal_tile_pairs']} "
              f"({band['tile_pairs'] / band['causal_tile_pairs']:.4f})")
        out, lse = fa.flash_fwd(q, k, v, True, scale, window)
        delta = fa.softmax_delta(out, do)
        calls = {
            "flash_fwd": lambda: fa.flash_fwd(q, k, v, True, scale, window),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale,
                                                      window),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True, scale,
                                                    window),
        }
        for name, (bound, by, flops, nbytes) in bounds((B, L, H, Hk, D), window).items():
            dev, ev = device_ms(calls[name]), time_ms(calls[name], iters=5)
            print(f"[timing band] {name} {list(BAND_SHAPE)} W {window} bf16 causal: device "
                  f"time {dev:.4f} ms ({ev:.4f} ms by events), bound {bound:.4f} ms ({by}; "
                  f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), {100 * bound / dev:.2f} % "
                  f"of it, {flops / dev / 1e9:.1f} TFLOP/s")
        del out, lse, delta
    fa.reset_launch_counts()


# the unbanded launches of the benchmark's other flash cells: GPT-2's
# [B, L, H, D] and Moonlight's narrow-V [B, L, H, D_qk] with D_v
UNBANDED_SHAPES = {"gpt2s-fedavg-k8": ((32, 1024, 12, 64), None),
                   "moonlight-ep8-fedavg-k4-l8192": ((4, 8192, 16, 192), 128)}
# device ms of each kernel at UNBANDED_SHAPES, by the helpers every checkout
# of this file has (run from the checkout's root, printed as one JSON line)
_UNBANDED_PROBE = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as c
from pygrid_tpu_torch.kernels import build
from pygrid_tpu_torch.parallel import flash_attention as fa
build.build_all()
out = {}
for cell, (shape, dv) in %r.items():
    q, k, v, do = c._inputs(shape, shape[1], torch.bfloat16, seed=3, Dv=dv)
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = fa.softmax_delta(o, do)
    for name, fn in (("flash_fwd", lambda: fa.flash_fwd(q, k, v, True, scale)),
                     ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale)),
                     ("flash_bwd_dq", lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True, scale))):
        out[cell + " " + name] = c.device_ms(fn, calls=7)
print("UNBANDED " + json.dumps(out), flush=True)
"""


def phase_unbanded_vs_parent(parent: str) -> None:
    """GPT-2's and Moonlight's flash launches, which take no band, timed in
    this checkout and in the parent's at ``parent`` in turns (parent,
    change, change, parent; one process each); each kernel's device time
    must stay within 1 % of the parent's (summed over both turns). Not in
    main(): it needs the parent's checkout, say ``git archive`` into a
    git-ignored directory."""
    here = Path(__file__).resolve().parent
    code = _UNBANDED_PROBE % (UNBANDED_SHAPES,)
    turns = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent"):
        out = subprocess.run([sys.executable, "-c", code], cwd=parent if side == "parent" else here,
                             capture_output=True, text=True, check=True, timeout=600).stdout
        line = [x for x in out.splitlines() if x.startswith("UNBANDED ")][-1]
        turns[side].append(json.loads(line[len("UNBANDED "):]))
    for key in turns["parent"][0]:
        p = sum(t[key] for t in turns["parent"])
        ch = sum(t[key] for t in turns["change"])
        print(f"[timing unbanded] {key}: parent {p / 2:.4f} ms, change {ch / 2:.4f} ms device "
              f"time ({ch / p:.4f}x)")
        check(ch <= 1.01 * p, f"{key}: {ch / 2:.4f} ms against the parent's {p / 2:.4f}")


TRINITY_CELL = "trinity-mini-ep16-fedavg-k4-l8192"


def phase_rounds_trinity() -> dict:
    """One FedAvg round of TRINITY_CELL as the benchmark builds it, after
    one round of warm-up: one launch of each flash kernel a layer, every
    one grouped and the sliding layers' with the window, the forwards'
    tile pairs those of 9 sliding and 3 full layers; the row kernels once
    per expert layer and direction; the round's peak memory."""
    from benchmark import harness, traffic
    from pygrid_tpu_torch.models import moe
    from pygrid_tpu_torch.parallel import flash_attention as fa, make_fused_round

    root = Path(__file__).resolve().parent
    cell = harness.load_cell(root, TRINITY_CELL)
    port = cell.config["port"]
    ctx = harness.RunContext(root=root, cell=cell, seed=7, seconds=1, trace=False,
                             device="cuda", t0=0.0, rank=0, world=1, store=None)
    fam = ctx.family()
    torch.cuda.reset_peak_memory_stats()
    params = fam.init(cell.config, 7, "cuda")
    X, y = traffic.batch(cell.traffic, cell.config, 7, 0, "cuda")
    round_fn = make_fused_round(fam.port_loss(cell.config, cell.spec),
                                local_steps=cell.spec["local_steps"])
    round_fn(params, X, y, cell.spec["lr"])
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    moe.reset_launch_counts()
    t0 = time.perf_counter()
    new, loss, _ = round_fn(params, X, y, cell.spec["lr"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    layers = port["n_layers"]
    sliding = sum(kind == "sliding_attention" for kind in port["layer_types"])
    counts, band = fa.launch_counts(), fa.band_counts()
    recompute = 2 if cell.spec.get("remat") else 1
    want = {"flash_fwd": recompute * layers, "flash_bwd_dkv": layers, "flash_bwd_dq": layers}
    check(counts == want and band["grouped"] == counts,
          f"{TRINITY_CELL}: launches {counts}, band {band}, expected {want}, all grouped")
    check(band["window"] == {k: n // layers * sliding for k, n in want.items()},
          f"{TRINITY_CELL}: windowed launches {band['window']}, {sliding} sliding layers")
    print(f"[rounds] {TRINITY_CELL}: one round {ms:.1f} ms, loss {float(loss):.4f}, launched "
          f"{counts}, band {band} ({band['tile_pairs'] / band['causal_tile_pairs']:.4f} of "
          f"causal's tile pairs); peak memory {torch.cuda.max_memory_allocated()} B; "
          f"row kernels {moe.launch_counts()}")
    check(bool(torch.isfinite(loss)), f"{TRINITY_CELL}: loss {float(loss)}")
    del params, X, y, round_fn, new
    torch.cuda.empty_cache()
    return counts


#: the faults TRINITY_CELL's limits must fail: ``models/afmoe.py``'s
#: ``layer_attention`` (RoPE, window) of a layer kind, broken
TRINITY_FAULTS = {
    "window_dropped": lambda cfg, kind: (kind == "sliding_attention", None),
    "rope_on_full": lambda cfg, kind: (
        True, cfg.sliding_window if kind == "sliding_attention" else None),
}


def phase_trinity_limits(seeds=(11, 12, 13),
                         sides=("program", *TRINITY_FAULTS, "fp8", "half")) -> None:
    """The readings TRINITY_CELL's limits are set from, at the cell's size,
    each seed's reference computed once: the program as a run checks it, the
    fp8 control and half the clients (``benchmark/calibrate.py``'s sides),
    and the program with the sliding layers' window dropped and with RoPE
    on the full layers too (TRINITY_FAULTS). One JSON line a reading. Not
    in main(): about four minutes a seed.

        python3 -c "import chip_smoke as c; c.phase_build(); c.phase_trinity_limits()"
    """
    from benchmark import harness
    from benchmark.reference import compare
    from pygrid_tpu_torch.models import afmoe
    from pygrid_tpu_torch.parallel import make_fused_round

    root = Path(__file__).resolve().parent
    cell = harness.load_cell(root, TRINITY_CELL)
    single = harness.load_entry(root, "fedavg_round")
    spec, K = cell.spec, cell.traffic["clients"]
    real = afmoe.layer_attention
    for seed in seeds:
        ctx = harness.RunContext(root=root, cell=cell, seed=seed, seconds=1, trace=False,
                                 device="cuda", t0=time.perf_counter())
        fam = ctx.family()
        ref = single.reference_readings(ctx, fam, "cuda")
        for side in sides:
            t0 = time.perf_counter()
            if side == "fp8":
                prog = single.reference_readings(ctx, fam, "cuda", precision="fp8")
            elif side == "half":
                prog = single.reference_readings(ctx, fam, "cuda", clients=K // 2)
            else:
                afmoe.layer_attention = TRINITY_FAULTS.get(side, real)
                try:
                    single.pin_precision()
                    _, params, pool, loss_fn = single.setup(ctx, "cuda")
                    round_fn = make_fused_round(loss_fn, local_steps=spec["local_steps"])
                    _, prog = single.first_rounds(round_fn, params, pool, spec["lr"])
                    del params, pool, round_fn, loss_fn
                finally:
                    afmoe.layer_attention = real
            torch.cuda.empty_cache()
            nums = compare.training_numbers(prog, ref)
            print(json.dumps(dict(seed=seed, side=side, **nums, limits=spec["limits"],
                                  seconds=round(time.perf_counter() - t0, 1))), flush=True)


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
    # the expert layer's row passes (models/moe.py): the top-k layer has no
    # JAX counterpart, so these replace no TPU kernel
    **{name: ("pygrid_tpu_torch/csrc/moe_rows.cu", "none")
       for name in ("moe_gather", "moe_swiglu_fwd", "moe_combine_fwd", "moe_rows_bwd",
                    "moe_swiglu_bwd", "moe_combine_bwd")},
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
    from pygrid_tpu_torch.models import moe
    from pygrid_tpu_torch.parallel import flash_attention as fa
    from pygrid_tpu_torch.smpc import ring_matmul as rm

    return {"flash": fa, "ring": rm, "moe": moe}


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


def phase_rounds(n_rounds=3):
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
    return counts, final


def profiled(fn):
    """(wall µs, the CUDA kernels' key averages) of one call of ``fn``
    under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return wall_us, [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def profile_round(fn, top=12) -> None:
    """Device time by kernel over one more round under torch.profiler (after
    the counted run, so its launches count nowhere), and the device's idle
    share of the round's wall time."""
    wall_us, kernels = profiled(fn)
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
    """``lm.dot_f32`` on bf16 operands takes the card's native product with
    an f32 output (``torch.mm(..., out_dtype=float32)``), at the main
    path's three shapes: the logits [N, d] x [d, vocab] and the CE head's
    two gradient products, the last with a transposed left operand, as
    ``dlogits.T``. Against the f64 product its error must stay under 2^-13
    of the largest value, 1/16 of a bf16 half-ulp there: a result rounded
    through bf16 would miss that 16-fold, an f32-accumulated one meets it
    with room (seen on an H100: 9.7e-5, 4.9e-3 and 1.5e-2 at k = 512, 8192
    and 16384, against limits of 1.8e-2, 6.4e-2 and 7.9e-2; the widened
    f32 product's errors were 8.2e-5, 1.6e-3 and 1.5e-3)."""
    from pygrid_tpu_torch.models import lm

    N = 8 * 4 * cfg.max_len  # K clients x B sequences x L tokens
    g = torch.Generator(device="cuda").manual_seed(seed)
    for m, k, n, t in ((N, cfg.d_model, cfg.vocab, False),
                       (N, cfg.vocab, cfg.d_model, False),
                       (cfg.vocab, N, cfg.d_model, True)):
        a = torch.randn((k, m) if t else (m, k), generator=g, device="cuda")
        a = (a.T if t else a).to(torch.bfloat16)
        b = torch.randn((k, n), generator=g, device="cuda").to(torch.bfloat16)
        got = lm.dot_f32(a, b)
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


def phase_encrypted_mlp():
    """The encrypted 784→392→10 MLP forward at batch 256 through
    ``fix_prec(...).share("alice", "bob", "charlie", crypto_provider=...)``.
    (a) On the card with triples dealt there: the decoded output against the
    float64 plaintext within MLP_ATOL, and 8 ring launches (two matmul
    rounds: the triple's c, then d∘b, a∘e, d∘e). (b) The same input shares,
    triples and truncation pairs, dealt on the CPU and injected through
    ``strict_store`` providers, on the card and on the CPU: every step's
    output shares bit-identical, and 6 launches on the card. Returns the
    launches of (a) and its output (shares on the card)."""
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
    return counts["ring_matmul"], out


# --------------------------------------------------------------------------
# phase 11: the wire and storage plane
# --------------------------------------------------------------------------


def _host_ms(fn):
    """(result, host milliseconds) of ``fn`` after a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_wire(params, mlp_out) -> None:
    """The node's model-hosting path on the main path's model at full width:
    the params after phase rounds leave the card as wire-v2 State blobs (f32
    and bf16), are stored in and read back from a Warehouse on a sqlite
    file, decode zero-copy, come back onto the card bit for bit, seed a
    round that matches one from the in-memory params, fold as bf16 client
    diffs through native.accum_bf16 exactly, pass through a checkpoint and a
    zlib frame unchanged; the encrypted MLP's shares cross too."""
    import dataclasses
    import tempfile
    from functools import partial

    from pygrid_tpu_torch import native, serde
    from pygrid_tpu_torch.checkpoint import export_checkpoint, import_checkpoint
    from pygrid_tpu_torch.models import transformer
    from pygrid_tpu_torch.parallel import flash_attention as fa
    from pygrid_tpu_torch.parallel import make_fused_rounds
    from pygrid_tpu_torch.plans.state import serialize_model_params, unserialize_model_params
    from pygrid_tpu_torch.storage import Database, Warehouse

    check(native.BACKEND == "native", f"native backend is {native.BACKEND!r}, not the C++ one")
    n_params = sum(p.numel() for p in params)
    print(f"[wire] {card_line()}; {len(params)} tensors, {n_params} parameters, native backend "
          f"{native.BACKEND}")

    # 1. the card's params to wire bytes, f32 and bf16
    _, d2h_ms = _host_ms(lambda: [p.cpu() for p in params])
    blob32, ms32 = _host_ms(lambda: serialize_model_params(params))
    blob16, ms16 = _host_ms(lambda: serialize_model_params(params, bf16=True))
    print(f"[wire] device-to-host copy of the params {d2h_ms:.2f} ms; serialize_model_params "
          f"f32 {len(blob32)} B in {ms32:.2f} ms, bf16 {len(blob16)} B in {ms16:.2f} ms "
          f"(host time, each including its own device-to-host copy)")
    check(len(blob16) < 0.55 * len(blob32), "bf16 blob is not about half the f32 blob")
    check(all(serde.serialize(p) == serde.serialize(p.cpu().numpy()) for p in params[:4])
          and serde.serialize(params[0].bfloat16()) == serde.serialize(params[0].bfloat16().cpu()),
          "a tensor on the card does not serialize as its host copy does")

    # 2. a Warehouse row each on a sqlite file, read back
    @dataclasses.dataclass
    class ModelBlob:
        id: int | None = None
        name: str = ""
        value: bytes = b""

    with tempfile.TemporaryDirectory() as tmp:
        wh = Warehouse(ModelBlob, Database(f"{tmp}/node.db"))
        _, store_ms = _host_ms(lambda: [wh.register(name=n, value=b)
                                        for n, b in (("f32", blob32), ("bf16", blob16))])
        (back32, back16), load_ms = _host_ms(
            lambda: [bytes(wh.first(name=n).value) for n in ("f32", "bf16")])
    check(back32 == blob32 and back16 == blob16, "warehouse: blobs read back differ")
    print(f"[wire] warehouse on a sqlite file: 2 rows stored in {store_ms:.2f} ms, read back "
          f"byte-equal in {load_ms:.2f} ms")

    # 3. zero-copy decodes
    before = serde.tensor_copy_count()
    raws, raw_ms = _host_ms(lambda: serde.state_raw_tensors(blob32))
    state, dec_ms = _host_ms(lambda: serde.deserialize(blob32))
    raws16 = serde.state_raw_tensors(blob16)
    copies = serde.tensor_copy_count() - before
    check(copies == 0, f"decode made {copies} tensor copies")
    check(len(raws) == len(raws16) == len(params) and len(state) == len(params),
          "decode: wrong number of tensors")
    check(all(r.kind == "<f4" and tuple(r.shape) == tuple(p.shape) for r, p in zip(raws, params))
          and all(r.kind == "bf16" for r in raws16), "state_raw_tensors: wrong kinds or shapes")
    print(f"[wire] state_raw_tensors {raw_ms:.3f} ms, deserialize {dec_ms:.3f} ms, "
          f"tensor copies {copies}")

    # 4. back onto the card
    got32, up32 = _host_ms(lambda: unserialize_model_params(blob32, device="cuda"))
    got16, up16 = _host_ms(lambda: unserialize_model_params(blob16, device="cuda"))
    check(all(g.is_cuda and torch.equal(g, p) for g, p in zip(got32, params)),
          "f32 params do not come back bit-identical")
    check(all(torch.equal(g, p.to(torch.bfloat16).float()) for g, p in zip(got16, params)),
          "bf16 params are not bit-identical to p.to(bfloat16).float()")
    print(f"[wire] unserialize_model_params onto the card: f32 {up32:.2f} ms, bf16 {up16:.2f} ms; "
          f"f32 bit-identical, bf16 == p.to(bfloat16).float()")

    # 5. the cycle manager's fold: K bf16 client diffs into f64 sums
    K = 8
    g = torch.Generator(device="cuda").manual_seed(11)
    diffs = [[torch.randn(p.shape, generator=g, device="cuda") * 1e-2 for p in params]
             for _ in range(K)]
    blobs = [serialize_model_params(d, bf16=True) for d in diffs]

    def fold():
        sums = [np.zeros(p.numel(), np.float64) for p in params]
        for b in blobs:
            for acc, rt in zip(sums, serde.state_raw_tensors(b)):
                native.accum_bf16(acc, rt.raw)
        return sums

    sums, fold_ms = _host_ms(fold)
    for i, p in enumerate(params):
        want = sum(d[i].to(torch.bfloat16).double() for d in diffs).flatten()
        check(torch.equal(torch.from_numpy(sums[i]).to(want.device), want),
              f"accum_bf16 sum of tensor {i} differs from the f64 sum on the card")
    print(f"[wire] {K} bf16 client diffs ({sum(len(b) for b in blobs)} B) folded into f64 by "
          f"native.accum_bf16 from RawTensors in {fold_ms:.2f} ms; equal to the card's f64 sum")

    # 6. a round from the restored params
    cfg, Kc, B = full_config(), 8, 4
    _, X, y = transformer_setup(cfg, Kc, B, "cuda")
    loss_fn = partial(transformer.loss_and_acc, cfg=cfg, attn_fn=fa.flash_attention,
                      compute_dtype="bfloat16", ce_grad_dtype="bfloat16")
    one_round = make_fused_rounds(loss_fn, n_rounds=1)
    mem_a = one_round(params, X, y, 0.1)[0]
    restored = one_round(got32, X, y, 0.1)[0]
    same = all(torch.equal(a, b) for a, b in zip(mem_a, restored))
    if same:
        print("[wire] a round from the restored f32 params: update bit-identical to the round "
              "from the in-memory params")
    else:
        mem_b = one_round(params, X, y, 0.1)[0]
        spread = max(float((a - b).abs().max()) for a, b in zip(mem_a, mem_b))
        err = max(float((a - b).abs().max()) for a, b in zip(mem_a, restored))
        print(f"[wire] a round from the restored params differs from the in-memory round by "
              f"{err:.3e}; two in-memory rounds differ by {spread:.3e}")
        check(err <= spread, "the restored params' round is further off than the round's own "
              "run-to-run difference")

    # 7. checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        _, exp_ms = _host_ms(lambda: export_checkpoint(params, f"{tmp}/ckpt"))
        ck, imp_ms = _host_ms(lambda: import_checkpoint(f"{tmp}/ckpt", device="cuda"))
    check(all(torch.equal(a, b) for a, b in zip(ck, params)), "checkpoint: params differ")
    print(f"[wire] export_checkpoint {exp_ms:.2f} ms, import_checkpoint {imp_ms:.2f} ms: "
          f"bit-identical")

    # 8. the encrypted MLP's shares
    ast_blob = serde.serialize(mlp_out)
    ast_back = serde.deserialize(ast_blob, device="cuda")
    check(ast_back.shares.is_cuda and torch.equal(ast_back.shares, mlp_out.shares)
          and ast_back.owners == mlp_out.owners, "AdditiveSharingTensor: shares differ")
    print(f"[wire] the encrypted MLP's output shares {tuple(mlp_out.shares.shape)}: "
          f"{len(ast_blob)} B, deserialized onto the card bit-identical")

    # 9. a wire-v2 zlib frame
    frame, enc_ms = _host_ms(lambda: serde.encode_frame(blob32, "zlib"))
    body, dec_ms = _host_ms(lambda: serde.decode_frame(frame))
    check(bytes(body) == blob32, "zlib frame: payload differs")
    print(f"[wire] zlib frame {len(frame)} B ({len(frame) / len(blob32):.4f} of the blob), "
          f"encoded in {enc_ms:.2f} ms, decoded unchanged in {dec_ms:.2f} ms")


# --------------------------------------------------------------------------
# phase 12: the model-centric FL cycle
# --------------------------------------------------------------------------

# the list dialect's tolerance (the tests' own, tests/test_torch_plans.py):
# f32 with TF32 off, the op-list interpreter against the direct step, the
# torch.export program and the same list on the CPU
FL_TOL = (2e-4, 2e-5)
LR_FL = 0.005  # phase fl's learning rate


def _fl_batch(kind, cycle, worker, device, B=64):
    """A worker's synthetic MNIST-shaped batch, seeded by (cycle, worker):
    X in [0, 1) (NHWC images for the CNN, flat for the MLP), one-hot y."""
    g = torch.Generator().manual_seed(1000 * cycle + worker)
    shape = (B, 28, 28, 1) if kind == "cnn" else (B, 784)
    X = torch.rand(shape, generator=g)
    y = torch.eye(10)[torch.randint(0, 10, (B,), generator=g)]
    return X.to(device), y.to(device)


def _fl_close(a, b) -> bool:
    rtol, atol = FL_TOL
    return len(a) == len(b) and all(
        x.shape == y.shape and bool(torch.allclose(x.float().cpu(), y.float().cpu(),
                                                   rtol=rtol, atol=atol))
        for x, y in zip(a, b))


def _fl_max_err(a, b) -> float:
    return max(float((x.float().cpu() - y.float().cpu()).abs().max()) for x, y in zip(a, b))


def _fl_tol_share(a, b) -> float:
    """The largest |a - b| / (atol + rtol |b|) over every element: the share
    of the dialect's tolerance the worst element uses (within it: <= 1)."""
    rtol, atol = FL_TOL
    return max(float(((x.double().cpu() - y.double().cpu()).abs()
                      / (atol + rtol * y.double().cpu().abs())).max()) for x, y in zip(a, b))


def phase_fl(device="cuda") -> dict:
    """The port's model-centric FL cycle on the card at full width: a port
    FLController on a sqlite file hosts three processes — A, the committed
    JAX-built CNN training plan (its "list" variant); B, the same CNN plan
    built by the port from cnn.training_step on the CPU (its "torchscript"
    variant, a torch.export program); C, the committed JAX-built 784-392-10
    MLP plan ("list") — each for 2 cycles of 8 workers at batch 64. Every
    worker runs its own protocol steps and trains on the card; every
    checkpoint is held against an f64 computation on the card.
    (``device="cpu"`` rehearses the phase on a host without one.)"""
    import tempfile
    from functools import partial
    from pathlib import Path

    from pygrid_tpu_torch import serde
    from pygrid_tpu_torch.federated import FLController, tasks
    from pygrid_tpu_torch.models import cnn, mlp
    from pygrid_tpu_torch.plans import Plan
    from pygrid_tpu_torch.plans.state import (
        host_model_params,
        serialize_model_params,
        unserialize_model_params,
    )
    from pygrid_tpu_torch.plans.translators import count_ops, run_oplist
    from pygrid_tpu_torch.storage import Database
    from pygrid_tpu_torch.utils import exceptions as E
    from pygrid_tpu_torch.utils import profiling
    from pygrid_tpu_torch.utils.codes import CYCLE

    B, LR, K, CYCLES = 64, LR_FL, 8, 2
    fixtures = Path(__file__).resolve().parent / "pygrid_tpu_torch" / "plans" / "fixtures"
    cnn_params = cnn.init(torch.Generator().manual_seed(0), device=device)
    mlp_params = mlp.init((784, 392, 10), generator=torch.Generator().manual_seed(1),
                          device=device)
    lr_t = torch.tensor(LR, device=device)

    # B's plan: traced and exported by the port on the CPU
    cpu_example = (torch.zeros(B, 28, 28, 1), torch.zeros(B, 10), torch.tensor(LR),
                   *[p.cpu() for p in cnn_params])
    torch_plan, build_ms = _host_ms(
        lambda: Plan(name="training_plan", fn=cnn.training_step).build(*cpu_example))
    processes = {
        "mnist-cnn-list": ("cnn", (fixtures / "cnn_training_plan.bin").read_bytes(),
                           cnn_params, "list"),
        "mnist-cnn-torch": ("cnn", serde.serialize(torch_plan), cnn_params, "torchscript"),
        "mnist-mlp-list": ("mlp", (fixtures / "mlp_training_plan.bin").read_bytes(),
                           mlp_params, "list"),
    }
    print(f"[fl] {card_line()}; plans: {', '.join(f'{n} {len(v[1])} B' for n, v in processes.items())}"
          f"; B's plan built on the CPU in {build_ms:.1f} ms (make_fx + torch.export)")
    server_config = {"min_workers": K, "max_workers": K, "min_diffs": K, "max_diffs": K,
                     "num_cycles": CYCLES, "cycle_length": None, "minimum_upload_speed": 0,
                     "minimum_download_speed": 0}
    steps = ("assign", "model", "plan", "deserialize", "train", "report")
    host_ms = {name: {step: [] for step in steps} for name in processes}
    direct = {"cnn": cnn.training_step, "mlp": mlp.training_step}
    agg_before = profiling.stats.snapshot().get("cycle.aggregate", {}).get("count", 0)
    tasks.set_sync(True)  # the K-th report aggregates before it returns

    counters = _counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        ctl = FLController(Database(f"{tmp}/node.db"))
        pids = {}
        for name, (kind, blob, params, _) in processes.items():
            pids[name] = ctl.create_process(
                model_blob=serialize_model_params(params),
                client_plans={"training_plan": blob}, name=name, version="1.0",
                client_config={"name": name, "version": "1.0", "batch_size": B, "lr": LR,
                               "max_updates": 1},
                server_config=dict(server_config)).id
        for name in processes:
            for w in range(K):
                worker = ctl.worker_manager.create(f"{name}-w{w}")
                worker.avg_upload = worker.avg_download = 100.0
                ctl.worker_manager.update(worker)
        first_diffs = {}
        for cycle in range(CYCLES):
            for name, (kind, _, _, variant) in processes.items():
                model = ctl.model_manager.get(fl_process_id=pids[name])
                old = host_model_params(
                    ctl.model_manager.load(model_id=model.id, alias="latest").value)
                diffs = []
                for w in range(K):
                    t = host_ms[name]
                    worker = ctl.worker_manager.get(id=f"{name}-w{w}")
                    resp, ms = _host_ms(lambda: ctl.assign(name, "1.0", worker))
                    t["assign"].append(ms)
                    check(resp[CYCLE.STATUS] == CYCLE.ACCEPTED, f"{name}: worker {w} rejected")
                    params, ms = _host_ms(lambda: unserialize_model_params(
                        ctl.model_manager.load_encoded(resp["model_id"],
                                                       precision="bf16" if w == 0 else None),
                        device=device))
                    t["model"].append(ms)
                    pblob, ms = _host_ms(lambda: ctl.plan_manager.get_variant(
                        resp[CYCLE.PLANS]["training_plan"], variant))
                    t["plan"].append(ms)
                    if variant == "list":
                        oplist, ms = _host_ms(lambda: serde.deserialize(pblob))
                        step = partial(run_oplist, oplist, device=device)
                    else:
                        plan, ms = _host_ms(lambda: ctl.plan_manager.deserialize_plan(pblob))
                        step = partial(plan, device=device)
                    t["deserialize"].append(ms)
                    X, y = _fl_batch(kind, cycle, w, device)
                    out, ms = _host_ms(lambda: step(X, y, lr_t, *params))
                    t["train"].append(ms)
                    check(_finite(*out) and 0.0 <= float(out[1]) <= 1.0,
                          f"{name}: worker {w} output not finite or acc outside [0, 1]")
                    if w == 0:  # the plan against the direct step and, for a list, the CPU
                        ref = direct[kind](X, y, lr_t, *params)
                        check(_fl_close(out, ref), f"{name}: plan differs from {kind}."
                              f"training_step on the card by {_fl_max_err(out, ref):.3e}")
                        msg = f"[fl] {name} cycle {cycle}: plan vs {kind}.training_step on the card " \
                              f"{_fl_max_err(out, ref):.3e}"
                        if variant == "list":
                            cpu = run_oplist(oplist, X.cpu(), y.cpu(), LR,
                                             *[p.cpu() for p in params], device="cpu")
                            check(_fl_close(out, cpu), f"{name}: the list on the card differs "
                                  f"from the CPU by {_fl_max_err(out, cpu):.3e}")
                            msg += f", vs the same list on the CPU {_fl_max_err(out, cpu):.3e}"
                        print(msg)

                    def report():
                        diff = [(p - n).cpu() for p, n in zip(params, out[2:])]
                        ctl.submit_diff(f"{name}-w{w}", resp[CYCLE.KEY],
                                        serialize_model_params(diff))
                        return diff
                    diff, ms = _host_ms(report)
                    t["report"].append(ms)
                    diffs.append(diff)
                    if cycle == 0:
                        first_diffs.setdefault(name, []).append((out, diff))
                # the checkpoint against old params minus the f64 mean, on the card
                new = ctl.model_manager.load(model_id=model.id, alias="latest")
                check(new.number == cycle + 2, f"{name}: checkpoint {new.number} after cycle {cycle}")
                got = [torch.from_numpy(np.array(a)).to(device) for a in host_model_params(new.value)]
                exact, worst = True, 0.0
                for i, (o, g) in enumerate(zip(old, got)):
                    mean64 = sum(d[i].to(device).double() for d in diffs) / K
                    o32 = torch.from_numpy(np.array(o)).to(device)
                    want64 = o32.double() - mean64
                    exact &= bool(torch.equal(g, o32 - mean64.float()))
                    ulp = torch.finfo(torch.float32).eps * (o32.double().abs() + mean64.abs())
                    err = (g.double() - want64).abs()
                    check(bool((err <= ulp).all()), f"{name}: checkpoint tensor {i} is off the f64 "
                          f"mean by {float(err.max()):.3e}")
                    worst = max(worst, float((err / ulp.clamp_min(1e-45)).max()))
                print(f"[fl] {name} cycle {cycle}: checkpoint {new.number} == old - mean of {K} "
                      f"diffs: within f32 rounding of the f64 value on the card (worst "
                      f"{worst:.3f} of its bound); bit-identical to old - f32(f64 mean): {exact}")
        for name in processes:
            try:
                ctl.cycle_manager.last(pids[name])
            except E.CycleNotFoundError:
                continue
            raise RuntimeError(f"{name}: a cycle is still open after {CYCLES} cycles")
        torch.cuda.synchronize()
        launches = {k: n for c in counters.values() for k, n in c.launch_counts().items()}
    check(not any(launches.values()), f"the FL path launched hand-written kernels: {launches}")
    # A and B on the same inputs (cycle 0: the same params and batches)
    a_runs, b_runs = first_diffs["mnist-cnn-list"], first_diffs["mnist-cnn-torch"]
    ab = max(max(_fl_max_err(oa, ob), _fl_max_err(da, db))
             for (oa, da), (ob, db) in zip(a_runs, b_runs))
    check(all(_fl_close(oa, ob) and _fl_close(da, db) for (oa, da), (ob, db) in zip(a_runs, b_runs)),
          f"processes A and B differ on the same inputs by {ab:.3e}")
    agg = profiling.stats.snapshot().get("cycle.aggregate", {})
    print(f"[fl] {len(processes)} processes x {CYCLES} cycles x {K} workers done; no cycle open; "
          f"A vs B on the same inputs (outputs and diffs) max abs {ab:.3e}; hand-written kernel "
          f"launches on this path: {sum(launches.values())} {launches}; cycle.aggregate "
          f"{agg.get('count', 0) - agg_before} runs, mean {agg.get('mean_s', 0) * 1e3:.3f} ms")
    medians = {}
    for name in processes:
        med = medians[name] = {step: statistics.median(v) for step, v in host_ms[name].items()}
        print(f"[fl] {name} host ms per protocol step, median over {K * CYCLES} workers: "
              + ", ".join(f"{k} {v:.3f}" for k, v in med.items()))
    print("[fl] (a worker's train step is its plan's first call: for the torchscript variant "
          "it includes torch.export.load of the program)")

    # the plan's device time at batch 64, three ways
    X, y = _fl_batch("cnn", 9, 0, device)
    cnn_list = serde.deserialize(processes["mnist-cnn-list"][1]).oplist
    exported = serde.deserialize(processes["mnist-cnn-torch"][1])
    ways = {
        "list-dialect interpreter": lambda: run_oplist(cnn_list, X, y, lr_t, *cnn_params,
                                                       device=device),
        "torch.export program": lambda: exported(X, y, lr_t, *cnn_params, device=device),
        "direct cnn.training_step": lambda: cnn.training_step(X, y, lr_t, *cnn_params),
    }
    fresh = serde.deserialize(processes["mnist-cnn-torch"][1])
    _, first_ms = _host_ms(lambda: fresh(X, y, lr_t, *cnn_params, device=device))
    _, again_ms = _host_ms(lambda: fresh(X, y, lr_t, *cnn_params, device=device))
    print(f"[fl] torch.export program: first call after deserialize {first_ms:.3f} ms "
          f"(load, device rewrite, run), second call {again_ms:.3f} ms (host time)")
    for way, fn in ways.items():
        dms, ems = device_ms(fn), time_ms(fn, iters=10, repeats=5)
        print(f"[fl] CNN training step at batch {B}, {way}: device {dms:.4f} ms, events "
              f"{ems:.4f} ms per step")
    mlp_list = serde.deserialize(processes["mnist-mlp-list"][1]).oplist
    print(f"[fl] ops per list-dialect run: CNN {count_ops(cnn_list)}, MLP {count_ops(mlp_list)}")
    check_f32_pin(cnn_list, X, y, cnn_params, device)
    return medians


def _tf32_flags() -> tuple[bool, bool]:
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _set_tf32(cudnn: bool, matmul: bool) -> None:
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


def check_f32_pin(oplist, X, y, params, device) -> None:
    """The port computes f32 as f32 whatever the caller set: with both TF32
    flags switched on beforehand, phase fl's CNN list step through the
    port's entry point (``run_oplist``, whose ``resolve`` pins f32) agrees
    with the same step on the CPU at the dialect's tolerance. First, the
    size of the fault the pin removes: the same step with TF32 forced on
    for that one call (the pin bypassed), against the CPU."""
    from pygrid_tpu_torch import device as port_device
    from pygrid_tpu_torch.plans.translators import run_oplist

    cpu = run_oplist(oplist, X.cpu(), y.cpu(), LR_FL, *[p.cpu() for p in params], device="cpu")
    saved = _tf32_flags()
    pin = port_device.pin_f32
    try:
        port_device.pin_f32 = lambda: None  # TF32 stays on for this one call
        _set_tf32(True, True)
        unpinned = run_oplist(oplist, X, y, LR_FL, *params, device=device)
        torch.cuda.synchronize()
        check(_tf32_flags() == (True, True), "fl f32 pin: the bypass did not keep TF32 on")
    finally:
        port_device.pin_f32 = pin
        _set_tf32(*saved)
    print(f"[fl] f32 pin: the CNN list step with cuDNN and cuBLAS TF32 forced on (pin bypassed) "
          f"differs from the CPU by {_fl_max_err(unpinned, cpu):.3e} (max abs; dialect tolerance "
          f"rtol {FL_TOL[0]:g} / atol {FL_TOL[1]:g}: within it: {_fl_close(unpinned, cpu)}, "
          f"the worst element at {_fl_tol_share(unpinned, cpu):.4f} of its bound)")
    try:
        _set_tf32(True, True)  # the worst a caller's script can do
        pinned = run_oplist(oplist, X, y, LR_FL, *params, device=device)
        torch.cuda.synchronize()
        after = _tf32_flags()
    finally:
        _set_tf32(*saved)
    check(after == (False, False), f"fl f32 pin: resolve left the TF32 flags at {after}")
    check(_fl_close(pinned, cpu), f"fl f32 pin: with TF32 switched on beforehand, the CNN list "
          f"step differs from the CPU by {_fl_max_err(pinned, cpu):.3e}")
    print(f"[fl] f32 pin: with both TF32 flags switched on beforehand, run_oplist(device="
          f"{str(device)!r}) pinned them off and the CNN list step agrees with the CPU at the "
          f"dialect tolerance (max abs {_fl_max_err(pinned, cpu):.3e}, the worst element at "
          f"{_fl_tol_share(pinned, cpu):.4f} of its bound)")



# --------------------------------------------------------------------------
# phase 13: the data-centric plane
# --------------------------------------------------------------------------

# the float ops of the worker's float path, card against CPU: f32 with TF32
# off, products of up to 784 terms summed in other orders
DC_TOL = (1e-5, 1e-5)
DC_SEED = 21


def _dc_grid(device, provider):
    """alice, bob and charlie holding shares and dan, the crypto provider,
    dialed into each, all on ``device``."""
    from pygrid_tpu_torch.runtime import VirtualWorker

    holders = [VirtualWorker(n, device=device) for n in PARTIES]
    dan = VirtualWorker("dan", device=device)
    dan.crypto_provider = provider
    for h in holders:
        dan.add_worker(h)
    return holders, dan


def _dc_profile_line(tag, fn, n=3) -> float:
    """Host ms per call (median of ``n``), then one call under
    torch.profiler: its wall, device busy time, idle share and the ring
    kernel's share of the busy time, printed. Returns the host ms."""
    host = statistics.median(_host_ms(fn)[1] for _ in range(n))
    wall_us, kernels = profiled(fn)
    busy_us = sum(e.self_device_time_total for e in kernels)
    head = f"[datacentric] {tag}: host {host:.3f} ms per forward (median of {n})"
    if busy_us == 0:
        print(f"{head}; device time not measured (the profiler saw none)")
        return host
    ring_us = sum(e.self_device_time_total for e in kernels if "ring_matmul" in e.key)
    print(f"{head}; profiled call wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} "
          f"ms, idle share {1 - busy_us / wall_us:.4f}, ring kernel {ring_us / busy_us:.2%} of "
          f"the busy time")
    return host


def phase_datacentric(device="cuda") -> tuple[int, np.ndarray, float]:
    """The data-centric plane on the card at full width: the committed
    JAX-built CryptoNets plan (examples/encrypted_inference.py's forward at
    x [256, 784], 784→392→10) as the reference's cross-node flow over four
    in-process workers on ``device`` — alice, bob and charlie hold the
    shares, dan deals. (a) ``EncryptedModel.predict``: the decoded output
    against float64 within MLP_ATOL and 16 ring launches; host ms, device
    busy time, idle share and the ring kernel's share, beside phase mlp's
    class-API forward on the same inputs. (b) The same input shares, triples
    and truncation pairs on a CPU set of workers and a card set: every
    party's shares bit-identical at every step, 14 launches on the card.
    (c) The pointer plane: the float ops on alice against the CPU, a move
    to bob keeping a private tensor private, and the holders' stores
    written through to a sqlite file, recovered by new workers onto the
    card and run again, bit for bit. Returns (a)'s launches, its first
    decoded output and its host ms per forward."""
    import tempfile
    from pathlib import Path

    from pygrid_tpu_torch import serde
    from pygrid_tpu_torch.datacentric import SqliteKV, recover_objects, set_persistent_mode
    from pygrid_tpu_torch.runtime import PointerTensor, VirtualWorker, send
    from pygrid_tpu_torch.smpc import (AdditiveSharingTensor, CryptoProvider, CryptoStore,
                                       EncryptedModel, FixedPointEncoder, RemoteCryptoProvider,
                                       RemoteSharedTensor, fix_prec, fix_prec_share_to_nodes)
    from pygrid_tpu_torch.utils.exceptions import GetNotPermittedError

    fixture = Path(__file__).resolve().parent / "pygrid_tpu_torch" / "plans" / "fixtures"
    plan = serde.deserialize((fixture / "cryptonets_plan.bin").read_bytes(), device=device)
    check(plan.oplist is not None, "datacentric: the fixture plan has no op-list")
    x, w1, b1, w2, b2 = plain = mlp_plaintext()
    weights = [w1, b1[0], w2, b2[0]]  # the plan's biases are [392] and [10]
    want = mlp_forward(*plain)[-1]
    encoder = FixedPointEncoder()

    # (a) encrypted inference through EncryptedModel
    holders, dan = _dc_grid(device, CryptoProvider(seed=DC_SEED, device=device))
    provider = RemoteCryptoProvider(dan)
    gw = torch.Generator(device=device).manual_seed(DC_SEED)
    shared = [fix_prec_share_to_nodes(w, holders, crypto_provider=dan, generator=gw,
                                      device=device) for w in weights]
    model = EncryptedModel(plan, shared, holders, provider, encoder, device=device)
    first, counts, secs = counted(
        lambda: model.predict(x, generator=torch.Generator(device=device).manual_seed(1)), "ring")
    err = float(np.abs(first - want).max())
    print(f"[datacentric] {card_line()}; encrypted CryptoNets forward of the JAX-built plan "
          f"({len(plan.oplist['eqns'])} ops), batch 256, 3 holders + a provider on {device}: "
          f"{secs * 1e3:.3f} ms (first call), launches {counts}, decoded max abs err vs float64 "
          f"{err:.4e} (limit {MLP_ATOL:.4e})")
    check(first.shape == want.shape and bool(np.isfinite(first).all()),
          "datacentric: bad decoded output")
    check(err <= MLP_ATOL, f"datacentric: decoded output {err:.3e} from float64, "
          f"limit {MLP_ATOL:.3e}")
    check(counts["ring_matmul"] == 16,
          f"datacentric: {counts['ring_matmul']} ring launches a forward, expected 16")
    predict_ms = _dc_profile_line("EncryptedModel.predict (pointers, messages, 4 workers)",
                                  lambda: model.predict(x))
    class_provider = CryptoProvider(seed=5, device=device)
    class_in = [fix_prec(v).share(*PARTIES, crypto_provider=class_provider, generator=gw,
                                  device=device) for v in plain]
    _dc_profile_line("phase mlp's class-API forward on the same inputs",
                     lambda: mlp_forward(*class_in)[-1].get())
    # the kernel at this path's two launch shapes (8 launches a forward each),
    # by events: a profiler session of one such short launch sees no device
    # time on the card
    from pygrid_tpu_torch.smpc import ring as R
    from pygrid_tpu_torch.smpc import ring_matmul as rm

    g = torch.Generator(device=device).manual_seed(DC_SEED + 3)
    for M, K, N in ((256, 784, 392), (256, 392, 10)):
        a, b = R.ring_random(g, (M, K)), R.ring_random(g, (K, N))
        ms = time_ms(lambda: rm.ring_matmul_kernel(a, b))
        bound, by, ops, _ = ring_bound(1, M, K, N)
        print(f"[datacentric] ring kernel at [{M}, {K}] @ [{K}, {N}]: {ms:.4f} ms a launch "
              f"(events, back to back), bound {bound:.4f} ms ({by}; {ops / 1e9:.2f} G int8 "
              f"ops), {ms / bound:.1f}x the bound")

    # (b) card against CPU on injected shares, triples and truncation pairs
    scale = encoder.scale
    dealer = CryptoProvider(seed=DC_SEED + 1, device="cpu")
    # two sets of workers: "cpu" on the CPU, "card" on the card
    stacks = {side: _dc_grid(dev, CryptoProvider(strict_store=True, device=dev))
              for side, dev in (("cpu", "cpu"), ("card", device))}
    for op, sx, sy, ts in mlp_steps():
        items = [(CryptoStore.key(op, sx, sy, 3), dealer.triple(op, sx, sy, 3)),
                 (CryptoStore.key("trunc", ts, (scale,), 3), dealer.trunc_pair(ts, scale, 3))]
        for key, item in items:
            for _, d in stacks.values():
                d.crypto_provider.store.put(key, tuple(t.to(d.device) for t in item))
    g_cpu = torch.Generator().manual_seed(DC_SEED + 2)
    values = [AdditiveSharingTensor.share(v, PARTIES, encoder=encoder, generator=g_cpu,
                                          device="cpu").shares for v in [x] + weights]
    inputs = {side: [RemoteSharedTensor([send(sh[i].to(d.device), hs[i]) for i in range(3)],
                                        encoder, RemoteCryptoProvider(d), device=d.device)
                     for sh in values]
              for side, (hs, d) in stacks.items()}
    t0 = time.perf_counter()
    cpu_steps = mlp_forward(*inputs["cpu"])
    cpu_s = time.perf_counter() - t0
    dev_steps, counts_b, secs_b = counted(lambda: mlp_forward(*inputs["card"]), "ring")
    for k, (c, d) in enumerate(zip(cpu_steps, dev_steps)):
        for i, (pc, pd) in enumerate(zip(c.pointers, d.pointers)):
            sc, sd = pc.get(delete=False), pd.get(delete=False)
            check(sd.device.type == torch.device(device).type and torch.equal(sd.cpu(), sc),
                  f"datacentric parity: step {k}, party {PARTIES[i]}: shares differ")
    check(counts_b["ring_matmul"] == 14,
          f"datacentric parity: {counts_b['ring_matmul']} launches, expected 14")
    print(f"[datacentric] injected shares, triples and truncation pairs: {device} "
          f"({secs_b * 1e3:.3f} ms, launches {counts_b}) and CPU ({cpu_s * 1e3:.1f} ms) party "
          f"shares bit-identical at all 3 steps, every party")

    # (c) the pointer plane at the same width
    alice, bob = VirtualWorker("alice", device=device), VirtualWorker("bob", device=device)
    alice.add_worker(bob)
    ref = VirtualWorker("alice", device="cpu")
    xf, wf, bf = (v.astype(np.float32) for v in (x, w1, b1[0]))
    cases = [("__add__", [xf, xf], {}), ("__sub__", [xf, xf[::-1].copy()], {}),
             ("__mul__", [xf, xf], {}), ("__truediv__", [xf, np.asarray(3.0)], {}),
             ("__matmul__", [xf, wf], {}), ("__neg__", [xf], {}), ("sum", [xf], {"axis": 0}),
             ("mean", [xf], {}), ("max", [xf], {"axis": 1}), ("min", [xf], {}),
             ("exp", [xf], {}), ("log", [xf], {}), ("tanh", [xf], {}), ("sqrt", [xf], {}),
             ("abs", [xf - 0.5], {}), ("sigmoid", [xf], {}), ("relu", [xf - 0.5], {}),
             ("t", [xf], {}), ("reshape", [xf, 784, 256], {}),
             ("broadcast_to", [bf], {"shape": [256, 392]}), ("argmax", [xf], {"axis": 1}),
             ("softmax", [xf], {})]
    worst = 0.0
    for op, args, kw in cases:
        # tensors are sent, 0-d values and ints go as literals
        got, cpu_out = (send(args[0], w).remote_op(
            op, *[send(a, w) if np.ndim(a) else a for a in args[1:]], **kw).get()
            for w in (alice, ref))
        check(got.device.type == torch.device(device).type and got.dtype == cpu_out.dtype
              and got.shape == cpu_out.shape, f"pointer plane: {op} dtype/shape/device differ")
        check(torch.allclose(got.cpu(), cpu_out, rtol=DC_TOL[0], atol=DC_TOL[1]),
              f"pointer plane: {op} differs from the CPU beyond rtol/atol {DC_TOL}")
        if got.dtype.is_floating_point:
            worst = max(worst, float((got.cpu() - cpu_out).abs().max()))
    px = send(xf, alice, tags=("#x",))
    moved = px.move(bob)
    check(px.id_at_location not in alice.store
          and bob.store.get_obj(moved.id_at_location).value.device.type
          == torch.device(device).type, "pointer plane: move left a copy or left the card")
    priv = send(xf, alice, allowed_users=("ana",), user="ana")
    mpriv = PointerTensor(alice, priv.id_at_location, owner_user="ana").move(bob)
    try:
        PointerTensor(bob, mpriv.id_at_location).get()
        leaked = True
    except GetNotPermittedError:
        leaked = False
    check(not leaked and bob.store.get_obj(mpriv.id_at_location).allowed_users == {"ana"},
          "pointer plane: a private tensor is readable after its move")
    check(torch.equal(mpriv.get().cpu(), torch.from_numpy(xf))
          and torch.equal(moved.get().cpu(), torch.from_numpy(xf)),
          "pointer plane: moved values differ")
    print(f"[datacentric] pointer plane: {len(cases)} float ops on alice ({device}) match the "
          f"CPU within rtol/atol {DC_TOL} (worst {worst:.3e}); move to bob on the card, a "
          f"private tensor stays private, get bit-identical")

    with tempfile.TemporaryDirectory() as tmp:
        kv_path = f"{tmp}/objects.db"
        _, write_ms = _host_ms(lambda: [set_persistent_mode(h, SqliteKV(kv_path))
                                        for h in holders])
        fresh = [VirtualWorker(h.id, device=device) for h in holders]
        restored, read_ms = _host_ms(lambda: [recover_objects(w, SqliteKV(kv_path))
                                              for w in fresh])
        for old, new in zip(holders, fresh):
            check(sorted(old.store.ids()) == sorted(new.store.ids()),
                  f"recovery: {old.id}'s objects differ")
            for i in old.store.ids():
                a, b = old.store.get_obj(i).value, new.store.get_obj(i).value
                check(isinstance(b, torch.Tensor) and b.device.type == torch.device(device).type
                      and torch.equal(a, b), f"recovery: {old.id}'s object {i} differs")
        new_dan = VirtualWorker("dan", device=device)
        new_dan.crypto_provider = CryptoProvider(seed=DC_SEED, device=device)
        for w in fresh:
            new_dan.add_worker(w)
        new_provider = RemoteCryptoProvider(new_dan)
        handles = [RemoteSharedTensor([PointerTensor(w, p.id_at_location, shape=p.shape)
                                       for w, p in zip(fresh, st.pointers)],
                                      encoder, new_provider, device=device) for st in shared]
        again = EncryptedModel(plan, handles, fresh, new_provider, encoder, device=device).predict(
            x, generator=torch.Generator(device=device).manual_seed(1))
    check(np.array_equal(again, first), "recovery: the forward on the recovered shares differs "
          "from (a)'s first forward")
    print(f"[datacentric] the holders' {sum(restored)} objects written through to a sqlite file "
          f"({write_ms:.2f} ms) and recovered onto the card by new workers ({read_ms:.2f} ms), "
          f"all bit-identical; (a)'s forward on them decodes to the same output bit for bit")
    held = [holders[0].store.get_obj(i).value for i in holders[0].store.ids()]
    print(f"[datacentric] {holders[0].id} holds {len(held)} objects, "
          f"{sum(v.numel() * v.element_size() for v in held) / 1e6:.3f} MB: {len(weights)} "
          f"weight shares and what the forwards left (nothing deletes intermediate shares)")
    return counts["ring_matmul"], first, predict_ms


# --------------------------------------------------------------------------
# phase 14: serving
# --------------------------------------------------------------------------

# a greedy divergence between the engine and generate() is allowed only
# where generate()'s own top-2 logit gap is at most this share of its
# largest |logit|: cuBLAS may pick another kernel for a width-8 step than
# for generate()'s batch of 1, and another rounding flips a near tie
SERVE_TIE = 1e-4
# the card against the CPU: f32 logits at rtol and atol 1e-4
SERVE_CPU_TOL = 1e-4


def _serve_cases(cfg, rng, n=8, base_new=48):
    """bench_serving's traffic: ``n`` single-row prompts of 2–9 tokens,
    every request a distinct n_new from ``base_new`` up."""
    return [(rng.randint(0, cfg.vocab, size=(1, int(rng.randint(2, 10)))).astype(np.int32),
             base_new + i) for i in range(n)]


def _logits_at(params, cfg, prompt, toks, j, device):
    """generate()'s logits for its token ``j``: the prefill of ``prompt``
    and ``j`` decode steps fed generate()'s own tokens, as generate() ran
    them (batch 1, f32)."""
    from pygrid_tpu_torch.models import decode

    cache = decode.init_cache(cfg, 1, device=device)
    logits, cache = decode.prefill(params, cache, torch.as_tensor(prompt).long().to(device), cfg)
    for i in range(j):
        tok = torch.tensor([int(toks[i])], device=device)
        logits, cache = decode.decode_step(params, cache, tok, cfg)
    return logits[0].float().cpu()


def _serve_match(tag, params, cfg, cases, outs, refs, device) -> list:
    """Hold each request's tokens against generate()'s: equal, or the first
    divergent position sits at a near tie of generate()'s logits. Returns
    the divergences as (request, position, gap, limit)."""
    found = []
    for i, ((prompt, _), got, ref) in enumerate(zip(cases, outs, refs)):
        got, ref = np.asarray(got)[0], np.asarray(ref)[0]
        if np.array_equal(got, ref):
            continue
        j = int(np.flatnonzero(got != ref)[0])
        row = _logits_at(params, cfg, prompt, ref, j, device)
        top2 = torch.topk(row, 2).values
        gap = float(top2[0] - top2[1])
        limit = SERVE_TIE * float(row.abs().max())
        print(f"[serving] {tag}: request {i} diverges from generate() at token {j} "
              f"(engine {got[j]}, generate {ref[j]}); generate's top-2 gap there {gap:.3e}, "
              f"near-tie limit {limit:.3e}")
        check(gap <= limit, f"{tag}: request {i} diverges at token {j} where generate()'s top-2 "
              f"gap {gap:.3e} exceeds the near-tie limit {limit:.3e}")
        found.append((i, j, gap, limit))
    return found


def _drive(engine, cases, timeout=600):
    """Every case submitted from its own thread at once; (outputs, wall s)."""
    import threading

    outs = [None] * len(cases)
    errors = []

    def go(i):
        try:
            outs[i] = engine.submit(*cases[i], timeout=timeout)
        except Exception as err:  # noqa: BLE001 — re-raised below
            errors.append(err)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(cases))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    secs = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return outs, secs


def _quantum_timer(engine, name):
    """Wrap the engine's ``name`` method (one quantum of decode: a fused
    call or a speculative cycle, each ending in the token fetch) to record
    its host milliseconds."""
    orig = getattr(engine, name)
    samples = []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        samples.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(engine, name, timed)
    return samples


def _serve_profile(tag, fn, top=0):
    """One call of ``fn`` under torch.profiler: (wall ms, busy ms, kernels)
    printed with the idle share, and the ``top`` kernels by device time."""
    wall_us, kernels = profiled(fn)
    busy_us = sum(e.self_device_time_total for e in kernels)
    n = sum(e.count for e in kernels)
    if busy_us == 0:
        print(f"[serving] {tag}: the profiler saw no device time: not measured")
        return wall_us / 1e3, None, n
    print(f"[serving] {tag}: profiled wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.4f}, {n} kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[serving]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.self_device_time_total / busy_us:7.2%} x{e.count:<6d} {e.key[:90]}")
    return wall_us / 1e3, busy_us / 1e3, n


def phase_serving(device="cuda") -> float:
    """Generation serving at the flagship width (``full_config()``, random
    weights from seed 0), through the port's entry points on ``device``.
    Returns the engine's tokens/s on the 8 concurrent requests."""
    from pygrid_tpu_torch import telemetry
    from pygrid_tpu_torch.models import decode, transformer
    from pygrid_tpu_torch.serving import EngineConfig, GenerationEngine
    from pygrid_tpu_torch.utils import prng

    cfg = full_config()
    g = torch.Generator().manual_seed(0)
    params = transformer.init(cfg, generator=g, device=device)
    counters = _counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset_launch_counts()

    # (a) generate() at bench_decode's shape, bf16 compute
    B, P, N = 8, 32, 256
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=g).to(device)
    cast = decode.cast_params(params, "bfloat16")

    def gen():
        return decode.generate(params, prompt, N, cfg, compute_dtype="bfloat16", cast_cache=cast)

    out, first_ms = _host_ms(gen)
    check(tuple(out.shape) == (B, N) and bool(((out >= 0) & (out < cfg.vocab)).all()),
          f"generate: tokens of shape {tuple(out.shape)} or out of the vocabulary")
    again, _ = _host_ms(gen)
    check(torch.equal(out, again), "generate: two greedy calls gave different tokens")
    runs = [_host_ms(gen)[1] for _ in range(3)]
    best = min(runs)
    print(f"[serving] generate B={B} P={P} N={N} bf16: first call {first_ms:.1f} ms, then "
          f"{[round(r, 3) for r in runs]} ms; best {best:.3f} ms = {B * N / best * 1e3:.1f} "
          f"tokens/s, {best / N:.4f} ms per step (prefill included)")
    wall, busy, n_kernels = _serve_profile("generate", gen, top=8)
    weights = sum(p.numel() for p in params)
    bound_us = weights * 2 / PEAK_BYTES * 1e6  # the bf16 weights read once a step
    print(f"[serving] generate: {n_kernels / N:.1f} kernels per step; a step's weight read "
          f"({weights / 1e6:.2f} M params in bf16) bounds it at {bound_us:.2f} us")
    # the host's share: 64 decode steps enqueued with no sync between them,
    # against the same 64 steps ending in a sync
    cache = decode.init_cache(cfg, B, dtype="bfloat16", device=device)
    _, cache = decode.prefill(params, cache, prompt, cfg, "bfloat16", cast)
    tok = prompt[:, -1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(64):
        _, cache = decode.decode_step(params, cache, tok, cfg, "bfloat16", cast)
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 64
    torch.cuda.synchronize()
    synced_ms = (time.perf_counter() - t0) * 1e3 / 64
    print(f"[serving] decode_step at B={B}: {enqueue_ms:.4f} ms a step to enqueue, "
          f"{synced_ms:.4f} ms a step with the device's finish")

    # (e) the card against the CPU (f32), and the PRNG's bits
    if torch.device(device).type == "cuda":
        cpu_params = [p.cpu() for p in params]
        got, want = [], []
        for dev, ps in ((device, params), ("cpu", cpu_params)):
            cache = decode.init_cache(cfg, B, device=dev)
            lp, cache = decode.prefill(ps, cache, prompt.to(dev), cfg)
            ls, cache = decode.decode_step(ps, cache, prompt[:, 0].to(dev), cfg)
            (got if dev == device else want).append((lp.cpu(), ls.cpu()))
        errs = [float((a - b).abs().max()) for a, b in zip(got[0], want[0])]
        ok = all(torch.allclose(a, b, rtol=SERVE_CPU_TOL, atol=SERVE_CPU_TOL)
                 for a, b in zip(got[0], want[0]))
        print(f"[serving] card vs CPU, f32 B={B}: prefill logits max abs err {errs[0]:.3e}, "
              f"decode step {errs[1]:.3e} (rtol/atol {SERVE_CPU_TOL})")
        check(ok, f"card vs CPU: logits differ by {errs}")
        keys = {}
        for dev in (device, "cpu"):
            k = prng.split(prng.PRNGKey(20260, device=dev), 64)
            keys[dev] = (k.cpu(), prng.random_bits(k, (8, 8192)).cpu(),
                         prng.uniform(prng.fold_in(k, 3), (100,)).cpu())
        check(all(torch.equal(a, b) for a, b in zip(keys[device], keys["cpu"])),
              "PRNG: the card's bits differ from the CPU's")
        print("[serving] PRNG: split, fold_in, random bits and uniform bit-identical to the CPU "
              f"({keys['cpu'][1].numel()} words)")

    # (b) the engine on bench_serving's traffic: 8 concurrent requests
    rng = np.random.RandomState(7)
    cases = _serve_cases(cfg, rng)
    refs = [decode.generate(params, torch.from_numpy(p).long().to(device), n, cfg).cpu().numpy()
            for p, n in cases]
    total = sum(n for _, n in cases)
    engine = GenerationEngine(cfg, params, EngineConfig(max_slots=8, cache_dtype=torch.float32),
                              model_id="smoke", device=device)
    try:
        engine.warmup(prompt_lens=(max(p.shape[1] for p, _ in cases),))
        built = engine.compile_count()
        quanta = _quantum_timer(engine, "_fused_scan")
        outs, secs = _drive(engine, cases)
        check(engine.compile_count() == built,
              f"engine: {engine.compile_count() - built} programs built under traffic")
        check(engine.programs.trace_count() == engine.compile_count(),
              "engine: a program saw a second argument signature")
        div = _serve_match("engine", params, cfg, cases, outs, refs, device)
        stats = engine.stats()
        launch = {r["bucket"]: r["execute_ms_mean"] for r in telemetry.profiler.programs_snapshot()
                  if r["model"] == "smoke" and r["kind"] == "paged_decode_fused" and r["hits"]}
        print(f"[serving] engine, 8 concurrent requests, {total} tokens: {secs * 1e3:.1f} ms = "
              f"{total / secs:.1f} tokens/s; {built} programs, none built under traffic; "
              f"{len(div)} of 8 requests diverge from generate() (near ties)")
        print(f"[serving] engine: {stats['fused_scans']} fused quanta of {engine.config.quantum} "
              f"steps, host ms per quantum (call + token fetch) median "
              f"{statistics.median(quanta):.3f}, range {min(quanta):.3f}-{max(quanta):.3f}; "
              f"launch only (profiler execute mean, by width) {launch} ms")
        engine_tps = total / secs
        engine_wall, engine_busy, _ = _serve_profile("engine, the same 8 requests again",
                                                     lambda: _drive(engine, cases))
        led = engine.ledger()
        check(led["balanced"] and led["drained"], f"engine: ledger not balanced: {led}")
    finally:
        engine.close()

    # (d) the same traffic per step, and with speculative decode
    for tag, over in (("per-step", dict(fused=False)), ("spec", dict(spec_decode=True))):
        eng = GenerationEngine(cfg, params,
                               EngineConfig(max_slots=8, cache_dtype=torch.float32, **over),
                               model_id=f"smoke-{tag}", device=device)
        try:
            eng.warmup(prompt_lens=(max(p.shape[1] for p, _ in cases),))
            built = eng.compile_count()
            outs_t, secs_t = _drive(eng, cases)
            check(eng.compile_count() == built, f"{tag}: programs built under traffic")
            _serve_match(tag, params, cfg, cases, outs_t, refs, device)
            st = eng.stats()
            extra = (f", acceptance {st['spec_acceptance']} over {st['spec_verifies']} verifies "
                     f"(k={st['spec_k']}, {st['spec_draft_layers']} draft layers)"
                     if tag == "spec" else "")
            print(f"[serving] {tag}: {secs_t * 1e3:.1f} ms = {total / secs_t:.1f} tokens/s{extra}")
            check(eng.ledger()["balanced"], f"{tag}: ledger not balanced")
        finally:
            eng.close()

    # (c) prefix sharing on bench_serving_paged's traffic: 16 requests
    # sharing a 4-page system prompt, block 64
    block, pages, n_prefix = 64, 4, 16
    prng_np = np.random.RandomState(11)
    sys_prompt = prng_np.randint(0, cfg.vocab, size=pages * block).astype(np.int32)
    pcases = [(np.concatenate([sys_prompt, prng_np.randint(0, cfg.vocab, size=4)
                               .astype(np.int32)])[None, :], 6) for _ in range(n_prefix)]
    prefs = [decode.generate(params, torch.from_numpy(p).long().to(device), n, cfg).cpu().numpy()
             for p, n in pcases]
    slots = 8 * cfg.max_len // block
    eng = GenerationEngine(cfg, params, EngineConfig(
        max_slots=slots, slot_buckets=(1, 4, 8, slots), block_size=block,
        num_blocks=slots + 1, max_queue=4 * slots, cache_dtype=torch.float32),
        model_id="smoke-prefix", device=device)
    try:
        eng.warmup(prompt_lens=(8, pages * block + 4, 5))
        built = eng.compile_count()
        first, first_s = _drive(eng, pcases[:1])
        rest, rest_s = _drive(eng, pcases[1:])
        check(eng.compile_count() == built, "prefix: programs built under traffic")
        _serve_match("prefix", params, cfg, pcases, first + rest, prefs, device)
        st = eng.stats()
        check(st["prefix_hits"] >= n_prefix - 1 and
              st["prefix_tokens_saved"] >= (n_prefix - 1) * pages * block,
              f"prefix: {st['prefix_hits']} hits, {st['prefix_tokens_saved']} tokens saved")
        led = eng.ledger()
        check(led["balanced"] and led["drained"], f"prefix: ledger not balanced: {led}")
        eng._prefix.clear()
        check(eng._pool.free_count() == eng._pool.usable,
              f"prefix: {eng._pool.usable - eng._pool.free_count()} blocks leaked")
        print(f"[serving] prefix: {n_prefix} requests on a {pages * block}-token system prompt, "
              f"block {block}: {st['prefix_hits']} hits, {st['prefix_tokens_saved']} prompt "
              f"tokens not prefilled again; first request {first_s * 1e3:.1f} ms, the other "
              f"{n_prefix - 1} together {rest_s * 1e3:.1f} ms; no block leaked")
    finally:
        eng.close()

    torch.cuda.synchronize()
    launches = {k: n for c in counters.values() for k, n in c.launch_counts().items()}
    check(not any(launches.values()), f"the serving path launched hand-written kernels: {launches}")
    print("[serving] the serving path launched none of the hand-written kernels")
    return engine_tps


# --------------------------------------------------------------------------
# phase 15: grid — four port nodes driven over HTTP and WebSocket
# --------------------------------------------------------------------------

GRID_SECRET = "grid-smoke-secret"
GRID_NODES = ("alice", "bob", "charlie", "dan")


def _grid_events() -> tuple[int, int]:
    """(WS messages the nodes in this process have dispatched so far —
    each observes ``node_event_seconds`` once — and the bytes of those
    messages, ``wire_bytes_total{direction="in"}``)."""
    from pygrid_tpu_torch import telemetry

    messages = sum(h["count"] for (name, _), h in telemetry.histograms().items()
                   if name == "node_event_seconds")
    nbytes = sum(v for (name, labels), v in telemetry.counters().items()
                 if name == "wire_bytes_total" and ("direction", "in") in labels)
    return messages, int(nbytes)


def _grid_fl(urls, fl_steps, device) -> None:
    """Model-centric: the committed JAX-built CNN plan hosted on alice with
    JWT authentication; 8 port FLClients a cycle for 2 cycles, each over a
    wire-v2 socket (model by frame, the "list" variant by HTTP), training on
    the card at batch 64; every checkpoint bit-identical to old − f32(f64
    mean of the diffs)."""
    from pathlib import Path

    from pygrid_tpu_torch.client import FLClient, ModelCentricFLClient
    from pygrid_tpu_torch.federated.auth import jwt_encode
    from pygrid_tpu_torch.models import cnn
    from pygrid_tpu_torch.plans.state import serialize_model_params
    from pygrid_tpu_torch.plans.translators import run_oplist
    from pygrid_tpu_torch.utils.codes import CYCLE

    B, LR, K, CYCLES = 64, 0.005, 8, 2
    name, version = "grid-cnn", "1.0"
    fixture = Path(__file__).resolve().parent / "pygrid_tpu_torch" / "plans" / "fixtures"
    params0 = cnn.init(torch.Generator().manual_seed(0), device=device)
    lr_t = torch.tensor(LR, device=device)
    mc = ModelCentricFLClient(urls["alice"], device=device)
    try:
        resp = mc.host_federated_training(
            model=params0,
            client_plans={"training_plan": (fixture / "cnn_training_plan.bin").read_bytes()},
            client_config={"name": name, "version": version, "batch_size": B, "lr": LR,
                           "max_updates": 1},
            server_config={"min_workers": K, "max_workers": K, "min_diffs": K, "max_diffs": K,
                           "num_cycles": CYCLES, "cycle_length": None,
                           "authentication": {"secret": GRID_SECRET}})
        check(resp.get("status") == "success", f"grid fl: hosting failed: {resp}")
        bad = FLClient(urls["alice"], auth_token="not.a.token", device=device)
        check("error" in bad.authenticate(name, version), "grid fl: a bad JWT was accepted")
        bad.close()
        token = jwt_encode({"sub": "grid-worker"}, secret=GRID_SECRET)
        workers = [FLClient(urls["alice"], auth_token=token, device=device) for _ in range(K)]
        steps = ("authenticate", "cycle", "model", "plan", "train", "report")
        host_ms = {s: [] for s in steps}
        try:
            for cycle in range(CYCLES):
                old = mc.retrieve_model(name, version)
                diffs = []
                for w, client in enumerate(workers):
                    auth, ms = _host_ms(lambda: client.authenticate(name, version))
                    host_ms["authenticate"].append(ms)
                    check(auth.get("status") == "success", f"grid fl: authenticate: {auth}")
                    wid = auth["worker_id"]
                    cyc, ms = _host_ms(lambda: client.cycle_request(wid, name, version, 1.0,
                                                                    1000.0, 1000.0))
                    host_ms["cycle"].append(ms)
                    check(cyc.get(CYCLE.STATUS) == CYCLE.ACCEPTED,
                          f"grid fl: worker {w} rejected: {cyc}")
                    key = cyc[CYCLE.KEY]
                    params, ms = _host_ms(lambda: client.get_model(wid, key, cyc["model_id"]))
                    host_ms["model"].append(ms)
                    check(client.ws.wire_v2 and all(p.device.type == torch.device(device).type
                                                    for p in params),
                          "grid fl: the model did not come by wire-v2 frame onto the card")
                    oplist, ms = _host_ms(lambda: client.get_plan(
                        wid, key, cyc[CYCLE.PLANS]["training_plan"], receive_operations_as="list"))
                    host_ms["plan"].append(ms)
                    X, y = _fl_batch("cnn", cycle, w, device)
                    out, ms = _host_ms(lambda: run_oplist(oplist, X, y, lr_t, *params,
                                                          device=device))
                    host_ms["train"].append(ms)
                    check(_finite(*out), f"grid fl: worker {w}'s step is not finite")
                    diff = [p - n for p, n in zip(params, out[2:])]
                    rep, ms = _host_ms(lambda: client.report(wid, key,
                                                             serialize_model_params(diff)))
                    host_ms["report"].append(ms)
                    check(not rep.get("error"), f"grid fl: report: {rep}")
                    diffs.append(diff)
                new = mc.retrieve_model(name, version)
                for i, (o, g) in enumerate(zip(old, new)):
                    mean64 = sum(d[i].double() for d in diffs) / K
                    check(torch.equal(g, o - mean64.float()),
                          f"grid fl: checkpoint tensor {i} after cycle {cycle} is not "
                          "old - f32(f64 mean of the diffs)")
                print(f"[grid] fl cycle {cycle}: {K} FLClients over wire-v2 "
                      f"({workers[0].ws.wire_codec or 'no'} codec); retrieve-model == old - "
                      f"f32(f64 mean of {K} diffs), bit for bit")
            late = workers[0].cycle_request(workers[0].authenticate(name, version)["worker_id"],
                                            name, version, 1.0, 1000.0, 1000.0)
            check(late.get(CYCLE.STATUS) == CYCLE.REJECTED,
                  f"grid fl: a cycle is still open after {CYCLES} cycles: {late}")
        finally:
            for client in workers:
                client.close()
    finally:
        mc.close()
    med = {s: statistics.median(v) for s, v in host_ms.items()}
    print(f"[grid] fl host ms per protocol step over the wire, median over {K * CYCLES} "
          "workers: " + ", ".join(f"{k} {v:.3f}" for k, v in med.items()))
    print("[grid] fl in process (phase fl, the same plan): "
          + ", ".join(f"{k} {v:.3f}" for k, v in fl_steps.items()))


def _grid_datacentric(urls, dc_first, dc_ms, device) -> tuple[int, float]:
    """Data-centric: the committed CryptoNets plan shared over alice, bob
    and charlie with dan dealing, all through DataCentricFLClients; the
    decoded output bit for bit phase datacentric's (a). Returns the ring
    kernel's launches on the nodes in that forward and the host ms per
    forward."""
    from pathlib import Path

    from pygrid_tpu_torch import serde
    from pygrid_tpu_torch.client import DataCentricFLClient
    from pygrid_tpu_torch.smpc import (EncryptedModel, FixedPointEncoder, RemoteCryptoProvider,
                                       fix_prec_share_to_nodes)

    fixture = Path(__file__).resolve().parent / "pygrid_tpu_torch" / "plans" / "fixtures"
    plan = serde.deserialize((fixture / "cryptonets_plan.bin").read_bytes(), device=device)
    x, w1, b1, w2, b2 = mlp_plaintext()
    weights = [w1, b1[0], w2, b2[0]]
    holders = [DataCentricFLClient(urls[n], device=device) for n in PARTIES]
    dan = DataCentricFLClient(urls["dan"], device=device)
    try:
        for h in holders:
            dan.connect_nodes(h)
        provider = RemoteCryptoProvider(dan)
        gw = torch.Generator(device=device).manual_seed(DC_SEED)
        shared = [fix_prec_share_to_nodes(w, holders, crypto_provider=dan, generator=gw,
                                          device=device) for w in weights]
        model = EncryptedModel(plan, shared, holders, provider, FixedPointEncoder(),
                               device=device)
        events0 = _grid_events()
        got, counts, secs = counted(
            lambda: model.predict(x, generator=torch.Generator(device=device).manual_seed(1)),
            "ring")
        messages, nbytes = (b - a for a, b in zip(events0, _grid_events()))
        check(np.array_equal(got, dc_first), "grid datacentric: the forward over the nodes "
              "differs from phase datacentric's in-process forward")
        check(counts["ring_matmul"] == 16, f"grid datacentric: {counts['ring_matmul']} ring "
              "launches on the nodes, expected 16")
        host = [_host_ms(lambda: model.predict(x))[1] for _ in range(3)]
        host_ms = statistics.median(host)
        print(f"[grid] datacentric: EncryptedModel.predict over 4 nodes (alice, bob, charlie "
              f"hold, dan deals) bit-identical to phase datacentric's; {counts} on the nodes; "
              f"first call {secs * 1e3:.3f} ms, {messages} WS messages dispatched by the nodes "
              f"carrying {nbytes / 1e6:.3f} MB; "
              f"host ms per forward {host_ms:.3f} (median of 3) against "
              f"{dc_ms:.3f} in process (phase datacentric; PR 8 measured 22.139)")
        return counts["ring_matmul"], host_ms
    finally:
        dan.close()
        for h in holders:
            h.close()


def _grid_serving(urls, serve_tps, device) -> None:
    """Serving: phase serving's flagship bundle (seed 0) hosted on alice;
    8 concurrent POST /data-centric/run-generation, each greedy result held
    to generate() as phase serving holds the engine."""
    import base64
    import threading

    from pygrid_tpu_torch import serde
    from pygrid_tpu_torch.client import DataCentricFLClient
    from pygrid_tpu_torch.models import decode, transformer
    from pygrid_tpu_torch.web import client as http

    cfg = full_config()
    params = transformer.init(cfg, generator=torch.Generator().manual_seed(0), device=device)
    cases = _serve_cases(cfg, np.random.RandomState(7))
    refs = [decode.generate(params, torch.from_numpy(p).long().to(device), n, cfg).cpu().numpy()
            for p, n in cases]
    client = DataCentricFLClient(urls["alice"], device=device)
    try:
        hosted, ms = _host_ms(lambda: client.serve_model(decode.bundle(cfg, params), "flagship",
                                                         allow_remote_inference=True))
        check(hosted.get("success"), f"grid serving: hosting failed: {hosted}")
        url = urls["alice"] + "/data-centric/run-generation"
        headers = {"token": client._auth_token}

        def post(prompt, n_new):
            return http.post(url, headers=headers, timeout=600, json={
                "model_id": "flagship", "n_new": int(n_new), "temperature": 0.0,
                "data": base64.b64encode(serde.serialize(np.asarray(prompt))).decode()})

        warm = post(cases[0][0][:, :2], 2)
        check(warm.status_code == 200, f"grid serving: warm-up answered {warm.status_code}")
        bad = http.post(url, headers=headers, timeout=60, json={"model_id": "flagship",
                        "n_new": True, "data": ""})
        check(bad.status_code == 400, f"grid serving: a bad request answered {bad.status_code}")
        outs = [None] * len(cases)

        def go(i):
            outs[i] = post(*cases[i])

        threads = [threading.Thread(target=go, args=(i,)) for i in range(len(cases))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        secs = time.perf_counter() - t0
        for i, r in enumerate(outs):
            check(r is not None and r.status_code == 200,
                  f"grid serving: request {i} answered {getattr(r, 'status_code', None)}")
        toks = [np.asarray(r.json()["tokens"]) for r in outs]
        div = _serve_match("grid", params, cfg, cases, toks, refs, device)
        total = sum(n for _, n in cases)
        print(f"[grid] serving: bundle hosted over WS in {ms:.1f} ms; 8 concurrent HTTP "
              f"generations, {total} tokens in {secs * 1e3:.1f} ms = {total / secs:.1f} tokens/s "
              f"over HTTP against {serve_tps:.1f} in process (phase serving's engine); "
              f"{len(div)} of 8 diverge from generate() (near ties)")
    finally:
        client.close()


def _grid_monitor(network, urls) -> float:
    """The nodes join the network through the node's join_network (on each
    node's loop, as the CLI joins at startup); after the monitor's first
    sweep /nodes-status shows all four online with a ping. Then one sweep
    of the four HTTP polls, run on the network's loop as monitor_loop runs
    it, timed. Returns its host ms."""
    import asyncio

    from pygrid_tpu_torch.network.monitor import poll_node
    from pygrid_tpu_torch.web import client as http

    ctx = network.app["network"]
    deadline = time.monotonic() + 60
    while True:
        status = http.get(network.url + "/nodes-status", timeout=30).json()
        online = {n: s for n, s in status.items()
                  if s["status"] == "online" and s["ping_ms"] is not None}
        if set(online) == set(urls) or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    check(set(online) == set(urls) and all(status[n]["address"] == u for n, u in urls.items()),
          f"grid network: nodes not all online after a monitor sweep: {status}")

    async def sweep():
        for node_id, address in ctx.manager.connected_nodes().items():
            await poll_node(ctx.proxy(node_id, address))

    sweeps = []
    for _ in range(5):
        t0 = time.perf_counter()
        asyncio.run_coroutine_threadsafe(sweep(), network.loop).result(60)
        sweeps.append((time.perf_counter() - t0) * 1e3)
    check(all(p.status == "online" for p in ctx.proxies.values()),
          "grid network: a node went offline in a timed sweep")
    print(f"[network] {len(online)} nodes online after the first monitor sweep (ping_ms "
          + ", ".join(f"{n} {s['ping_ms']:.3f}" for n, s in sorted(online.items()))
          + f"); one sweep of {len(urls)} HTTP polls (3 GETs each): "
          f"{statistics.median(sweeps):.3f} ms host (median of 5)")
    return statistics.median(sweeps)


def _grid_network_health(url) -> None:
    from pygrid_tpu_torch.telemetry import promtext
    from pygrid_tpu_torch.web import client as http

    for path, params in (("/healthz", None), ("/healthz", {"deep": "1"}), ("/metrics", None),
                         ("/telemetry/slo", None)):
        r = http.get(url + path, params=params, timeout=30)
        check(r.status_code == 200, f"grid network: {path} {params or ''} answered "
              f"{r.status_code}: {r.text[:300]}")
        if path == "/metrics":
            families = promtext.parse(r.text)
            check('pygrid_grid_nodes{status="online"} 4' in r.text,
                  "grid network: /metrics does not count 4 online nodes")
    print(f"[network] /healthz (shallow and deep), /metrics (strict Prometheus text, "
          f"{len(families)} families, 4 nodes online) and /telemetry/slo answered 200")


def _grid_discover(network, servers, urls, dc_first, grid_dc_ms, device) -> tuple:
    """The model owner publishes the committed CryptoNets plan over alice,
    bob and charlie (weight shares from phase grid's seed) with dan
    dealing from a fresh provider of phase datacentric's seed; a data
    scientist then finds it with EncryptedModel.discover and predicts on
    phase datacentric's input with its input seed: bit-identical to phase
    datacentric's output, 16 ring launches. Returns the launches and the
    host ms of discover, of a predict after it and of the 4-node fan-out."""
    from pathlib import Path

    from pygrid_tpu_torch import serde
    from pygrid_tpu_torch.client import DataCentricFLClient
    from pygrid_tpu_torch.smpc import CryptoProvider, EncryptedModel, publish_encrypted_model
    from pygrid_tpu_torch.web import client as http

    # the dealer repeats phase datacentric's triples: installed before any
    # client of this block logs in (a session takes the provider at login)
    dan = servers["dan"].app["node"]
    dan.crypto_provider = dan.local_worker.crypto_provider = CryptoProvider(
        id="dan-crypto", seed=DC_SEED, device=device)
    fixture = Path(__file__).resolve().parent / "pygrid_tpu_torch" / "plans" / "fixtures"
    plan = serde.deserialize((fixture / "cryptonets_plan.bin").read_bytes(), device=device)
    x, w1, b1, w2, b2 = mlp_plaintext()
    owners = {n: DataCentricFLClient(urls[n], device=device) for n in GRID_NODES}
    try:
        _, publish_ms = _host_ms(lambda: publish_encrypted_model(
            plan, "cryptonets", owners["alice"], [owners[n] for n in PARTIES], owners["dan"],
            [w1, b1[0], w2, b2[0]], generator=torch.Generator(device=device).manual_seed(DC_SEED),
            device=device))
    finally:
        for c in owners.values():
            c.close()
    fanout = []
    for _ in range(5):
        r, ms = _host_ms(lambda: http.post(network.url + "/search-encrypted-model",
                                           json={"model_id": "cryptonets"}, timeout=30))
        fanout.append(ms)
    match = r.json()["match-nodes"]
    check(list(match) == ["alice"] and match["alice"]["nodes"]["workers"] == list(PARTIES)
          and match["alice"]["nodes"]["crypto_provider"] == ["dan"]
          and match["alice"]["worker_addresses"] == urls,
          f"grid network: search-encrypted-model answered {match}")
    model, discover_ms = _host_ms(
        lambda: EncryptedModel.discover(network.url, "cryptonets", device=device))
    try:
        got, counts, secs = counted(
            lambda: model.predict(x, generator=torch.Generator(device=device).manual_seed(1)),
            "ring")
        check(np.array_equal(got, dc_first), "grid network: predict after discover differs "
              "from phase datacentric's output")
        check(counts["ring_matmul"] == 16, f"grid network: {counts['ring_matmul']} ring launches "
              "on the nodes after discover, expected 16")
        host = statistics.median(_host_ms(lambda: model.predict(x))[1] for _ in range(3))
    finally:
        model.close()
    print(f"[network] encrypted model published over alice, bob, charlie (dan deals) in "
          f"{publish_ms:.1f} ms; 4-node fan-out POST /search-encrypted-model "
          f"{statistics.median(fanout):.3f} ms host (median of 5)")
    print(f"[network] EncryptedModel.discover(network, 'cryptonets', device={str(device)!r}) "
          f"{discover_ms:.3f} ms host; predict after discover bit-identical to phase "
          f"datacentric's output, {counts} on the nodes, first call {secs * 1e3:.3f} ms, "
          f"then {host:.3f} ms host per forward (median of 3) against {grid_dc_ms:.3f} for the "
          f"directly wired model above")
    return counts["ring_matmul"], discover_ms, host, statistics.median(fanout)


def _grid_public_search(network, urls, device) -> None:
    """A tagged tensor sent to bob on the card comes back through
    PublicGridNetwork.search as a pointer on bob."""
    from pygrid_tpu_torch.client import DataCentricFLClient, PublicGridNetwork

    value = torch.arange(12, dtype=torch.float32, device=device).reshape(3, 4)
    bob = DataCentricFLClient(urls["bob"], device=device)
    grid = PublicGridNetwork(network.url, device=device)
    try:
        bob.send(value, tags={"#grid-net", "#smoke"})
        found, ms = _host_ms(lambda: grid.search("#grid-net", "#smoke"))
        check(list(found) == ["bob"] and len(found["bob"]) == 1,
              f"grid network: PublicGridNetwork.search found {found}")
        ptr = found["bob"][0]
        back = np.asarray(ptr.get(delete=False))
        check(np.array_equal(back, value.cpu().numpy()),
              "grid network: the found pointer does not hold the sent tensor")
    finally:
        grid.close()
        bob.close()
    print(f"[network] PublicGridNetwork.search('#grid-net', '#smoke') {ms:.3f} ms host: "
          f"one pointer on bob (shape {tuple(ptr.shape)}), its value the tensor sent")


def _grid_workers(network, urls, device) -> dict:
    """One cycle of 8 threaded run_worker(device) on phase fl's CNN plan
    (batch 64) hosted on alice: four ask the network for placement and
    report through a port sub-aggregator registered with it, four report
    direct. The checkpoint equals old - f32(f64 mean of the 8 diffs), bit
    for bit. Host ms per report on each route."""
    import threading
    from pathlib import Path

    from pygrid_tpu_torch import web
    from pygrid_tpu_torch.client import ModelCentricFLClient
    from pygrid_tpu_torch.client.fl_client import FLJob
    from pygrid_tpu_torch.models import cnn
    from pygrid_tpu_torch.worker import run_worker
    from pygrid_tpu_torch.worker.subagg import create_subagg_app

    B, K, name = 64, 8, "grid-workers"
    fixture = Path(__file__).resolve().parent / "pygrid_tpu_torch" / "plans" / "fixtures"
    params0 = cnn.init(torch.Generator().manual_seed(0), device=device)
    mc = ModelCentricFLClient(urls["alice"], device=device)
    sub = None
    orig_report = FLJob.report
    try:
        resp = mc.host_federated_training(
            model=params0,
            client_plans={"training_plan": (fixture / "cnn_training_plan.bin").read_bytes()},
            client_config={"name": name, "version": "1.0", "batch_size": B, "lr": LR_FL,
                           "max_updates": 1},
            server_config={"min_workers": K, "max_workers": K, "min_diffs": K, "max_diffs": K,
                           "num_cycles": 1, "cycle_length": None})
        check(resp.get("status") == "success", f"grid workers: hosting failed: {resp}")
        old = [p.cpu() for p in mc.retrieve_model(name, "1.0")]
        sub = web.BackgroundServer(create_subagg_app(
            urls["alice"], fanout=3, flush_interval=3600.0, network_url=network.url,
            register_interval=0.1)).start()
        agg = sub.app["subagg"]
        agg.address = sub.url
        check(agg.registered.wait(30), "grid workers: the sub-aggregator never registered")
        seen, lock = [], threading.Lock()

        def report(job, diff):  # records each diff and the route its report took
            via = job.client.aggregator_url
            t0 = time.perf_counter()
            out = orig_report(job, diff)
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                seen.append(([d.detach().float().cpu() for d in diff], via, ms, out))
            return out

        FLJob.report = report
        results = [None] * K
        errors = []

        def go(i):
            def data(batch):
                X, y = _fl_batch("cnn", 7, i, "cpu", B=batch)
                return X.numpy(), y.numpy()

            try:
                results[i] = run_worker(urls["alice"], name, model_version="1.0", data_fn=data,
                                        network_url=network.url if i % 2 else None,
                                        device=device)
            except Exception as err:  # noqa: BLE001 — raised below, on the main thread
                errors.append(err)

        threads = [threading.Thread(target=go, args=(i,), name=f"grid-worker-{i}")
                   for i in range(K)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = (time.perf_counter() - t0) * 1e3
        check(not errors, f"grid workers: {errors}")
        check(all(r is not None and r.accepted == 1 and not r.errors for r in results),
              f"grid workers: {results}")
        agg.flush_all()  # whatever the fanout left buffered goes up now
        stats = agg.stats()
        routes = sorted(v is not None for _, v, _, _ in seen)
        check(routes == [False] * 4 + [True] * 4 and all(not o.get("error") for *_, o in seen),
              f"grid workers: routes {routes}")
        check(stats["leaves_forwarded"] == 4 and stats["flush_errors"] == 0,
              f"grid workers: sub-aggregator stats {stats}")
        new = [p.cpu() for p in mc.retrieve_model(name, "1.0")]
        for i, (o, g) in enumerate(zip(old, new)):
            mean64 = sum(d[i].double() for d, *_ in seen) / K
            check(torch.equal(g, o - mean64.float()), f"grid workers: checkpoint tensor {i} is "
                  "not old - f32(f64 mean of the 8 diffs)")
    finally:
        FLJob.report = orig_report
        if sub is not None:
            sub.stop()
        mc.close()
    ms = {route: statistics.median(m for _, v, m, _ in seen if (v is not None) == route)
          for route in (False, True)}
    print(f"[network] 8 threaded run_worker(device={str(device)!r}) on the CNN plan, one cycle "
          f"in {wall:.1f} ms: 4 through the sub-aggregator the network placed "
          f"({stats['flushes']} upstream flushes, the first report of a key probing it, "
          f"{stats['leaves_forwarded']} leaves forwarded), "
          f"4 direct; checkpoint == old - f32(f64 mean of 8 diffs), bit for bit; host ms per "
          f"report: direct {ms[False]:.3f}, through the sub-aggregator {ms[True]:.3f} (median "
          f"of 4 each)")
    return {"direct": ms[False], "subagg": ms[True]}


def _grid_network_block(servers, urls, dc_first, grid_dc_ms, device) -> int:
    """[network]: a port network on its own loop thread (monitor every
    0.5 s); the four nodes join it; monitor sweep, health routes, discover
    and predict, PublicGridNetwork.search, and a worker cycle half through a
    placed sub-aggregator. Returns the ring launches of predict."""
    import asyncio

    from pygrid_tpu_torch import web
    from pygrid_tpu_torch.network import create_app as create_network
    from pygrid_tpu_torch.node.__main__ import join_network

    network = web.BackgroundServer(create_network("grid-network", monitor_interval=0.5)).start()
    try:
        for name, server in servers.items():
            asyncio.run_coroutine_threadsafe(join_network(network.url, name, server.url),
                                             server.loop).result(60)
        _grid_monitor(network, urls)
        _grid_network_health(network.url)
        launches, *_ = _grid_discover(network, servers, urls, dc_first, grid_dc_ms, device)
        _grid_public_search(network, urls, device)
        _grid_workers(network, urls, device)
    finally:
        network.stop()
    return launches


def phase_grid(fl_steps, dc_first, dc_ms, serve_tps, device="cuda") -> int:
    """Four port nodes (alice, bob, charlie, dan), each an app of
    ``pygrid_tpu_torch.node`` on its own loop thread on 127.0.0.1 with its
    tensors on ``device``, driven only through the port's clients over HTTP
    and WebSocket: the model-centric cycle, encrypted inference and
    generation serving, every node's health routes, then the [network]
    block (a port network the nodes join) and a clean stop. Returns the
    ring kernel's launches on the nodes."""
    import dataclasses
    import threading

    from pygrid_tpu_torch import web
    from pygrid_tpu_torch.federated import tasks
    from pygrid_tpu_torch.node import create_app
    from pygrid_tpu_torch.smpc import CryptoProvider
    from pygrid_tpu_torch.telemetry import promtext
    from pygrid_tpu_torch.web import client as http

    before = {t.ident for t in threading.enumerate()}
    tasks.set_sync(True)  # the K-th report aggregates before it answers
    servers = {}
    try:
        for name in GRID_NODES:
            app = create_app(name, device=device)
            node = app["node"]
            if name == "dan":  # deals with phase datacentric's seed: its triples repeat
                node.crypto_provider = node.local_worker.crypto_provider = CryptoProvider(
                    id="dan-crypto", seed=DC_SEED, device=device)
            # an f32 KV cache, as phase serving pins it, to hold the engine
            # against generate()'s f32 cache
            serving = node.serving
            serving.config = dataclasses.replace(serving.config, cache_dtype=torch.float32)
            servers[name] = web.BackgroundServer(app).start()
        urls = {n: s.url for n, s in servers.items()}
        print(f"[grid] {card_line()}; nodes {', '.join(f'{n} {u}' for n, u in urls.items())} "
              f"on {device}")
        _grid_fl(urls, fl_steps, device)
        launches, grid_dc_ms = _grid_datacentric(urls, dc_first, dc_ms, device)
        _grid_serving(urls, serve_tps, device)
        for name, url in urls.items():
            for path, headers in (("/healthz", None), ("/metrics", None),
                                  ("/telemetry/slo", None), ("/", {"Accept": "text/html"}),
                                  ("/", None)):
                r = http.get(url + path, headers=headers, timeout=30)
                check(r.status_code == 200, f"grid: {name} {path} answered {r.status_code}")
                if path == "/metrics":
                    families = promtext.parse(r.text)
        print(f"[grid] every node answered 200 on /healthz, /metrics (strict Prometheus text, "
              f"{len(families)} families on dan), /telemetry/slo and GET /")
        launches += _grid_network_block(servers, urls, dc_first, grid_dc_ms, device)
    finally:
        for server in servers.values():
            server.stop()
    deadline = time.time() + 10
    while True:
        left = [t.name for t in threading.enumerate()
                if t.ident not in before and not t.name.startswith("pygrid-ws")]
        if not left or time.time() > deadline:
            break
        time.sleep(0.1)
    check(not left, f"grid: threads left after the nodes stopped: {left}")
    print("[grid] the 4 nodes, the network and the sub-aggregator stopped; no thread of theirs "
          "is left (the WS executor's pool is the process's)")
    return launches


SECAGG_CLIP, SECAGG_THRESHOLD, SECAGG_K = 0.5, 3, 4
SIM_CLIENTS = 16
CRYPTONETS_SHAPES = ((256, 784), (784, 392), (392,), (392, 10), (10,))


def cryptonets_forward(x, w1, b1, w2, b2):
    """examples/encrypted_inference.py's forward, written in torch: affine
    → square → affine."""
    h = x @ w1 + b1
    h = h * h
    return h @ w2 + b2


def _secagg_plans(device) -> bytes:
    """(a) The MNIST CNN's and the MLP's training_step built by the port
    (Plan.build on the CPU: make_fx, torch.export, fx_to_oplist), each op
    list run on the card against the direct step and against the JAX-built
    fixture on the same params; device and event ms per step beside the
    JAX-built list's. Returns the port-built CNN plan's blob."""
    from pathlib import Path

    from pygrid_tpu_torch import serde
    from pygrid_tpu_torch.models import cnn, mlp
    from pygrid_tpu_torch.plans import Plan
    from pygrid_tpu_torch.plans.translators import count_ops, run_oplist

    B, LR = 64, LR_FL
    fixtures = Path(__file__).resolve().parent / "pygrid_tpu_torch" / "plans" / "fixtures"
    lr_t = torch.tensor(LR, device=device)
    cnn_blob = b""
    for kind, model, params in (
            ("cnn", cnn, cnn.init(torch.Generator().manual_seed(0), device=device)),
            ("mlp", mlp, mlp.init((784, 392, 10), generator=torch.Generator().manual_seed(1),
                                  device=device))):
        example = [torch.zeros(s) for s in ((B, 28, 28, 1) if kind == "cnn" else (B, 784),
                                             (B, 10))] + [torch.tensor(LR)]
        plan, build_ms = _host_ms(lambda: Plan(name="training_plan", fn=model.training_step)
                                  .build(*example, *[p.cpu() for p in params]))
        check(plan.oplist is not None, f"secagg: the port-built {kind} plan has no op list")
        jax_list = serde.deserialize((fixtures / f"{kind}_training_plan.bin").read_bytes()).oplist
        X, y = _fl_batch(kind, 7, 0, device)
        port = run_oplist(plan.oplist, X, y, lr_t, *params, device=device)
        direct = model.training_step(X, y, lr_t, *params)
        jax_built = run_oplist(jax_list, X, y, lr_t, *params, device=device)
        check(_finite(*port), f"secagg: the port-built {kind} list's step is not finite")
        for what, ref in (("the direct step", direct), ("the JAX-built list", jax_built)):
            check(_fl_close(port, ref), f"secagg: the port-built {kind} list differs from {what} "
                  f"by {_fl_max_err(port, ref):.3e}")
        print(f"[secagg] (a) {kind}: port-built plan in {build_ms:.1f} ms on the CPU, "
              f"{len(plan.oplist['eqns'])} ops ({count_ops(plan.oplist)} a run; the JAX-built "
              f"list {count_ops(jax_list)}); its step on the card against the direct step "
              f"{_fl_max_err(port, direct):.3e} max abs ({_fl_tol_share(port, direct):.4f} of "
              f"rtol 2e-4 / atol 2e-5), against the JAX-built list {_fl_max_err(port, jax_built):.3e}"
              f" ({_fl_tol_share(port, jax_built):.4f})")
        for what, ol in (("port-built", plan.oplist), ("JAX-built", jax_list)):
            def step(ol=ol):
                return run_oplist(ol, X, y, lr_t, *params, device=device)
            print(f"[secagg] (a) {kind} step at batch {B}, {what} list: device "
                  f"{device_ms(step):.4f} ms, events {time_ms(step, iters=10, repeats=5):.4f} ms "
                  "per step")
        if kind == "cnn":
            cnn_blob = serde.serialize(plan)
    return cnn_blob


def _secagg_worker(url, name, i, drop, device, masked, results) -> None:
    """One port worker's SecAgg cycle on ``device``: the four rounds, and
    between masking and report a training step of the "list" variant at
    batch 64. No worker reports before all have seen the masking phase
    (``masked``, a barrier), so the one that leaves leaves after it.
    Records (phase, host-side diffs, stage ms) or the error."""
    from pygrid_tpu_torch.client import FLClient, SecAggSession
    from pygrid_tpu_torch.plans.translators import run_oplist
    from pygrid_tpu_torch.utils.codes import CYCLE

    try:
        client = FLClient(url, timeout=120.0, device=device)
        try:
            wid = client.authenticate(name, "1.0")["worker_id"]
            cyc = client.cycle_request(wid, name, "1.0", 1.0, 1000.0, 1000.0)
            check(cyc.get(CYCLE.STATUS) == CYCLE.ACCEPTED, f"secagg: worker {i} rejected: {cyc}")
            key = cyc[CYCLE.KEY]
            session = SecAggSession(client, wid, key, cyc.get("client_config"))
            ms = {}
            _, ms["advertise -> roster"] = _host_ms(
                lambda: (session.advertise(), session.wait_roster(timeout=120.0)))
            _, ms["shares -> masking"] = _host_ms(
                lambda: (session.upload_shares(), session.wait_masking(timeout=120.0)))
            masked.wait(timeout=300)
            if drop:
                results[i] = ("dropped", None, ms)
                return
            params = client.get_model(wid, key, cyc["model_id"])
            oplist = client.get_plan(wid, key, cyc[CYCLE.PLANS]["training_plan"],
                                     receive_operations_as="list")
            X, y = _fl_batch("cnn", 20, i, device)
            out = run_oplist(oplist, X, y, torch.tensor(LR_FL, device=device), *params,
                             device=device)
            check(_finite(*out), f"secagg: worker {i}'s step is not finite")
            diff = [p - n for p, n in zip(params, out[2:])]  # on the card
            _, ms["report"] = _host_ms(lambda: session.report(diff))
            phase, ms["finish"] = _host_ms(lambda: session.finish(timeout=120.0))
            results[i] = (phase, [d.cpu().numpy() for d in diff], ms)
        finally:
            client.close()
    except Exception as err:  # noqa: BLE001 — raised by the phase below
        results[i] = ("error", err, {})


def _secagg_cycle(device, plan_blob) -> None:
    """(b) One port node on ``device`` (a loop thread) hosts the port-built
    CNN plan with secure aggregation (clip 0.5, threshold 3); four port
    FLClients with SecAggSession train on the card. Once with all four
    reporting, once with worker 3 leaving after the masking phase opens:
    each checkpoint within n · step of the survivors' plain mean."""
    import threading

    from pygrid_tpu_torch import web
    from pygrid_tpu_torch.client import ModelCentricFLClient
    from pygrid_tpu_torch.federated import secagg, tasks
    from pygrid_tpu_torch.models import cnn
    from pygrid_tpu_torch.node import create_app

    tasks.set_sync(True)
    server = web.BackgroundServer(create_app("secagg", device=device)).start()
    try:
        params0 = [p.cpu().numpy() for p in cnn.init(torch.Generator().manual_seed(0),
                                                     device=device)]
        for name, drop_idx in (("secagg-full", None), ("secagg-drop", SECAGG_K - 1)):
            n_diffs = SECAGG_K if drop_idx is None else SECAGG_THRESHOLD
            mc = ModelCentricFLClient(server.url, device=device)
            try:
                resp = mc.host_federated_training(
                    model=params0, client_plans={"training_plan": plan_blob},
                    client_config={"name": name, "version": "1.0", "batch_size": 64,
                                   "lr": LR_FL, "max_updates": 1},
                    server_config={"min_workers": SECAGG_K, "max_workers": SECAGG_K,
                                   "min_diffs": n_diffs, "max_diffs": n_diffs, "num_cycles": 1,
                                   "pool_selection": "random",
                                   "do_not_reuse_workers_until_cycle": 0,
                                   "secure_aggregation": {"clip_range": SECAGG_CLIP,
                                                          "threshold": SECAGG_THRESHOLD,
                                                          "phase_timeout": 60.0}})
                check(resp.get("status") == "success", f"secagg: hosting failed: {resp}")
                results: dict = {}
                masked = threading.Barrier(SECAGG_K)
                threads = [threading.Thread(target=_secagg_worker, daemon=True,
                                            args=(server.url, name, i, i == drop_idx, device,
                                                  masked, results))
                           for i in range(SECAGG_K)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=300)
                wall = (time.perf_counter() - t0) * 1e3
                check(not any(t.is_alive() for t in threads), f"secagg {name}: a worker hangs")
                errors = {i: r[1] for i, r in results.items() if r[0] == "error"}
                check(not errors, f"secagg {name}: worker errors {errors}")
                survivors = [r for r in results.values() if r[1] is not None]
                check(all(r[0] in ("done", "closed") for r in survivors),
                      f"secagg {name}: phases {[r[0] for r in results.values()]}")
                new = [p.cpu().numpy() for p in mc.retrieve_model(name, "1.0")]
            finally:
                mc.close()
            step = 1.0 / secagg.choose_scale(SECAGG_CLIP, SECAGG_K)
            worst = 0.0
            for k, (p, got) in enumerate(zip(params0, new)):
                want = p - np.mean([r[1][k] for r in survivors], axis=0, dtype=np.float64)
                err = float(np.abs(got.astype(np.float64) - want).max())
                check(err <= SECAGG_K * step + 1e-6, f"secagg {name}: checkpoint tensor {k} is "
                      f"{err:.3e} off the survivors' plain mean (limit n * step + 1e-6)")
                worst = max(worst, err)
            stages = {s: statistics.median(r[2][s] for r in survivors)
                      for s in ("advertise -> roster", "shares -> masking", "report", "finish")}
            print(f"[secagg] (b) {name}: {len(survivors)} of {SECAGG_K} workers reported on "
                  f"{device}, checkpoint within {worst:.3e} of the survivors' plain mean (n * step "
                  f"= {SECAGG_K * step:.3e}, + 1e-6); cycle wall {wall:.1f} ms; host ms per stage, "
                  "median of the reporting workers: "
                  + ", ".join(f"{s} {v:.3f}" for s, v in stages.items()))
    finally:
        server.stop()


def _secagg_sim(device) -> None:
    """(c) simulate_secagg_round on the card: 16 clients over the CNN's
    parameter count, bit-identical to the plain quantised sum and to the
    same round on the CPU; device ms and the launches of one masked sum."""
    from pygrid_tpu_torch.federated import secagg
    from pygrid_tpu_torch.models import cnn
    from pygrid_tpu_torch.parallel import secagg_sim
    from pygrid_tpu_torch.utils import prng

    n = sum(int(np.prod(s)) for s in cnn.PARAM_SHAPES)
    K = SIM_CLIENTS
    diffs = np.random.default_rng(31).normal(0, 0.01, (K, n)).astype(np.float32)
    key = prng.PRNGKey(5, device=device)
    got, ms = _host_ms(lambda: secagg_sim.simulate_secagg_round(key, diffs, SECAGG_CLIP,
                                                                device=device))
    quantized = np.stack([secagg.quantize([d], SECAGG_CLIP, K)[0] for d in diffs])
    plain = secagg.dequantize_sum([quantized.sum(axis=0, dtype=np.uint32)], SECAGG_CLIP, K, K)[0]
    check(np.array_equal(got, plain), "secagg sim: the masked sum is not the plain quantised sum")
    t0 = time.perf_counter()
    cpu = secagg_sim.simulate_secagg_round(prng.PRNGKey(5, device="cpu"), diffs, SECAGG_CLIP,
                                           device="cpu")
    cpu_s = time.perf_counter() - t0
    check(np.array_equal(got, cpu), "secagg sim: the card's round differs from the CPU's")
    words = torch.from_numpy(quantized.astype(np.int64)).to(device)
    masked = lambda: secagg_sim.masked_sum(key, words, device=device)  # noqa: E731
    _, kernels = profiled(masked)
    launches = sum(e.count for e in kernels)
    print(f"[secagg] (c) simulate_secagg_round, {K} clients x {n} params ({4 * n / 1e6:.1f} MB "
          f"a diff) on {device}: bit-identical to the plain quantised sum and to the CPU's round "
          f"({cpu_s:.1f} s there); round {ms:.3f} ms host (quantise on the host included); one "
          f"masked sum: device {device_ms(masked, calls=3):.4f} ms, events "
          f"{time_ms(masked, iters=2, repeats=3):.4f} ms, {launches} kernel launches")


def _secagg_cryptonets(device, dc_first) -> int:
    """(d) The CryptoNets forward built by the port (784→392→10, batch 256)
    through EncryptedModel.predict over alice, bob and charlie with dan
    dealing, with phase datacentric (a)'s seeds: 16 ring launches, within
    MLP_ATOL of float64 and bit-identical to the JAX-built plan's output
    of (a). Returns the launches."""
    from pygrid_tpu_torch.plans import Plan
    from pygrid_tpu_torch.smpc import (CryptoProvider, EncryptedModel, FixedPointEncoder,
                                       RemoteCryptoProvider, fix_prec_share_to_nodes)

    plan = Plan(name="encrypted_forward", fn=cryptonets_forward).build(
        *[torch.zeros(s) for s in CRYPTONETS_SHAPES])
    ops = [e["op"] for e in plan.oplist["eqns"]]
    check(ops == ["dot_general", "broadcast_in_dim", "add", "mul", "dot_general",
                  "broadcast_in_dim", "add"], f"secagg: the port-built CryptoNets list is {ops}")
    x, w1, b1, w2, b2 = plain = mlp_plaintext()
    want = mlp_forward(*plain)[-1]
    holders, dan = _dc_grid(device, CryptoProvider(seed=DC_SEED, device=device))
    gw = torch.Generator(device=device).manual_seed(DC_SEED)
    shared = [fix_prec_share_to_nodes(w, holders, crypto_provider=dan, generator=gw,
                                      device=device) for w in (w1, b1[0], w2, b2[0])]
    model = EncryptedModel(plan, shared, holders, RemoteCryptoProvider(dan), FixedPointEncoder(),
                           device=device)
    out, counts, secs = counted(
        lambda: model.predict(x, generator=torch.Generator(device=device).manual_seed(1)), "ring")
    err = float(np.abs(out - want).max())
    check(counts["ring_matmul"] == 16,
          f"secagg: {counts['ring_matmul']} ring launches a forward, expected 16")
    check(err <= MLP_ATOL, f"secagg: decoded output {err:.3e} from float64, limit {MLP_ATOL:.3e}")
    check(np.array_equal(out, dc_first),
          "secagg: the port-built plan's forward differs from the JAX-built plan's")
    print(f"[secagg] (d) the port-built CryptoNets plan ({len(ops)} ops, the JAX-built list's op "
          f"for op) through EncryptedModel.predict on {device}: {secs * 1e3:.3f} ms (first "
          f"call), launches {counts}, decoded max abs err vs float64 {err:.4e} (limit "
          f"{MLP_ATOL:.4e}), bit-identical to phase datacentric's JAX-built forward: True")
    return counts["ring_matmul"]


def phase_secagg(dc_first, device="cuda") -> int:
    """Secure aggregation and port-built plans on the card: (a) the port's
    own CNN and MLP training plans as op lists, (b) a SecAgg cycle of four
    port workers over a port node, (c) the on-device SecAgg simulation, (d)
    the port-built CryptoNets plan's encrypted forward. Returns (d)'s ring
    launches."""
    print(f"[secagg] {card_line()}")
    plan_blob = _secagg_plans(device)
    _secagg_cycle(device, plan_blob)
    _secagg_sim(device)
    return _secagg_cryptonets(device, dc_first)


# --------------------------------------------------------------------------
# phase 17: mesh
# --------------------------------------------------------------------------

#: (d_model, d_ff, experts, tokens) of (h): the flagship transformer's
#: widths (the JAX package publishes no MoE configuration), 16,384 tokens
MESH_MOE = (512, 2048, 8, 16384)
#: (width, rows, microbatches) of (g): one 512-wide tanh stage
MESH_PIPE = (512, 16384, 4)
MESH_LR_ADAM = 1e-3


def _mesh_times(fn, n=3) -> tuple[float, float]:
    """(CUDA-event ms, median host ms over ``n`` synchronised calls) of ``fn``."""
    events = time_ms(fn, iters=1, repeats=n)
    return events, statistics.median(_host_ms(fn)[1] for _ in range(n))


def _mesh_line(tag, mesh_fn, twin_fn, twin_name, n=3) -> None:
    m_ev, m_wall = _mesh_times(mesh_fn, n)
    t_ev, t_wall = _mesh_times(twin_fn, n)
    print(f"[mesh] {tag}: mesh path {m_ev:.3f} ms events / {m_wall:.3f} ms wall, {twin_name} "
          f"{t_ev:.3f} / {t_wall:.3f} ms (medians of {n}; mesh / twin {m_wall / t_wall:.3f} by "
          f"wall)")


def _mesh_profile(tag, fn, top=5) -> None:
    """Device busy time, idle share, launches and the top kernels of one
    call of ``fn`` under torch.profiler."""
    wall_us, kernels = profiled(fn)
    busy = sum(e.self_device_time_total for e in kernels)
    if busy == 0:
        print(f"[mesh] {tag} profile: the profiler saw no device time: not measured")
        return
    top_k = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    print(f"[mesh] {tag} profile: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
          f"idle share {1 - busy / wall_us:.4f}, {sum(e.count for e in kernels)} kernel "
          "launches; top: " + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
                                       f"x{e.count}" for e in top_k))


def _same_or_close(tag, got, want, dtype) -> str:
    """'bit-identical', or the largest error within ``dtype``'s tolerance."""
    if all(torch.equal(a, b) for a, b in zip(got, want)):
        return "bit-identical"
    err = max(_err(a, b, dtype, f"mesh {tag}") for a, b in zip(got, want))
    return f"max abs err {err:.3e} (within {TOL[dtype]})"


def _add(total: dict, counts: dict) -> None:
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def _mesh_rounds(cfg, device, total) -> None:
    """(a) the sharded fused round of the main path, (b) the sharded MLP round."""
    from functools import partial

    from pygrid_tpu_torch.models import mlp, transformer
    from pygrid_tpu_torch.parallel import flash_attention as fa
    from pygrid_tpu_torch.parallel import (make_fused_round, make_mesh, make_round,
                                           make_sharded_fused_round, make_sharded_round)

    mesh = make_mesh(axes=("clients",), device=device)
    K, B = 8, 4
    params, X, y = transformer_setup(cfg, K, B, device)
    loss_fn = partial(transformer.loss_and_acc, cfg=cfg, attn_fn=fa.flash_attention,
                      compute_dtype="bfloat16", ce_grad_dtype="bfloat16")
    sharded, twin = make_sharded_fused_round(loss_fn, mesh), make_fused_round(loss_fn)
    sharded(params, X, y, 0.1)  # warm-up
    (p_m, loss_m, acc_m), counts, _ = counted(lambda: sharded(params, X, y, 0.1))
    p_t, loss_t, acc_t = twin(params, X, y, 0.1)
    check(_finite(loss_m, acc_m, *p_m), "mesh (a): non-finite result")
    for name, n in counts.items():
        check(device != "cuda" or n == cfg.n_layers,
              f"mesh (a): {name} launched {n} times, expected {cfg.n_layers}")
    _add(total, counts)
    same = _same_or_close("(a)", [*p_m, loss_m, acc_m], [*p_t, loss_t, acc_t], torch.bfloat16)
    print(f"[mesh] (a) make_sharded_fused_round, {cfg}, K={K} B={B}, bf16: loss "
          f"{float(loss_m):.5f}, params and metrics against make_fused_round's: {same}; "
          f"launches {counts}")
    _mesh_line("(a) sharded fused round", lambda: sharded(params, X, y, 0.1),
               lambda: twin(params, X, y, 0.1), "make_fused_round")

    g = torch.Generator().manual_seed(2)
    mparams = mlp.init(generator=g, device=device)
    mX = torch.randn((8, 16, 784), generator=g).to(device)
    my = torch.nn.functional.one_hot(torch.randint(0, 10, (8, 16), generator=g), 10)
    my = my.float().to(device)
    msharded, mtwin = make_sharded_round(mlp.training_step, mesh), make_round(mlp.training_step)
    (mp, ml, ma), counts, _ = counted(lambda: msharded(mparams, mX, my, 0.1))
    tp, tl, ta = mtwin(mparams, mX, my, 0.1)
    same = _same_or_close("(b)", [*mp, ml, ma], [*tp, tl, ta], torch.float32)
    print(f"[mesh] (b) make_sharded_round, MLP K=8 B=16: loss {float(ml):.5f}, against "
          f"make_round: {same}; launches {counts}")
    _mesh_line("(b) sharded MLP round", lambda: msharded(mparams, mX, my, 0.1),
               lambda: mtwin(mparams, mX, my, 0.1), "make_round")


def _mesh_attention(cfg, device, total) -> None:
    """(c) ring and Ulysses (with the flash kernels) at the main path's
    attention shape, then as the transformer's attn_fn."""
    from functools import partial

    from pygrid_tpu_torch.models import transformer
    from pygrid_tpu_torch.parallel import attention, make_mesh, ring_attention, ulysses_attention
    from pygrid_tpu_torch.parallel import flash_attention as fa

    mesh = make_mesh(axes=("seq",), device=device)
    shape = (32, cfg.max_len, cfg.n_heads, cfg.d_model // cfg.n_heads)
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(shape, generator=g).to(device, torch.bfloat16) for _ in range(3))
    ref = attention(q, k, v, causal=True)
    ring = ring_attention(q, k, v, mesh, causal=True)
    uly = partial(ulysses_attention, mesh=mesh, causal=True, attn_fn=fa.flash_attention)
    out, counts, _ = counted(lambda: uly(q, k, v))
    _add(total, counts)
    check(device != "cuda" or counts["flash_fwd"] == 1, f"mesh (c): Ulysses launches {counts}")
    direct = "bit-identical" if torch.equal(out, fa.flash_attention(q, k, v, causal=True)) else \
        "differs"
    print(f"[mesh] (c) {list(shape)} bf16 causal: ring max abs err vs attention "
          f"{_err(ring, ref, torch.bfloat16, 'mesh (c) ring'):.3e}, Ulysses+flash "
          f"{_err(out, ref, torch.bfloat16, 'mesh (c) ulysses'):.3e} (to flash_attention "
          f"itself: {direct}); launches {counts}")
    _mesh_line("(c) ring attention", lambda: ring_attention(q, k, v, mesh, causal=True),
               lambda: attention(q, k, v, causal=True), "attention")
    _mesh_line("(c) Ulysses attention (flash)", lambda: uly(q, k, v),
               lambda: fa.flash_attention(q, k, v, causal=True), "flash_attention")
    _mesh_profile("(c) Ulysses attention (flash)", lambda: uly(q, k, v))

    # the ring's block step rounds the unnormalised probabilities to bf16
    # where attention rounds the normalised ones, and a bf16 forward carries
    # that through every layer into the logits: the ring's forward is held
    # to the local one in f32, Ulysses with the bf16 flash kernels in bf16
    params, X, _ = transformer_setup(cfg, 8, 4, device, seed=4)
    X = X.reshape(32, cfg.max_len)
    ring = partial(ring_attention, mesh=mesh)
    with torch.no_grad():
        local_plain = transformer.apply(params, X, cfg, attn_fn=attention)
        ring_logits = transformer.apply(params, X, cfg, attn_fn=ring)
        local_flash = transformer.apply(params, X, cfg, attn_fn=fa.flash_attention,
                                        compute_dtype="bfloat16")
        uly_logits, counts, _ = counted(lambda: transformer.apply(
            params, X, cfg, attn_fn=uly, compute_dtype="bfloat16"))
    _add(total, counts)
    check(device != "cuda" or counts["flash_fwd"] == cfg.n_layers,
          f"mesh (c): the Ulysses forward's launches {counts}")
    ring_same = _same_or_close("(c) ring forward", [ring_logits], [local_plain], torch.float32)
    uly_same = _same_or_close("(c) Ulysses forward", [uly_logits], [local_flash], torch.bfloat16)
    print(f"[mesh] (c) transformer forward [32, {cfg.max_len}]: ring as attn_fn (f32) against "
          f"the local forward (attention): {ring_same}; Ulysses+flash (bf16) against the local "
          f"forward (flash_attention): {uly_same}; launches {counts}")


def _mesh_smpc(device, total) -> None:
    """(d) sharded_beaver at bench_smpc's two configurations."""
    from pygrid_tpu_torch.parallel import collectives as C
    from pygrid_tpu_torch.parallel import make_mesh
    from pygrid_tpu_torch.smpc import ring as R
    from pygrid_tpu_torch.smpc import ring_matmul as rm
    from pygrid_tpu_torch.smpc.kernels import batched_beaver, share_kernel
    from pygrid_tpu_torch.smpc.sharded import make_sharded_open, sharded_beaver
    from pygrid_tpu_torch.utils import prng

    mesh = make_mesh(axes=("parties",), device=device)
    open_ = make_sharded_open(mesh)
    world = C.axis_size(mesh, "parties")
    for B, P, N in SMPC_CONFIGS:
        P = P if P % world == 0 else world  # the parties must split over the ranks
        g = torch.Generator(device=device).manual_seed(B + 1)
        x = torch.randint(0, 2**32, (B, N, N), generator=g, device=device)
        y = torch.randint(0, 2**32, (B, N, N), generator=g, device=device)
        x_sh, y_sh = share_kernel(g, x, P), share_kernel(g, y, P)  # [P, B, N, N]
        key = prng.PRNGKey(B, device=device)
        z, counts, secs = counted(lambda: sharded_beaver(mesh, key, x_sh, y_sh), "ring")
        _add(total, counts)
        # c = a∘b, d∘b_i and a_i∘e on every rank; d∘e on party 0's rank only
        want = 4 if C.axis_index(mesh, "parties") == 0 else 3
        check(device != "cuda" or counts["ring_matmul"] == want,
              f"mesh (d) B={B} N={N}: {counts['ring_matmul']} ring launches, expected {want}")
        opened = open_(z)
        check(torch.equal(opened, rm.ring_matmul_reference(x, y)),
              f"mesh (d) B={B} N={N}: the round does not open to x @ y mod 2^64")
        check(np.array_equal(R.from_ring(opened[0]),
                             _np_u64_matmul(R.from_ring(x[0]), R.from_ring(y[0]))),
              f"mesh (d) B={B} N={N}: the round differs from numpy uint64")
        print(f"[mesh] (d) sharded_beaver B={B} P={P} [{N}, {N}]: opens to x @ y mod 2^64 "
              f"(plain on the card, numpy element 0), {secs * 1e3:.3f} ms first round, "
              f"launches {counts}")
        xb, yb = x_sh.transpose(0, 1), y_sh.transpose(0, 1)  # phase smpc's [B, P, ...]
        _mesh_line(f"(d) Beaver round B={B} [{N}, {N}]",
                   lambda: sharded_beaver(mesh, key, x_sh, y_sh),
                   lambda: batched_beaver(g, xb, yb, n_parties=P), "batched_beaver")
        _mesh_profile(f"(d) Beaver round B={B} [{N}, {N}]",
                      lambda: sharded_beaver(mesh, key, x_sh, y_sh))


def _mesh_secagg(device) -> None:
    """(e) the SecAgg simulation's masked sum over the mesh."""
    from pygrid_tpu_torch.models import cnn
    from pygrid_tpu_torch.parallel import make_mesh, make_sharded_masked_sum, masked_sum
    from pygrid_tpu_torch.utils import prng

    n = sum(int(np.prod(s)) for s in cnn.PARAM_SHAPES)
    g = torch.Generator(device=device).manual_seed(6)
    words = torch.randint(0, 2**32, (SIM_CLIENTS, n), generator=g, device=device)
    key = prng.PRNGKey(5, device=device)
    sharded = make_sharded_masked_sum(make_mesh(axes=("clients",), device=device))
    got = sharded(key, words)
    want = masked_sum(key, words, device=device)
    check(torch.equal(got, want), "mesh (e): the mesh's masked sum differs from masked_sum")
    plain = words.sum(dim=0) & 0xFFFFFFFF
    check(torch.equal(got, plain), "mesh (e): the masked sum is not the plain sum")
    print(f"[mesh] (e) make_sharded_masked_sum, {SIM_CLIENTS} clients x {n} words: "
          f"bit-identical to masked_sum and the plain sum")
    _mesh_line("(e) masked sum", lambda: sharded(key, words),
               lambda: masked_sum(key, words, device=device), "masked_sum")


def _adam_reference(loss_fn, params, X, y, lr, n_steps, b1=0.9, b2=0.999, eps=1e-8):
    """The unsharded full-batch Adam update, written out."""
    p = [t.detach().clone() for t in params]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    for t in range(1, n_steps + 1):
        leaves = [q.requires_grad_() for q in p]
        loss, _ = loss_fn(leaves, X, y)
        grads = torch.autograd.grad(loss, leaves)
        step_t = torch.tensor(float(t), device=p[0].device)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, device=p[0].device), step_t)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, device=p[0].device), step_t)
        m = [b1 * mi + (1.0 - b1) * gi for mi, gi in zip(m, grads)]
        v = [b2 * vi + (1.0 - b2) * gi * gi for vi, gi in zip(v, grads)]
        p = [q.detach() - lr * (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
             for q, mi, vi in zip(p, m, v)]
    return p


def _mesh_fsdp(cfg, device, total) -> None:
    """(f) the FSDP Adam step on the main path's transformer, 3 steps."""
    from functools import partial

    from pygrid_tpu_torch.models import transformer
    from pygrid_tpu_torch.parallel import flash_attention as fa
    from pygrid_tpu_torch.parallel import make_fsdp_training_step, make_mesh, unshard_params

    mesh = make_mesh(axes=("fsdp",), device=device)
    params, X, y = transformer_setup(cfg, 8, 4, device, seed=5)
    X, y = X.reshape(32, cfg.max_len), y.reshape(32, cfg.max_len)
    for cd, dtype in (("bfloat16", torch.bfloat16), (None, torch.float32)):
        loss_fn = partial(transformer.loss_and_acc, cfg=cfg, attn_fn=fa.flash_attention,
                          compute_dtype=cd, ce_grad_dtype=cd)
        init_state, step = make_fsdp_training_step(loss_fn, params, mesh, optimizer="adam")

        def run():
            state, losses = init_state(params), []
            for _ in range(3):
                state, loss, _ = step(state, X, y, MESH_LR_ADAM)
                losses.append(float(loss))
            return state, losses

        (state, losses), counts, secs = counted(run)
        _add(total, counts)
        for name, n in counts.items():
            check(device != "cuda" or n == 3 * cfg.n_layers,
                  f"mesh (f) {cd}: {name} launched {n} times, expected {3 * cfg.n_layers}")
        full = unshard_params(state["shards"], params, mesh)
        ref = _adam_reference(loss_fn, params, X, y, MESH_LR_ADAM, 3)
        same = _same_or_close(f"(f) {cd}", full, ref, dtype)
        print(f"[mesh] (f) make_fsdp_training_step (Adam), {cfg}, batch [32, {cfg.max_len}], "
              f"compute {cd or 'float32'}: losses {[round(x, 5) for x in losses]}, 3 steps "
              f"{secs * 1e3:.1f} ms; params against the unsharded Adam update: {same}; "
              f"launches {counts}")
        state0 = init_state(params)
        _mesh_line(f"(f) FSDP Adam step, {cd or 'float32'}",
                   lambda: step(state0, X, y, MESH_LR_ADAM),
                   lambda: _adam_reference(loss_fn, params, X, y, MESH_LR_ADAM, 1),
                   "the unsharded Adam step")
        _mesh_profile(f"(f) FSDP Adam step, {cd or 'float32'}",
                      lambda: step(state0, X, y, MESH_LR_ADAM))


def _mesh_pipeline(device) -> None:
    """(g) pipeline_apply, one stage a rank."""
    from pygrid_tpu_torch.parallel import collectives as C
    from pygrid_tpu_torch.parallel import make_mesh, pipeline_apply, sequential_apply

    width, rows, micro = MESH_PIPE
    mesh = make_mesh(axes=("stage",), device=device)
    n = C.axis_size(mesh, "stage")
    g = torch.Generator().manual_seed(7)
    params = ((torch.randn((n, width, width), generator=g) / width**0.5).to(device),
              (torch.randn((n, width), generator=g) * 0.1).to(device))
    x = torch.randn((rows, width), generator=g).to(device)
    stage = lambda p, h: torch.tanh(h @ p[0] + p[1])  # noqa: E731
    got = pipeline_apply(stage, params, x, mesh, n_microbatches=micro)
    want = sequential_apply(stage, params, x)
    print(f"[mesh] (g) pipeline_apply, {n} {width}-wide tanh stage(s), {rows} rows in {micro} "
          f"microbatches, f32: against sequential_apply "
          f"{_same_or_close('(g)', [got], [want], torch.float32)}")
    _mesh_line("(g) pipeline", lambda: pipeline_apply(stage, params, x, mesh,
                                                      n_microbatches=micro),
               lambda: sequential_apply(stage, params, x), "sequential_apply")


def _mesh_moe(device) -> None:
    """(h) the expert-parallel MoE against the dense reference."""
    from pygrid_tpu_torch.models import moe
    from pygrid_tpu_torch.parallel import collectives as C
    from pygrid_tpu_torch.parallel import make_mesh

    d, ff, E, T = MESH_MOE
    g = torch.Generator().manual_seed(8)
    params = moe.init(d, ff, E, generator=g, device=device)
    x = torch.randn((T, d), generator=g).to(device)
    mesh = make_mesh(axes=("expert",), device=device)
    n = C.axis_size(mesh, "expert")
    capacity = -(-(T // n) * 2 // E)  # a rank's bucket for each expert
    idx = torch.softmax(x @ params[0], -1).argmax(-1).view(n, -1)
    load = max(int(torch.bincount(blk, minlength=E).max()) for blk in idx)
    check(load <= capacity, f"mesh (h): an expert gets {load} tokens of a rank's block, past "
                            f"its capacity {capacity}: the dense check needs no drop")
    got = moe.apply_expert_parallel(params, x, mesh, capacity_factor=2.0)
    want = moe.apply_dense(params, x)
    mb = sum(p.numel() for p in params[1:]) * 4 / 1e6
    print(f"[mesh] (h) apply_expert_parallel d_model {d} d_ff {ff}, {E} experts ({mb:.1f} MB), "
          f"{T} tokens over {n} rank(s), capacity {capacity} a rank (most loaded {load}), f32: "
          f"against apply_dense {_same_or_close('(h)', [got], [want], torch.float32)}")
    _mesh_line("(h) expert-parallel MoE",
               lambda: moe.apply_expert_parallel(params, x, mesh, capacity_factor=2.0),
               lambda: moe.apply_dense(params, x), "apply_dense")
    _mesh_profile("(h) expert-parallel MoE",
                  lambda: moe.apply_expert_parallel(params, x, mesh, capacity_factor=2.0))


def phase_mesh(device="cuda", rank=0, world=1, store_dir=None) -> dict:
    """The multi-device plane: this process is ``rank`` of a torch.distributed
    world of ``world`` (NCCL on the card, gloo on the CPU) that meets
    through a FileStore in ``store_dir`` (a temporary directory for a
    world of one), with its DeviceMeshes, (a)-(h) each beside its
    single-device twin. Returns each kernel's launches on this rank."""
    import shutil
    import tempfile

    import torch.distributed as dist

    tmp = store_dir or tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    backend = "nccl" if device == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(f"{tmp}/store", world), rank=rank,
                            world_size=world)
    total: dict = {}
    t0 = time.perf_counter()
    try:
        if world == 1:
            print(f"[mesh] world size 1 on 1 GPU: collectives are {backend.upper()} calls over "
                  "one rank; no multi-GPU number")
            print("[mesh] ppermute at world size 1: ring attention makes no rotation and a "
                  "one-stage pipeline has an empty stage chain, so the card sends and receives "
                  "nothing; psum, all-gather, reduce-scatter and all-to-all run as collectives")
        else:
            print(f"[mesh] world size {world}, one process and one device a rank: collectives "
                  f"are {backend.upper()} calls across {world} devices; rank 0 prints")
        cfg = full_config()
        _mesh_rounds(cfg, device, total)
        _mesh_attention(cfg, device, total)
        _mesh_smpc(device, total)
        _mesh_secagg(device)
        _mesh_fsdp(cfg, device, total)
        _mesh_pipeline(device)
        _mesh_moe(device)
    finally:
        dist.destroy_process_group()
        if store_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    for name in KERNELS:
        # the mesh path's MoE is the top-1 layer: no row kernel
        check(device != "cuda" or KERNELS[name][1] == "none" or total.get(name, 0) > 0,
              f"mesh: {name} was not launched on the mesh path")
    print(f"[mesh] phase mesh {time.perf_counter() - t0:.1f} s; launches on the mesh path "
          f"(rank {rank}) {total}")
    return total


def _mesh_rank(rank, world, store_dir, device) -> None:
    """One rank of :func:`mesh_world`: only rank 0 prints."""
    import os

    if rank:
        sys.stdout = open(os.devnull, "w")
    if device == "cuda":
        torch.cuda.set_device(rank)
    phase_mesh(device, rank=rank, world=world, store_dir=store_dir)


def mesh_world(world: int, device="cuda", timeout=300) -> None:
    """Phase mesh on ``world`` devices of one machine, one spawned process
    each (``python3 chip_smoke.py --mesh-world 4`` on a four-GPU machine):
    the kernels are built here first, then every rank runs (a)-(h) with the
    whole inputs and checks its own results. Fails, and stops every rank,
    as soon as one rank fails (the others would wait in a collective) or
    after ``timeout`` seconds."""
    import multiprocessing
    import shutil
    import tempfile

    if device == "cuda":
        check(torch.cuda.device_count() >= world,
              f"{world} ranks need {world} GPUs, this machine has {torch.cuda.device_count()}")
        phase_build()
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_world_")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank, args=(r, world, store_dir, device))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
        codes = [p.exitcode for p in procs]
        check(all(c == 0 for c in codes),
              f"mesh world of {world}: rank exit codes {codes} (None: still running, stopped)")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
    print(f"[mesh] world of {world}: every rank passed")


# --------------------------------------------------------------------------
# phase 18: storm
# --------------------------------------------------------------------------

STORM_SCENARIOS = ("smoke", "full")


def _ttft_buckets() -> list:
    """Cumulative (le, count) buckets of ``serving_ttft_seconds`` summed over
    every label set of this process's telemetry bus — the histogram the
    nodes' SLO engines read their TTFT objective from."""
    from pygrid_tpu_torch import telemetry

    total: dict = {}
    for (name, _), snap in telemetry.histograms().items():
        if name == "serving_ttft_seconds":
            for le, n in snap["buckets"]:
                total[le] = total.get(le, 0) + n
    return sorted(total.items())


def _quantile_bound(before: list, after: list, q: float):
    """The upper bound of the bucket that holds quantile ``q`` of the
    observations made between two ``_ttft_buckets`` readings."""
    prev = dict(before)
    diff = [(le, n - prev.get(le, 0)) for le, n in after]
    count = diff[-1][1] if diff else 0
    if not count:
        return None, 0
    return next(le for le, n in diff if n >= q * count), count


def _storm_probe(topology, device) -> None:
    """Before the storm's topology stops: node 0's paged KV pool and a
    tensor the node holds (sent through a port client) are on ``device``."""
    import numpy as np

    from pygrid_tpu_torch.client import DataCentricFLClient
    from pygrid_tpu_torch.storm.loadgen import GEN_MODEL_ID

    ctx = topology.node_ctx(0)
    engine = ctx.serving.engines()[GEN_MODEL_ID]
    check(engine._k.device.type == torch.device(device).type,
          f"storm: the KV pool is on {engine._k.device}, not {device}")
    client = DataCentricFLClient(topology.nodes[0].url, device=device)
    try:
        client.send(np.arange(4, dtype=np.float32), tags=("#storm-device",))
        held = [o.value for store in ctx.all_stores() for o in store.search(["#storm-device"])]
    finally:
        client.close()
    check(len(held) == 1 and isinstance(held[0], torch.Tensor)
          and held[0].device.type == torch.device(device).type,
          f"storm: the node holds {[getattr(v, 'device', type(v)) for v in held]}, not {device}")
    print(f"[storm] node 0's KV pool {tuple(engine._k.shape)} {engine._k.dtype} on "
          f"{engine._k.device}; a tensor it holds on {held[0].device}")


def _storm_lines(name, report, secs, ttft) -> None:
    v = {x.name: x for x in report.verdicts}
    print(f"[storm] {name}: {secs:.1f} s wall (build, {report.scenario['duration_s']} s of "
          f"traffic, {report.scenario['settle_s']} s settle, checks)")
    for leg, counts in sorted(report.metrics["ops"].items()):
        print(f"[storm] {name} traffic {leg}: "
              + ", ".join(f"{k}={n}" for k, n in sorted(counts.items())))
    for x in report.verdicts:
        measured = {k: m for k, m in x.measured.items() if k not in ("ledgers", "ops")}
        print(f"[storm] {name} verdict {x.name}: {'PASS' if x.ok else 'FAIL'} {measured}"
              + (f" ({x.detail})" if x.detail else ""))
    trans = [t for t in report.metrics["transitions"] if t["from"] is not None]
    held = []
    for i, t in enumerate(trans):
        if t["to"] == "breach":
            out = next((u for u in trans[i + 1:] if u["name"] == t["name"]
                        and u["from"] == "breach"), None)
            held.append(f"{t['name']} {out['ts'] - t['ts']:.3f} s" if out else
                        f"{t['name']} not left")
    print(f"[storm] {name} SLO transitions on node 0: "
          f"{[(t['name'], t['from'], t['to']) for t in trans]}; breach to recovery: {held}")
    if "degraded_routing" in v and v["degraded_routing"].ok:
        print(f"[storm] {name} slow node flipped to degraded "
              f"{v['degraded_routing'].measured['react_s']} s after slow_node was applied, "
              "and every node was back online before the run ended")
    p50, n = ttft[0]
    p99, _ = ttft[1]
    print(f"[storm] {name} TTFT over {n} generations (serving_ttft_seconds, the SLO engine's "
          f"histogram): p50 <= {p50} s, p99 <= {p99} s (bucket bounds)")


def phase_storm(device="cuda") -> dict:
    """The storm harness on the card: ``StormHarness(get_scenario(name),
    device=device)`` for smoke, then full; every verdict must pass, the
    smoke dump replays with no mismatch, node 0's KV pool and a tensor it
    holds are on ``device``. Returns each kernel's launches during the
    storms (expected 0: decode runs eagerly, the SMPC leg only adds
    shares)."""
    import os
    import shutil
    import tempfile

    from pygrid_tpu_torch.storm import loadgen
    from pygrid_tpu_torch.storm.replay import replay
    from pygrid_tpu_torch.storm.scenarios import get_scenario

    flight = tempfile.mkdtemp(prefix="chip_smoke_flight_")
    saved = {k: os.environ.get(k) for k in ("PYGRID_FLIGHT_DIR", "PYGRID_FLIGHT_MIN_INTERVAL_S")}
    os.environ.update(PYGRID_FLIGHT_DIR=flight, PYGRID_FLIGHT_MIN_INTERVAL_S="0")

    class ProbedTopology(loadgen.StormTopology):
        def close(self):
            try:
                _storm_probe(self, device)
            finally:
                super().close()

    counters = _counters()
    for c in counters.values():
        c.reset_launch_counts()
    plain = loadgen.StormTopology
    loadgen.StormTopology = ProbedTopology
    print(f"[storm] {card_line()}; nodes on {device}, network and sub-aggregators on the host")
    try:
        for name in STORM_SCENARIOS:
            before = _ttft_buckets()
            t0 = time.perf_counter()
            report = loadgen.StormHarness(get_scenario(name), device=device).run()
            secs = time.perf_counter() - t0
            after = _ttft_buckets()
            _storm_lines(name, report, secs, (_quantile_bound(before, after, 0.5),
                                              _quantile_bound(before, after, 0.99)))
            failed = [(x.name, x.detail) for x in report.verdicts if not x.ok]
            check(report.ok and not failed, f"storm {name}: verdicts failed: {failed}")
            if name == "smoke":
                t0 = time.perf_counter()
                replayed, mismatches = replay(report.dump_path, device=device)
                check(not mismatches and replayed.ok,
                      f"storm: the smoke dump's replay differs: {mismatches}; replayed "
                      f"{[(x.name, x.detail, x.measured) for x in replayed.verdicts if not x.ok]}")
                print(f"[storm] smoke dump replayed in {time.perf_counter() - t0:.1f} s: "
                      f"{len(replayed.verdicts)} verdicts, no mismatch")
    finally:
        loadgen.StormTopology = plain
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(flight, ignore_errors=True)
    launches = {k: n for c in counters.values() for k, n in c.launch_counts().items()}
    print(f"[storm] hand-written kernel launches during the storms: {launches}")
    return launches


# --------------------------------------------------------------------------
# phase 19: deploy
# --------------------------------------------------------------------------


def _gpu_pids() -> list:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return [int(x) for x in out.stdout.split() if x.strip().isdigit()]


def _wait_gpu_pids(done, device, timeout=10.0) -> list:
    """Poll nvidia-smi's compute processes until ``done(pids)`` or the
    timeout; the last reading (no reading off the card)."""
    if device != "cuda":
        return []
    deadline = time.perf_counter() + timeout
    while True:
        pids = _gpu_pids()
        if done(pids) or time.perf_counter() > deadline:
            return pids
        time.sleep(0.2)


def phase_deploy(device="cuda") -> None:
    """The deploy plane: every provider, deployment type and app rendered
    as a dry run; then ``LocalProvider.deploy(apply=True)`` spawns a port
    node on ``device`` on a free port: ``/healthz`` 200 within 60 s, a
    tensor through ``DataCentricFLClient`` and back, the child among the
    card's compute processes (by its pid, or, where nvidia-smi reports pids
    of another namespace, by their count growing by one), and after
    ``destroy()`` the child gone and the count back."""
    import json as _json
    import socket
    import tempfile

    import numpy as np

    from pygrid_tpu_torch.client import DataCentricFLClient
    from pygrid_tpu_torch.infra.config import (APPS, DEPLOYMENT_TYPES, PROVIDERS, AppConfig,
                                               DeployConfig, GpuConfig)
    from pygrid_tpu_torch.infra.providers import build_provider
    from pygrid_tpu_torch.web import client as http

    with tempfile.TemporaryDirectory(prefix="chip_smoke_deploy_") as tmp:
        rendered = 0
        for provider in PROVIDERS:
            for kind in DEPLOYMENT_TYPES:
                for app in APPS:
                    cfg = DeployConfig(provider=provider, deployment_type=kind,
                                       app=AppConfig(name=app), root_dir=tmp)
                    out = build_provider(cfg).deploy(apply=False)
                    check(out["applied"] is False and out["files"],
                          f"deploy: {provider}/{kind}/{app} rendered nothing")
                    if "main.tf.json" in out["files"]:
                        with open(f"{out['root_dir']}/main.tf.json") as fh:
                            _json.load(fh)
                    rendered += 1
        print(f"[deploy] {rendered} (provider, deployment type, app) stacks rendered as dry runs "
              f"(terraform {'present' if build_provider(cfg).tf.available() else 'absent'})")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        cfg = DeployConfig(provider="local", app=AppConfig(name="node", id="deployed",
                                                           host="127.0.0.1", port=port),
                           gpu=GpuConfig(device=device), root_dir=tmp)
        provider = build_provider(cfg)
        pids_before = _gpu_pids() if device == "cuda" else []
        t0 = time.perf_counter()
        result = provider.deploy(apply=True)
        proc = provider.processes[0]
        try:
            url = f"http://127.0.0.1:{port}"
            healthy = None
            while healthy is None and time.perf_counter() - t0 < 60:
                check(proc.poll() is None, f"deploy: the node exited with {proc.returncode}")
                try:
                    if http.get(url + "/healthz", timeout=2).status_code == 200:
                        healthy = time.perf_counter() - t0
                except OSError:
                    time.sleep(0.1)
            check(healthy is not None, "deploy: the spawned node was not healthy within 60 s")
            client = DataCentricFLClient(url, device=device)
            try:
                sent = np.arange(6, dtype=np.float32) * 1.5
                back = client.send(sent, tags=("#deployed",)).get()
            finally:
                client.close()
            back = back.cpu().numpy() if isinstance(back, torch.Tensor) else np.asarray(back)
            check(np.array_equal(back, sent), f"deploy: the tensor came back as {back!r}")
            pids = _wait_gpu_pids(lambda p: result["pid"] in p or len(p) > len(pids_before),
                                  device)
            check(device != "cuda" or result["pid"] in pids or len(pids) == len(pids_before) + 1,
                  f"deploy: the node (pid {result['pid']}) holds no CUDA context: the card's "
                  f"compute processes {pids_before} before it, {pids} with it")
            print(f"[deploy] {provider.command()[1:3]} spawned (pid {result['pid']}) healthy in "
                  f"{healthy:.2f} s; a tensor sent through DataCentricFLClient came back equal; "
                  f"nvidia-smi's compute processes {pids_before} before the node, {pids} with "
                  "it (a pid namespace apart from ours when the pid is not among them: the "
                  "count says the node holds a context)")
        finally:
            provider.destroy()
        after = _wait_gpu_pids(lambda p: len(p) <= len(pids_before), device)
        check(device != "cuda" or len(after) == len(pids_before),
              f"deploy: the card's compute processes {after} after destroy(), {pids_before} "
              "before the node")
        check(proc.poll() is not None, "deploy: the node still runs after destroy()")
        print(f"[deploy] destroy(): the node exited with {proc.returncode}")

# --------------------------------------------------------------------------
# phase 20: lint — gridlint on the card's machine, and its two twins
# --------------------------------------------------------------------------


def _lint_run() -> None:
    """(a) ``python -m pygrid_tpu_torch.analysis pygrid_tpu_torch/`` in a
    subprocess, strict against the committed baseline: it must exit 0."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pygrid_tpu_torch.analysis", "pygrid_tpu_torch/",
         "--strict-baseline", "--format", "json"],
        cwd=root, capture_output=True, text=True, timeout=600,
    )
    secs = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"lint: exit {proc.returncode}:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout)
    families = {}
    for f in report["baselined"]:
        families[f["code"][:3]] = families.get(f["code"][:3], 0) + 1
    print(f"[lint] python -m pygrid_tpu_torch.analysis pygrid_tpu_torch/ --strict-baseline: exit 0, "
          f"{report['files_checked']} files, {len(report['failures'])} findings, "
          f"{len(report['baselined'])} baselined by family {dict(sorted(families.items()))}, "
          f"{len(report['suppressed'])} suppressed, {len(report['stale_baseline'])} stale; "
          f"{report['elapsed_s']} s in the linter, {secs:.2f} s with the interpreter's start")


def _sync_stacks(fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``; returns
    (its result, one list of ``(repo path, line, function)`` frames inside
    pygrid_tpu_torch, innermost last, per sync warning), from whichever
    thread the sync ran on."""
    import threading
    import traceback
    import warnings

    root = os.path.dirname(os.path.abspath(__file__)) + os.sep
    pkg = os.path.join(root, "pygrid_tpu_torch") + os.sep
    stacks, lock = [], threading.Lock()

    def hook(message, category, filename, lineno, file=None, line=None):
        # torch's text for a sync; its one-time "prototype feature" notice
        # at set_sync_debug_mode is no sync
        if "called a synchronizing CUDA operation" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        frames = [(f.filename[len(root):], f.lineno, f.name) for f in stack
                  if f.filename.startswith(pkg)]
        if not frames:  # say where it came from instead
            print(f"[lint] a sync with no pygrid_tpu_torch frame on thread "
                  f"{threading.current_thread().name}: {str(message)[:120]!r} at "
                  + " <- ".join(f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"
                                for f in reversed(stack[-6:])))
        with lock:
            stacks.append(frames)

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, stacks


def _classify_syncs(tag, stacks, gl1, gl102) -> dict:
    """Hold each observed sync against GL1: a sync with a program body on
    its stack must sit in a body GL1 reaches, on a line GL102 reported.
    Returns the syncs outside programs by (site, function)."""
    def inside(spans, path, line):
        return any(a <= line <= b for a, b, _ in spans.get(path, ()))

    in_programs, outside = {}, {}
    for frames in stacks:
        check(frames, f"lint {tag}: a sync with no pygrid_tpu_torch frame cannot be held "
                      "against GL1 (its origin is printed above)")
        path, line, _ = frames[-1]
        if any(inside(gl1.roots, p, n) for p, n, _ in frames):
            check(inside(gl1.closure, path, line),
                  f"lint {tag}: a sync at {path}:{line} inside a program, in a body GL1 does "
                  "not reach")
            check(any(a <= line <= b for a, b in gl102.get(path, ())),
                  f"lint {tag}: a sync at {path}:{line} inside a program, on a line GL102 "
                  "reported clean")
            in_programs[f"{path}:{line}"] = in_programs.get(f"{path}:{line}", 0) + 1
        else:
            site = (f"{path}:{line}", frames[-1][2])
            outside[site] = outside.get(site, 0) + 1
    print(f"[lint] {tag}: {len(stacks)} syncs; in programs, each on a GL102 line "
          f"(baselined): {in_programs or 'none'}; outside programs: "
          f"{ {site: n for (site, _), n in outside.items()} or 'none'}")
    return outside


def _no_syncs_in_programs(tag, stacks, outside) -> None:
    """Every sync of a run lies outside the programs: their host inputs
    cross in pinned memory without waiting for the stream."""
    inside = len(stacks) - sum(outside.values())
    check(inside == 0, f"lint {tag}: {inside} syncs inside programs (listed above)")


def _lint_syncs() -> None:
    """(b) The GL1 twin: one fused FedAvg round and one serving request
    (phase rounds' and phase serving's configurations, full width) under
    the sync debug mode; every sync is mapped to its innermost
    pygrid_tpu_torch frame and held against GL1's reach and GL102's
    findings."""
    from functools import partial

    from pygrid_tpu_torch.analysis import run_checks
    from pygrid_tpu_torch.analysis.checkers import TraceSafetyChecker
    from pygrid_tpu_torch.models import transformer
    from pygrid_tpu_torch.parallel import flash_attention as fa
    from pygrid_tpu_torch.parallel import make_fused_rounds
    from pygrid_tpu_torch.serving import EngineConfig, GenerationEngine

    root = os.path.dirname(os.path.abspath(__file__))
    gl1 = TraceSafetyChecker()
    t0 = time.perf_counter()
    res = run_checks([os.path.join(root, "pygrid_tpu_torch")], checkers=[gl1], root=root)
    gl102 = {}
    for f in res.failures + res.baselined + res.suppressed:
        if f.code == "GL102":
            gl102.setdefault(f.path, []).append((f.line, f.end_line or f.line))
    n_roots = sum(len(v) for v in gl1.roots.values())
    n_bodies = sum(len(v) for v in gl1.closure.values())
    print(f"[lint] GL1 in {time.perf_counter() - t0:.2f} s: {n_roots} program bodies reaching "
          f"{n_bodies} function bodies in {len(gl1.closure)} files; "
          f"{sum(len(v) for v in gl102.values())} GL102 lines")

    from pygrid_tpu_torch.models import decode

    cfg, K, B = full_config(), 8, 4
    params, X, y = transformer_setup(cfg, K, B, "cuda")
    loss_fn = partial(transformer.loss_and_acc, cfg=cfg, attn_fn=fa.flash_attention,
                      compute_dtype="bfloat16", ce_grad_dtype="bfloat16")
    one_round = make_fused_rounds(loss_fn, n_rounds=1)
    one_round(params, X, y, 0.1)
    fa.reset_launch_counts()
    # the backward on the calling thread: a sync inside it then carries the
    # Python stack of the program that ran it
    torch.autograd.set_multithreading_enabled(False)
    try:
        (_, losses, _), stacks = _sync_stacks(lambda: one_round(params, X, y, 0.1))
    finally:
        torch.autograd.set_multithreading_enabled(True)
    counts = fa.launch_counts()
    check(all(n == cfg.n_layers for n in counts.values()),
          f"lint fused round: the flash kernels launched {counts}, expected {cfg.n_layers} each")
    check(_finite(losses), "lint fused round: non-finite loss")
    outside = _classify_syncs(f"one fused FedAvg round (K={K}, B={B}, flash launches {counts})",
                              stacks, gl1, gl102)
    _no_syncs_in_programs("fused round", stacks, outside)

    engine = GenerationEngine(cfg, params, EngineConfig(max_slots=8, cache_dtype=torch.float32),
                              model_id="lint", device="cuda")
    try:
        rng = np.random.RandomState(7)
        cases = _serve_cases(cfg, rng)
        engine.warmup(prompt_lens=(max(p.shape[1] for p, _ in cases),))
        _drive(engine, cases[:2])
        quanta0 = engine.stats()["fused_scans"]
        n_new = 3 * engine.config.quantum + 1  # the prefill's token, then 3 fused quanta
        toks, stacks = _sync_stacks(lambda: engine.submit(cases[0][0], n_new, timeout=300))
        quanta = engine.stats()["fused_scans"] - quanta0
        check(np.asarray(toks).shape == (1, n_new), f"lint serving: tokens {np.shape(toks)}")
        check(quanta >= 1, "lint serving: no fused quantum ran")
        # the same request sampled: the sampling programs' PRNG draws
        quanta0 = engine.stats()["fused_scans"]
        sampled, s_stacks = _sync_stacks(lambda: engine.submit(
            cases[0][0], n_new, temperature=0.8, seed=11, timeout=300))
        s_quanta = engine.stats()["fused_scans"] - quanta0
        s_toks = np.asarray(sampled)
        check(s_toks.shape == (1, n_new) and bool(((s_toks >= 0) & (s_toks < cfg.vocab)).all()),
              f"lint serving: sampled tokens {s_toks.shape} or out of the vocabulary")
    finally:
        engine.close()
    ref = decode.generate(params, torch.from_numpy(cases[0][0]).long().to("cuda"), n_new,
                          cfg).cpu().numpy()
    _serve_match("lint greedy request", params, cfg, [(cases[0][0], n_new)], [toks], [ref], "cuda")
    print(f"[lint] greedy request: tokens equal to generate()'s: "
          f"{bool(np.array_equal(np.asarray(toks), ref))} (else a near tie, checked above)")
    outside = _classify_syncs(f"one serving request (1 prefill, {quanta} fused quanta of "
                              f"{engine.config.quantum} steps)", stacks, gl1, gl102)
    _no_syncs_in_programs("greedy serving request", stacks, outside)
    fused = sum(n for (_, fn), n in outside.items() if fn == "_fused_scan")
    print(f"[lint] serving: {sum(outside.values())} syncs outside programs for 1 admission and "
          f"{quanta} fused quanta; {fused} of them in _fused_scan: {fused / quanta:.2f} a "
          "quantum (the design: one token fetch a quantum)")
    s_outside = _classify_syncs(f"the same request at temperature 0.8 (1 prefill, {s_quanta} "
                                "fused quanta)", s_stacks, gl1, gl102)
    _no_syncs_in_programs("sampled serving request", s_stacks, s_outside)
    print(f"[lint] sampled serving: {sum(s_outside.values())} syncs outside programs")


def _demangle(name: str) -> tuple[str, tuple[int, ...]] | None:
    """``_ZN3pgt19flash_fwd_tc_kernelILi128EE…`` -> ("flash_fwd_tc_kernel",
    (128,)); a profiler name ``void pgt::flash_fwd_tc_kernel<128>(…)`` too."""
    import re

    m = re.match(r"_ZN3pgt(\d+)(\w+)", name)
    if m:
        n = int(m.group(1))
        kernel, rest = m.group(2)[:n], m.group(2)[n:]
        t = re.match(r"I((?:Li-?\d+E)+)E", rest)
        return kernel, tuple(int(x) for x in re.findall(r"Li(-?\d+)E", t.group(1))) if t else ()
    m = re.search(r"pgt::(\w+)(?:<([-\d, ]+)>)?\(", name)
    if m:
        return m.group(1), tuple(int(x) for x in m.group(2).split(",")) if m.group(2) else ()
    return None


def _ptxas_report() -> dict:
    """(kernel, template args) -> {"registers", "static_smem"} from what
    kernels/build.py kept of ptxas -v for each library."""
    import re

    from pygrid_tpu_torch.kernels import build

    out, entry = {}, None
    for name in build.LIBRARIES:
        for line in build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = _demangle(m.group(1))
                out[entry] = {"registers": None, "static_smem": 0}
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and entry is not None:
                out[entry]["registers"] = int(m.group(1))
                s = re.search(r"(\d+) bytes smem", line)
                out[entry]["static_smem"] = int(s.group(1)) if s else 0
    return out


def _lint_bounds() -> None:
    """(c) The GL5 twin: GL5's static threads and shared memory of every
    kernel instantiation against ptxas' report (kept by kernels/build.py)
    and against the launches the card ran under torch.profiler."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from pygrid_tpu_torch.analysis.checkers.gl5_cuda import SMEM_LIMIT, launch_model
    from pygrid_tpu_torch.models import moe
    from pygrid_tpu_torch.parallel import flash_attention as fa
    from pygrid_tpu_torch.smpc import ring_matmul as rm

    root = os.path.dirname(os.path.abspath(__file__))
    gl5 = {}
    for launch in launch_model(os.path.join(root, "pygrid_tpu_torch", "csrc"), root):
        gl5[(launch.kernel, launch.targs)] = launch
    ptxas = _ptxas_report()
    check(set(gl5) == set(ptxas),
          f"lint GL5: instantiations {sorted(set(gl5) ^ set(ptxas))} are in only one of GL5's "
          "launch model and ptxas' entry functions")

    g = torch.Generator(device="cuda").manual_seed(3)
    runs = []  # (D used, the call)
    for dtype, dims in ((torch.bfloat16, (40, 64, 128, 256, (192, 128))),
                        (torch.float32, (64, 256))):
        for D in dims:
            D, Dv = D if isinstance(D, tuple) else (D, D)  # q, k at D; v, dO at Dv
            q, k, v, do = (torch.randn(2, 130, 2, w, device="cuda", dtype=dtype, generator=g)
                           for w in (D, D, Dv, Dv))
            scale = D ** -0.5

            def call(q=q, k=k, v=v, do=do, scale=scale):
                out, lse = fa.flash_fwd(q, k, v, True, scale)
                delta = fa.softmax_delta(out, do)
                fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale)
                fa.flash_bwd_dq(q, k, v, do, lse, delta, True, scale)

            runs.append((D, call))
    a = torch.randint(-2**62, 2**62, (3, 100, 70), device="cuda", generator=g)
    b = torch.randint(-2**62, 2**62, (3, 70, 90), device="cuda", generator=g)
    runs.append((None, lambda: rm.ring_matmul_kernel(a, b)))
    for dtype in (torch.bfloat16, torch.float32):  # the six row kernels in each dtype
        T, E, k, held, d, f = 64, 16, 4, 4, 64, 32
        x32 = torch.randn(T, d, device="cuda", generator=g)
        wg = torch.randn(E, d, device="cuda", generator=g)
        sel, w = moe.route_topk(x32, wg, torch.zeros(E, device="cuda"), k, 1.0)
        order, offs, pos, mask = moe.dispatch(sel, 0, held)
        M = order.shape[0]
        x, h, o, da, gy = (torch.randn(*shape, device="cuda", generator=g).to(dtype) for shape in
                           ((T, d), (M, 2 * f), (M, d), (M, f), (T, d)))
        dws = torch.randn(M, device="cuda", generator=g)

        def rows(x=x, h=h, o=o, da=da, gy=gy, dws=dws, w=w, order=order, offs=offs, pos=pos,
                 mask=mask, k=k):
            moe.gather_rows(x, order, offs, k)
            moe.swiglu(h, offs)
            moe.combine(o, w, pos, mask)
            moe.rows_bwd(gy, o, w, order, offs, k)
            moe.swiglu_bwd(h, da, offs)
            moe.combine_bwd(o, dws, pos, mask)

        runs.append((None, rows))

    def capture(call) -> dict:
        """One profiler session over ``call``: each pgt kernel's first
        launch record (block threads, shared memory, registers)."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)  # a kernel ahead of the ones recorded
            call()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                trace = json.load(fh)
        records = {}
        for ev in trace.get("traceEvents", []):
            key = _demangle(ev.get("name", "")) if ev.get("cat") == "kernel" else None
            if key is not None:
                names.add(ev["name"][:60])
            if key in gl5:
                args = ev.get("args", {})
                block = args.get("block", [0, 0, 0])
                records.setdefault(key, (int(block[0]) * int(block[1]) * int(block[2]),
                                         args.get("shared memory"),
                                         args.get("registers per thread")))
        return records

    for _, call in runs:
        call()
    torch.cuda.synchronize()
    # the runs launch every instantiation between them; where the profiler
    # dropped a launch record, every run is traced again (3 passes at most)
    seen, passes, names = {}, 0, set()
    while passes < 3 and set(gl5) - set(seen):
        passes += 1
        for D, call in runs:
            for key, rec in capture(call).items():
                seen.setdefault(key, (D, *rec))
        if set(gl5) - set(seen):
            print(f"[lint] GL5 twin: profiler pass {passes} has no launch record of "
                  f"{sorted(set(gl5) - set(seen))}; the pgt kernel names it saw: {sorted(names)}")
    check(not set(gl5) - set(seen),
          f"lint GL5: no launch record of {sorted(set(gl5) - set(seen))} in {passes} profiler "
          "passes over runs that launch them")
    print("[lint] GL5 twin: kernel | GL5 threads / launched block | GL5 dynamic smem (at D) + "
          "ptxas static = profiler smem | ptxas registers = profiler registers")
    for key in sorted(gl5):
        launch, rep = gl5[key], ptxas[key]
        name = launch.name
        D, block, smem, regs = seen[key]
        want_smem = launch.smem() if launch.smem() is not None else launch.smem(D=D)
        check(launch.threads == launch.block == block,
              f"lint GL5 {name}: __launch_bounds__ {launch.threads}, GL5 block {launch.block}, "
              f"the card launched {block} threads")
        check(want_smem is not None and want_smem <= SMEM_LIMIT,
              f"lint GL5 {name}: shared memory {want_smem} at D={D}")
        check(smem is not None and want_smem + rep["static_smem"] == int(smem),
              f"lint GL5 {name}: GL5 {want_smem} + ptxas static {rep['static_smem']} bytes of "
              f"shared memory, the profiler {smem}")
        check(regs is not None and rep["registers"] == int(regs),
              f"lint GL5 {name}: ptxas {rep['registers']} registers, the profiler {regs}")
        print(f"[lint]   {name}: {launch.threads} / {block} | {want_smem} (D={D}) + "
              f"{rep['static_smem']} = {smem} | {rep['registers']} = {regs}")
    print(f"[lint] GL5 twin: all {len(gl5)} instantiations launched and held ({passes} "
          f"profiler pass(es)); {len(gl5)} = ptxas' {len(ptxas)} entry functions")


def phase_lint() -> None:
    """The port's gridlint on the card's machine: (a) the lint, strict
    against its baseline; (b) GL1's dynamic twin, the sync debug mode over a
    fused round and a serving request; (c) GL5's twin against ptxas and the
    profiler. Any failure raises."""
    _lint_run()
    _lint_syncs()
    # (c) in a fresh interpreter: after the other phases in this process the
    # profiler returned launch records of only some of the kernels it ran
    # (two whole runs; alone after the build it returned all of them)
    sys.stdout.flush()
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke as c; c._lint_bounds()"],
        cwd=os.path.dirname(os.path.abspath(__file__)), timeout=900,
    )
    check(proc.returncode == 0, f"lint GL5 twin: exit {proc.returncode} (its output is above)")
    print(card_line())


EXAMPLES = [
    # script under examples_torch/, its arguments beside --device cuda, and
    # the success line its JAX twin's test asserts
    ("smpc_demo.py", (), "Beaver"),
    ("model_centric/01_create_plan.py", ("--spawn",), "hosted mnist/1.0"),
    ("model_centric/02_execute_plan.py", (), "latest checkpoint"),
    ("data_centric/01_populate_node.py", ("--spawn",), "8 pointers"),
    ("full_fl_demo.py", ("--spawn", "--workers", "2", "--cycles", "2"), "latest checkpoint"),
    ("data_centric/02_train_model.py", ("--spawn",), "max |w - w*|"),
    ("encrypted_inference.py", ("--spawn",), "encrypted inference OK"),
    ("advanced_fl.py", ("--spawn",), "advanced FL OK"),
    ("secagg_fl.py", ("--spawn",), "secure aggregation OK"),
    ("async_fl.py", ("--spawn",), "async FL OK"),
    ("fed_transformer.py", (), "federated transformer"),
]
#: the kernels each example must launch on the card
EXAMPLE_KERNELS = {
    "smpc_demo.py": ("ring_matmul",),
    "encrypted_inference.py": ("ring_matmul",),
    "fed_transformer.py": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
}


def _example_main(script: str):
    """The ``main(argv)`` of ``examples_torch/<script>``, loaded from its file
    (the scripts' names are not module names)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "examples_torch" / script
    spec = importlib.util.spec_from_file_location(
        "example_" + script.replace("/", "_").removesuffix(".py"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def _captured(fn):
    """Run ``fn`` with file descriptor 1 going to a temporary file, so that
    the output of Python and of any child process is caught; returns (its
    result, that output)."""
    import tempfile

    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile() as tmp:
        os.dup2(tmp.fileno(), 1)
        try:
            out = fn()
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        tmp.seek(0)
        text = tmp.read().decode(errors="replace")
    return out, text


def phase_examples(device="cuda") -> dict:
    """The port's examples (``examples_torch/``) on the card, in process
    through each script's ``main(argv)`` at ``--device cuda``, so that the
    launch counts see them: each must return 0 and print its success line;
    fed_transformer.py must launch the three flash kernels and
    smpc_demo.py and encrypted_inference.py the ring kernel. Prints each
    example's wall time and launches. Returns the launches by kernel."""
    from pygrid_tpu_torch import web
    from pygrid_tpu_torch.node import create_app

    print(f"[examples] {card_line()}; examples_torch/ at --device {device}")
    counters = _counters()
    total = {name: 0 for name in KERNELS}
    walls = {}
    t_all = time.perf_counter()
    for script, args, line in EXAMPLES:
        main = _example_main(script)
        argv = [*args, "--device", device]
        node = None
        if script == "model_centric/02_execute_plan.py":
            # it trains against a hosted process: host one first on a node
            node = web.BackgroundServer(create_app("alice", device=device)).start()
            argv += ["--node", node.url]
            rc, text = _captured(lambda: _example_main("model_centric/01_create_plan.py")(
                ["--node", node.url, "--device", device]))
            check(rc == 0 and "hosted mnist/1.0" in text,
                  f"examples: 01_create_plan.py --node failed (rc {rc}):\n{text[-3000:]}")
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            rc, text = _captured(lambda: main(argv))
        finally:
            if node is not None:
                node.stop()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: n for c in counters.values() for k, n in c.launch_counts().items()}
        walls[script] = secs
        check(rc == 0, f"examples: {script} returned {rc}:\n{text[-3000:]}")
        check(line in text, f"examples: {script} printed no {line!r}:\n{text[-3000:]}")
        for name in EXAMPLE_KERNELS.get(script, ()):
            check(counts[name] > 0, f"examples: {script} launched no {name}: {counts}")
        for name, n in counts.items():
            total[name] += n
        said = next(t for t in text.splitlines() if line in t)
        print(f"[examples] {script} {' '.join(argv)}: {secs:.2f} s wall; launches "
              f"{ {k: n for k, n in counts.items() if n} or 'none'}; {said.strip()[:160]!r}")
    print(f"[examples] all {len(EXAMPLES)} passed in {time.perf_counter() - t_all:.2f} s of wall "
          f"({', '.join(f'{s} {w:.2f}' for s, w in walls.items())}); launches {total}; "
          f"{card_line()}")
    return total


def main() -> int:
    check(torch.cuda.is_available(), "no CUDA GPU: chip_smoke.py runs on the card only")
    import pygrid_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    if sys.argv[1:2] == ["--mesh-world"]:
        mesh_world(int(sys.argv[2]))
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    phase_build()
    errs = phase_kernels()
    timing = phase_timing()
    phase_timing_wide()
    phase_timing_narrow_v()
    moe_errs, moe_timing = phase_moe_rows()
    errs.update(moe_errs)
    timing.update(moe_timing)
    moe_launches = phase_rounds_moonlight()
    phase_timing_band()
    phase_rounds_trinity()
    launches, params = phase_rounds()
    launches.update(moe_launches)
    phase_small()
    phase_parity()
    errs["ring_matmul"] = phase_ring_kernel()
    timing["ring_matmul"] = phase_ring_timing()
    smpc_launches = phase_smpc_rounds()
    mlp_launches, mlp_out = phase_encrypted_mlp()
    phase_wire(params, mlp_out)
    fl_steps = phase_fl()
    dc_launches, dc_first, dc_ms = phase_datacentric()
    serve_tps = phase_serving()
    grid_launches = phase_grid(fl_steps["mnist-cnn-list"], dc_first, dc_ms, serve_tps)
    secagg_launches = phase_secagg(dc_first)
    launches["ring_matmul"] = (smpc_launches + mlp_launches + dc_launches + grid_launches
                               + secagg_launches)
    for name, n in phase_mesh().items():
        launches[name] += n
    for name, n in phase_storm().items():
        launches[name] += n
    phase_deploy()
    phase_lint()
    for name, n in phase_examples().items():
        launches[name] += n

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
