"""FedAvg rounds with the client axis sharded over the cards:
``parallel/fedavg_fused.py``'s ``make_sharded_fused_round`` over
``make_mesh``/``initialize_distributed`` (NCCL), one process a card.

The first process is rank 0: it starts one process for each further card
(this same command with a hidden ``--rank``), meets them through a file
store in a fresh directory under ``TMPDIR``, and prints the result. Every
rank holds the whole client batch and runs its block of clients; a round's
gradients cross the cards in one all-reduce. Rank 0 decides when the window
ends and every rank follows. When a rank fails, rank 0 stops every rank;
a rank whose parent is gone stops itself.

Set-up, window and check are those of ``fedavg_round`` (the reference on
rank 0 alone, over all the clients).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

from benchmark import harness as H
from benchmark.reference import compare

_HERE = os.path.dirname(os.path.abspath(__file__))


def _single():
    return H.load_module(Path(_HERE) / "fedavg_round.py", "benchmark.entries.fedavg_round")


def _spawn(ctx: H.RunContext) -> list:
    cmd = [sys.executable, str(ctx.root / "benchmark" / "run.py"), "--workload", ctx.cell.name,
           "--seed", str(ctx.seed), "--seconds", repr(ctx.seconds), "--trace", str(int(ctx.trace)),
           "--device", ctx.device, "--store", ctx.store]
    return [subprocess.Popen(cmd + ["--rank", str(r)], stdout=subprocess.DEVNULL)
            for r in range(1, ctx.world)]


def _watch_ranks(procs) -> None:
    """Rank 0: stop every rank, and this process, when one fails."""
    def loop():
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                return
            if any(c not in (None, 0) for c in codes):
                print(f"benchmark: a rank failed (exit codes {codes}); stopping every rank",
                      file=sys.stderr, flush=True)
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                os._exit(1)
            time.sleep(0.2)

    threading.Thread(target=loop, daemon=True, name="bench-rank-watch").start()


def _watch_parent() -> None:
    """A further rank: stop when the process that started it is gone."""
    parent = os.getppid()

    def loop():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=loop, daemon=True, name="bench-parent-watch").start()


def run(ctx: H.RunContext) -> H.Outcome:
    import torch.distributed as dist

    from pygrid_tpu_torch.parallel import initialize_distributed, make_mesh, make_sharded_fused_round
    from pygrid_tpu_torch.parallel.mesh import mesh_device

    single = _single()
    procs, made_store = [], False
    if ctx.rank == 0:
        ctx.store = tempfile.mkdtemp(prefix="bench_mesh_")
        made_store = True
        procs = _spawn(ctx)
        _watch_ranks(procs)
    else:
        _watch_parent()
    try:
        initialize_distributed(init_method=f"file://{ctx.store}/rendezvous", world_size=ctx.world,
                               rank=ctx.rank, device=ctx.device)
        ctl = dist.new_group(backend="gloo")
        mesh = make_mesh(axes=("clients",), device=ctx.device)
        dev = mesh_device(mesh)
        return _run_rank(ctx, single, ctl, mesh, dev, make_sharded_fused_round)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in procs:
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if made_store:
            shutil.rmtree(ctx.store, ignore_errors=True)


def _run_rank(ctx, single, ctl, mesh, dev, make_sharded_fused_round) -> H.Outcome:
    import torch.distributed as dist

    single.pin_precision()
    spec = ctx.cell.spec
    fam, params, pool, loss_fn = single.setup(ctx, dev)
    round_fn = make_sharded_fused_round(loss_fn, mesh, local_steps=spec["local_steps"])
    state, prog = single.first_rounds(round_fn, params, pool, spec["lr"])
    del params
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0

    def keep_going(want: bool) -> bool:
        flag = torch.tensor([1 if want else 0])
        dist.broadcast(flag, src=0, group=ctl)
        return bool(flag.item())

    win, losses, state, data = single.window(ctx, round_fn, state, pool, spec["lr"], keep_going)
    peak = torch.tensor([single.memory_peak(ctx)], dtype=torch.float64)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=ctl)
    busy = torch.tensor([data.busy_s if data else 0.0, data.window_s if data else 0.0],
                        dtype=torch.float64)
    dist.all_reduce(busy, group=ctl)
    failed = single.failed_rounds(losses)
    del state, pool, round_fn, loss_fn, losses
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    numbers = {k: 0.0 for k in spec["limits"]}
    if ctx.rank == 0:
        t_ref = time.perf_counter()
        ref = single.reference_readings(ctx, fam, dev)
        H.note(f"set-up {setup_s:.3f} s, window {win.span_s:.3f} s ({win.units} rounds), "
               f"reference {time.perf_counter() - t_ref:.3f} s")
        numbers = compare.training_numbers(prog, ref)
    dist.barrier(group=ctl)
    return H.Outcome(
        e2e=single.e2e(ctx, win, setup_s), numbers=numbers, limits=spec["limits"],
        attempted=win.units, failed=failed, memory_peak_bytes=int(peak.item()), trace=data,
        metric_ctx=single.metric_ctx(ctx, fam, win, data),
        busy_s=float(busy[0]) / ctx.world if data else None,
        window_s=data.window_s if data else None)
