"""FedAvg rounds through ``parallel/fedavg_fused.py``'s ``make_fused_round``
on one card, back to back, each round's params feeding the next.

Set-up draws the weights and a pool of client batches on the card, builds
the round, and drives that same round from the seed through its first
three rounds on three different batches: those warm every shape and are
what the reference checks. The window then runs rounds on the pool's
batches in turn until ``--seconds`` have passed.

``correct``: the reference (plain float32, ``reference/``) runs the same
three rounds from the same weights and batches once the window has closed
and the program's state is freed; ``reference/compare.py`` holds the
program's losses, first update and three-round change against it.
"""

from __future__ import annotations

import time

import torch

from benchmark import harness as H
from benchmark import trace as T
from benchmark import traffic
from benchmark.reference import compare

CHECK_ROUNDS = 3
#: batches the window cycles through: the checked rounds' three and one more
BATCH_POOL = 4


def setup(ctx: H.RunContext, device):
    """(family, initial params, batch pool, loss) for this run."""
    cell = ctx.cell
    fam = ctx.family()
    params = fam.init(cell.config, ctx.seed, device)
    pool = [traffic.batch(cell.traffic, cell.config, ctx.seed, i, device) for i in range(BATCH_POOL)]
    return fam, params, pool, fam.port_loss(cell.config, cell.spec)


def first_rounds(round_fn, params, pool, lr):
    """The round driven through its first rounds on the pool's first
    batches; returns its state after them and the program's readings."""
    p0, p = params, params
    losses, grad = [], None
    for i in range(CHECK_ROUNDS):
        with T.span("round"):
            p, loss, _ = round_fn(p, *pool[i], lr)
        losses.append(float(loss))
        if i == 0:
            grad = [float(((a - b) / lr).double().norm()) for a, b in zip(p0, p)]
    change = [float((b - a).double().norm()) for a, b in zip(p0, p)]
    return p, {"losses": losses, "grad": grad, "change": change}


def reference_readings(ctx: H.RunContext, fam, device, precision="f32", clients=None):
    """The reference's readings from the same weights and first batches,
    drawn again from the seed; ``clients`` keeps only the first that many
    clients of each batch."""
    cell = ctx.cell
    params0 = fam.init(cell.config, ctx.seed, device)
    batches = []
    for i in range(CHECK_ROUNDS):
        X, y = traffic.batch(cell.traffic, cell.config, ctx.seed, i, device)
        batches.append((X[:clients], y[:clients]) if clients else (X, y))
    states, losses = fam.reference_rounds(cell.config, cell.spec, params0, batches, precision)
    return compare.training_readings(params0, states, losses, cell.spec["lr"])


def pin_precision() -> None:
    """Float32 products in float32: TF32 off, as the configurations state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def window(ctx: H.RunContext, round_fn, state, pool, lr, keep_going=None):
    """Rounds back to back over the pool; returns (window, the losses'
    tensors, the final state, the profiler's reduced trace or None)."""
    spec = ctx.cell.spec
    holder, losses = [state], []

    def unit(i):
        with T.span("round"):
            p, loss, _ = round_fn(holder[0], *pool[(CHECK_ROUNDS + i) % len(pool)], lr)
        holder[0] = p
        losses.append(loss.detach())

    max_units = spec.get("trace_units") if ctx.trace else None
    with T.profiled(ctx.trace) as prof:
        with T.span("window"):
            win = H.run_window(unit, ctx.seconds, ctx.sync, max_units, keep_going)
    data = T.reduce(prof, _device_index(ctx)) if prof is not None else None
    return win, losses, holder[0], data


def _device_index(ctx) -> int | None:
    return torch.cuda.current_device() if ctx.device == "cuda" else None


def e2e(ctx: H.RunContext, win: H.Window, setup_s: float) -> dict:
    tokens = traffic.tokens_per_batch(ctx.cell.traffic) * win.units
    return {"train_tokens_per_s": tokens / win.span_s, "round_ms": win.span_s / win.units * 1e3,
            "setup_s": setup_s}


def failed_rounds(losses) -> int:
    return int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0


def metric_ctx(ctx: H.RunContext, fam, win: H.Window, data) -> dict:
    cell = ctx.cell
    out = {"units": win.units, "chips": cell.chips, "config": cell.config,
           "traffic": cell.traffic, "spec": cell.spec}
    if data is not None:
        out["unit_s"] = data.window_s / win.units
    if hasattr(fam, "round_flops"):
        out["round_flops"] = fam.round_flops(cell.config, cell.traffic)
    return out


def memory_peak(ctx) -> int:
    return int(torch.cuda.max_memory_allocated()) if ctx.device == "cuda" else 0


def run(ctx: H.RunContext) -> H.Outcome:
    from pygrid_tpu_torch.parallel import make_fused_round

    pin_precision()
    spec = ctx.cell.spec
    fam, params, pool, loss_fn = setup(ctx, ctx.device)
    round_fn = make_fused_round(loss_fn, local_steps=spec["local_steps"])
    state, prog = first_rounds(round_fn, params, pool, spec["lr"])
    del params
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0
    win, losses, state, data = window(ctx, round_fn, state, pool, spec["lr"])
    peak = memory_peak(ctx)
    failed = failed_rounds(losses)
    del state, pool, round_fn, loss_fn, losses
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_readings(ctx, fam, ctx.device)
    H.note(f"set-up {setup_s:.3f} s, window {win.span_s:.3f} s ({win.units} rounds), "
           f"reference {time.perf_counter() - t_ref:.3f} s")
    ms = sorted(x * 1e3 for x in win.latencies)
    H.note(f"round ms: min {ms[0]:.1f}, median {H.quantile(ms, 0.5):.1f}, max {ms[-1]:.1f}")
    return H.Outcome(
        e2e=e2e(ctx, win, setup_s), numbers=compare.training_numbers(prog, ref),
        limits=spec["limits"], attempted=win.units, failed=failed, memory_peak_bytes=peak,
        trace=data, metric_ctx=metric_ctx(ctx, fam, win, data),
        busy_s=data.busy_s if data else None, window_s=data.window_s if data else None)
