"""Encrypted inference: ``smpc/encrypted_model.py``'s ``EncryptedModel.predict``
over in-process ``VirtualWorker``s, a closed loop of one data scientist.

Set-up reads the port's committed op-list plan through the port's
``serde``, draws the weights on the card from the seed, shares them over
the holders (alice, bob and charlie) with dan dealing through
``CryptoProvider``/``RemoteCryptoProvider``, and warms the path with
predictions that are not timed. Each call of the window shares a fresh
batch drawn from the seed and is timed from the call to its decoded
result.

``correct``: once the window has closed, every prediction it made is held
against the float64 reference over the same inputs and weights on the
fixed-point grid (``reference/cryptonets.py``).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import harness as H
from benchmark import trace as T
from benchmark import traffic
from benchmark.reference import compare, cryptonets


def weights(ctx: H.RunContext, device) -> list[np.ndarray]:
    """w1, b1, w2, b2 as float32 host arrays, drawn on the card."""
    fam = ctx.family()
    ws = fam.init(ctx.cell.config, ctx.seed, device, bias=ctx.cell.spec["bias_range"])
    return [w.cpu().numpy() for w in ws]


def request(ctx: H.RunContext, i: int, device) -> np.ndarray:
    """Request ``i``'s input batch, drawn on the card, as the client holds it."""
    return traffic.batch(ctx.cell.traffic, ctx.cell.config, ctx.seed, i, device).cpu().numpy()


def build(ctx: H.RunContext, ws, device, precision=None):
    """The model on the workers, the weights shared; ``precision`` other
    than the configuration's fractional digits gives the control."""
    from pygrid_tpu_torch import serde
    from pygrid_tpu_torch.runtime import VirtualWorker
    from pygrid_tpu_torch.smpc import (CryptoProvider, EncryptedModel, FixedPointEncoder,
                                       RemoteCryptoProvider, fix_prec_share_to_nodes)

    spec, fp = ctx.cell.spec, ctx.cell.config["fixed_point"]
    prec = fp["precision_fractional"] if precision is None else precision
    blob = (ctx.root / spec["plan"]).read_bytes()
    plan = serde.deserialize(blob, device=device)
    holders = [VirtualWorker(n, device=device) for n in spec["holders"]]
    dealer = VirtualWorker(spec["dealer"], device=device)
    dealer.crypto_provider = CryptoProvider(seed=H.sub_seed(ctx.seed, "dealer"), device=device)
    for h in holders:
        dealer.add_worker(h)
    g = torch.Generator(device=device).manual_seed(H.sub_seed(ctx.seed, "weight shares"))
    shared = [fix_prec_share_to_nodes(w, holders, base=fp["base"], precision_fractional=prec,
                                      crypto_provider=dealer, generator=g, device=device)
              for w in ws]
    model = EncryptedModel(plan, shared, holders, RemoteCryptoProvider(dealer),
                           FixedPointEncoder(fp["base"], prec), device=device)
    return model, torch.Generator(device=device).manual_seed(H.sub_seed(ctx.seed, "input shares"))


def serve(ctx: H.RunContext, model, gen, device, seconds, max_units=None):
    """The closed loop: (window, outputs, failures, reduced trace or None).
    Each request's input is drawn and copied to the host before its call,
    outside the call's timed span."""
    win, outputs, failed = H.Window(), [], 0
    with T.profiled(ctx.trace) as prof:
        with T.span("window"):
            while True:
                i = win.units
                with T.span("draw request"):
                    x = request(ctx, i, device)
                s = time.perf_counter()
                with T.span("predict"):
                    try:
                        outputs.append(model.predict(x, generator=gen))
                    except Exception as e:  # noqa: BLE001 — an answer that never comes
                        failed += 1
                        outputs.append(None)
                        print(f"benchmark: request {i} failed: {e!r}", file=sys.stderr)
                e = time.perf_counter()
                win.starts.append(s)
                win.ends.append(e)
                if e - win.starts[0] >= seconds or (max_units and win.units >= max_units):
                    break
    data = None
    if prof is not None:
        data = T.reduce(prof, torch.cuda.current_device() if device == "cuda" else None)
    return win, outputs, failed, data


def check(ctx: H.RunContext, ws, outputs, device, precision=None) -> dict:
    """The compared number over every answer of the window."""
    fp = ctx.cell.config["fixed_point"]
    prec = fp["precision_fractional"] if precision is None else precision
    refs = [cryptonets.forward(request(ctx, i, device), *ws, base=fp["base"], precision=prec,
                               device=device) for i in range(len(outputs))]
    got = [o if o is not None else np.full((1,), np.nan) for o in outputs]
    return compare.prediction_numbers(got, refs)


def run(ctx: H.RunContext) -> H.Outcome:
    spec, dev = ctx.cell.spec, ctx.device
    ws = weights(ctx, dev)
    model, gen = build(ctx, ws, dev)
    warm = torch.Generator(device=dev).manual_seed(H.sub_seed(ctx.seed, "warm-up"))
    for j in range(spec["warmup"]):
        model.predict(request(ctx, -1 - j, dev), generator=warm)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0
    win, outputs, failed, data = serve(ctx, model, gen, dev, ctx.seconds,
                                       spec.get("trace_units") if ctx.trace else None)
    peak = int(torch.cuda.max_memory_allocated()) if dev == "cuda" else 0
    del model, gen
    if dev == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = check(ctx, ws, outputs, dev)
    H.note(f"set-up {setup_s:.3f} s, window {win.span_s:.3f} s ({win.units} predictions), "
           f"reference {time.perf_counter() - t_ref:.3f} s")
    lat = win.latencies
    return H.Outcome(
        e2e={"predict_ms_p95": H.quantile(lat, 0.95) * 1e3, "setup_s": setup_s},
        numbers=numbers, limits=spec["limits"], attempted=win.units, failed=failed,
        memory_peak_bytes=peak, trace=data,
        metric_ctx={"units": win.units, "unit_s": (data.window_s / win.units) if data else None,
                    "config": ctx.cell.config, "traffic": ctx.cell.traffic, "spec": spec},
        busy_s=data.busy_s if data else None, window_s=data.window_s if data else None)
