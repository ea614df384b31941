"""Readings that the limits of ``correct`` are set from, many seeds in one
process on the chip. The benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --sides program,control,half

Each line of output is one reading, ``{"seed", "side", <compared numbers>}``:

- ``program``: the program's timed path at the cell's size against the
  reference, exactly as a run checks it (a prediction cell runs
  ``--seconds`` of its closed loop).
- ``control``: the reference put in the program's place, one precision
  below the configuration's: fp8 products for bf16, TF32 for float32 (a
  training cell), or the program's own path at one fractional digit fewer
  (a prediction cell).
- ``freeze``: the program with one leaf left where it was, the
  one-dimensional leaf (a LayerNorm's or a bias) whose reference gradient
  is the smallest: the fault that a leaf's norm scored against the median
  leaf's could miss (a training cell). Its line names the leaf and its
  reference gradient over the median leaf's.
- ``half``: the reference with half the clients left out, the mean taken
  over the rest (a training cell).
- ``alone``: the reference with only rank 0's block of clients, as when the
  exchange between the cards is left out (a multi-card training cell,
  read on one card).

A state left unchanged reads 1 by the training numbers' measure and needs
no run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _emit(seed, side, numbers, **extra) -> None:
    print(json.dumps(dict(seed=seed, side=side, **numbers, **extra)), flush=True)


def _freezing(round_fn, leaf: int):
    """``round_fn`` with leaf ``leaf`` handed back as it came in."""
    def frozen_round(params, X, y, lr):
        new, loss, acc = round_fn(params, X, y, lr)
        new = list(new)
        new[leaf] = params[leaf]
        return new, loss, acc
    return frozen_round


def training(ctx, sides, device) -> None:
    import torch

    from benchmark import harness as H
    from benchmark.reference import compare

    single = H.load_entry(ctx.root, "fedavg_round")
    spec = ctx.cell.spec
    fam = ctx.family()
    ref = single.reference_readings(ctx, fam, device)
    K = ctx.cell.traffic["clients"]
    control = "fp8" if spec.get("compute_dtype") == "bfloat16" else "tf32"
    med = statistics.median(ref["grad"])
    for side in sides:
        t0 = time.perf_counter()
        extra = {}
        if side in ("program", "freeze"):
            if ctx.cell.chips != 1:
                raise SystemExit("a multi-card cell's program readings come from its runs")
            from pygrid_tpu_torch.parallel import make_fused_round

            single.pin_precision()
            _, params, pool, loss_fn = single.setup(ctx, device)
            round_fn = make_fused_round(loss_fn, local_steps=spec["local_steps"])
            if side == "freeze":
                leaf = min((i for i, p in enumerate(params) if p.dim() == 1),
                           key=lambda i: ref["grad"][i])
                round_fn = _freezing(round_fn, leaf)
                extra = {"frozen_leaf": leaf, "frozen_size": params[leaf].numel(),
                         "frozen_ratio": ref["grad"][leaf] / med}
            _, prog = single.first_rounds(round_fn, params, pool, spec["lr"])
            del params, pool, round_fn
        elif side == "control":
            prog = single.reference_readings(ctx, fam, device, precision=control)
        elif side == "half":
            prog = single.reference_readings(ctx, fam, device, clients=K // 2)
        elif side == "alone":
            prog = single.reference_readings(ctx, fam, device, clients=K // ctx.cell.chips)
        else:
            raise SystemExit(f"unknown side {side!r}")
        if device == "cuda":
            torch.cuda.empty_cache()
        left_out = sum(g < compare.EXCLUDE_BELOW * med for g in ref["grad"])
        _emit(ctx.seed, side, compare.training_numbers(prog, ref), leaves=len(ref["grad"]),
              left_out_of_change=left_out, min_ratio=min(ref["grad"]) / med, **extra,
              seconds=round(time.perf_counter() - t0, 3))


def prediction(ctx, sides, device) -> None:
    from benchmark import harness as H

    entry = H.load_entry(ctx.root, "encrypted_predict")
    ws = entry.weights(ctx, device)
    prec = ctx.cell.config["fixed_point"]["precision_fractional"]
    for side in sides:
        if side not in ("program", "control"):
            raise SystemExit(f"unknown side {side!r} for a prediction cell")
        t0 = time.perf_counter()
        model, gen = entry.build(ctx, ws, device, precision=prec if side == "program" else prec - 1)
        model.predict(entry.request(ctx, -1, device), generator=gen)
        win, outputs, failed, _ = entry.serve(ctx, model, gen, device, ctx.seconds)
        numbers = entry.check(ctx, ws, outputs, device)
        _emit(ctx.seed, side, numbers, answers=len(outputs), failed=failed,
              seconds=round(time.perf_counter() - t0, 3))
        del model, gen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--sides", default="program,control")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness as H

    cell = H.load_cell(ROOT, args.workload)
    sides = args.sides.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = H.RunContext(root=ROOT, cell=cell, seed=seed, seconds=args.seconds, trace=False,
                           device=args.device, t0=time.perf_counter())
        if cell.spec["entry"] == "encrypted_predict":
            prediction(ctx, sides, args.device)
        else:
            training(ctx, sides, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
