"""``python -m pygrid_tpu_torch.worker`` — join a node and train.

    python -m pygrid_tpu_torch.worker --node http://localhost:5000 --device cuda
    python -m pygrid_tpu_torch.worker --role subagg --node http://localhost:5000 \
        --network http://localhost:7000 --listen-port 7001

The reference's worker app has no entrypoint (empty stub); this is the
CLI the compose file and the local infra provider launch. The port's
counterpart of :mod:`pygrid_tpu.worker.__main__`: ``--device`` (default
``cuda``) is where a worker trains, and the ``subagg`` role serves on the
port's :func:`~pygrid_tpu_torch.web.run_app` (a sub-aggregator folds on the
host and takes no device)."""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="pygrid-tpu FL worker (PyTorch port)")
    parser.add_argument(
        "--role",
        choices=("worker", "subagg"),
        default="worker",
        help="worker: train and report; subagg: run a sub-aggregator "
        "that folds a subtree of worker reports into one partial per "
        "flush (docs/AGGREGATION.md)",
    )
    parser.add_argument("--node", required=True, help="node URL")
    parser.add_argument(
        "--network",
        default=None,
        help="network URL — workers ask it for sub-aggregator placement; "
        "sub-aggregators register with it",
    )
    parser.add_argument(
        "--listen-port",
        type=int,
        default=7001,
        help="subagg role: port the sub-aggregator's WS endpoint serves on",
    )
    parser.add_argument(
        "--advertise",
        default=None,
        help="subagg role: externally reachable URL registered for "
        "placement (default http://127.0.0.1:<listen-port>, which only "
        "works single-host — set this in any real deployment)",
    )
    parser.add_argument(
        "--fanout",
        type=int,
        default=None,
        help="subagg role: leaf reports per forwarded partial "
        "(default PYGRID_AGG_FANOUT or 64)",
    )
    parser.add_argument("--model-name", default="mnist")
    parser.add_argument("--model-version", default=None)
    parser.add_argument("--auth-token", default=None)
    parser.add_argument("--cycles", type=int, default=1)
    parser.add_argument(
        "--wire",
        choices=("json", "binary", "bf16"),
        default="json",
        help="event transport: json (syft.js-compatible base64 wire), "
        "binary (msgpack frames, raw diff bytes), bf16 (binary + bfloat16 "
        "diff payloads)",
    )
    parser.add_argument(
        "--compress",
        default=None,
        metavar="topk:FRACTION",
        help="sparse diff uploads, e.g. topk:0.1 — top 10%% of entries per "
        "tensor with error feedback carrying the rest to the next cycle",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="worker role: torch device the plan trains on (cuda, cuda:N or cpu)",
    )
    args = parser.parse_args(argv)

    if args.role == "subagg":
        from pygrid_tpu_torch import web
        from pygrid_tpu_torch.worker.subagg import create_subagg_app

        app = create_subagg_app(
            args.node,
            fanout=args.fanout,
            network_url=args.network,
        )
        app["subagg"].address = (
            args.advertise or f"http://127.0.0.1:{args.listen_port}"
        )
        web.run_app(app, port=args.listen_port)
        return 0

    compression = None
    if args.compress:
        scheme, _, frac = args.compress.partition(":")
        if scheme != "topk":
            parser.error(f"unknown compression scheme {scheme!r}")
        try:
            fraction = float(frac) if frac else 0.1
        except ValueError:
            parser.error(f"--compress fraction {frac!r} is not a number")
        if not 0.0 < fraction <= 1.0:
            parser.error("--compress fraction must be in (0, 1]")
        compression = {"name": "topk", "fraction": fraction}

    from pygrid_tpu_torch.worker import run_worker

    result = run_worker(
        args.node,
        args.model_name,
        model_version=args.model_version,
        auth_token=args.auth_token,
        cycles=args.cycles,
        wire="binary" if args.wire in ("binary", "bf16") else "json",
        diff_precision="bf16" if args.wire == "bf16" else None,
        diff_compression=compression,
        network_url=args.network,
        device=args.device,
    )
    print(
        f"worker done: accepted={result.accepted} rejected={result.rejected} "
        f"errors={result.errors}"
    )
    return 0 if not result.errors else 1


if __name__ == "__main__":
    sys.exit(main())
