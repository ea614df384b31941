"""Network CLI entrypoint.

    python -m pygrid_tpu_torch.network --id network --port 7000

Parity surface: reference ``apps/network/src/__main__.py:10-36`` — flags
--port/--host/--start_local_db, env fallbacks (PORT, DATABASE_URL,
N_REPLICA), then serve. The port's counterpart of
:mod:`pygrid_tpu.network.__main__`, served by the port's
:func:`~pygrid_tpu_torch.web.run_app`. It takes no ``--device``: the
network holds no tensor.
"""

from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="pygrid-tpu Network (PyTorch port)")
    parser.add_argument("--id", default=os.environ.get("NETWORK_ID", "network"))
    parser.add_argument(
        "--port", type=int, default=int(os.environ.get("PORT", 7000))
    )
    parser.add_argument("--host", default=os.environ.get("HOST", "0.0.0.0"))
    parser.add_argument(
        "--num_replicas",
        type=int,
        default=int(os.environ.get("N_REPLICA", 1)),
    )
    parser.add_argument("--start_local_db", action="store_true")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    from pygrid_tpu_torch import web
    from pygrid_tpu_torch.network import create_app

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    database_url = (
        f"network_{args.id}.db" if args.start_local_db
        else os.environ.get("DATABASE_URL", ":memory:")
    )
    app = create_app(
        args.id, database_url=database_url, n_replica=args.num_replicas
    )
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
