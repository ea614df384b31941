"""Node CLI entrypoint.

    python -m pygrid_tpu_torch.node --id alice --port 5000 --device cuda

Parity surface: reference ``apps/node/src/__main__.py:17-102`` — argparse
flags (--id/--port/--host/--network/--num_replicas/--start_local_db), a POST
of ``{node-id, node-address}`` to the Network's ``/join`` at boot (:78-83),
then serve. Env fallbacks mirror the reference: NODE_ID, GRID_NETWORK_URL,
PORT, DATABASE_URL. The port's counterpart of :mod:`pygrid_tpu.node.__main__`:
``--device`` (default ``cuda``) is where the node's tensors live, the join
POSTs through the async :mod:`pygrid_tpu_torch.web.aioclient`, and the port's
:func:`~pygrid_tpu_torch.web.run_app` serves.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os

logger = logging.getLogger("pygrid_tpu_torch.node")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="pygrid-tpu Node (PyTorch)")
    parser.add_argument(
        "--id", default=os.environ.get("NODE_ID", "node"), help="node id"
    )
    parser.add_argument(
        "--port", type=int, default=int(os.environ.get("PORT", 5000))
    )
    parser.add_argument("--host", default=os.environ.get("HOST", "0.0.0.0"))
    parser.add_argument(
        "--network",
        default=os.environ.get("GRID_NETWORK_URL"),
        help="grid Network URL to join",
    )
    parser.add_argument(
        "--num_replicas",
        type=int,
        default=int(os.environ.get("N_REPLICA", 0)) or None,
    )
    parser.add_argument(
        "--start_local_db",
        action="store_true",
        help="use a local sqlite file instead of in-memory",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="torch device of the node's tensors (cuda, cuda:N or cpu)",
    )
    return parser.parse_args(argv)


async def join_network(network_url: str, node_id: str, address: str) -> None:
    """POST {node-id, node-address} to the Network (reference :78-83) on
    the port's async client, from the node's own event loop."""
    from pygrid_tpu_torch import web

    try:
        async with web.ClientSession(timeout=web.ClientTimeout(total=10)) as session:
            async with session.post(
                network_url.rstrip("/") + "/join",
                json={"node-id": node_id, "node-address": address},
            ) as resp:
                await resp.read()
        logger.info("joined network %s: %s", network_url, resp.status)
    except Exception as err:  # noqa: BLE001 — boot resilience
        logger.warning("could not join network %s: %s", network_url, err)


def main(argv=None) -> None:
    from pygrid_tpu_torch import web
    from pygrid_tpu_torch.node import create_app

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    database_url = (
        f"node_{args.id}.db" if args.start_local_db
        else os.environ.get("DATABASE_URL", ":memory:")
    )
    address = os.environ.get(
        "NODE_ADDRESS", f"http://localhost:{args.port}"
    )
    app = create_app(
        args.id,
        database_url=database_url,
        network_url=args.network,
        num_replicas=args.num_replicas,
        device=args.device,
    )
    app["node"].address = address
    if args.network:
        async def _on_startup(app_):
            app_["join_task"] = asyncio.get_running_loop().create_task(
                join_network(args.network, args.id, address)
            )

        app.on_startup.append(_on_startup)
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
