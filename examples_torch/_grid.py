"""Shared plumbing of the port's examples: arguments, waiting for a server,
and an optional ephemeral in-process grid of the port's own servers.

Every example takes ``--device`` (default ``cuda``; without a GPU that
raises, as every entry point of the port does, unless ``--device cpu`` is
passed). ``--spawn`` starts a port Network and port Nodes on loopback,
each on its own event-loop thread (``pygrid_tpu_torch.web.BackgroundServer``),
so no grid needs to be up. Nothing here uses ``requests`` or aiohttp: the
port's web layer serves and calls."""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Iterator

NODE_NAMES = ("alice", "bob", "charlie", "dan")


def wait_for(url: str, timeout: float = 60.0) -> None:
    """Poll until the server answers (a grid's services race their deps)."""
    from pygrid_tpu_torch.web import client as http

    deadline = time.monotonic() + timeout
    while True:
        try:
            http.get(url + "/", timeout=2)
            return
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)


def spawn_grid(n_nodes: int = 4, device: str = "cuda") -> tuple[str, dict, list]:
    """An ephemeral in-process grid: a port Network and ``n_nodes`` port
    Nodes on ``device``, each joined to the Network. Returns
    ``(network_url, {name: node_url}, servers)``; stop the servers with
    :func:`stop_grid`."""
    from pygrid_tpu_torch.network import create_app as network_app
    from pygrid_tpu_torch.node import create_app as node_app
    from pygrid_tpu_torch.web import BackgroundServer
    from pygrid_tpu_torch.web import client as http

    servers = [BackgroundServer(network_app("example-network")).start()]
    network_url = servers[0].url
    nodes = {}
    try:
        for name in NODE_NAMES[:n_nodes]:
            server = BackgroundServer(node_app(name, device=device)).start()
            servers.append(server)
            r = http.post(network_url + "/join",
                          json={"node-id": name, "node-address": server.url}, timeout=10)
            if r.status_code != 200:
                raise RuntimeError(f"{name} could not join the network: {r.status_code} {r.text}")
            nodes[name] = server.url
    except BaseException:
        stop_grid(servers)
        raise
    return network_url, nodes, servers


def stop_grid(servers) -> None:
    for server in reversed(servers):
        server.stop()


@contextlib.contextmanager
def grid(args, n_nodes: int = 1, ports: dict | None = None) -> Iterator[tuple[str, dict]]:
    """``(network_url, {name: node_url})``: a spawned grid when ``--spawn``
    was given (stopped on exit), else the servers the arguments name
    (``ports`` maps node names to localhost ports; by default the one
    ``--node`` is alice), waited for."""
    if args.spawn:
        network_url, nodes, servers = spawn_grid(n_nodes, args.device)
        try:
            yield network_url, nodes
        finally:
            stop_grid(servers)
        return
    if ports:
        nodes = {name: f"http://localhost:{port}" for name, port in ports.items()}
    else:
        nodes = {"alice": args.node}
    for url in nodes.values():
        wait_for(url, args.wait)
    yield args.network, nodes


def example_args(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--node", default="http://localhost:5000")
    parser.add_argument("--network", default="http://localhost:7000")
    parser.add_argument("--spawn", action="store_true",
                        help="spawn an ephemeral in-process grid")
    parser.add_argument("--wait", type=float, default=60.0,
                        help="seconds to wait for servers")
    parser.add_argument("--device", default="cuda",
                        help="where tensors live: cuda (default; raises without a GPU) or cpu")
    return parser


def parse(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse ``argv`` and resolve ``--device`` at once, so that a missing
    GPU fails before anything starts."""
    from pygrid_tpu_torch.device import resolve

    args = parser.parse_args(argv)
    resolve(args.device)
    return args
