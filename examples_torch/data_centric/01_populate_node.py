"""Populate a port node with private tagged tensors.

The port's twin of ``examples/data_centric/01_populate_node.py``: log in
to a node and ``send`` dataset shards with #tags and descriptions, so that
data scientists can find them by a grid search. The node keeps them on its
``--device``.

    python examples_torch/data_centric/01_populate_node.py --spawn [--device cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # _grid, then the checkout

import numpy as np

from _grid import example_args, grid, parse


def main(argv=None) -> int:
    parser = example_args("populate a node with tagged data")
    parser.add_argument("--shards", type=int, default=4)
    args = parse(parser, argv)
    with grid(args, n_nodes=1) as (_, nodes):
        return populate(nodes["alice"], args.shards, args.device)


def populate(node_url: str, shards: int, device) -> int:
    from pygrid_tpu_torch.client import DataCentricFLClient

    client = DataCentricFLClient(node_url, device=device)
    try:
        client.login("admin", "admin")
        rng = np.random.default_rng(0)
        for shard in range(shards):
            X = rng.normal(size=(64, 784)).astype("float32")
            y = rng.integers(0, 10, size=(64,)).astype("int32")
            client.send(
                X,
                tags={"#X", "#mnist", f"#shard-{shard}"},
                description=f"MNIST images shard {shard}",
            )
            client.send(
                y,
                tags={"#Y", "#mnist", f"#shard-{shard}"},
                description=f"MNIST labels shard {shard}",
            )
        found = client.search("#mnist")
    finally:
        client.close()
    print(f"sent {2 * shards} tensors to {node_url}; "
          f"search('#mnist') → {len(found)} pointers")
    return 0 if len(found) == 2 * shards else 1


if __name__ == "__main__":
    sys.exit(main())
