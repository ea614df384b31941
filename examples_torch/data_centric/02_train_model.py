"""Train a model on remote data through pointers, on port nodes.

The port's twin of ``examples/data_centric/02_train_model.py``:
``PublicGridNetwork.search`` finds the tagged shards across the grid, then
a linear model is trained where the data lives. Every forward and
backward op is a remote pointer op run by the node on its ``--device``;
only the losses and the gradient come back.

    python examples_torch/data_centric/02_train_model.py --spawn [--device cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # _grid, then the checkout

import numpy as np

from _grid import example_args, grid, parse, wait_for


def main(argv=None) -> int:
    parser = example_args("train on remote data via pointers")
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--lr", type=float, default=0.1)
    args = parse(parser, argv)
    with grid(args, n_nodes=1) as (network_url, nodes):
        wait_for(network_url, args.wait)
        return train(network_url, nodes["alice"], args.epochs, args.lr, args.device)


def train(network_url: str, node_url: str, epochs: int, lr: float, device) -> int:
    from pygrid_tpu_torch.client import DataCentricFLClient, PublicGridNetwork

    owner = DataCentricFLClient(node_url, device=device)
    network = PublicGridNetwork(network_url, device=device)
    try:
        owner.login("admin", "admin")
        rng = np.random.default_rng(1)
        true_w = rng.normal(size=(4, 1)).astype("float32")
        X = rng.normal(size=(256, 4)).astype("float32")
        y = X @ true_w
        owner.send(X, tags={"#train-X", "#regression"})
        owner.send(y, tags={"#train-Y", "#regression"})

        X_ptrs = network.search("#train-X")
        y_ptrs = network.search("#train-Y")
        print(f"found shards on nodes: {sorted(X_ptrs)}")

        w = np.zeros((4, 1), dtype="float32")
        for epoch in range(epochs):
            losses = []
            for node_name in X_ptrs:
                X_ptr, y_ptr = X_ptrs[node_name][0], y_ptrs[node_name][0]
                w_ptr = X_ptr.location.send(w)
                pred = X_ptr @ w_ptr
                err = pred - y_ptr
                loss = (err * err).mean()
                # d/dw mse = 2/N · Xᵀ err, computed where the data lives
                grad_ptr = X_ptr.t() @ err
                grad = grad_ptr.get() * (2.0 / 256)
                w = w - lr * grad
                losses.append(float(np.asarray(loss.get())))
            print(f"epoch {epoch}: mse={np.mean(losses):.5f}")
    finally:
        network.close()
        owner.close()

    final_err = float(np.abs(w - true_w).max())
    print(f"max |w - w*| = {final_err:.4f}")
    return 0 if final_err < 0.5 else 1


if __name__ == "__main__":
    sys.exit(main())
