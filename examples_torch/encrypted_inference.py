"""End-to-end encrypted inference across a grid of port nodes.

The port's twin of ``examples/encrypted_inference.py``: a model owner
shares an MLP's weights over alice, bob and charlie (dan deals the Beaver
triples) and serves the inference Plan; a data scientist discovers the
model through the Network, connects to the share holders, runs the Plan
with every matmul a cross-node Beaver round, and reconstructs the
prediction on its side. No single node, the dealer included, ever holds
the weights, the input or the output in the clear. The Plan is built from
a torch function (``Plan.build``: ``torch.export`` and its op list); on
the card each node's Beaver matmuls launch the hand-written ring-matmul
kernel.

Against a running grid (nodes on ports 3000-3003), or self-contained::

    python examples_torch/encrypted_inference.py --spawn [--device cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # _grid, then the checkout

import numpy as np

from _grid import example_args, grid, parse

PORTS = {"alice": 3000, "bob": 3001, "charlie": 3002, "dan": 3003}


def forward(x, w1, b1, w2, b2):
    """CryptoNets-style MLP: affine → square → affine. The square keeps the
    circuit polynomial — data-dependent nonlinearities (relu/max) need
    comparison protocols the ring doesn't give for free."""
    h = x @ w1 + b1
    h = h * h
    return h @ w2 + b2


def main(argv=None) -> int:
    args = parse(example_args(__doc__), argv)
    with grid(args, n_nodes=4, ports=PORTS) as (network_url, nodes):
        return run(network_url, nodes, args.device)


def run(network_url, nodes, device) -> int:
    from pygrid_tpu_torch.client import DataCentricFLClient
    from pygrid_tpu_torch.plans import Plan
    from pygrid_tpu_torch.smpc import EncryptedModel, publish_encrypted_model

    # ── model owner: build, share, serve ─────────────────────────────────
    rng = np.random.default_rng(0)
    weights = [
        rng.uniform(-0.5, 0.5, (4, 3)).astype(np.float32),
        rng.uniform(-0.2, 0.2, (3,)).astype(np.float32),
        rng.uniform(-0.5, 0.5, (3, 2)).astype(np.float32),
        rng.uniform(-0.2, 0.2, (2,)).astype(np.float32),
    ]
    plan = Plan(name="encrypted_forward", fn=forward)
    plan.build(np.zeros((2, 4), np.float32), *weights)

    clients = {n: DataCentricFLClient(url, device=device) for n, url in nodes.items()}
    try:
        publish_encrypted_model(
            plan,
            "encrypted-mlp",
            host_client=clients["alice"],
            holder_clients=[clients["alice"], clients["bob"], clients["charlie"]],
            provider_client=clients["dan"],
            weights=weights,
            device=device,
        )
        print("published encrypted-mlp: shares on alice/bob/charlie, dan deals")

        # ── data scientist: discover through the network, predict ───────
        model = EncryptedModel.discover(network_url, "encrypted-mlp", device=device)
        try:
            x = rng.uniform(-1, 1, (2, 4)).astype(np.float32)
            pred = np.asarray(model.predict(x))
        finally:
            model.close()
    finally:
        for c in clients.values():
            c.close()
    expected = forward(x, *weights)
    err = float(np.max(np.abs(pred - expected)))
    print(f"encrypted prediction:\n{pred}")
    print(f"plaintext forward:\n{expected}")
    print(f"max abs error: {err:.4f} (fixed-point scale 1e-3, Beaver rounds)")
    assert err < 5e-2, "encrypted inference diverged from plaintext"
    print("encrypted inference OK — every matmul was a cross-node Beaver round")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
