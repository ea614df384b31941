"""Host a model-centric FL process on a port node: build the plan, define
the configs, host.

The port's twin of ``examples/model_centric/01_create_plan.py``: the MNIST
MLP (drawn as the reference draws it, ``jax.random.PRNGKey(42)``, through
``pygrid_tpu_torch.utils.prng``), its training Plan built from the torch
function ``models.mlp.training_step`` (``Plan.build``: ``torch.export``
and the op list ``fx_to_oplist`` makes of it), the client and server
configs, and everything hosted on a node.

    python examples_torch/model_centric/01_create_plan.py --spawn [--device cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # _grid, then the checkout

import numpy as np

from _grid import example_args, grid, parse

NAME, VERSION = "mnist", "1.0"
D, H, C, B = 784, 392, 10, 64


def main(argv=None) -> int:
    args = parse(example_args("host an FL process"), argv)
    with grid(args, n_nodes=1) as (_, nodes):
        return host(nodes["alice"], args.device)


def host(node_url: str, device) -> int:
    from pygrid_tpu_torch.client import ModelCentricFLClient
    from pygrid_tpu_torch.models import mlp
    from pygrid_tpu_torch.plans import Plan
    from pygrid_tpu_torch.utils import prng

    params = mlp.init_from_key(prng.PRNGKey(42, device="cpu"), (D, H, C), device="cpu")
    training_plan = Plan(name="training_plan", fn=mlp.training_step)
    training_plan.build(
        np.zeros((B, D), np.float32),
        np.zeros((B, C), np.float32),
        np.float32(0.005),
        *params,
    )

    client = ModelCentricFLClient(node_url, device=device)
    try:
        response = client.host_federated_training(
            model=[p.numpy() for p in params],
            client_plans={"training_plan": training_plan},
            client_config={
                "name": NAME,
                "version": VERSION,
                "batch_size": B,
                "lr": 0.005,
                "max_updates": 100,
            },
            server_config={
                "min_workers": 2,
                "max_workers": 4,
                "pool_selection": "random",
                "do_not_reuse_workers_until_cycle": 6,
                "cycle_length": 28800,
                "num_cycles": 5,
                "max_diffs": 2,
                "min_diffs": 2,
                "minimum_upload_speed": 0,
                "minimum_download_speed": 0,
                "iterative_plan": True,
            },
        )
    finally:
        client.close()
    print(f"hosted {NAME}/{VERSION} on {node_url}: {response}")
    return 0 if response.get("status") == "success" else 1


if __name__ == "__main__":
    sys.exit(main())
