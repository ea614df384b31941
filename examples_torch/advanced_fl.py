"""Advanced FL on a port node: FedAdam, differential privacy and top-k
compression, together.

The port's twin of ``examples/advanced_fl.py``. Everything beyond the
reference's FedAvg in one hosted process:

- **FedAdam** (``server_config["server_optimizer"]``): the node treats the
  averaged diff as a pseudo-gradient and applies server-side Adam;
- **DP-FedAvg** (``server_config["differential_privacy"]``): every client
  diff clips to L2 ≤ C at ingest, and the mean gets N(0, (z·C/K)²) noise;
- **top-k uploads** (``client_config["diff_compression"]``): workers ship
  the top 10% of entries per tensor with error feedback, over the binary
  bf16 wire.

The MLP is drawn as the reference draws it (``jax.random.PRNGKey(0)``,
through ``pygrid_tpu_torch.utils.prng``); its Plan is built from the torch
function and the workers' steps run on ``--device``.

    python examples_torch/advanced_fl.py --spawn [--device cpu]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # _grid, then the checkout

import numpy as np

from _grid import example_args, grid, parse

K, D, H, C, B = 4, 64, 32, 10, 32
ROUNDS = 8


def main(argv=None) -> int:
    args = parse(example_args(__doc__), argv)
    with grid(args, n_nodes=1) as (_, nodes):
        return run(nodes["alice"], args.device)


def run(node_url: str, device) -> int:
    import torch

    from pygrid_tpu_torch.client import FLClient, ModelCentricFLClient
    from pygrid_tpu_torch.models import mlp
    from pygrid_tpu_torch.plans import Plan
    from pygrid_tpu_torch.utils import prng

    rng = np.random.default_rng(0)
    true_w = rng.normal(size=(D, C)).astype(np.float32)
    data_X = rng.normal(size=(K, B, D)).astype(np.float32)
    data_y = np.eye(C, dtype=np.float32)[
        np.argmax(data_X.reshape(-1, D) @ true_w, axis=1)
    ].reshape(K, B, C)

    params = mlp.init_from_key(prng.PRNGKey(0, device="cpu"), (D, H, C), device="cpu")
    plan = Plan(name="training_plan", fn=mlp.training_step)
    plan.build(
        np.zeros((B, D), np.float32),
        np.zeros((B, C), np.float32),
        np.float32(0.5),
        *params,
    )

    mc = ModelCentricFLClient(node_url, device=device)
    clients = []
    try:
        resp = mc.host_federated_training(
            model=[p.numpy() for p in params],
            client_plans={"training_plan": plan},
            client_config={
                "name": "advanced", "version": "1.0",
                "batch_size": B, "lr": 0.5, "max_updates": 1,
                "diff_precision": "bf16",
                "diff_compression": {"name": "topk", "fraction": 0.1},
            },
            server_config={
                "min_workers": K, "max_workers": K,
                "min_diffs": K, "max_diffs": K, "num_cycles": ROUNDS,
                "pool_selection": "random",
                "do_not_reuse_workers_until_cycle": 0,
                "server_optimizer": {
                    "name": "adam", "lr": 0.3, "beta1": 0.9, "beta2": 0.99,
                },
                "differential_privacy": {
                    "clip_norm": 5.0, "noise_multiplier": 0.01,
                },
            },
        )
        assert resp.get("status") == "success", resp

        for k in range(K):
            client = FLClient(node_url, wire="binary", device=device)
            auth = client.authenticate("advanced", "1.0")
            clients.append((client, auth["worker_id"], k))

        def request_until_accepted(client, wid):
            # the next cycle spawns when background aggregation finishes —
            # a rejected request means "retry shortly" (the reference's
            # reject+timeout contract)
            for _ in range(100):
                cyc = client.cycle_request(wid, "advanced", "1.0", 1.0, 100.0, 100.0)
                if cyc.get("status") == "accepted":
                    return cyc
                time.sleep(0.1)
            raise RuntimeError(f"never accepted: {cyc}")

        lr = torch.tensor(0.5, device=device)
        plans = {}
        losses = []
        for _ in range(ROUNDS):
            accepted = []
            for client, wid, k in clients:
                cyc = request_until_accepted(client, wid)
                accepted.append((client, wid, k, cyc))
            round_losses = []
            for client, wid, k, cyc in accepted:
                model_params = client.get_model(
                    wid, cyc["request_key"], cyc["model_id"], precision="bf16"
                )
                if k not in plans:
                    plans[k] = client.get_plan(
                        wid, cyc["request_key"], cyc["plans"]["training_plan"]
                    )
                X = torch.from_numpy(data_X[k]).to(device)
                y = torch.from_numpy(data_y[k]).to(device)
                out = plans[k].run_list(X, y, lr, *model_params, device=device)
                round_losses.append(float(out[0]))
                diff = [p - n for p, n in zip(model_params, out[2:])]
                job = client.new_job("advanced", "1.0")
                job.worker_id, job.request_key = wid, cyc["request_key"]
                job.client_config = cyc.get("client_config") or {}
                job.report(diff)  # topk+bf16 per the hosted client_config
            losses.append(np.mean(round_losses))
    finally:
        for client, _, _ in clients:
            client.close()
        mc.close()

    print("losses per round:", [round(float(l), 3) for l in losses])
    assert losses[-1] < losses[0], "FedAdam+DP+topk did not learn"
    print(
        "advanced FL OK — server Adam on clipped/noised means of top-k "
        "bf16 diffs, and the loss still goes down"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
