"""Asynchronous federated learning (FedBuff) on a port node.

The port's twin of ``examples/async_fl.py``. Three workers train against
whatever checkpoint they downloaded and report whenever they finish; the
node folds each report into a staleness-weighted buffer and flushes every
``buffer_size`` reports. One worker is deliberately slow: its report
arrives after a flush has already advanced the model, re-homes to the
current buffer, and is discounted by (1+staleness)^-0.5 — the final
checkpoint is asserted against the hand-computed weighted math.

    python examples_torch/async_fl.py --spawn [--device cpu]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # _grid, then the checkout

import numpy as np

from _grid import example_args, grid, parse

D, H, C, B = 16, 8, 4, 8
NAME, VERSION = "fedbuff-demo", "1.0"


def main(argv=None) -> int:
    args = parse(example_args(__doc__), argv)
    with grid(args, n_nodes=1) as (_, nodes):
        return run(nodes["alice"], args.device)


def run(node_url: str, device) -> int:
    from pygrid_tpu_torch.client import FLClient, ModelCentricFLClient
    from pygrid_tpu_torch.federated.cycle_manager import staleness_weight
    from pygrid_tpu_torch.models import mlp
    from pygrid_tpu_torch.plans import Plan
    from pygrid_tpu_torch.plans.state import serialize_model_params
    from pygrid_tpu_torch.utils import prng

    params = [p.numpy() for p in
              mlp.init_from_key(prng.PRNGKey(0, device="cpu"), (D, H, C), device="cpu")]
    plan = Plan(name="training_plan", fn=mlp.training_step)
    plan.build(
        np.zeros((B, D), np.float32),
        np.zeros((B, C), np.float32),
        np.float32(0.1),
        *params,
    )
    mc = ModelCentricFLClient(node_url, device=device)
    workers = []

    def join():
        client = FLClient(node_url, timeout=30.0, device=device)
        workers.append(client)
        wid = client.authenticate(NAME, VERSION)["worker_id"]
        cyc = client.cycle_request(wid, NAME, VERSION, 1.0, 100.0, 100.0)
        assert cyc.get("status") == "accepted", cyc
        return client, wid, cyc

    def diff(seed):
        rng = np.random.default_rng(seed)
        return [rng.normal(0, 0.01, p.shape).astype(np.float32) for p in params]

    def checkpoint():
        return [t.cpu().numpy() for t in mc.retrieve_model(NAME, VERSION)]

    def wait_new_ckpt(old_first):
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            got = checkpoint()
            if not np.allclose(got[0], old_first):
                return got
            time.sleep(0.05)
        raise TimeoutError("flush never landed")

    try:
        resp = mc.host_federated_training(
            model=params,
            client_plans={"training_plan": plan},
            client_config={
                "name": NAME, "version": VERSION,
                "batch_size": B, "lr": 0.1, "max_updates": 1,
            },
            server_config={
                "min_workers": 1, "max_workers": 8, "num_cycles": 2,
                "do_not_reuse_workers_until_cycle": 0,
                "pool_selection": "random",
                "async_aggregation": {
                    "buffer_size": 2, "staleness_power": 0.5,
                },
            },
        )
        assert resp.get("status") == "success", resp

        # slow worker downloads checkpoint 1 and goes quiet
        slow, slow_wid, slow_cyc = join()
        d_slow = diff(1)

        # two fast workers fill buffer #1 -> checkpoint 2
        fast = [join() for _ in range(2)]
        d_fast = [diff(2), diff(3)]
        for (client, wid, cyc), d in zip(fast, d_fast):
            client.report(wid, cyc["request_key"], serialize_model_params(d))
        ckpt2 = wait_new_ckpt(params[0])
        expect2 = [
            p - (a + b) / 2 for p, a, b in zip(params, d_fast[0], d_fast[1])
        ]
        for got, want in zip(ckpt2, expect2):
            np.testing.assert_allclose(got, want, atol=1e-6)
        print("flush #1: 2 fresh reports averaged (weights 1, 1)")

        # the slow worker finally reports — stale by one checkpoint — and a
        # fresh worker completes buffer #2
        slow.report(slow_wid, slow_cyc["request_key"], serialize_model_params(d_slow))
        fresh, fresh_wid, fresh_cyc = join()
        d_fresh = diff(4)
        fresh.report(fresh_wid, fresh_cyc["request_key"], serialize_model_params(d_fresh))
        w = staleness_weight(1, 0.5)
        expect3 = [
            p2 - (w * a + b) / (w + 1)
            for p2, a, b in zip(expect2, d_slow, d_fresh)
        ]
        ckpt3 = wait_new_ckpt(ckpt2[0])
        worst = 0.0
        for got, want in zip(ckpt3, expect3):
            worst = max(worst, float(np.abs(got - want).max()))
            np.testing.assert_allclose(got, want, atol=1e-6)
    finally:
        for client in workers:
            client.close()
        mc.close()
    print(
        f"flush #2: stale report discounted to weight {w:.3f}, fresh at 1 "
        f"(max |Δ| vs hand math = {worst:.2e})"
    )
    print("async FL OK: FedBuff staleness-weighted buffered aggregation")
    return 0


if __name__ == "__main__":
    sys.exit(main())
