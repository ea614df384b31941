"""Secure aggregation (Bonawitz double-masking) on a port node.

The port's twin of ``examples/secagg_fl.py``. Four workers train one cycle
where the node never sees an individual diff — only uint32-masked
envelopes whose pairwise masks cancel in the accumulator. One worker
completes the key rounds and then vanishes; the survivors' Shamir shares
reconstruct exactly the dangling mask terms, and the final checkpoint
equals the plain FedAvg of the survivors' diffs to quantization precision
(asserted).

Rounds per worker (``pygrid_tpu_torch.client.SecAggSession``):

1. ``advertise`` a Diffie–Hellman public key; poll the ``roster``;
2. Shamir-share the self-mask seed and DH secret, sealed per peer and
   uploaded through the (untrusted) node;
3. report the quantized diff masked with PRG(self) ± PRG(pairwise);
4. answer the ``unmask`` round for the survivor and dropout sets.

    python examples_torch/secagg_fl.py --spawn [--device cpu]
"""

from __future__ import annotations

import sys
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # _grid, then the checkout

import numpy as np

from _grid import example_args, grid, parse

K, D, H, C, B = 4, 32, 16, 4, 16
CLIP = 0.5
NAME, VERSION = "secagg-demo", "1.0"


def main(argv=None) -> int:
    args = parse(example_args(__doc__), argv)
    with grid(args, n_nodes=1) as (_, nodes):
        return run(nodes["alice"], args.device)


def run(node_url: str, device) -> int:
    from pygrid_tpu_torch.client import FLClient, ModelCentricFLClient, SecAggSession
    from pygrid_tpu_torch.federated import secagg
    from pygrid_tpu_torch.models import mlp
    from pygrid_tpu_torch.plans import Plan
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
    try:
        resp = mc.host_federated_training(
            model=params,
            client_plans={"training_plan": plan},
            client_config={
                "name": NAME, "version": VERSION,
                "batch_size": B, "lr": 0.1, "max_updates": 1,
            },
            server_config={
                "min_workers": K, "max_workers": K,
                # readiness at K-1 diffs: the demo's dropout must not stall it
                "min_diffs": K - 1, "max_diffs": K - 1, "num_cycles": 1,
                "pool_selection": "random",
                "do_not_reuse_workers_until_cycle": 0,
                "secure_aggregation": {
                    "clip_range": CLIP,
                    "threshold": K - 1,
                    "phase_timeout": 15.0,
                },
            },
        )
        assert resp.get("status") == "success", resp

        rng = np.random.default_rng(7)
        diffs = {
            i: [rng.normal(0, 0.01, p.shape).astype(np.float32) for p in params]
            for i in range(K)
        }
        results: dict[int, str] = {}
        errors: list[BaseException] = []

        def worker(i: int, drop: bool) -> None:
            client = FLClient(node_url, device=device)
            try:
                auth = client.authenticate(NAME, VERSION)
                wid = auth["worker_id"]
                cyc = client.cycle_request(wid, NAME, VERSION, 1.0, 100.0, 100.0)
                assert cyc.get("status") == "accepted", cyc
                session = SecAggSession(client, wid, cyc["request_key"])
                session.advertise()
                session.wait_roster()
                session.upload_shares()
                session.wait_masking()
                if drop:
                    results[i] = "dropped"
                    print(f"worker {i}: completed key rounds, dropping before report")
                    return
                session.report(diffs[i])
                results[i] = session.finish()
                print(f"worker {i}: reported masked diff, phase={results[i]}")
            except BaseException as err:  # noqa: BLE001 — re-raised below
                errors.append(err)
            finally:
                client.close()

        threads = [
            threading.Thread(target=worker, args=(i, i == K - 1), daemon=True)
            for i in range(K)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
        if errors:
            raise errors[0]
        assert len(results) == K, f"stuck workers: {sorted(results)}"

        latest = [t.cpu().numpy() for t in mc.retrieve_model(NAME, VERSION)]
    finally:
        mc.close()
    survivors = [i for i in range(K) if results[i] != "dropped"]
    expected = [
        p - np.mean([diffs[i][k] for i in survivors], axis=0)
        for k, p in enumerate(params)
    ]
    step = 1.0 / secagg.choose_scale(CLIP, K)
    worst = 0.0
    for got, want in zip(latest, expected):
        worst = max(worst, float(np.abs(got - want).max()))
        np.testing.assert_allclose(got, want, atol=K * step + 1e-6)
    print(
        f"secure aggregation OK: {len(survivors)}/{K} survivors averaged, "
        f"dropout unmasked via Shamir; checkpoint matches plain FedAvg "
        f"(max |Δ| = {worst:.2e}, quantization step {step:.2e})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
