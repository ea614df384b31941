"""Run FL workers against a hosted process until the cycles complete.

The port's twin of ``examples/model_centric/02_execute_plan.py``: N
workers (``pygrid_tpu_torch.worker.run_worker``) authenticate, request a
cycle, download the model and the plan, run local SGD through the plan's
op list on ``--device``, and report their diffs; the node averages them
and advances the cycles. The checkpoint is retrieved at the end.

    python examples_torch/model_centric/02_execute_plan.py --node URL [--device cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # _grid, then the checkout

from _grid import example_args, parse, wait_for

NAME, VERSION = "mnist", "1.0"


def main(argv=None) -> int:
    parser = example_args("execute FL training cycles")
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--cycles", type=int, default=2)
    args = parse(parser, argv)
    wait_for(args.node, args.wait)

    from pygrid_tpu_torch.client import ModelCentricFLClient
    from pygrid_tpu_torch.worker import run_worker

    total_accepted = 0
    for cycle in range(args.cycles):
        for w in range(args.workers):
            result = run_worker(args.node, NAME, VERSION, cycles=1, device=args.device)
            total_accepted += result.accepted
            print(
                f"cycle {cycle} worker {w}: accepted={result.accepted} "
                f"rejected={result.rejected} errors={result.errors}"
            )

    client = ModelCentricFLClient(args.node, device=args.device)
    try:
        checkpoint = client.retrieve_model(NAME, VERSION, "latest")
        print(f"latest checkpoint: {len(checkpoint)} tensors, "
              f"first shape {tuple(checkpoint[0].shape)}")
    finally:
        client.close()
    return 0 if total_accepted else 1


if __name__ == "__main__":
    sys.exit(main())
