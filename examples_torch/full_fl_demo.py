"""End-to-end model-centric FL on port nodes: host, train, checkpoint.

The port's twin of ``examples/full_fl_demo.py``: it runs
``model_centric/01_create_plan.py`` and ``model_centric/02_execute_plan.py``
as subprocesses against one node, passing ``--device`` on, then the
second pulls the final checkpoint.

    python examples_torch/full_fl_demo.py --spawn [--device cpu]
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # _grid, then the checkout

from _grid import example_args, grid, parse


def main(argv=None) -> int:
    parser = example_args("full FL round-trip demo")
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--cycles", type=int, default=2)
    args = parse(parser, argv)
    with grid(args, n_nodes=1) as (_, nodes):
        node_url = nodes["alice"]
        base = [sys.executable, "-u"]
        common = ["--node", node_url, "--device", args.device]
        host = subprocess.run(
            [*base, str(HERE / "model_centric" / "01_create_plan.py"), *common],
            timeout=600,
        )
        if host.returncode:
            return host.returncode
        execute = subprocess.run(
            [*base, str(HERE / "model_centric" / "02_execute_plan.py"), *common,
             "--workers", str(args.workers), "--cycles", str(args.cycles)],
            timeout=600,
        )
        return execute.returncode


if __name__ == "__main__":
    sys.exit(main())
