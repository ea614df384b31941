"""One rank of a test world: ``python -m torch_world NAME RANK WORLD DIR``.

Starts the gloo world through ``initialize_distributed`` with a file
rendezvous in DIR, runs every case of ``torch_world.NAME`` on the CPU and
writes ``{case: results}`` (or ``{"error": traceback}``) to DIR/rankRANK.pkl."""

import sys

assert "jax" not in sys.modules, "a rank process imported jax"

import importlib  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402


def main() -> None:
    name, rank, world, d = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    import numpy as np
    import torch
    import torch.distributed as dist

    from pygrid_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(init_method=f"file://{d / 'rendezvous'}", world_size=world, rank=rank,
                           device="cpu")
    module = importlib.import_module(f"torch_world.{name}")
    inputs = dict(np.load(d / "inputs.npz"))
    results = {}
    for case, fn in module.CASES.items():
        try:
            results[case] = fn(inputs)
        except Exception:  # recorded for the test of this case to report
            results[case] = {"error": traceback.format_exc()}
    assert "jax" not in sys.modules, "a rank process imported jax"
    tmp = d / f"rank{rank}.pkl.tmp"
    tmp.write_bytes(pickle.dumps(results))
    os.replace(tmp, d / f"rank{rank}.pkl")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
