"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout. The run makes its weights and inputs on the card from
``--seed``, warms every shape it uses (set-up), measures for ``--seconds``
(``--trace 1``: a bounded part of it under torch.profiler), checks what the
timed path produced against a plain reference, and prints one JSON object
as the last line of standard output, the compared numbers with their
limits as the last lines of standard error. It exits with another code than
0, and prints no result, without enough CUDA devices, or when ``jax``,
``jaxlib``, ``flax`` or ``pygrid_tpu`` is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, and
    one host thread for the CPU's math libraries: the timed paths are the
    card's work and one Python thread driving it."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"


def _build_kernels() -> dict:
    """The port's CUDA kernels built before anything else, so that a
    checkout's first run, in which nvcc builds them into
    ``pygrid_tpu_torch/_build/``, is told apart from the others: whether
    anything was built, and the seconds it took (part of ``setup_s``)."""
    from pygrid_tpu_torch.kernels import build

    t = time.perf_counter()
    built = build.build_all()
    return {"cold": bool(built), "build_s": time.perf_counter() - t, "built": sorted(built)}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the harness's own tests run a cell on the CPU at a tiny size
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help=argparse.SUPPRESS)
    # set by a multi-card run for the ranks it starts
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None, root: Path = ROOT) -> int:
    args = parse(argv)
    _environment()
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import torch

    torch.set_num_threads(1)

    from benchmark import harness as H

    try:
        cell = H.load_cell(root, args.workload)
        if args.device == "cuda":
            if not torch.cuda.is_available():
                raise H.BenchError("no CUDA device: torch.cuda.is_available() is false")
            if torch.cuda.device_count() < cell.chips:
                raise H.BenchError(f"{cell.name} needs {cell.chips} CUDA devices, "
                                   f"this machine has {torch.cuda.device_count()}")
        build = _build_kernels() if args.device == "cuda" and args.rank == 0 else None
        if build is not None:
            H.note(f"kernels: {'built by nvcc' if build['cold'] else 'found built'} "
                   f"in {build['build_s']:.3f} s (counted in setup_s)")
        entry = H.load_entry(root, cell.spec["entry"])
        ctx = H.RunContext(root=root, cell=cell, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), device=args.device, t0=T0, rank=args.rank,
                           world=cell.chips, store=args.store)
        outcome = entry.run(ctx)
        bad = H.forbidden_loaded()
        if bad:
            raise H.BenchError(f"forbidden modules loaded: {', '.join(bad)}")
        if args.rank:
            return 0
        device = {"platform": "gpu" if args.device == "cuda" else "cpu",
                  "kind": torch.cuda.get_device_name() if args.device == "cuda" else "cpu",
                  "count": cell.chips, "memory_peak_bytes": outcome.memory_peak_bytes}
        result, lines = H.compose(cell, outcome, bool(args.trace), device, build)
    except H.BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
