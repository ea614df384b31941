"""gridlint for the PyTorch/CUDA port — the repo-native static analysis,
run over ``pygrid_tpu_torch/``.

The counterpart of :mod:`pygrid_tpu.analysis`; it imports nothing of it,
reads source text only (Python, CUDA C++, the docs) and needs no device.
Five families carry over unchanged, and two are retargeted at what the
port has instead of JAX:

    python -m pygrid_tpu_torch.analysis pygrid_tpu_torch/

- **GL1 program safety** (GL101/GL102/GL103/GL105) — host side effects,
  host syncs and per-call builds in the port's *programs*: the functions
  ``ProgramSet._build`` serves, ``torch.export``/``torch.compile``/CUDA
  graph bodies, ``torch.autograd.Function`` forward/backward and the
  closures the FedAvg round builders return (``checkers/gl1_trace.py``
  lists each beside the reference's ``jax.jit`` site).
- **GL2 thread/lock discipline** (GL201–GL206) — lock-order cycles,
  unlocked mutation of locked state, blocking calls under a lock and
  state written from two execution domains, over the shared program
  graph (``analysis/graph.py``).
- **GL3 async hygiene** (GL301–GL303) — blocking calls on the event loop
  in the port's own ``web`` server's handlers.
- **GL4 contract drift** (GL401–GL406) — metric families and wire
  constants against ``docs/OBSERVABILITY.md`` and ``docs/WIRE.md``.
- **GL5 CUDA launch bounds** (GL501/GL502) — the launches in ``csrc/``:
  grids as ceiling divisions by the kernel's own tiles, blocks equal to
  ``__launch_bounds__``, shared memory within Hopper's 227 KB a block.
- **GL6 dataflow & taint** (GL601–GL604) — privacy taint into logs,
  metrics and egress; resource pairing; untyped-error escape.
- **GL7 protocol conformance** (GL701–GL705) — senders, handlers, payload
  keys and the lifecycle machines against ``docs/wire_protocol.yaml``
  (read by ``analysis/yaml_subset.py``: no PyYAML needed).

Per-line suppression: ``# gridlint: disable=GL202`` on any line of the
statement. Pre-existing findings live in ``analysis/baseline.json`` keyed
``(path, code) -> count``, each with a note; an entry larger than reality
is reported as *stale*.
"""

from __future__ import annotations

from pygrid_tpu_torch.analysis.core import (  # noqa: F401
    Baseline,
    Finding,
    RunResult,
    default_baseline_path,
    run_checks,
)
from pygrid_tpu_torch.analysis.checkers import ALL_CHECKERS  # noqa: F401

__all__ = [
    "ALL_CHECKERS",
    "Baseline",
    "Finding",
    "RunResult",
    "default_baseline_path",
    "run_checks",
]
