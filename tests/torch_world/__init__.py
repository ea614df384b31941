"""Run the port's multi-device cases in a gloo world of rank processes.

A test module names a rank-side module of this package (``mesh``,
``moe``, ...), whose ``CASES`` each take the numpy inputs and return numpy
results, and hands :func:`world` a function that makes those inputs. The
world is ``WORLD`` processes of ``python -m torch_world`` on the CPU, with
``torch.distributed`` (gloo) started through a file in the run's temporary
directory, not a TCP port. Each rank runs every case of the module once
and writes its results to a file; each test then reads its own case. The
rank processes import no ``jax`` (each checks), so the port's modules run
there as they would on the card's machine.

One world runs per module and test session: under pytest-xdist the first
worker to ask runs it and the others wait on a file lock and read its
files. A world that outlives ``TIMEOUT`` seconds is killed and every test
of the module fails with the ranks' output.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path
from typing import Callable

import numpy as np
from filelock import FileLock

WORLD = 4
TIMEOUT = 120
TESTS = Path(__file__).resolve().parent.parent
ROOT = TESTS.parent


def registry():
    """A module's ``CASES`` dict and the decorator that fills it, in order."""
    cases: dict[str, Callable] = {}

    def case(fn):
        cases[fn.__name__] = fn
        return fn

    return cases, case


class World:
    """The inputs and each rank's results of one world run."""

    def __init__(self, inputs: dict, results: list[dict] | None, error: str | None):
        self.inputs, self._results, self._error = inputs, results, error

    def ranks(self, case: str) -> list[dict]:
        """Every rank's results of ``case``; fails the test where the world
        or the case failed on any rank."""
        assert self._error is None, self._error
        out = [r[case] for r in self._results]
        errors = [f"rank {i}:\n{o['error']}" for i, o in enumerate(out) if "error" in o]
        assert not errors, "\n".join(errors)
        return out

    def __call__(self, case: str) -> dict:
        """Rank 0's results of ``case``."""
        return self.ranks(case)[0]


def _run(name: str, d: Path) -> str | None:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(TESTS), str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [
        subprocess.Popen([sys.executable, "-m", "torch_world", name, str(r), str(WORLD), str(d)],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for r in range(WORLD)
    ]
    outs, failed = [], False
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
            failed |= p.returncode != 0
    except subprocess.TimeoutExpired:
        failed = True
        outs.append(f"the world did not finish within {TIMEOUT} s")
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    if not failed:
        return None
    return f"world {name!r} failed:\n" + "\n".join(o[-3000:] for o in outs)


def world(tmp_path_factory, name: str, make_inputs: Callable[[], dict]) -> World:
    """The inputs and results of the ``name`` world, run once per session."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # shared by the workers of one run
    d = root / f"torch_world_{name}"
    with FileLock(str(d) + ".lock"):
        if not (d / "done").exists():
            d.mkdir(exist_ok=True)
            np.savez(d / "inputs.npz", **make_inputs())
            error = _run(name, d)
            (d / "done").write_text(error or "")
    inputs = dict(np.load(d / "inputs.npz"))
    error = (d / "done").read_text() or None
    results = None
    if error is None:
        results = [pickle.loads((d / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]
    return World(inputs, results, error)
