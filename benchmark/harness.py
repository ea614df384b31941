"""The harness: find a cell's files by name, check the device, drive the
entry, judge its output, print the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix. Each lives in a file of its own, and so
does the cell's entry kind and every per-layer metric:

- ``configs/<config>.json``   the configuration as it is run
- ``traffic/<traffic>.json``  the mix's parameters, read by ``traffic.py``
- ``workloads/<cell>.json``   the entry kind, its options and the limits
                              that decide ``correct``
- ``entries/<kind>.py``       ``run(ctx) -> Outcome``: set-up, window, check
- ``metrics/<metric>.py``     ``read(ctx) -> float | None`` over a traced run

Nothing in this folder imports ``jax`` or the JAX package; a run that finds
either loaded once its window has closed prints no result.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

FORBIDDEN = ("jax", "jaxlib", "flax", "pygrid_tpu")


class BenchError(RuntimeError):
    """A cell that cannot run: a missing file, a wrong device, a broken rule."""


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    spec: dict
    end_to_end: list
    per_layer: list
    readers: dict = field(default_factory=dict)


def load_json(path: Path) -> Any:
    if not path.is_file():
        raise BenchError(f"missing file {path}")
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    if not path.is_file():
        raise BenchError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """Everything a cell needs, found by the names in ``BENCHMARK.json``."""
    bench = load_json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise BenchError(f"no workload named {name!r} in BENCHMARK.json")
    w = entries[0]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise BenchError(f"workload {name!r} names an unknown config {w['config']!r}")
    bdir = root / "benchmark"
    cell = Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=load_json(root / configs[w["config"]]["file"]),
        traffic_name=w["traffic"], traffic=load_json(bdir / "traffic" / f"{w['traffic']}.json"),
        spec=load_json(bdir / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _listed(m, name)],
        per_layer=[m for m in bench["per_layer"] if _listed(m, name)],
    )
    for m in cell.per_layer:
        cell.readers[m["name"]] = load_module(
            bdir / "metrics" / f"{m['name']}.py", f"benchmark.metrics.{m['name'].replace('.', '_')}")
    return cell


def load_entry(root: Path, kind: str):
    return load_module(root / "benchmark" / "entries" / f"{kind}.py", f"benchmark.entries.{kind}")


def sub_seed(seed: int, *labels) -> int:
    """A 63-bit seed for one stream of draws, fixed by ``seed`` and labels."""
    h = hashlib.sha256(repr((int(seed),) + labels).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def note(text: str) -> None:
    """A line for the reader of standard error (never the last ones)."""
    print(f"benchmark: {text}", file=sys.stderr, flush=True)


def forbidden_loaded() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def quantile(values, q: float) -> float:
    """The ``q`` quantile (0..1) by linear interpolation between order
    statistics; every value counts."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


@dataclass
class RunContext:
    """One run of one cell."""
    root: Path
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str            # "cuda", or "cpu" in the harness's own tests
    t0: float              # perf_counter at process start
    rank: int = 0
    world: int = 1
    store: str | None = None

    def sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def family(self):
        fam = self.cell.config["family"]
        return load_module(self.root / "benchmark" / "families" / f"{fam}.py",
                           f"benchmark.families.{fam}")


@dataclass
class Window:
    """Units of work run back to back: each unit's start and end (host
    seconds, after the device finished it)."""
    starts: list = field(default_factory=list)
    ends: list = field(default_factory=list)

    @property
    def units(self) -> int:
        return len(self.ends)

    @property
    def span_s(self) -> float:
        return self.ends[-1] - self.starts[0] if self.ends else 0.0

    @property
    def latencies(self) -> list:
        return [e - s for s, e in zip(self.starts, self.ends)]


def run_window(unit: Callable[[int], None], seconds: float, sync: Callable[[], None],
               max_units: int | None = None, keep_going: Callable[[bool], bool] | None = None,
               ) -> Window:
    """Run ``unit(i)`` until ``seconds`` have passed since the first
    started (a unit started before then is finished and counted), or
    ``max_units`` ran. ``sync`` waits for the device after each unit.
    ``keep_going(want)``, where given, turns this process's wish to go on
    into the decision every rank takes alike."""
    w = Window()
    t0 = time.perf_counter()
    i = 0
    while True:
        s = time.perf_counter()
        unit(i)
        sync()
        e = time.perf_counter()
        w.starts.append(s)
        w.ends.append(e)
        i += 1
        want = (e - t0) < seconds and (max_units is None or i < max_units)
        if keep_going is not None:
            want = keep_going(want)
        if not want:
            return w


@dataclass
class Outcome:
    """What an entry hands back to the harness."""
    e2e: dict                      # end-to-end name -> value (host clock)
    numbers: dict                  # compared number -> value
    limits: dict                   # compared number -> limit
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Any = None              # trace.TraceData of a traced run
    metric_ctx: dict = field(default_factory=dict)
    busy_s: float | None = None    # averaged over the chips used
    window_s: float | None = None


def compose(cell: Cell, outcome: Outcome, traced: bool, device: dict,
            build: dict | None = None) -> tuple[dict, list]:
    """The result object and the stderr lines of the compared numbers;
    ``build`` records a build of the kernels apart from ``setup_s``."""
    from benchmark.reference.compare import judge

    ok, rows = judge(outcome.numbers, outcome.limits)
    correct = bool(ok and outcome.failed == 0 and outcome.attempted > 0)
    metrics = {}
    if traced:
        ctx = dict(outcome.metric_ctx, trace=outcome.trace, cell=cell)
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device = dict(device, busy_s=outcome.busy_s, window_s=outcome.window_s)
    else:
        for m in cell.end_to_end:
            if m["name"] not in outcome.e2e:
                raise BenchError(f"entry gave no {m['name']!r} for {cell.name}")
            metrics[m["name"]] = {"value": float(outcome.e2e[m["name"]]), "unit": m["unit"]}
    result = {"correct": correct, "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": metrics, "device": device}
    if traced and outcome.trace is not None:
        result["breakdown"] = outcome.trace.breakdown()
    if build is not None:
        result["build"] = build
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    lines = [f"check {k}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}"
             for k, v, lim in rows]
    lines.append(f"check attempted {outcome.attempted}, failed {outcome.failed}: "
                 f"correct {str(correct).lower()}")
    return result, lines
