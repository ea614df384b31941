"""The port's telemetry spine and profiling helpers against the JAX
package's: the same sequence of calls into both packages' bus, trace and
timeline gives equal counters, histograms, events, trace header bytes and
timeline snapshots, timestamps and random span ids aside."""

import datetime as dt
import os
import types

import numpy as np
import pytest
import torch

from pygrid_tpu import telemetry as jtel
from pygrid_tpu.telemetry import timeline as jtimeline
from pygrid_tpu.telemetry import trace as jtrace
from pygrid_tpu.utils import metrics as jmetrics
from pygrid_tpu_torch import telemetry as ttel
from pygrid_tpu_torch.telemetry import timeline as ttimeline
from pygrid_tpu_torch.telemetry import trace as ttrace
from pygrid_tpu_torch.utils import metrics as tmetrics
from pygrid_tpu_torch.utils import profiling

STACKS = {"jax": (jtel, jtrace, jtimeline), "torch": (ttel, ttrace, ttimeline)}
_TS = {"ts", "created_ts", "completed_ts", "assigned_ts", "reported_ts", "duration_s",
       "span_id"}


def _strip(obj):
    """``obj`` with timestamps and random span ids taken out."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in _TS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


@pytest.fixture(autouse=True)
def _clean():
    for tel, _, tl in STACKS.values():
        tel.reset()
        tl.reset()
    yield
    for tel, _, tl in STACKS.values():
        tel.reset()
        tl.reset()


def _feed_bus(tel):
    rng = np.random.RandomState(0)
    for i in range(40):
        tel.incr("reports_total", 1, outcome="ok" if i % 3 else "bounced")
        tel.incr("bytes_total", int(rng.randint(1, 1 << 20)), codec="zlib")
        tel.observe("report_latency_seconds", float(10 ** rng.uniform(-6, 2)))
        tel.observe("cycle_phase_seconds", float(rng.rand()), phase="aggregate")
        tel.record("cycle.closed", cycle_id=i, reported=i % 5)
    for i in range(300):  # past a family's label-set cap: folds into other
        tel.incr("http_requests_total", 1, route=f"/r{i}", code="200")
    tel.observe("custom_seconds", 0.3, bounds=[0.1, 0.5, 1.0])


@pytest.mark.parametrize("part", ["counters", "histograms", "events"])
def test_bus_matches_the_jax_package(part):
    for tel, _, _ in STACKS.values():
        _feed_bus(tel)
    got = {name: getattr(tel, part)() for name, (tel, _, _) in STACKS.items()}
    if part == "events":
        got = {k: _strip(v) for k, v in got.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"]


def test_export_renders_the_jax_package_exposition():
    rendered = {}
    for (name, (tel, _, _)), metrics in zip(STACKS.items(), (jmetrics, tmetrics)):
        _feed_bus(tel)
        exp = metrics.Exposition()
        tel.export(exp)
        rendered[name] = [
            line for line in exp.render().splitlines()
            if "serde_tensor_copies_total " not in line  # each package's own count
        ]
    assert rendered["torch"] == rendered["jax"]
    assert any("pygrid_report_latency_seconds_bucket" in line for line in rendered["torch"])


@pytest.mark.parametrize("value", [
    "0123456789abcdef0123456789abcdef-0123456789abcdef",
    "0123456789ABCDEF0123456789abcdef-0123456789abcdef",
    "0123456789abcdef0123456789abcdef-0123456789abcde",
    "not-a-trace", None, 17,
])
def test_trace_header_parses_like_the_jax_package(value):
    parsed = {name: tr.parse_header(value) for name, (_, tr, _) in STACKS.items()}
    assert (None if parsed["torch"] is None else tuple(parsed["torch"])) == (
        None if parsed["jax"] is None else tuple(parsed["jax"]))


def test_trace_wire_bytes_and_spans_match():
    ctx_hex = ("00112233445566778899aabbccddeeff", "0123456789abcdef")
    out = {}
    for name, (tel, tr, _) in STACKS.items():
        ctx = tr.TraceContext(*ctx_hex)
        raw = tr.to_bytes(ctx)
        assert len(raw) == 24
        with tr.use(ctx):
            assert tr.header() == f"{ctx_hex[0]}-{ctx_hex[1]}"
            with tr.span("fl.report", worker="w1") as child:
                inner = tr.current()
            with tr.serve(None) as served:
                pass
        out[name] = (raw, tuple(tr.from_bytes(raw)), tr.from_bytes(raw[:23]),
                     child.trace_id, inner == child, served.trace_id,
                     _strip(tel.events("span")), tr.current())
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == bytes.fromhex(ctx_hex[0] + ctx_hex[1])


def _feed_timeline(tl):
    tl.cycle_started(1, fl_process_id=7, sequence=1)
    tl.cycle_started(2, fl_process_id=7, sequence=2)
    for w in range(5):
        tl.worker_assigned(1, f"w{w}", trace_id=f"{w:032x}")
    for w in range(3):
        tl.worker_report(1, f"w{w}", latency_s=0.5 * w, n_bytes=1000 * (w + 1),
                         codec="zlib" if w else None, trace_id=f"{w:032x}")
    tl.add_bytes(1, "download", "raw", 4096)
    tl.phase(1, "aggregate", 0.25)
    tl.phase(1, "aggregate", 0.5)
    tl.cycle_closed(1, assigned=5, reported=3, outcome="aggregated")
    tl.cycle_started(1, fl_process_id=8, sequence=9)  # a restarted id replaces the record
    tl.worker_assigned(1, "late")


@pytest.mark.parametrize("view", ["snapshot", "recent", "merged"])
def test_timeline_matches_the_jax_package(view):
    t0 = dt.datetime(2026, 1, 1, 12, 0, 0)
    rows = [types.SimpleNamespace(worker_id="late", started_at=t0,
                                  completed_at=t0 + dt.timedelta(seconds=2.5)),
            types.SimpleNamespace(worker_id="db-only", started_at=t0, completed_at=None)]
    got = {}
    for name, (_, _, tl) in STACKS.items():
        _feed_timeline(tl)
        if view == "snapshot":
            got[name] = [tl.snapshot(1), tl.snapshot(2), tl.snapshot(99)]
        elif view == "recent":
            got[name] = tl.recent(limit=5)
        else:
            got[name] = tl.merge_db_workers(tl.snapshot(1), rows)
    assert _strip(got["torch"]) == _strip(got["jax"])


def test_profiling_timed_records_and_syncs():
    profiling.stats.reset()
    with profiling.timed("unit.block", sync=[torch.ones(3), {"x": torch.zeros(2)}]) as box:
        torch.ones(256).sum()
    result, seconds = profiling.timed_call("unit.call", lambda x: x * 2, torch.arange(4.0))
    assert box["seconds"] >= 0 and seconds >= 0
    assert torch.equal(result, torch.arange(4.0) * 2)
    snap = profiling.stats.snapshot()
    assert snap["unit.block"]["count"] == 1 and snap["unit.call"]["count"] == 1
    assert profiling._cuda_devices([torch.ones(1), (torch.ones(1),)]) == set()


def test_device_trace_writes_a_chrome_trace_and_never_moves_to_the_cpu(tmp_path):
    with profiling.device_trace(str(tmp_path), device="cpu"):
        torch.ones(64).cumsum(0)
    assert os.path.getsize(tmp_path / "trace.json") > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            with profiling.device_trace(str(tmp_path / "gpu")):
                pass
