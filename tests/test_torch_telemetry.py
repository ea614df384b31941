"""The port's telemetry spine and profiling helpers against the JAX
package's: the same sequence of calls into both packages' bus, trace and
timeline gives equal counters, histograms, events, trace header bytes and
timeline snapshots, timestamps and random span ids aside; the serving
path's program profiler and flight recorder give equal rows and dumps; the
node's strict Prometheus parser, burn-rate SLO engine and HTTP middleware
answer as the JAX package's do."""

import datetime as dt
import json
import time
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
    assert box["seconds"] >= 0
    snap = profiling.stats.snapshot()
    assert snap["unit.block"]["count"] == 1
    assert profiling._cuda_devices([torch.ones(1), (torch.ones(1),)]) == set()


# ── the profiler and the flight recorder (serving's telemetry) ──────────

from pygrid_tpu.telemetry import profiler as jprofiler  # noqa: E402
from pygrid_tpu.telemetry import recorder as jrecorder  # noqa: E402
from pygrid_tpu_torch.telemetry import profiler as tprofiler  # noqa: E402
from pygrid_tpu_torch.telemetry import recorder as trecorder  # noqa: E402

PROFILERS = {"jax": (jtel, jprofiler), "torch": (ttel, tprofiler)}
_TIMES = {"compile_ms", "execute_ms_total", "execute_ms_mean"}


class _Program:
    """A program whose signature cache grows on the calls listed."""

    def __init__(self, grows_on):
        self.calls, self._size, self.grows_on = 0, 0, set(grows_on)

    def __call__(self, x):
        if self.calls in self.grows_on:
            self._size += 1
        self.calls += 1
        return x + 1

    def _cache_size(self):
        return self._size


def _feed_profiler(tel, prof):
    p = prof.JitSiteProfiler()
    a = p.wrap(_Program({0, 3}), kind="paged_decode", bucket=4, model_id="m")
    b = p.wrap(lambda x: x * 2, kind="prefill", bucket=16, model_id="m")
    c = p.wrap(_Program({0}), kind="paged_decode", bucket=4, model_id="m")  # a re-host
    for i in range(5):
        assert a(i) == i + 1
    for i in range(3):
        assert b(i) == 2 * i
    c(0), c(1)
    hists = {k: v["count"] for (k, _), v in tel.histograms().items() if k.startswith("profiler")}
    return p.snapshot(), hists, getattr(a, "_cache_size", None) is not None


def test_profiler_splits_compiles_and_hits_like_the_jax_package():
    """The same calls into both packages' profilers: a call that grew the
    program's cache is a compile, others are hits; without the hook the
    first call is the compile; a rebuilt program's first call compiles
    again. Rows and histogram counts equal, times aside."""
    out = {}
    for name, (tel, prof) in PROFILERS.items():
        rows, hists, hooked = _feed_profiler(tel, prof)
        out[name] = ([{k: v for k, v in r.items() if k not in _TIMES} for r in rows], hists,
                     hooked)
    assert out["torch"] == out["jax"]
    rows = {r["kind"]: r for r in out["torch"][0]}
    assert rows["paged_decode"]["compiles"] == 3 and rows["paged_decode"]["hits"] == 4
    assert rows["prefill"]["compiles"] == 1 and rows["prefill"]["hits"] == 2


def test_profiler_off_switch_returns_the_function(monkeypatch):
    monkeypatch.setenv("PYGRID_PROFILER", "off")
    fn = _Program({0})
    assert tprofiler.JitSiteProfiler().wrap(fn, kind="k", bucket=1) is fn
    assert not tprofiler.cost_enabled()
    sampler = tprofiler.DeviceMemorySampler(interval_s=0.01)
    sampler.start()
    assert sampler._thread is None
    sampler.stop()


def test_profiler_cost_counts_flops_on_meta_tensors():
    """Cost attribution replays the first call on meta tensors under
    FlopCounterMode: 2·M·N·K for a product, bytes of arguments and
    outputs; the real arguments are never touched again."""
    p = tprofiler.JitSiteProfiler()
    calls = []

    def program(params, x):
        calls.append(x.device.type)
        return x @ params[0]

    fn = p.wrap(program, kind="decode", bucket=8, model_id="cost")
    w, x = torch.ones(16, 32), torch.ones(8, 16)
    assert torch.equal(fn([w], x), x @ w)
    fn([w], x)
    (row,) = p.snapshot(include_cost=True)
    assert row["flops"] == 2 * 8 * 16 * 32
    assert row["bytes_accessed"] == 4 * (16 * 32 + 8 * 16 + 8 * 32)
    assert row["bytes_accessed_total"] == 2 * row["bytes_accessed"]
    assert calls == ["cpu", "cpu", "meta"]
    assert p.snapshot(include_cost=True)[0]["flops"] == row["flops"]  # cached


def test_device_memory_sampler_and_export_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert tprofiler.DeviceMemorySampler.sample_once() == []
    sampler = tprofiler.DeviceMemorySampler(interval_s=0.01)
    sampler.start()
    deadline = time.monotonic() + 5
    while sampler.age_s() is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sampler.latest() == [] and sampler.age_s() is not None
    sampler.stop()
    exp = tmetrics.Exposition()
    tprofiler.MEMORY._latest = [{"device": "0", "platform": "gpu", "bytes_in_use": 5,
                                 "peak_bytes_in_use": 9, "bytes_limit": 80}]
    try:
        tprofiler.export_device_memory(exp)
    finally:
        tprofiler.MEMORY._latest = []
    text = exp.render()
    assert 'kind="peak_bytes_in_use"' in text and "pygrid_device_memory_bytes" in text


@pytest.mark.cuda
def test_device_memory_sampler_reads_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    x = torch.ones(1 << 20, device="cuda")
    (row, *_) = tprofiler.DeviceMemorySampler.sample_once()
    assert row["bytes_in_use"] >= x.numel() * 4 and row["bytes_limit"] > row["bytes_in_use"]


_SECRET = {"token": "abc", "nested": {"Password": "p", "ok": [1, b"xyz", "a" * 3000]},
           "request_key": 5, "obj": object, "val": 1.5}


def test_recorder_redacts_and_dumps_like_the_jax_package(tmp_path, monkeypatch):
    """One sequence of notes, a registered stats provider and a dump into
    both packages' recorders: equal redaction, ring and dump payload
    (timestamps and bus events aside); the rate limit and the off-switch
    act alike."""
    assert trecorder.redact(_SECRET) == jrecorder.redact(_SECRET)

    class Provider:
        def stats(self):
            return {"queue_depth": 2, "token": "t"}

    provider = Provider()
    dumps = {}
    for name, rec_mod, tel in (("jax", jrecorder, jtel), ("torch", trecorder, ttel)):
        monkeypatch.setenv("PYGRID_FLIGHT_DIR", str(tmp_path / name))
        rec = rec_mod.FlightRecorder()
        rec.note("engine.fail_all", model="m", error="boom", failed=2)
        rec.note("other", token="secret")
        rec.register_stats_provider("serving", provider)
        tel.incr("serving_requests_total", 2, outcome="error", model="m")
        path = rec.dump("engine_fail_all", snapshot={"slots": [1], "jwt": "x"},
                        error=RuntimeError("boom"))
        assert rec.dump("engine_fail_all") is None  # rate-limited per reason
        assert rec.should_dump("other_reason")
        with open(path) as fh:
            payload = json.load(fh)
        payload.pop("events")
        dumps[name] = _strip(payload)
    assert dumps["torch"] == dumps["jax"]
    assert dumps["torch"]["ring"][1]["token"] == "[redacted]"
    assert dumps["torch"]["stats"]["serving"]["token"] == "[redacted]"
    monkeypatch.setenv("PYGRID_FLIGHT", "off")
    rec = trecorder.FlightRecorder()
    rec.note("x")
    assert rec.ring() == [] and rec.dump("y") is None
    assert rec.dump("y", force=True) is not None


def test_telemetry_package_reexports_profiler_and_recorder():
    assert ttel.profiler is tprofiler and ttel.recorder is trecorder
    assert callable(ttel.recorder.note) and callable(ttel.recorder.dump)
    assert callable(ttel.recorder.register_stats_provider)
    assert callable(ttel.profiler.wrap) and callable(ttel.profiler.programs_snapshot)


# --------------------------------------------------------------------------
# promtext, slo and the HTTP middleware (the node's observability)
# --------------------------------------------------------------------------

_BAD_EXPOSITIONS = [
    "# HELP a x\n# HELP a y\na 1\n",                       # duplicate HELP
    "# TYPE a counter\n# TYPE a gauge\na 1\n",             # duplicate TYPE
    'a{l="x} 1\n',                                          # unterminated label value
    "a 1\nb 2\na 3\n",                                      # interleaved family groups
    "# TYPE h histogram\nh_bucket{le=\"1\"} 5\nh_bucket{le=\"+Inf\"} 3\nh_count 3\nh_sum 1\n",
    "a one\n",                                              # not a number
]


def test_promtext_parses_the_export_as_the_jax_package_does():
    from pygrid_tpu.telemetry import promtext as jprom
    from pygrid_tpu_torch.telemetry import promtext as tprom

    _feed_bus(ttel)
    exp = tmetrics.Exposition()
    ttel.export(exp)
    text = exp.render()
    got, want = tprom.parse(text), jprom.parse(text)
    assert sorted(got) == sorted(want) and len(got) > 4
    for name in want:
        assert (got[name].type, got[name].samples) == (want[name].type, want[name].samples)


@pytest.mark.parametrize("text", _BAD_EXPOSITIONS)
def test_promtext_refuses_what_the_jax_package_refuses(text):
    from pygrid_tpu.telemetry import promtext as jprom
    from pygrid_tpu_torch.telemetry import promtext as tprom

    with pytest.raises(ValueError):
        jprom.parse(text)
    with pytest.raises(ValueError):
        tprom.parse(text)


def test_slo_engine_evaluates_like_the_jax_package():
    """The node's objectives over two buses fed alike: every row (status,
    compliance, burns) equal at each evaluation, and the exported gauges
    parse strictly."""
    from pygrid_tpu.telemetry import slo as jslo
    from pygrid_tpu.telemetry.bus import TelemetryBus as JBus
    from pygrid_tpu_torch.telemetry import promtext as tprom
    from pygrid_tpu_torch.telemetry import slo as tslo
    from pygrid_tpu_torch.telemetry.bus import TelemetryBus as TBus

    buses = {"jax": JBus(), "torch": TBus()}
    engines = {"jax": jslo.SLOEngine(jslo.node_objectives(), windows=(60.0, 600.0),
                                     source=buses["jax"]),
               "torch": tslo.SLOEngine(tslo.node_objectives(), windows=(60.0, 600.0),
                                       source=buses["torch"])}
    rng = np.random.RandomState(4)
    rows = {k: [] for k in buses}
    for step, now in enumerate((0.0, 30.0, 90.0, 400.0)):
        values = 10 ** rng.uniform(-4, 1, size=40)
        for k, bus in buses.items():
            for v in values:
                bus.observe("serving_ttft_seconds", float(v), model="m")
                bus.observe("node_event_seconds", float(v) / 10, event="model-centric/report")
            rows[k].append(engines[k].evaluate(now=now))
    assert rows["torch"] == rows["jax"]
    assert {r["status"] for r in rows["torch"][-1]} - {"no_data"}
    exp = tmetrics.Exposition()
    engines["torch"].export(exp)
    assert tprom.parse(exp.render())


def test_http_middleware_labels_routes_and_codes_as_the_jax_package():
    """The same requests through the JAX package's aiohttp middleware and
    the port's over its own server: equal ``http_requests_total`` counters
    (route = canonical resource, "unmatched" for 404 and 405) and request
    histogram counts."""
    from aiohttp import web as aioweb

    from pygrid_tpu_torch import web
    from pygrid_tpu_torch.web import client as http
    from test_torch_web import AioServer

    def requests_to(base):
        for method, path, body in (("GET", "/items/1", None), ("GET", "/items/2", None),
                                   ("POST", "/items/3", b"x"), ("GET", "/nope", None),
                                   ("POST", "/big", b"y" * 2048), ("GET", "/boom", None)):
            http.request(method, base + path, data=body, timeout=10)

    async def item(request):
        return web.json_response({"id": request.match_info["id"]})

    async def big(request):
        await request.read()
        return web.json_response({})

    async def boom(request):
        raise RuntimeError("handler defect")

    port_app = web.Application(middlewares=[ttel.http_middleware()], client_max_size=1024)
    port_app.router.add_get("/items/{id}", item)
    port_app.router.add_post("/big", big)
    port_app.router.add_get("/boom", boom)

    async def aitem(request):
        return aioweb.json_response({"id": request.match_info["id"]})

    async def abig(request):
        await request.read()
        return aioweb.json_response({})

    async def aboom(request):
        raise RuntimeError("handler defect")

    jax_app = aioweb.Application(middlewares=[jtel.http_middleware()], client_max_size=1024)
    jax_app.router.add_get("/items/{id}", aitem)
    jax_app.router.add_post("/big", abig)
    jax_app.router.add_get("/boom", aboom)

    srv = web.BackgroundServer(port_app).start()
    try:
        requests_to(srv.url)
    finally:
        srv.stop()
    with AioServer(jax_app) as base:
        requests_to(base)

    def http_counters(tel):
        return {k: v for k, v in tel.counters().items() if k[0] == "http_requests_total"}

    got, want = http_counters(ttel), http_counters(jtel)
    assert got == want
    assert {dict(labels)["route"] for _, labels in got} == {"/items/{id}", "unmatched", "/big",
                                                            "/boom"}
    assert {dict(labels)["code"] for _, labels in got} == {"200", "404", "405", "413", "500"}
    counts = {tel: {k: h["count"] for k, h in tel.histograms().items()
                    if k[0] == "http_request_seconds"} for tel in (ttel, jtel)}
    assert counts[ttel] == counts[jtel]
