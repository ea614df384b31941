"""The attribution of device time to the program's ``pgt.`` spans
(``benchmark/spans.py``) and the metrics that read it, on synthetic
traces: by launch, never by when an op ran."""

from pathlib import Path

import pytest

from benchmark import harness as H
from benchmark import spans as S
from benchmark.trace import TraceData

METRICS = Path(__file__).resolve().parents[1] / "metrics"
MAIN, AUTOGRAD = 1, 2

#: one round on the host (µs): the forward's block and head on the main
#: thread, the backward on the autograd engine's thread under the main
#: thread's ``pgt.round.backward``, then the update
SPANS = [
    (MAIN, "bench.round", 0, 1000),
    (MAIN, "pgt.round", 0, 1000),
    (MAIN, "pgt.round.forward", 0, 400),
    (MAIN, "pgt.model.block", 10, 200),
    (MAIN, "pgt.model.head.fwd", 250, 390),
    (MAIN, "pgt.round.backward", 400, 900),
    (AUTOGRAD, "pgt.model.head.bwd", 410, 500),
    (AUTOGRAD, "pgt.model.block", 600, 700),
    (MAIN, "pgt.round.update", 900, 990),
]


def _trace(launches, spans=SPANS):
    """A reduced trace whose i-th device op (start, seconds) was launched
    by the i-th call ``(thread, time)``; each op also launches from a
    ``cudaLaunchKernel`` call on the host's timeline."""
    host = list(spans) + [(th, "aten::mm", t - 1, t + 2) for th, t, _, _ in launches]
    host += [(th, "cudaLaunchKernel", t, t + 1) for th, t, _, _ in launches]
    device = [(f"k{i}", start, start + dur * 1e6) for i, (_, _, start, dur) in enumerate(launches)]
    return TraceData(window=(0, 300_000), device_ops=device, host_ops=host)


# (launching thread, launch time, run start, device seconds)
LAUNCHES = [
    (MAIN, 20, 20, 1e-3),         # inside the forward's block: block, forward, round
    (MAIN, 300, 1021, 2e-3),      # head forward, run long after, inside the backward's time
    (MAIN, 395, 3021, 4e-6),      # forward, after its head closed, run after the round ended
    (AUTOGRAD, 450, 3025, 8e-3),  # the head's backward on the autograd thread
    (AUTOGRAD, 550, 11025, 16e-3),  # autograd thread, no span of its own: the backward
    (AUTOGRAD, 650, 27025, 32e-3),  # the block's recompute in the backward
    (MAIN, 950, 59025, 64e-3),    # the update
    (MAIN, 1500, 123025, 128e-3),  # after the round: no span
]


def test_attribute_by_launch_with_nesting_and_fallback():
    got = S.attribute([(dur, th, t) for th, t, _, dur in LAUNCHES],
                      [sp for sp in SPANS if sp[1].startswith("pgt.")])
    ms = {k: v[0] * 1e3 for k, v in got.items()}
    assert ms == pytest.approx({
        "pgt.round": 1 + 2 + 0.004 + 8 + 16 + 32 + 64,
        "pgt.round.forward": 1 + 2 + 0.004,
        "pgt.model.block": 1 + 32,
        "pgt.model.head.fwd": 2,
        "pgt.round.backward": 8 + 16 + 32,
        "pgt.model.head.bwd": 8,
        "pgt.round.update": 64,
    })
    assert {k: v[1] for k, v in got.items()} == {
        "pgt.round": 1, "pgt.round.forward": 1, "pgt.model.block": 2, "pgt.model.head.fwd": 1,
        "pgt.round.backward": 1, "pgt.model.head.bwd": 1, "pgt.round.update": 1}


def test_a_span_of_the_same_name_on_two_threads_counts_an_op_once():
    spans = [(MAIN, "pgt.x", 0, 100), (AUTOGRAD, "pgt.x", 10, 50)]
    assert S.attribute([(1.0, AUTOGRAD, 20), (2.0, MAIN, 60)], spans) == {"pgt.x": (3.0, 2)}


def test_ops_outside_every_span_count_for_none():
    assert S.attribute([(1.0, MAIN, 5)], [(MAIN, "pgt.x", 10, 20)]) == {"pgt.x": (0.0, 1)}
    assert S.attribute([(1.0, MAIN, 5)], []) == {}


def test_launched_ops_pair_by_stream_order():
    ops = S.launched_ops(_trace(LAUNCHES))
    assert [(th, t) for _, th, t in ops] == [(th, t) for th, t, _, _ in LAUNCHES]
    assert [round(s, 9) for s, _, _ in ops] == [d for *_, d in LAUNCHES]


def test_launched_ops_pair_kinds_and_allow_clock_skew():
    """Copies and fills pair with their own calls; an op that, on the
    card's clock mapped to the host's, starts just before its call still
    pairs."""
    t = TraceData((0, 300_000),
                  device_ops=[("k0", 18, 30), ("Memset (Device)", 40, 41),
                              ("Memcpy DtoD (Device -> Device)", 50, 52)],
                  host_ops=[(MAIN, "cuLaunchKernelEx", 20, 21), (MAIN, "cudaMemsetAsync", 22, 23),
                            (AUTOGRAD, "cudaMemcpyAsync", 24, 25)])
    assert S.launched_ops(t) == [(12e-6, MAIN, 20), (1e-6, MAIN, 22), (2e-6, AUTOGRAD, 24)]


def test_launched_ops_refuse_what_does_not_pair():
    t = _trace(LAUNCHES)
    extra = TraceData(t.window, t.device_ops, t.host_ops + [(MAIN, "cudaMemsetAsync", 4000, 4001)])
    assert S.launched_ops(extra) is None
    fill = TraceData(t.window, t.device_ops[:-1] + [("Memset (Device)", 123025, 123026)],
                     t.host_ops)  # a kernel launch paired with a fill
    assert S.launched_ops(fill) is None
    assert S.launched_ops(TraceData((0, 10), [], [])) is None


def _metric(name):
    return H.load_module(METRICS / f"{name}.py", f"benchmark.metrics.{name.replace('.', '_')}")


EXPECTED_MS = {  # per unit, two units traced
    "fwd_ms.gpt2": (1 + 2 + 0.004) / 2,
    "bwd_ms.gpt2": (8 + 16 + 32) / 2,
    "update_ms.gpt2": 64 / 2,
    "head_ms.gpt2": (2 + 8) / 2,
}


@pytest.mark.parametrize("name", sorted(EXPECTED_MS))
def test_span_metrics_read_ms_per_unit(name):
    m = _metric(name)
    assert m.UNIT == "ms" and m.MOVES == "train_tokens_per_s"
    assert m.read({"trace": _trace(LAUNCHES), "units": 2}) == pytest.approx(EXPECTED_MS[name])


@pytest.mark.parametrize("name", sorted(EXPECTED_MS))
def test_span_metrics_read_nothing_without_the_spans(name):
    m = _metric(name)
    bench_only = [sp for sp in SPANS if sp[1].startswith("bench.")]
    assert m.read({"trace": _trace(LAUNCHES, bench_only), "units": 2}) is None
    assert m.read({"trace": None, "units": 2}) is None
    unpaired = _trace(LAUNCHES)
    unpaired.host_ops.append((MAIN, "cudaLaunchKernel", 4000, 4001))
    assert m.read({"trace": unpaired, "units": 2}) is None


def test_head_ms_reads_nothing_with_one_direction_traced():
    no_bwd = [sp for sp in SPANS if sp[1] != "pgt.model.head.bwd"]
    assert _metric("head_ms.gpt2").read({"trace": _trace(LAUNCHES, no_bwd), "units": 2}) is None


def test_the_span_metrics_cover_the_round():
    """Forward, backward and update hold every op launched in the round."""
    ctx = {"trace": _trace(LAUNCHES[:-1]), "units": 1}
    parts = sum(_metric(n).read(ctx) for n in ("fwd_ms.gpt2", "bwd_ms.gpt2", "update_ms.gpt2"))
    assert parts == pytest.approx(S.ms_per_unit(ctx, "pgt.round"))
    assert parts == pytest.approx(ctx["trace"].busy_s * 1e3)
