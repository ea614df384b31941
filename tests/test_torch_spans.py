"""The port's ranges on torch.profiler's clock: ``utils.profiling.region``
(a ``record_function`` range while a profiler records, a shared no-op
otherwise), and the ``pgt.`` spans of the fused FedAvg round, the
transformer and flash attention, as a CPU profile records them; the grid's
``telemetry.trace.span`` keeps its bus event and opens no range."""

import collections
import json
import subprocess
import sys
import textwrap
from functools import partial
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pygrid_tpu_torch import telemetry
from pygrid_tpu_torch.models import transformer as T
from pygrid_tpu_torch.parallel import flash_attention as fa
from pygrid_tpu_torch.parallel import make_fused_round
from pygrid_tpu_torch.telemetry import trace
from pygrid_tpu_torch.utils.profiling import region

REPO = Path(__file__).resolve().parents[1]
CFG = T.TransformerConfig(vocab=32, d_model=16, n_heads=2, n_layers=3, d_ff=32, max_len=8)
K = 3


@pytest.fixture(autouse=True)
def _clean_bus():
    telemetry.reset()
    yield
    telemetry.reset()


def _names(prof, prefix="pgt.") -> collections.Counter:
    return collections.Counter(e.name for e in prof.events() if e.name.startswith(prefix))


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.randint(0, CFG.vocab, (K, 2, CFG.max_len), generator=g)
    y = torch.randint(0, CFG.vocab, (K, 2, CFG.max_len), generator=g)
    return X, y


def test_region_off_is_one_shared_no_op():
    a, b = region("pgt.a"), region("pgt.b")
    assert a is b
    with a as got:
        assert got is None


def test_region_records_nothing_without_a_profiler():
    with region("pgt.before"):
        torch.ones(4).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    with region("pgt.after"):
        torch.ones(4).sum()
    assert _names(prof) == {}
    assert telemetry.events() == []


def test_region_is_a_profiler_range_while_one_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with region("pgt.outer"):
            with region("pgt.inner"):
                torch.ones(4).sum()
    ev = {e.name: e for e in prof.events() if e.name.startswith("pgt.")}
    assert set(ev) == {"pgt.outer", "pgt.inner"}
    outer, inner = ev["pgt.outer"].time_range, ev["pgt.inner"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end
    assert telemetry.events() == []


@pytest.mark.parametrize("profiled", [False, True])
def test_span_keeps_its_bus_event_under_a_profiler(profiled):
    def run():
        with trace.span("grid.outer", cycle=7) as outer:
            with trace.span("grid.inner") as inner:
                torch.ones(4).sum()
        return outer, inner

    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            outer, inner = run()
        assert _names(prof, "grid.") == {}
    else:
        outer, inner = run()
    ev = telemetry.events("span")
    assert [e["name"] for e in ev] == ["grid.inner", "grid.outer"]
    assert ev[0]["trace_id"] == ev[1]["trace_id"] == outer.trace_id == inner.trace_id
    assert ev[0]["parent_id"] == outer.span_id and ev[1]["parent_id"] is None
    assert ev[1]["cycle"] == 7 and ev[1]["duration_s"] >= ev[0]["duration_s"] >= 0
    assert set(ev[0]) == {"event", "ts", "name", "trace_id", "span_id", "parent_id", "duration_s"}


LOSSES = {
    "plain": {},
    "remat": {"remat": True},
    "flash_bf16_head": {"attn_fn": fa.flash_attention, "compute_dtype": "bfloat16",
                        "ce_grad_dtype": "bfloat16"},
}


@pytest.mark.parametrize("local_steps", [1, 2])
@pytest.mark.parametrize("loss", list(LOSSES))
def test_fused_round_records_its_spans(loss, local_steps):
    kw = LOSSES[loss]
    round_fn = make_fused_round(partial(T.loss_and_acc, cfg=CFG, **kw), local_steps=local_steps)
    params = T.init(CFG, device="cpu")
    X, y = _batch()
    want = round_fn(params, X, y, 0.1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = round_fn(params, X, y, 0.1)
    # the ranges change nothing of the round's numbers
    assert all(torch.equal(a, b) for a, b in zip(want[0], got[0]))
    assert torch.equal(want[1], got[1]) and torch.equal(want[2], got[2])

    steps = 1 if local_steps == 1 else K * local_steps  # forward-backward passes
    blocks = CFG.n_layers * steps * (2 if kw.get("remat") else 1)
    expect = {"pgt.round": 1, "pgt.round.forward": steps, "pgt.round.backward": steps,
              "pgt.round.update": 1, "pgt.model.embed": steps, "pgt.model.block": blocks}
    if "ce_grad_dtype" in kw:  # the head's ranges are _CEHead's alone
        expect["pgt.model.head.fwd"] = expect["pgt.model.head.bwd"] = steps
    if "attn_fn" in kw:
        expect["pgt.flash.fwd"] = expect["pgt.flash.bwd"] = CFG.n_layers * steps
    assert _names(prof) == expect
    assert telemetry.events() == []


def test_round_spans_nest_as_the_round_runs():
    round_fn = make_fused_round(partial(T.loss_and_acc, cfg=CFG), local_steps=2)
    X, y = _batch(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        round_fn(T.init(CFG, device="cpu"), X, y, 0.1)
    ev = [e for e in prof.events() if e.name.startswith("pgt.")]
    (rnd,) = [e.time_range for e in ev if e.name == "pgt.round"]
    (upd,) = [e.time_range for e in ev if e.name == "pgt.round.update"]
    assert all(rnd.start <= e.time_range.start and e.time_range.end <= rnd.end for e in ev)
    # each pass's backward follows its forward, and the update follows both
    def ranges(name):
        return sorted((e.time_range for e in ev if e.name == name), key=lambda r: r.start)

    fwd, bwd = ranges("pgt.round.forward"), ranges("pgt.round.backward")
    assert len(fwd) == len(bwd) == 2 * K
    assert all(f.end <= b.start for f, b in zip(fwd, bwd))
    assert bwd[-1].end <= upd.start
    blocks = [e.time_range for e in ev if e.name == "pgt.model.block"]
    assert all(any(f.start <= b.start and b.end <= f.end for f in fwd) for b in blocks)


def test_sharded_round_records_its_passes(tmp_path):
    """A one-rank gloo world in a child process: the sharded round shares
    ``_grad``'s forward and backward ranges, once a pass, and opens no
    range of its own."""
    code = textwrap.dedent(f"""
        import collections, json, sys
        import torch
        from torch.profiler import ProfilerActivity, profile
        sys.path.insert(0, {str(REPO)!r})
        from pygrid_tpu_torch.models import mlp
        from pygrid_tpu_torch.parallel import make_sharded_fused_round
        from pygrid_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
        initialize_distributed({(tmp_path / 'store').as_uri()!r}, 1, 0, device="cpu")
        mesh = make_mesh(1, device="cpu")
        g = torch.Generator().manual_seed(0)
        params = mlp.init((8, 6, 3), generator=g, device="cpu")
        X = torch.randn(4, 5, 8, generator=g)
        y = torch.nn.functional.one_hot(torch.randint(0, 3, (4, 5), generator=g), 3).float()
        out = {{}}
        for steps in (1, 2):
            round_fn = make_sharded_fused_round(mlp.loss_and_acc, mesh, local_steps=steps)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                round_fn(params, X, y, 0.1)
            out[steps] = collections.Counter(
                e.name for e in prof.events() if e.name.startswith("pgt."))
        torch.distributed.destroy_process_group()
        print(json.dumps(out))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=240, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["1"] == {"pgt.round.forward": 1, "pgt.round.backward": 1}
    assert got["2"] == {"pgt.round.forward": 8, "pgt.round.backward": 8}
