"""The port's gridstorm end to end on the CPU (``device="cpu"``), as the
JAX package's ``tests/integration/test_storm_smoke.py`` runs its own:
one real port node + network + sub-aggregator topology takes mixed FL,
generation, and data-centric open-loop traffic while three faults land
mid-run (subagg killed mid-cycle, KV block-pool exhaustion, admission
saturation). Every reaction verdict must pass, the run's flight dump must
carry the versioned storm record (loadable by the reference's
``load_dump`` too, with an equal scenario), and replaying that dump must
reproduce the identical verdict set. The full 64-worker acceptance storm
runs as the ``slow``-marked test below."""

from __future__ import annotations

import json

import pytest

from pygrid_tpu.storm.replay import load_dump as reference_load_dump
from pygrid_tpu_torch.storm.loadgen import StormHarness
from pygrid_tpu_torch.storm.replay import load_dump, replay
from pygrid_tpu_torch.storm.scenarios import get_scenario
from pygrid_tpu_torch.telemetry.recorder import SCHEMA_VERSION
from test_torch_network import restore_process_state  # noqa: F401 (an autouse fixture)


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PYGRID_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("PYGRID_FLIGHT_MIN_INTERVAL_S", "0")


def test_storm_smoke_verdicts_and_replay():
    spec = get_scenario("smoke")
    report = StormHarness(spec, device="cpu").run()

    by_name = {v.name: v for v in report.verdicts}
    assert set(by_name) == set(spec.checks)
    failed = [(v.name, v.detail) for v in report.verdicts if not v.ok]
    assert report.ok and not failed, failed

    # reaction evidence, not mere survival: the breach was measured
    # against the injection instant and placement actually re-routed
    assert by_name["breach_detected"].measured["histogram_count"] >= 1
    assert by_name["breach_detected"].measured["detect_s"] <= 5.0
    assert by_name["routes_around_subagg"].measured["react_s"] <= 3.0
    # the leak ledgers the verdict rode on are the public snapshot API
    for ledger in by_name["leak_free"].measured["ledgers"]:
        assert ledger["balanced"], ledger

    # the dump is the versioned replay contract, in both stacks
    assert report.dump_path
    with open(report.dump_path, encoding="utf-8") as fh:
        payload = json.load(fh)
    assert payload["schema_version"] == SCHEMA_VERSION
    storm = load_dump(report.dump_path)
    assert storm["scenario"] == spec.to_dict()
    assert reference_load_dump(report.dump_path)["scenario"] == spec.to_dict()

    # replay: same seed → same schedules → same verdict set
    replayed_report, mismatches = replay(report.dump_path, device="cpu")
    assert not mismatches, mismatches
    assert replayed_report.ok


@pytest.mark.slow
def test_storm_full_acceptance():
    """The acceptance storm: 64 workers, 2 nodes, 2 subaggs, all four
    traffic legs, six fault kinds — degraded routing and poison
    rejection included."""
    report = StormHarness(get_scenario("full"), device="cpu").run()
    failed = [(v.name, v.detail) for v in report.verdicts if not v.ok]
    assert report.ok and not failed, failed
