"""The port's gridstorm plumbing (pygrid_tpu_torch.storm), against the JAX
package's: the cases of ``tests/unit/test_storm.py`` on the port — scenario
specs as the replay contract, the rejected specs, seeded arrival schedules,
the SLO fault clock that turns breach transitions into
``slo_breach_detect_seconds`` samples, the block-pool ledger through
churn, ``expire`` back-dating, and flight-dump validation — and parity
across the stacks: each built-in scenario's dict and every (seed, leg)
schedule equal the reference's, and a storm dump of either package loads
in the other's ``load_dump`` with an equal scenario. The storm itself runs
in ``tests/test_torch_storm_smoke.py``."""

from __future__ import annotations

import json

import pytest

from pygrid_tpu import storm as jstorm
from pygrid_tpu.storm import replay as jreplay
from pygrid_tpu.storm.loadgen import arrival_times as j_arrival_times
from pygrid_tpu.telemetry import recorder as jrecorder
from pygrid_tpu_torch import telemetry
from pygrid_tpu_torch.network.aggregation import AggregationRegistry
from pygrid_tpu_torch.serving.pagedkv import BlockPool
from pygrid_tpu_torch.storm import replay as replay_mod
from pygrid_tpu_torch.storm.loadgen import arrival_times
from pygrid_tpu_torch.storm.scenarios import (
    CHECKS,
    FAULT_KINDS,
    TRAFFIC_LEGS,
    FaultSpec,
    StormScenario,
    TrafficSpec,
    builtin_scenarios,
    get_scenario,
)
from pygrid_tpu_torch.telemetry import recorder
from pygrid_tpu_torch.telemetry import slo as slo_mod
from pygrid_tpu_torch.telemetry.bus import TelemetryBus
from pygrid_tpu_torch.telemetry.slo import Objective, SLOEngine


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("PYGRID_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("PYGRID_FLIGHT_MIN_INTERVAL_S", "0")
    telemetry.reset()
    recorder.reset()
    slo_mod.clear_fault()
    yield
    telemetry.reset()
    recorder.reset()
    slo_mod.clear_fault()


# ── scenarios: the replay contract ──────────────────────────────────────


class TestScenarioSpec:
    def test_builtins_validate_and_round_trip(self):
        for name in builtin_scenarios():
            spec = get_scenario(name)
            clone = StormScenario.from_dict(spec.to_dict())
            assert clone.to_dict() == spec.to_dict()

    def test_dict_round_trip_is_json_safe(self):
        # the dump embeds the dict via json — no dataclass leakage
        d = get_scenario("smoke").to_dict()
        assert json.loads(json.dumps(d)) == d

    def test_yaml_round_trip(self):
        yaml = pytest.importorskip("yaml")
        spec = get_scenario("smoke")
        clone = StormScenario.from_yaml(yaml.safe_dump(spec.to_dict()))
        assert clone.to_dict() == spec.to_dict()

    def test_json_spec_parses_without_yaml(self, monkeypatch):
        """The card's machine has no PyYAML: ``from_yaml`` falls back to
        JSON (a YAML subset), as the reference's does."""
        import builtins

        real_import = builtins.__import__

        def no_yaml(name, *args, **kwargs):
            if name == "yaml":
                raise ImportError("no yaml here")
            return real_import(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", no_yaml)
        spec = get_scenario("full")
        assert StormScenario.from_yaml(json.dumps(spec.to_dict())).to_dict() == spec.to_dict()

    def test_unknown_leg_fault_check_and_field_rejected(self):
        with pytest.raises(ValueError, match="unknown traffic leg"):
            StormScenario(
                name="x", duration_s=1.0,
                traffic=[TrafficSpec(leg="carrier-pigeon", rate_hz=1.0)],
            ).validate()
        with pytest.raises(ValueError, match="unknown fault kind"):
            StormScenario(
                name="x", duration_s=1.0,
                faults=[FaultSpec(kind="meteor", at_s=0.5)],
            ).validate()
        with pytest.raises(ValueError, match="unknown check"):
            StormScenario(
                name="x", duration_s=1.0, checks=["vibes"],
            ).validate()
        with pytest.raises(ValueError, match="unknown scenario fields"):
            StormScenario.from_dict(
                {"name": "x", "duration_s": 1.0, "cadence": 3}
            )

    def test_fault_outside_clock_and_impossible_kill_rejected(self):
        with pytest.raises(ValueError, match="outside the scenario"):
            StormScenario(
                name="x", duration_s=1.0,
                faults=[FaultSpec(kind="slow_node", at_s=5.0)],
            ).validate()
        with pytest.raises(ValueError, match="needs at least one"):
            StormScenario(
                name="x", duration_s=1.0, subaggs=0,
                faults=[FaultSpec(kind="kill_subagg", at_s=0.1)],
            ).validate()

    def test_nonpositive_sizes_and_rates_rejected(self):
        with pytest.raises(ValueError, match="duration_s must be positive"):
            StormScenario(name="x", duration_s=0.0).validate()
        with pytest.raises(ValueError, match="topology sizes"):
            StormScenario(name="x", duration_s=1.0, workers=0).validate()
        with pytest.raises(ValueError, match="rate_hz must be positive"):
            StormScenario(
                name="x", duration_s=1.0,
                traffic=[TrafficSpec(leg="fl", rate_hz=0.0)],
            ).validate()
        with pytest.raises(ValueError, match="unknown scenario 'nope'"):
            get_scenario("nope")


class TestScenarioParity:
    """The scenarios are data: the port's equal the reference's."""

    @pytest.mark.parametrize("name", ("smoke", "full"))
    def test_builtin_to_dict_equals_reference(self, name):
        assert get_scenario(name).to_dict() == jstorm.get_scenario(name).to_dict()

    def test_catalogues_and_listing_equal_reference(self):
        from pygrid_tpu.storm import scenarios as jscen

        assert (FAULT_KINDS, TRAFFIC_LEGS, CHECKS) == (
            jscen.FAULT_KINDS, jscen.TRAFFIC_LEGS, jscen.CHECKS)
        assert builtin_scenarios() == jstorm.builtin_scenarios()

    @pytest.mark.parametrize("name", ("smoke", "full"))
    def test_reference_dict_parses_in_the_port_and_back(self, name):
        ref = jstorm.get_scenario(name).to_dict()
        assert StormScenario.from_dict(ref).to_dict() == ref
        assert jstorm.StormScenario.from_dict(get_scenario(name).to_dict()).to_dict() == ref


class TestArrivalSchedule:
    def test_deterministic_across_calls(self):
        a = arrival_times(7, 2, 5.0, 0.0, 30.0)
        b = arrival_times(7, 2, 5.0, 0.0, 30.0)
        assert a == b and len(a) > 0

    def test_seed_and_leg_decorrelate(self):
        assert arrival_times(7, 0, 5.0, 0.0, 30.0) != arrival_times(
            8, 0, 5.0, 0.0, 30.0
        )
        assert arrival_times(7, 0, 5.0, 0.0, 30.0) != arrival_times(
            7, 1, 5.0, 0.0, 30.0
        )

    def test_rate_and_bounds(self):
        times = arrival_times(7, 0, 10.0, 2.0, 32.0)
        assert all(2.0 < t < 32.0 for t in times)
        assert times == sorted(times)
        # 300 expected arrivals: a 3× deviation means broken seeding
        assert 100 < len(times) < 900

    @pytest.mark.parametrize("seed", (0, 7, 11, 12345))
    @pytest.mark.parametrize("leg", (0, 1, 2, 3))
    def test_schedule_equals_reference(self, seed, leg):
        args = (seed, leg, 3.0 + leg, 0.5 * leg, 24.0)
        assert arrival_times(*args) == j_arrival_times(*args)

    @pytest.mark.parametrize("name", ("smoke", "full"))
    def test_builtin_schedules_equal_reference(self, name):
        spec = get_scenario(name)
        for i, leg in enumerate(spec.traffic):
            stop = leg.stop_s if leg.stop_s is not None else spec.duration_s
            got = arrival_times(spec.seed, i, leg.rate_hz, leg.start_s, stop)
            assert got and got == j_arrival_times(spec.seed, i, leg.rate_hz, leg.start_s, stop)


# ── slo fault clock → transitions → reaction histogram ──────────────────


class TestFaultClock:
    def _engine(self, bus):
        return SLOEngine(
            [Objective("lat", "lat_seconds", threshold_s=0.01,
                       target=0.99)],
            windows=(60.0, 600.0),
            source=bus,
        )

    def test_breach_after_mark_observes_detect_latency(self):
        bus = TelemetryBus()
        eng = self._engine(bus)
        eng.evaluate(now=0.0)
        slo_mod.mark_fault("chaos", ts=5.0)
        for _ in range(50):
            bus.observe("lat_seconds", 5.0)
        eng.evaluate(now=12.0)
        flips = [t for t in eng.transitions() if t["to"] == "breach"]
        assert [t["name"] for t in flips] == ["lat"]
        snaps = {
            name: snap
            for (name, _labels), snap in bus.histograms().items()
            if name == "slo_breach_detect_seconds"
        }
        (snap,) = snaps.values()
        assert snap["count"] == 1
        # detected at now=12 against the fault marked at 5 → 7s
        assert 6.9 <= snap["sum"] <= 7.1

    def test_no_mark_no_sample(self):
        bus = TelemetryBus()
        eng = self._engine(bus)
        eng.evaluate(now=0.0)
        for _ in range(50):
            bus.observe("lat_seconds", 5.0)
        eng.evaluate(now=12.0)
        assert any(t["to"] == "breach" for t in eng.transitions())
        assert not any(
            name == "slo_breach_detect_seconds"
            for (name, _labels) in bus.histograms()
        )

    def test_staying_in_breach_samples_once(self):
        bus = TelemetryBus()
        eng = self._engine(bus)
        eng.evaluate(now=0.0)
        slo_mod.mark_fault("chaos", ts=1.0)
        for _ in range(50):
            bus.observe("lat_seconds", 5.0)
        eng.evaluate(now=12.0)
        eng.evaluate(now=13.0)  # still in breach — no new edge
        (snap,) = (
            snap for (name, _l), snap in bus.histograms().items()
            if name == "slo_breach_detect_seconds"
        )
        assert snap["count"] == 1

    def test_transitions_log_orders_and_bounds(self):
        bus = TelemetryBus()
        eng = self._engine(bus)
        eng.evaluate(now=0.0)
        for _ in range(50):
            bus.observe("lat_seconds", 5.0)
        eng.evaluate(now=12.0)
        for _ in range(500):
            bus.observe("lat_seconds", 0.001)
        eng.tick(now=3620.0)
        eng.evaluate(now=3650.0)
        log = eng.transitions()
        assert [t["ts"] for t in log] == sorted(t["ts"] for t in log)
        assert log[0]["from"] is None
        tos = [t["to"] for t in log if t["name"] == "lat"]
        assert "breach" in tos and tos[-1] != "breach"
        assert len(log) <= slo_mod.MAX_TRANSITIONS

    def test_mark_clear_and_last(self):
        assert slo_mod.last_fault_ts() is None
        slo_mod.mark_fault("a", ts=3.0)
        slo_mod.mark_fault("b", ts=9.0)
        assert slo_mod.last_fault_ts() == 9.0
        slo_mod.clear_fault("b")
        assert slo_mod.last_fault_ts() == 3.0
        slo_mod.clear_fault()
        assert slo_mod.last_fault_ts() is None


# ── leak ledgers ────────────────────────────────────────────────────────


class TestLedgers:
    def test_block_pool_ledger_balances_through_churn(self):
        pool = BlockPool(16)
        led = pool.ledger()
        # block 0 is the trash block — usable is num_blocks - 1
        assert led["free"] == led["usable"] == 15 and led["balanced"]
        blocks = pool.alloc(5)
        led = pool.ledger()
        assert led["held"] == 5 and led["free"] == 10 and led["balanced"]
        pool.release(blocks[:2])
        led = pool.ledger()
        assert led["held"] == 3 and led["free"] == 12 and led["balanced"]
        pool.retire(2)
        led = pool.ledger()
        assert led["retired"] == 2 and led["usable"] == 13
        assert led["balanced"]

    def test_expire_backdates_heartbeat(self):
        reg = AggregationRegistry(ttl_s=30.0)
        reg.register("sub-1", "ws://x", "ws://node")
        assert [e.subagg_id for e in reg.live()] == ["sub-1"]
        assert reg.expire("sub-1") is True
        assert reg.live() == []
        assert reg.expire("no-such") is False


# ── flight-dump validation (the replay gate) ────────────────────────────


def _storm_dump(rec, name: str, scenario: dict) -> str:
    """A dump shaped as a storm harness writes it (loadgen.StormHarness)."""
    return rec.dump(
        f"storm-{name}",
        snapshot={"storm": {
            "scenario": scenario,
            "verdicts": [{"name": "served_traffic", "ok": True, "detail": "",
                          "measured": {}}],
            "metrics": {"ops": {}},
        }},
        force=True,
    )


class TestReplayValidation:
    def test_dump_round_trips_schema_version(self):
        path = recorder.dump("unit-roundtrip", force=True)
        payload = json.loads(open(path, encoding="utf-8").read())
        assert payload["schema_version"] == recorder.SCHEMA_VERSION
        # the version key leads the record so forensics can gate on it
        # before parsing the rest
        first = open(path, encoding="utf-8").read(40)
        assert '"schema_version"' in first

    def test_load_dump_rejects_wrong_schema(self, tmp_path):
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"schema_version": 99}))
        with pytest.raises(replay_mod.ReplayError, match="schema_version"):
            replay_mod.load_dump(str(bad))

    def test_load_dump_rejects_non_storm_record(self):
        path = recorder.dump("unit-nonstorm", force=True)
        with pytest.raises(replay_mod.ReplayError, match="no storm"):
            replay_mod.load_dump(path)

    def test_schema_version_equals_reference(self):
        assert recorder.SCHEMA_VERSION == jrecorder.SCHEMA_VERSION == 1

    @pytest.mark.parametrize("name", ("smoke", "full"))
    def test_dumps_load_across_the_stacks(self, name):
        """A storm record the port's recorder writes loads in the
        reference's ``load_dump`` and the other way round, each with the
        scenario dict it carried, equal in both stacks."""
        scenario = get_scenario(name).to_dict()
        port_path = _storm_dump(recorder, name, scenario)
        jrecorder.reset()
        ref_path = _storm_dump(jrecorder, name, jstorm.get_scenario(name).to_dict())
        for path in (port_path, ref_path):
            port_side = replay_mod.load_dump(path)
            ref_side = jreplay.load_dump(path)
            assert port_side == ref_side
            assert port_side["scenario"] == scenario
            assert StormScenario.from_dict(port_side["scenario"]).to_dict() == scenario


# ── the entry points' device ────────────────────────────────────────────


def test_harness_and_cli_refuse_the_card_without_one(capsys):
    """``StormHarness`` and the CLI default to ``cuda`` and raise on a
    host without a GPU before they build anything; ``--list`` needs no
    device."""
    import torch

    from pygrid_tpu_torch.storm.__main__ import main
    from pygrid_tpu_torch.storm.loadgen import StormHarness

    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "smoke" in out and "full" in out
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        StormHarness(get_scenario("smoke"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(["--scenario", "smoke"])
    assert StormHarness(get_scenario("smoke"), device="cpu").device == torch.device("cpu")
