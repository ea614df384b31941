"""BENCHMARK.json against the contract, and every file found by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness as H

REPO = Path(__file__).resolve().parents[2]
DOC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert DOC["paths"] == ["benchmark"] and DOC["command"][1] == "benchmark/run.py"
    assert 1 <= DOC["run_seconds"] <= 51 and isinstance(DOC["run_seconds"], int)
    cells = len(DOC["workloads"])
    assert (2 + 14 * 24) * (DOC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in DOC["workloads"]) <= max(1, cells // 4)


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(group):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[group]
    names = [e["name"] for e in DOC[group]]
    assert len(names) == len(set(names))
    for e in DOC[group]:
        assert NAME.match(e["name"]), e["name"]
        assert set(e) - {"workloads"} == keys, e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_end_to_end_rules():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in DOC["workloads"]:
        mine = [m for m in DOC["end_to_end"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert len(mine) >= 2, w["name"]
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in DOC["per_layer"])
    for m in DOC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_every_cell_finds_its_files():
    for w in DOC["workloads"]:
        cell = H.load_cell(REPO, w["name"])
        assert cell.chips == w["chips"]
        assert H.load_entry(REPO, cell.spec["entry"]).run
        for m in cell.per_layer:
            mod = cell.readers[m["name"]]
            assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"], m["moves"])


def test_config_files_hold_what_is_run():
    for c in DOC["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg and key in cfg.get("published", {}), key


def test_a_cell_naming_a_missing_metric_is_an_error(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "benchmark" / "metrics" / "mfu.gpt2.py").unlink()
    with pytest.raises(H.BenchError, match="mfu.gpt2"):
        H.load_cell(tmp_path, "gpt2s-fedavg-k8")
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["per_layer"] = [m for m in doc["per_layer"] if m["name"] != "mfu.gpt2"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    H.load_cell(tmp_path, "gpt2s-fedavg-k8")  # once no metric names the file


def test_an_unknown_workload_is_an_error():
    with pytest.raises(H.BenchError):
        H.load_cell(REPO, "no-such-cell")


def test_a_throwaway_cell_is_new_files_only(tiny_tree):
    """The tiny tree adds configs, traffic, workloads and a metric as new
    files beside an unchanged copy of the harness."""
    ours = {p.relative_to(REPO / "benchmark"): p.read_bytes()
            for p in (REPO / "benchmark").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts and "tests" not in p.parts}
    for rel, data in ours.items():
        assert (tiny_tree / "benchmark" / rel).read_bytes() == data, rel
    cell = H.load_cell(tiny_tree, "tiny-gpt-fedavg")
    assert cell.config["name"] == "tiny-gpt" and "tiny_ops" in cell.readers
