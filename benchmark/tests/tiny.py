"""A throwaway checkout for the harness's CPU tests: a copy of this folder's
code beside a BENCHMARK.json of tiny cells, each a new config, traffic,
workload and metric file, so that adding a cell is shown to need only new
files."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent

TINY_GPT = {"name": "tiny-gpt", "source": "test", "family": "transformer",
            "initializer_range": 0.02,
            "port": {"vocab": 64, "d_model": 32, "n_heads": 2, "n_layers": 2, "d_ff": 64,
                     "max_len": 16, "ln_eps": 1e-6}}
TINY_MLP = {"name": "tiny-mlp", "source": "test", "family": "mlp", "sizes": [12, 8, 4],
            "activation": "relu", "fixed_point": {"base": 10, "precision_fractional": 3}}
CELLS = {
    "tiny-gpt-fedavg": ("tiny-gpt", "tiny-tokens", 1,
                        {"kind": "tokens", "clients": 4, "batch": 2, "seq_len": 16},
                        {"entry": "fedavg_round", "local_steps": 1, "lr": 0.1,
                         "compute_dtype": "bfloat16", "ce_grad_dtype": "bfloat16",
                         "trace_units": 2,
                         "limits": {"loss_gap": 0.001, "grad_gap": 0.006, "change_gap": 0.006}}),
    "tiny-mlp-fedavg": ("tiny-mlp", "tiny-features", 1,
                        {"kind": "features", "clients": 6, "batch": 5, "x": "normal",
                         "labels": "onehot"},
                        {"entry": "fedavg_round", "local_steps": 3, "lr": 0.1,
                         "compute_dtype": None, "trace_units": 1,
                         "limits": {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4}}),
    "tiny-mlp-predict": ("pysyft-mnist-mlp", "tiny-requests", 1,
                         {"kind": "features", "batch": 4, "x": "uniform01"},
                         {"entry": "encrypted_predict",
                          "plan": "pygrid_tpu_torch/plans/fixtures/cryptonets_plan.bin",
                          "holders": ["alice", "bob", "charlie"], "dealer": "dan",
                          "bias_range": 0.1, "warmup": 1, "trace_units": 2,
                          "limits": {"pred_err": 0.05}}),
    "tiny-gpt-mesh": ("tiny-gpt", "tiny-tokens-4", 4,
                      {"kind": "tokens", "clients": 8, "batch": 1, "seq_len": 16},
                      {"entry": "fedavg_round_mesh", "local_steps": 1, "lr": 0.1,
                       "compute_dtype": "bfloat16", "ce_grad_dtype": "bfloat16",
                       "trace_units": 2,
                       "limits": {"loss_gap": 0.001, "grad_gap": 0.006, "change_gap": 0.006}}),
}
E2E = {"train_tokens_per_s": ["tiny-gpt-fedavg", "tiny-gpt-mesh"],
       "round_ms": ["tiny-mlp-fedavg"], "predict_ms_p95": ["tiny-mlp-predict"]}
E2E_METRICS = [("train_tokens_per_s", "tokens/s", "higher"), ("round_ms", "ms", "lower"),
               ("predict_ms_p95", "ms", "lower")]
TINY_METRIC = '''"""A throwaway metric: device ops in the traced window."""

LAYER = "device"
UNIT = "ops"
MOVES = "setup_s"


def read(ctx):
    t = ctx["trace"]
    return len(t.device_ops) if t is not None and t.device_ops else None
'''


def make_tree(dest: Path, cells=tuple(CELLS)) -> Path:
    """``dest`` as a checkout: the benchmark's code, the port by a link,
    and ``cells`` as new files. Returns ``dest``."""
    bench = dest / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dest / "pygrid_tpu_torch").symlink_to(REPO / "pygrid_tpu_torch")
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    configs = {"tiny-gpt": TINY_GPT, "tiny-mlp": TINY_MLP}
    for name, cfg in configs.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (bench / "metrics" / "tiny_ops.py").write_text(TINY_METRIC)
    workloads = []
    for cell in cells:
        config, traffic, chips, mix, spec = CELLS[cell]
        (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
        (bench / "workloads" / f"{cell}.json").write_text(json.dumps(spec))
        workloads.append({"name": cell, "config": config, "traffic": traffic, "chips": chips,
                          "why": "a CPU test"})
    doc = {
        "command": real["command"], "paths": real["paths"], "run_seconds": 1,
        "configs": real["configs"] + [
            {"name": n, "source": "test", "file": f"benchmark/configs/{n}.json", "reduced": [],
             "why": "a CPU test"} for n in [*configs, "pysyft-mnist-mlp"]
            if n not in {c["name"] for c in real["configs"]}],
        "workloads": workloads,
        "end_to_end": [
            {"name": name, "unit": unit, "better": better, "bound": 0.25, "source": "host_clock",
             "workloads": [c for c in E2E[name] if c in cells]}
            for name, unit, better in E2E_METRICS if set(E2E[name]) & set(cells)]
        + [m for m in real["end_to_end"] if m["name"] == "setup_s"],
        "per_layer": [{"name": "tiny_ops", "unit": "ops", "better": "lower",
                       "source": "device_trace", "layer": "device", "moves": "setup_s"}],
    }
    (dest / "BENCHMARK.json").write_text(json.dumps(doc))
    return dest
