"""Each entry at a tiny size on the CPU, through the whole command, agrees
with its reference; the controls and the faults a cell can have come out
not correct."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SEED = 3_000_000_019  # over 32 signed bits


def run_cell(tree, cell, seconds=0.5, trace=0, patch=None, tmp=None):
    """(exit code, the result object or None, stderr) of one run on the CPU;
    ``patch`` is the source of a sitecustomize that breaks the program."""
    env = dict(os.environ)
    if patch is not None:
        (tmp / "sitecustomize.py").write_text(patch)
        env["PYTHONPATH"] = os.pathsep.join([str(tmp), str(REPO)])
    r = subprocess.run([sys.executable, str(tree / "benchmark" / "run.py"), "--workload", cell,
                        "--seed", str(SEED), "--seconds", str(seconds), "--trace", str(trace),
                        "--device", "cpu"], capture_output=True, text=True, env=env, timeout=600)
    last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    result = json.loads(last) if last.startswith("{") else None
    return r.returncode, result, r.stderr


@pytest.mark.parametrize("cell", ["tiny-gpt-fedavg", "tiny-mlp-fedavg", "tiny-mlp-predict"])
def test_entry_agrees_with_its_reference(tiny_tree, cell):
    rc, res, err = run_cell(tiny_tree, cell)
    assert rc == 0 and res is not None, err[-3000:]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1, err[-2000:]
    assert list(res)[-1] == "checks" and res["checks"]
    assert err.strip().splitlines()[-1].startswith("check attempted")
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2


def test_traced_run_reports_window_and_breakdown(tiny_tree):
    rc, res, err = run_cell(tiny_tree, "tiny-gpt-fedavg", trace=1)
    assert rc == 0 and res["correct"] is True, err[-3000:]
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device ops: the throwaway metric finds nothing, and is left out
    assert res["metrics"] == {}


def test_no_device_means_no_result(tiny_tree):
    r = subprocess.run([sys.executable, str(tiny_tree / "benchmark" / "run.py"), "--workload",
                        "tiny-gpt-fedavg", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    if r.returncode == 0:
        pytest.skip("this machine has a CUDA device")
    assert not r.stdout.strip().startswith("{") and "CUDA" in r.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "gpt2s-fedavg-k8",
                        "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert r.returncode != 0 and not r.stdout.strip()


ROUND_FAULT = '''
import torch
import pygrid_tpu_torch.parallel as P
_real = P.make_fused_round

def _broken(loss_fn, local_steps=1, carry_dtype=None):
    rnd = _real(loss_fn, local_steps=local_steps, carry_dtype=carry_dtype)
    def round_fn(params, X, y, lr):
{body}
    return round_fn

P.make_fused_round = _broken
'''
FAULTS = {
    # a step that returns its state unchanged
    "unchanged": "        _, loss, acc = rnd(params, X, y, lr)\n        return list(params), loss, acc",
    # half of the batch left out, the mean taken over the rest
    "half": "        return rnd(params, X[: X.shape[0] // 2], y[: y.shape[0] // 2], lr)",
    # an answer altered where it is produced: one leaf moved twice as far
    "altered": ("        new, loss, acc = rnd(params, X, y, lr)\n"
                "        new = list(new)\n"
                "        new[-2] = 2 * new[-2] - params[-2]\n"
                "        return new, loss, acc"),
}


@pytest.mark.parametrize("cell", ["tiny-gpt-fedavg", "tiny-mlp-fedavg"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_training_faults_are_not_correct(tiny_tree, tmp_path, cell, fault):
    patch = ROUND_FAULT.format(body=FAULTS[fault])
    rc, res, err = run_cell(tiny_tree, cell, patch=patch, tmp=tmp_path)
    assert rc == 0 and res is not None, err[-3000:]
    assert res["correct"] is False, res["checks"]


PREDICT_FAULTS = {
    "altered": "out = out.copy(); out[0, 0] += 0.5; return out",
    "half": "return out[: out.shape[0] // 2]",
}


@pytest.mark.parametrize("fault", sorted(PREDICT_FAULTS))
def test_prediction_faults_are_not_correct(tiny_tree, tmp_path, fault):
    patch = ("import pygrid_tpu_torch.smpc.encrypted_model as M\n"
             "_real = M.EncryptedModel.predict\n"
             "def _broken(self, x, generator=None):\n"
             "    out = _real(self, x, generator=generator)\n"
             f"    {PREDICT_FAULTS[fault]}\n"
             "M.EncryptedModel.predict = _broken\n")
    rc, res, err = run_cell(tiny_tree, "tiny-mlp-predict", patch=patch, tmp=tmp_path)
    assert rc == 0 and res is not None, err[-3000:]
    assert res["correct"] is False, res["checks"]


def test_mesh_cell_agrees_and_fails_without_the_exchange(tiny_tree, tmp_path):
    rc, res, err = run_cell(tiny_tree, "tiny-gpt-mesh", seconds=0.2)
    assert rc == 0 and res["correct"] is True and res["device"]["count"] == 4, err[-3000:]
    patch = ("import pygrid_tpu_torch.parallel.collectives as C\n"
             "C.pmean_many = lambda xs, mesh, axis: [x.detach() for x in xs]\n")
    rc, res, err = run_cell(tiny_tree, "tiny-gpt-mesh", seconds=0.2, patch=patch, tmp=tmp_path)
    assert rc == 0 and res["correct"] is False, err[-3000:]


def test_a_failing_rank_stops_every_rank(tiny_tree, tmp_path):
    patch = ("import os, sys\n"
             "if '--rank' in sys.argv and sys.argv[sys.argv.index('--rank') + 1] == '2':\n"
             "    os._exit(7)\n")
    rc, res, err = run_cell(tiny_tree, "tiny-gpt-mesh", seconds=0.2, patch=patch, tmp=tmp_path)
    assert rc != 0 and res is None and "a rank failed" in err


@pytest.mark.parametrize("family,constant,cell", [
    ("transformer", "REFERENCE_BLOCK_ROWS", "tiny-gpt-fedavg"),
    ("mlp", "REFERENCE_BLOCK_CLIENTS", "tiny-mlp-fedavg")])
def test_reference_in_blocks_agrees_with_one_block(monkeypatch, family, constant, cell):
    """The reference takes a cell's clients or rows in blocks so that it fits
    on one card; the blocks change nothing but the order of the sums."""
    import importlib

    import torch

    from benchmark import traffic
    from benchmark.tests.tiny import CELLS, TINY_GPT, TINY_MLP

    fam = importlib.import_module(f"benchmark.families.{family}")
    name, _, _, mix, spec = CELLS[cell]
    config = {"tiny-gpt": TINY_GPT, "tiny-mlp": TINY_MLP}[name]
    params0 = fam.init(config, SEED, "cpu")
    batches = [traffic.batch(mix, config, SEED, i, "cpu") for i in range(3)]
    runs = []
    for block in (10**6, 3):
        monkeypatch.setattr(fam, constant, block)
        runs.append(fam.reference_rounds(config, spec, params0, batches, "f32"))
    (whole, whole_losses), (blocked, blocked_losses) = runs
    assert whole_losses == pytest.approx(blocked_losses, rel=1e-6)
    for a, b in zip(whole[-1], blocked[-1]):
        torch.testing.assert_close(a, b)


def calibrate(tree, cell, sides):
    r = subprocess.run([sys.executable, str(tree / "benchmark" / "calibrate.py"), "--workload", cell,
                        "--seeds", "5", "--sides", sides, "--device", "cpu", "--seconds", "0.3"],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return {d["side"]: d for d in map(json.loads, r.stdout.strip().splitlines())}


def _fails(reading, limits):
    return any(reading[k] > v for k, v in limits.items())


def test_controls_fail_where_the_program_passes(tiny_tree):
    """The lower-precision controls, at the tiny cells' limits: fp8 products
    for the bf16 transformer, one fractional digit fewer for the encrypted
    MLP. (TF32 exists only on the card: the MLP's control is read there.)"""
    from benchmark.tests.tiny import CELLS

    for cell in ("tiny-gpt-fedavg", "tiny-mlp-predict"):
        limits = CELLS[cell][4]["limits"]
        got = calibrate(tiny_tree, cell, "program,control")
        assert not _fails(got["program"], limits), got
        assert _fails(got["control"], limits), got


@pytest.mark.parametrize("cell", ["tiny-gpt-fedavg", "tiny-mlp-fedavg"])
def test_a_frozen_vector_leaf_fails_where_the_program_passes(tiny_tree, cell):
    """The program with the one-dimensional leaf of the smallest reference
    gradient left unmoved: scored against the median leaf's norm, it still
    fails a limit."""
    from benchmark.tests.tiny import CELLS

    limits = CELLS[cell][4]["limits"]
    got = calibrate(tiny_tree, cell, "program,freeze")
    assert not _fails(got["program"], limits), got
    assert _fails(got["freeze"], limits), got
    assert got["freeze"]["grad_gap"] == pytest.approx(got["freeze"]["frozen_ratio"])
