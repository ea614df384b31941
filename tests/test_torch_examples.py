"""The port's examples (``examples_torch/``) run to their end on the CPU.

Each script runs in its own interpreter at ``--device cpu`` (with
``--spawn`` where ``tests/integration/test_examples.py`` passes it to the
JAX twin), under a meta-path hook that refuses ``jax``, ``pygrid_tpu``,
``requests`` and what else the card's machine lacks — installed through a
``sitecustomize`` so that the subprocesses an example starts carry it
too — and must print its JAX twin's success line.

Three are run beside their JAX twin instead, and held against its printed
numbers:

- ``smpc_demo.py``: each op's max error against numpy within 2e-3 of the
  twin's (two steps of the fixed-point scale, 1e-3), and the reconstructed
  ``x @ y`` within 1e-2 of numpy's;
- ``encrypted_inference.py``: the decoded prediction within 3e-3 of the
  twin's (three fixed-point steps: each stack draws its own shares and
  truncation masks);
- ``data_centric/02_train_model.py``: ``max |w - w*|`` within 5e-4 (it is
  printed to 4 decimals) and every epoch's mse within 2e-5 (5 decimals).
"""

from __future__ import annotations

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_isolation import EXAMPLES_BANNED, meta_path_block

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "examples_torch"
JAX = ROOT / "examples"

#: script, its arguments, and the success line's text (the JAX test's)
CASES = [
    ("smpc_demo.py", (), "Beaver"),
    ("model_centric/01_create_plan.py", ("--spawn",), "hosted mnist/1.0"),
    ("model_centric/02_execute_plan.py", ("--spawn",), "latest checkpoint"),
    ("data_centric/01_populate_node.py", ("--spawn",), "8 pointers"),
    ("full_fl_demo.py", ("--spawn", "--workers", "2", "--cycles", "2"), "latest checkpoint"),
    ("data_centric/02_train_model.py", ("--spawn",), "max |w - w*|"),
    ("encrypted_inference.py", ("--spawn",), "encrypted inference OK"),
    ("advanced_fl.py", ("--spawn",), "advanced FL OK"),
    ("secagg_fl.py", ("--spawn",), "secure aggregation OK"),
    ("async_fl.py", ("--spawn",), "async FL OK"),
    ("fed_transformer.py", (), "federated transformer"),
]


@pytest.fixture(scope="module")
def blocked_site(tmp_path_factory) -> Path:
    """A directory holding a ``sitecustomize`` that installs the hook."""
    site = tmp_path_factory.mktemp("blocked_site")
    (site / "sitecustomize.py").write_text(meta_path_block(EXAMPLES_BANNED))
    return site


def _run_port(script: str, args, site: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(site), str(ROOT)])
    # small shapes: more threads only contend with the other test workers
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, str(PORT / script), *args, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )


def _run_jax(script: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env.update(PYGRID_TPU_FORCE_CPU="1", JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, str(JAX / script), *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )


def _ok(result: subprocess.CompletedProcess, line: str, who: str) -> str:
    assert result.returncode == 0, f"{who}:\n{result.stdout[-3000:]}\n{result.stderr[-3000:]}"
    assert line in result.stdout, f"{who}: no {line!r} in\n{result.stdout[-3000:]}"
    return result.stdout


#: run beside their JAX twins below, success line included
COMPARED = ("smpc_demo.py", "encrypted_inference.py", "data_centric/02_train_model.py")
ALONE = [c for c in CASES if c[0] not in COMPARED]


@pytest.mark.parametrize("script, args, line", ALONE, ids=[c[0] for c in ALONE])
def test_example_runs_on_cpu_without_jax_or_requests(script, args, line, blocked_site):
    if script == "model_centric/02_execute_plan.py":
        # it trains against a process hosted by 01: host it first on a
        # node the test spawns, as full_fl_demo.py does
        _execute_after_hosting(blocked_site)
        return
    _ok(_run_port(script, args, blocked_site), line, script)


def _execute_after_hosting(site: Path) -> None:
    from pygrid_tpu_torch.node import create_app
    from pygrid_tpu_torch.web import BackgroundServer

    server = BackgroundServer(create_app("alice", device="cpu")).start()
    try:
        node = ("--node", server.url)
        _ok(_run_port("model_centric/01_create_plan.py", node, site), "hosted mnist/1.0",
            "01_create_plan.py --node")
        out = _ok(_run_port("model_centric/02_execute_plan.py", node, site),
                  "latest checkpoint", "02_execute_plan.py")
        # the example's own test: some report was accepted (a worker that
        # asks while the last cycle still aggregates may be turned away)
        assert "accepted=1" in out, out
    finally:
        server.stop()


def _floats(text: str) -> np.ndarray:
    return np.array([float(x) for x in re.findall(r"-?\d+\.\d*(?:e[-+]?\d+)?", text)])


def test_smpc_demo_matches_its_jax_twin(blocked_site):
    port = _ok(_run_port("smpc_demo.py", (), blocked_site), "Beaver", "port")
    jax = _ok(_run_jax("smpc_demo.py"), "Beaver", "jax")
    errs = {}
    for who, out in (("port", port), ("jax", jax)):
        errs[who] = {m.group(1): float(m.group(2))
                     for m in re.finditer(r"^\s*(.+?): max err (\S+)$", out, re.M)}
    assert set(errs["port"]) == set(errs["jax"]) and len(errs["port"]) == 4
    for op, err in errs["port"].items():
        assert err < 1e-2 and abs(err - errs["jax"][op]) <= 2e-3, (op, err, errs["jax"][op])
    product = re.search(r"reconstructed x @ y: \[(.*)\]", port).group(1)
    x = np.array([[0.1, 0.2], [0.3, 0.4]])
    y = np.array([[2.0, 0.5], [1.0, -1.0]])
    np.testing.assert_allclose(_floats(product), (x @ y).ravel(), atol=1e-2)


def _prediction(out: str) -> np.ndarray:
    block = out.split("encrypted prediction:")[1].split("plaintext forward:")[0]
    return _floats(block)


def test_encrypted_inference_matches_its_jax_twin(blocked_site):
    port = _ok(_run_port("encrypted_inference.py", ("--spawn",), blocked_site),
               "encrypted inference OK", "port")
    jax = _ok(_run_jax("encrypted_inference.py", "--spawn"), "encrypted inference OK", "jax")
    got, want = _prediction(port), _prediction(jax)
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got, want, atol=3e-3)


def test_data_centric_training_matches_its_jax_twin(blocked_site):
    script = "data_centric/02_train_model.py"
    port = _ok(_run_port(script, ("--spawn",), blocked_site), "max |w - w*|", "port")
    jax = _ok(_run_jax(script, "--spawn"), "max |w - w*|", "jax")

    def read(out):
        mse = [float(v) for v in re.findall(r"^epoch \d+: mse=(\S+)$", out, re.M)]
        w = float(re.search(r"max \|w - w\*\| = (\S+)", out).group(1))
        return np.array(mse), w

    (port_mse, port_w), (jax_mse, jax_w) = read(port), read(jax)
    assert port_mse.shape == jax_mse.shape == (20,)
    np.testing.assert_allclose(port_mse, jax_mse, atol=2e-5)
    assert abs(port_w - jax_w) <= 5e-4 and port_w < 0.5


def _load(script: str):
    spec = importlib.util.spec_from_file_location(
        "example_" + script.replace("/", "_").removesuffix(".py"), PORT / script)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("script", [c[0] for c in CASES])
def test_example_at_device_cuda_raises_without_a_gpu(script):
    """``--device cuda`` (the default) on a host without a GPU raises the
    typed error before any server starts: no fallback hides the device."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from pygrid_tpu_torch.utils.exceptions import DeviceUnavailableError

    main = _load(script).main
    with pytest.raises(DeviceUnavailableError):
        main(["--spawn"] if script != "smpc_demo.py" and script != "fed_transformer.py" else [])
