"""The port stands alone: pygrid_tpu_torch imports neither ``jax`` nor
anything of ``pygrid_tpu``, and its entry points never move to the CPU
unless asked."""

import ast
import os
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import pygrid_tpu_torch
from pygrid_tpu_torch import convert
from pygrid_tpu_torch.models import mlp, transformer

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "pygrid_tpu_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules() -> list[str]:
    return [pygrid_tpu_torch.__name__] + [
        m.name
        for m in pkgutil.walk_packages(
            pygrid_tpu_torch.__path__, prefix="pygrid_tpu_torch."
        )
    ]


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "pygrid_tpu")


_BLOCKED_IMPORT = textwrap.dedent(
    f"""
    import importlib, importlib.abc, sys
    sys.path.insert(0, {str(ROOT)!r})

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "pygrid_tpu"):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    for mod in {_modules()!r} + ["chip_smoke"]:
        importlib.import_module(mod)
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "pygrid_tpu")]
    assert not leaked, leaked
    print("ok", len({_modules()!r}))
    """
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The module's fresh interpreters, all started at once (each spends
    its time importing torch): the import check with ``jax`` and the exact
    top-level name ``pygrid_tpu`` blocked, and chip_smoke.py run from the
    repo and from a directory holding nothing else of it. Each test waits
    on its own."""
    lone_dir = tmp_path_factory.mktemp("lone")
    lone = lone_dir / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cmds = {"blocked_import": ([sys.executable, "-c", _BLOCKED_IMPORT], ROOT)}
    if not torch.cuda.is_available():  # with a GPU the smoke would run in full
        cmds["smoke_in_repo"] = ([sys.executable, str(ROOT / "chip_smoke.py")], ROOT)
        cmds["smoke_alone"] = ([sys.executable, str(lone)], lone_dir)
    procs = {
        name: subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
        for name, (cmd, cwd) in cmds.items()
    }
    yield procs
    for proc in procs.values():
        proc.kill()
        proc.communicate()


def _wait(proc):
    stdout, stderr = proc.communicate(timeout=120)
    return proc.returncode, stdout, stderr


def test_every_module_imports_with_jax_and_pygrid_tpu_blocked(runs):
    """A fresh interpreter with a meta-path hook refusing ``jax`` and the
    exact top-level name ``pygrid_tpu`` (not ``pygrid_tpu_torch``) imports
    every module of the port, and chip_smoke.py."""
    rc, stdout, stderr = _wait(runs["blocked_import"])
    assert rc == 0, stderr
    assert stdout.startswith("ok")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_pygrid_tpu_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _banned(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_entry_points_without_device_cpu_raise_on_a_gpu_less_host():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = transformer.TransformerConfig(vocab=8, d_model=8, n_heads=2, n_layers=1,
                                        d_ff=8, max_len=4)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        transformer.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mlp.init((4, 2))
    arrays = [p.numpy() for p in mlp.init((4, 2), device="cpu")]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        convert.params_from_numpy(arrays, mlp_sizes=(4, 2))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pygrid_tpu_torch.resolve("cuda:0")
    assert pygrid_tpu_torch.resolve("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_a_gpu_and_outside_the_repo(runs):
    """chip_smoke.py exits non-zero and prints no result line where there
    is no GPU, and in a directory holding nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for name in ("smoke_in_repo", "smoke_alone"):
        rc, stdout, _ = _wait(runs[name])
        assert rc != 0, name
        assert '"ok"' not in stdout, name
