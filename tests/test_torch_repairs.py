"""The port's repaired faults, each held by a test of its own.

- The serving programs take their host inputs without waiting for the
  stream: a private copy of each input, pinned and copied with
  ``non_blocking=True`` on a CUDA device (``serving/programs.py``).
- The prefill programs write a slot's position with a device fill, and an
  out-of-range slot is dropped as ``.at[slot].set`` drops it
  (``models/decode.py``).
- ``fold_in`` and ``uniform`` make no host-to-device copy of their
  scalars, and stay bit for bit ``jax.random``'s (``utils/prng.py``).
- GL102 finds none of these copies in the three files any more.
- ``device.resolve`` raises a typed error that older callers still catch
  as ``RuntimeError``.
- An installed copy of the port carries every non-Python file the package
  opens, the linter's baseline among them.
"""

from __future__ import annotations

import fnmatch
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygrid_tpu_torch import device as pdevice
from pygrid_tpu_torch.models import decode
from pygrid_tpu_torch.serving.programs import ProgramSet
from pygrid_tpu_torch.utils import prng
from pygrid_tpu_torch.utils.exceptions import DeviceUnavailableError, PyGridError

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "pygrid_tpu_torch"


# ── serving programs: staged host inputs ────────────────────────────────


def _programs() -> ProgramSet:
    return ProgramSet(decode.TransformerConfig(), device="cpu")


@pytest.mark.parametrize(
    "stage, dtype, torch_dtype",
    [("_ints", np.int64, torch.int64), ("_floats", np.float32, torch.float32)],
)
def test_staged_input_is_a_private_copy(stage, dtype, torch_dtype):
    """The engine reuses its numpy arrays once a call returns; the tensor a
    program reads must not change with them."""
    host = np.arange(6, dtype=dtype)
    got = getattr(_programs(), stage)(host)
    host[:] = -7
    assert got.dtype == torch_dtype
    assert np.array_equal(got.numpy(), np.arange(6, dtype=dtype))


def test_staged_active_mask_is_a_private_bool_copy():
    host = np.array([True, False, True])
    got = _programs()._stage(host, np.bool_)
    host[:] = False
    assert got.dtype == torch.bool and got.tolist() == [True, False, True]


def test_staged_input_on_cuda_is_pinned_and_non_blocking(monkeypatch):
    """On a CUDA device the copy is taken into pinned memory and crosses
    with ``non_blocking=True``: no blocking copy waits for the stream."""
    ps = _programs()
    ps.device = torch.device("cuda", 0)
    calls = []

    def pin_memory(self):
        calls.append(("pin_memory",))
        return self

    def to(self, *args, **kwargs):
        calls.append(("to", args, kwargs))
        return self

    monkeypatch.setattr(torch.Tensor, "pin_memory", pin_memory)
    monkeypatch.setattr(torch.Tensor, "to", to)
    host = np.array([3, 1, 4], dtype=np.int32)
    got = ps._ints(host)
    assert calls == [("pin_memory",), ("to", (torch.device("cuda", 0),), {"non_blocking": True})]
    assert got.dtype == torch.int64 and got.tolist() == [3, 1, 4]


# ── prefill programs: the slot's position ───────────────────────────────


@pytest.mark.parametrize("slot", [-5, -4, -1, 0, 2, 3, 4, 9])
def test_set_pos_matches_at_set_and_drops_out_of_range(slot):
    pos = torch.tensor([5, 6, 7, 8])
    decode._set_pos(pos, slot, 42)
    want = jnp.asarray([5, 6, 7, 8]).at[slot].set(42, mode="drop")
    assert pos.tolist() == np.asarray(want).tolist()


def test_set_pos_writes_no_indexed_assignment(monkeypatch):
    """``pos[slot] = int(length)`` copies a host scalar into the device
    tensor with a blocking copy; the fill does not index-assign at all."""
    def refuse(self, key, value):
        raise AssertionError("pos written by an indexed assignment")

    pos = torch.zeros(3, dtype=torch.int64)
    monkeypatch.setattr(torch.Tensor, "__setitem__", refuse)
    decode._set_pos(pos, 1, 9)
    assert pos.tolist() == [0, 9, 0]


# ── PRNG scalars ────────────────────────────────────────────────────────


def _no_host_copies(monkeypatch):
    """``torch.tensor``/``torch.as_tensor`` refuse to place on a device."""
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def guarded(*args, _real=real, _name=name, **kwargs):
            if kwargs.get("device") is not None:
                raise AssertionError(f"torch.{_name}(..., device=) in a PRNG draw")
            return _real(*args, **kwargs)

        monkeypatch.setattr(torch, name, guarded)


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 5])
def test_fold_in_and_uniform_copy_no_scalar_and_match_jax(seed, monkeypatch):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed, device="cpu")
    keys = prng.split(tk, 3)
    jkeys = jax.random.split(jk, 3)
    _no_host_copies(monkeypatch)
    for data in (0, 3, 2**31 + 9):
        want = np.asarray(jax.vmap(lambda k, d=data: jax.random.fold_in(k, d))(jkeys))
        assert np.array_equal(prng.fold_in(keys, data).numpy(), want.astype(np.int64))
    for lo, hi in ((0.0, 1.0), (-2.0, 3.0), (1e-30, 1.0), (0.1, 0.7)):
        want = np.asarray(jax.random.uniform(jk, (4, 5), minval=lo, maxval=hi))
        got = prng.uniform(tk, (4, 5), lo, hi).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# ── GL102 over the repaired files ───────────────────────────────────────


@pytest.fixture(scope="module")
def gl102_unbaselined():
    """GL1 over the whole port with no baseline: GL102's findings by file."""
    from pygrid_tpu_torch.analysis import run_checks
    from pygrid_tpu_torch.analysis.checkers import TraceSafetyChecker

    res = run_checks([str(PKG)], checkers=[TraceSafetyChecker()], baseline_path="",
                     root=str(ROOT))
    found: dict[str, list[int]] = {}
    for f in res.failures:
        if f.code == "GL102":
            found.setdefault(f.path, []).append(f.line)
    return found


@pytest.mark.parametrize("path", [
    "pygrid_tpu_torch/serving/programs.py",
    "pygrid_tpu_torch/models/decode.py",
    "pygrid_tpu_torch/utils/prng.py",
])
def test_no_blocking_host_copy_left_in_programs(path, gl102_unbaselined):
    assert gl102_unbaselined.get(path, []) == []


# ── the typed no-GPU error ──────────────────────────────────────────────


def test_resolve_without_a_gpu_raises_a_typed_runtime_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="no CUDA GPU") as info:
        pdevice.resolve("cuda")
    assert isinstance(info.value, PyGridError) and isinstance(info.value, RuntimeError)
    assert pdevice.resolve("cpu") == torch.device("cpu")


# ── package data ────────────────────────────────────────────────────────


def _package_globs() -> list[str]:
    with open(ROOT / "pyproject.toml", "rb") as fh:
        return tomllib.load(fh)["tool"]["setuptools"]["package-data"]["pygrid_tpu_torch"]


def _covered(rel: str, globs: list[str]) -> bool:
    # setuptools matches a glob per directory level: '*' stays in its level
    return any(
        fnmatch.fnmatch(rel, g) and rel.count("/") == g.count("/") for g in globs
    )


def _files_the_package_opens() -> list[Path]:
    """Every non-Python file the port reads relative to its own package:
    the kernels' sources, the native library's source, the linter's
    baseline, and the typing marker."""
    from pygrid_tpu_torch.analysis.core import default_baseline_path
    from pygrid_tpu_torch.kernels import build as kbuild
    from pygrid_tpu_torch.native import build as nbuild

    files = [*kbuild.CSRC.glob("*.cu"), *kbuild.CSRC.glob("*.cuh"), nbuild._SRC,
             default_baseline_path(), PKG / "py.typed"]
    return [Path(f).resolve() for f in files]


def test_package_data_covers_every_file_the_package_opens():
    globs = _package_globs()
    opened = _files_the_package_opens()
    assert all(f.is_file() for f in opened), [str(f) for f in opened if not f.is_file()]
    missing = [str(f.relative_to(PKG)) for f in opened
               if not _covered(f.relative_to(PKG).as_posix(), globs)]
    assert missing == []


def test_package_data_covers_the_default_baseline():
    from pygrid_tpu_torch.analysis.core import default_baseline_path

    rel = default_baseline_path().resolve().relative_to(PKG).as_posix()
    assert rel == "analysis/baseline.json"
    assert _covered(rel, _package_globs())


def test_every_shipped_non_python_file_is_in_package_data():
    """A data file added to the package later is either covered, or it is
    one of the plan fixtures read from a checkout (by ``chip_smoke.py`` and
    the tests), or a build product."""
    globs = _package_globs()
    loose = []
    for f in PKG.rglob("*"):
        rel = f.relative_to(PKG).as_posix()
        if (not f.is_file() or f.suffix in (".py", ".pyc") or "__pycache__" in rel
                or "/_build/" in f"/{rel}" or rel.startswith("plans/fixtures/")):
            continue
        if not _covered(rel, globs):
            loose.append(rel)
    assert loose == []
