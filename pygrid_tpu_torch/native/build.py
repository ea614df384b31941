"""Build the native host library on demand.

The port's copy of :mod:`pygrid_tpu.native.build`: the one C++
translation unit in ``src/`` is compiled at first use with the host's
``g++`` (or ``clang++``, or ``$CXX``) into ``_build/`` beside it (git-ignored)
and cached there, keyed by mtime. No toolchain or a failed build leaves
the callers on their numpy paths, as in the JAX package: this is host code
on the wire's hot path, not a device kernel."""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path

logger = logging.getLogger(__name__)

_SRC = Path(__file__).parent / "src" / "pygrid_native.cpp"


def _lib_path() -> Path:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return Path(__file__).parent / "_build" / f"libpygrid_native{suffix}"


def ensure_built(force: bool = False) -> Path | None:
    """Compile if stale or missing; returns the library path or None."""
    lib = _lib_path()
    if not force and lib.exists() and lib.stat().st_mtime >= _SRC.stat().st_mtime:
        return lib
    compiler = os.environ.get("CXX") or shutil.which("g++") or shutil.which("clang++")
    if compiler is None:
        logger.info("pygrid_tpu_torch.native: no C++ compiler; using numpy paths")
        return None
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler, "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired) as err:
        detail = getattr(err, "stderr", "") or str(err)
        logger.warning("pygrid_tpu_torch.native build failed: %s", detail)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)  # atomic: a concurrent importer never loads half a file
    return lib
