"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/*.cu`` file with a plain C interface is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``pygrid_tpu_torch/_build/``
(git-ignored). The library's name carries a hash of its source, the shared
headers and the flags, so an edited ``.cu`` file rebuilds and an unchanged
one loads at once. The sources compile in parallel, one ``nvcc`` each.

There is no fallback: where ``nvcc`` is missing or a build fails, this
raises. The kernels' plain PyTorch versions run only for CPU tensors, and
that choice is made by the wrappers, never here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_STRIDES = [_I] * 3

#: library -> (source, {C entry: argtypes}); every entry returns its
#: launch's cudaError_t as an int
LIBRARIES: dict[str, tuple[str, dict[str, list]]] = {
    "flash_fwd": (
        "flash_fwd.cu",
        {
            "pgt_flash_fwd": [_P] * 5 + [_I] * 6 + _STRIDES * 3
            + [_F, _I, _I, _P],
        },
    ),
    "flash_bwd": (
        "flash_bwd.cu",
        {
            "pgt_flash_bwd_dkv": [_P] * 8 + [_I] * 6 + _STRIDES * 4
            + [_F, _I, _I, _P],
            "pgt_flash_bwd_dq": [_P] * 7 + [_I] * 6 + _STRIDES * 4
            + [_F, _I, _I, _P],
        },
    ),
    "ring_matmul": (
        "ring_matmul.cu",
        # a, b, c; B1, B2, M, N, K; four int64 strides of each operand
        {"pgt_ring_matmul": [_P] * 3 + [_I] * 5 + [_L] * 12 + [_P]},
    ),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location. Raises if there is none."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels cannot be built, and CUDA tensors have no other path"
    )


def _digest(source: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(LIBRARIES[name][0])}.so"


def build_all() -> dict[str, float]:
    """Compile every library that is not built yet, all at once; returns
    the wall seconds of each compile that ran (empty when all were
    cached). The compiler's register and shared-memory report for each
    kernel is kept beside its library as ``<lib>.log``."""
    todo = {n: library_path(n) for n in LIBRARIES if not library_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / LIBRARIES[name][0])]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp, target, time.perf_counter(),
        )
    seconds, failures = {}, []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)  # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """What nvcc printed for library ``name`` (ptxas registers, spills and
    shared memory per kernel); empty if it was never built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in LIBRARIES[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {status}")


def launch(name: str, entry: str, device, *args) -> None:
    """Call C entry ``entry`` of library ``name`` on ``device``'s current
    stream (the kernel does not synchronise) and raise if its launch failed."""
    import torch

    with torch.cuda.device(device):
        fn = getattr(library(name), entry)
        check(fn(*args, torch.cuda.current_stream(device).cuda_stream), entry)
