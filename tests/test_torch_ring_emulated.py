"""The port's Z_2^64 ring-matmul kernel, built for the CPU and held bit for bit.

pygrid_tpu_torch/csrc/ring_matmul.cu is compiled by g++ against the CPU
stand-in headers in tests/cuda_emu (as tests/test_torch_flash_emulated.py
builds the flash kernels): every CUDA thread is a host thread, and the
int8 tensor-core products (mma.m16n8k32 u8), ldmatrix on the u8 limb planes
and the 8-byte cp.async copies are emulated with PTX's fragment layouts.
So the kernel's own limb split, fragment addressing, zero-filled ragged
edges, strides and its folds of the s32 partials every 4096 of K run here,
through the C entry, with the strides the wrapper
(pygrid_tpu_torch.smpc.ring_matmul.ring_matmul_kernel) gives it.

Ring arithmetic is exact, so every case must equal numpy's uint64 product
and ``ring_matmul_reference`` bit for bit (``np.array_equal``). The
emulated mma sums integers exactly, as the tensor cores do.

Run as a script (``python tests/test_torch_ring_emulated.py LIB OUT``) it
runs every case against the built library LIB and writes the results to OUT.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

# id: (a's numpy shape, b's numpy shape, how the torch operands are made)
CASES = {
    "ragged-2d (130, 600) @ (600, 70)": ((130, 600), (600, 70), "plain"),
    # 2^64 - 1 everywhere: the largest limbs, and K past one fold of 4096
    "all-ones (8, 4100) @ (4100, 8)": ((8, 4100), (4100, 8), "ones"),
    # a [40, 33] operand broadcast over a batch of 5 with stride 0
    "stride-0 batch (5, 40, 33) @ (5, 33, 21)": ((40, 33), (5, 33, 21), "stride0"),
    # a batch of 2 rounds x 3 parties: a broadcast over the parties with
    # stride 0, b the transpose of a [2, 3, 66, 64] tensor
    "two batch axes (2, 3, 65, 64) @ (2, 3, 64, 66)": ((2, 65, 64), (2, 3, 66, 64), "parties"),
    "(1, 1) @ (1, 1)": ((1, 1), (1, 1), "plain"),
    # a the transpose of a [70, 130] tensor: the kernel reads it along M
    "transposed a (130, 70) @ (70, 40)": ((70, 130), (70, 40), "trans_a"),
}


def _operands(rng, sa, sb, how):
    """(a, b) as numpy uint64 of the product's shapes, and as the torch ring
    views the kernel gets."""
    import numpy as np

    from pygrid_tpu_torch.smpc import ring as R

    if how == "ones":
        a, b = np.full(sa, 2**64 - 1, np.uint64), np.full(sb, 2**64 - 1, np.uint64)
    else:
        a = rng.integers(0, 2**64, size=sa, dtype=np.uint64)
        b = rng.integers(0, 2**64, size=sb, dtype=np.uint64)
    ta, tb = R.to_ring(a, "cpu"), R.to_ring(b, "cpu")
    if how == "stride0":
        ta = ta.expand(sb[0], *sa)
        a = np.broadcast_to(a, (sb[0], *sa))
    elif how == "trans_a":
        ta, a = ta.T, a.T
    elif how == "parties":
        ta = ta.unsqueeze(1).expand(sa[0], sb[1], *sa[1:])
        a = np.broadcast_to(a[:, None], (sa[0], sb[1], *sa[1:]))
        tb = tb.transpose(-1, -2)
        b = b.swapaxes(-1, -2)
    return a, b, ta, tb


def run_cases(lib_path: str) -> dict:
    """Each case through the emulated kernel's C entry, launched as the
    wrapper launches it: {case: [equals numpy, equals the plain version]},
    and the C entry's answer for a batch past the grid's limit."""
    import ctypes

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from pygrid_tpu_torch.kernels import build
    from pygrid_tpu_torch.smpc import ring as R
    from pygrid_tpu_torch.smpc import ring_matmul as rm

    lib = ctypes.CDLL(lib_path)
    for fn, argtypes in build.LIBRARIES["ring_matmul"][1].items():
        getattr(lib, fn).argtypes = argtypes
    rng = np.random.default_rng(12)
    results = {}
    for case, (sa, sb, how) in CASES.items():
        a, b, ta, tb = _operands(rng, sa, sb, how)
        M, K, N = ta.shape[-2], ta.shape[-1], tb.shape[-1]
        # poison: an element the kernel fails to write cannot pass
        out = torch.full(ta.shape[:-1] + (N,), 0x5A5A5A5A5A5A5A5A, dtype=torch.int64)
        a4, b4, c4 = rm._as4d(ta), rm._as4d(tb), rm._as4d(out)
        build.check(lib.pgt_ring_matmul(
            a4.data_ptr(), b4.data_ptr(), c4.data_ptr(), a4.shape[0], a4.shape[1], M, N, K,
            *a4.stride(), *b4.stride(), *c4.stride(), None), "pgt_ring_matmul")
        with np.errstate(over="ignore"):
            want = np.matmul(a, b)
        got = R.from_ring(out)
        results[case] = [bool(np.array_equal(got, want)),
                         bool(np.array_equal(got, R.from_ring(rm.ring_matmul_reference(ta, tb))))]
    x = torch.zeros((1, 1), dtype=torch.int64)
    results["batch past the grid"] = lib.pgt_ring_matmul(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), 65536, 1, 1, 1, 1, *[0] * 12, None)
    return results


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel for the CPU")
    from test_torch_flash_emulated import build_library

    out_dir = tmp_path_factory.mktemp("ring_emu")
    lib = build_library(out_dir, names=("ring_matmul",))
    result = out_dir / "result.json"
    subprocess.run([sys.executable, __file__, str(lib), str(result)], check=True, timeout=600)
    return json.loads(result.read_text())


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_ring_kernel_is_exact(emulated, case):
    equals_numpy, equals_plain = emulated[case]
    assert equals_numpy, f"{case}: the kernel differs from numpy's uint64 product"
    assert equals_plain, f"{case}: the kernel differs from ring_matmul_reference"


def test_emulated_ring_entry_refuses_a_batch_past_the_grid(emulated):
    """B1 * B2 above 65535 comes back as cudaErrorInvalidValue (1), with no
    launch: the wrapper turns it into a raise."""
    assert emulated["batch past the grid"] == 1


if __name__ == "__main__":
    Path(sys.argv[2]).write_text(json.dumps(run_cases(sys.argv[1])))
