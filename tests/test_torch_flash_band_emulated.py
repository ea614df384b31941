"""The flash kernels' band instantiations (a sliding window, and fewer K/V
heads than query heads), built for the CPU and held to their plain versions.

The same emulation as tests/test_torch_flash_emulated.py (g++ against the
stand-ins in tests/cuda_emu, every CUDA thread a host thread, the PTX
fragment layouts emulated), through the same C entries and the wrapper's
layout step, on the band's edges: a window at least as long as the
sequence, a window of one key, lengths and windows off the 64-row tiles,
and H_kv of 1, of a few heads, and of every head. The tolerances are that
file's (bf16 atol 1e-2 + rtol 1e-2): a check of the kernels' logic (which
key tiles a block visits, the band's mask, the group loop of the dK/dV
block and its writes at H_kv heads), not of the tensor cores' rounding.

Run as a script (``python tests/test_torch_flash_band_emulated.py LIB OUT``)
it runs every case against the built library LIB and writes the errors to
OUT.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_flash_emulated import OUTPUTS, build_library, run_cases  # noqa: E402

# id: (B, Lq, Lk, H, D, Dv, causal, views, dtype, H_kv, window)
CASES = {
    "W-over-L-Hkv4": (1, 97, 97, 8, 64, 64, True, False, "bfloat16", 4, 200),
    "W1-Hkv2": (1, 65, 65, 2, 64, 64, True, False, "bfloat16", 2, 1),
    "L161-W70-Hkv1-D128": (1, 161, 161, 4, 128, 128, True, False, "bfloat16", 1, 70),
    "L130-W33-Hkv2-D40": (1, 130, 130, 4, 40, 40, True, False, "bfloat16", 2, 33),
    "L129-W64-Hkv-H": (1, 129, 129, 2, 128, 128, True, False, "bfloat16", 2, 64),
    "L97-W96-Hkv2-B2": (2, 97, 97, 4, 64, 64, True, False, "bfloat16", 2, 96),
    # grouped without a window: causal, and a cross-attention shape
    "L97-Hkv2-causal": (2, 97, 97, 8, 64, 64, True, False, "bfloat16", 2, None),
    "Lq64-Lk129-Hkv1": (1, 64, 129, 4, 64, 64, False, False, "bfloat16", 1, None),
}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the CPU")
    out_dir = tmp_path_factory.mktemp("flash_band_emu")
    lib = build_library(out_dir)
    result = out_dir / "result.json"
    subprocess.run([sys.executable, __file__, str(lib), str(result)],
                   check=True, timeout=600)
    return json.loads(result.read_text())


@pytest.mark.parametrize("case", list(CASES))
def test_band_kernels_match_plain_versions(emulated, case):
    errs = emulated[case]
    for name in OUTPUTS:
        max_err, n_bad = errs[name]
        assert n_bad == 0, f"{case} {name}: {n_bad} elements off, max abs err {max_err:.3e}"
    assert errs["dkv_same_bits"], f"{case}: dK/dV differ between two launches"
    assert errs["dq_same_bits"], f"{case}: dQ differs between two launches"


if __name__ == "__main__":
    Path(sys.argv[2]).write_text(json.dumps(run_cases(sys.argv[1], CASES)))
