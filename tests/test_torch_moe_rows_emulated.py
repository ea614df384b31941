"""The expert layer's row kernels, built for the CPU and held to their plain versions.

pygrid_tpu_torch/csrc/moe_rows.cu is compiled by g++ against the CPU
stand-in headers in tests/cuda_emu (as tests/test_torch_flash_emulated.py
builds the flash kernels): every CUDA thread is a host thread and the warp
shuffles of the router-weight gradient's dot products are emulated. So the
kernels' own arithmetic runs here, through their C entries with the
tensors the wrappers in pygrid_tpu_torch.models.moe hand them: the held
count read from ``offs`` at entry, the grid-stride walk over rows (a grid
of 3 blocks, so each warp takes several rows), the 16-byte vectors at
aligned widths and the element-by-element path at odd ones.

Each case routes random tokens with ``moe.route_topk`` and plans them with
``moe.dispatch``. Every row the kernels read past the held count is NaN and
every output starts at a sentinel, so a kernel that reads a row past the
held count, or writes one, shows: rows before it must equal the plain
versions, rows after it must still hold the sentinel, and the per-token
outputs (y, dx, dw) must be finite everywhere. The plain
versions round bf16 intermediates where the kernels keep f32, so bf16 is
held at 1e-2 (atol and rtol, chip_smoke.py's), f32 at 1e-5.

Run as a script (``python tests/test_torch_moe_rows_emulated.py LIB OUT``) it
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
GRID = 3  # blocks: 24 warps walk the rows
SENTINEL = -8192.0  # exact in bf16

# id: (tokens T, experts E, top-k, held experts, d, f, dtype, routing)
# routing: "random", "none held" (every token's top-k outside the held
# experts: a held count of 0), "all held" (every token's top-k inside
# them: the dispatch bound's worst case, n = M)
CASES = {
    "T40-d64-f32-bf16": (40, 16, 4, 4, 64, 32, "bfloat16", "random"),
    "T40-d64-f32-f32": (40, 16, 4, 4, 64, 32, "float32", "random"),
    "T37-d60-f36-bf16-odd-widths": (37, 16, 4, 4, 60, 36, "bfloat16", "random"),
    "T37-d66-f18-f32-odd-widths": (37, 16, 4, 4, 66, 18, "float32", "random"),
    "T24-k6-of-64-held8-bf16": (24, 64, 6, 8, 64, 40, "bfloat16", "random"),
    "T16-none-held-bf16": (16, 16, 4, 4, 64, 32, "bfloat16", "none held"),
    "T16-all-held-bf16": (16, 16, 4, 4, 64, 32, "bfloat16", "all held"),
    "T16-all-held-f32-odd": (16, 16, 4, 4, 60, 36, "float32", "all held"),
}
TOL = {"bfloat16": 1e-2, "float32": 1e-5}
OUTPUTS = ("xs", "a", "y", "dws", "do", "dh", "dx", "dw")


def _plan(T, E, k, held, d, routing, g):
    import torch

    from pygrid_tpu_torch.models import moe

    x32 = torch.randn(T, d, generator=g)
    wg = torch.randn(E, d, generator=g) * 0.3
    bias = torch.zeros(E)
    if routing == "none held":
        bias[held:held + k] = 100.0
    elif routing == "all held":
        bias[:k] = 100.0
    sel, w = moe.route_topk(x32, wg, bias, k, 2.5)
    return x32, w, moe.dispatch(sel, 0, held)


def run_cases(lib_path: str) -> dict:
    """Each case through the emulated C entries: {case: {output: [max abs
    error against the plain version where it is defined, entries outside
    the tolerance there, entries written where they must not be]}, with the
    held count and the rows M."""
    import ctypes

    import torch

    sys.path.insert(0, str(ROOT))
    from pygrid_tpu_torch.kernels import build
    from pygrid_tpu_torch.models import moe

    lib = ctypes.CDLL(lib_path)
    for fn, argtypes in build.LIBRARIES["moe_rows"][1].items():
        getattr(lib, fn).argtypes = argtypes

    def call(name, *args):
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        build.check(getattr(lib, f"pgt_{name}")(*ptrs, GRID, None), name)

    results = {}
    for case, (T, E, k, held, d, f, dt, routing) in CASES.items():
        dtype = getattr(torch, dt)
        bf16 = int(dtype == torch.bfloat16)
        g = torch.Generator().manual_seed(T * 100 + d + f)
        x32, w, (order, offs, pos, mask) = _plan(T, E, k, held, d, routing, g)
        x = x32.to(dtype)
        M, n = order.shape[0], int(offs[-1])

        def rnd(*shape):
            """Random rows, NaN past the held count."""
            t = torch.randn(*shape, generator=g).to(dtype)
            t[n:] = float("nan")
            return t

        def unset(*shape, like=dtype):
            return torch.full(shape, SENTINEL, dtype=like)

        h, o, da, dxs = rnd(M, 2 * f), rnd(M, d), rnd(M, f), rnd(M, d)
        gy = torch.randn(T, d, generator=g).to(dtype)
        dws_in = torch.randn(M, generator=g)
        dws_in[n:] = float("nan")

        got = {name: unset(*shape) for name, shape in
               (("xs", (M, d)), ("a", (M, f)), ("y", (T, d)), ("do", (M, d)),
                ("dh", (M, 2 * f)), ("dx", (T, d)))}
        got["dws"], got["dw"] = unset(M, like=torch.float32), unset(T, k, like=torch.float32)
        call("moe_gather", x, order, offs, got["xs"], held, k, d, bf16)
        call("moe_swiglu_fwd", h, offs, got["a"], held, f, bf16)
        call("moe_combine_fwd", o, w, pos, mask, got["y"], T, k, d, bf16)
        call("moe_rows_bwd", gy, o, w, order, offs, got["dws"], got["do"], held, k, d, bf16)
        call("moe_swiglu_bwd", h, da, offs, got["dh"], held, f, bf16)
        call("moe_combine_bwd", dxs, dws_in, pos, mask, got["dx"], got["dw"], T, k, d, bf16)

        dws_r, do_r = moe.rows_bwd_reference(gy, o, w, order, k)
        dx_r, dw_r = moe.combine_bwd_reference(dxs, dws_in, pos, mask)
        want = {
            "xs": moe.gather_reference(x, order, k), "a": moe.swiglu_reference(h),
            "y": moe.combine_reference(o, w, pos, mask), "dws": dws_r, "do": do_r,
            "dh": moe.swiglu_bwd_reference(h, da), "dx": dx_r, "dw": dw_r,
        }
        tol = TOL[dt]
        errs = {"n": n, "M": M}
        for name in OUTPUTS:
            a, b = got[name].float(), want[name].float()
            rows = slice(None) if name in ("y", "dx", "dw") else slice(0, n)
            a_in, b_in = a[rows], b[rows]
            bad = ~torch.isfinite(a_in) | ((a_in - b_in).abs() > tol + tol * b_in.abs())
            err = float((a_in - b_in).abs().max()) if a_in.numel() else 0.0
            past = 0 if rows == slice(None) else int((a[n:] != SENTINEL).sum())
            errs[name] = [err, int(bad.sum()), past]
        errs["per-token outputs zero"] = all(
            bool((got[name] == 0).all()) for name in ("y", "dx", "dw"))
        results[case] = errs
    x = torch.zeros(4)
    results["a size below 1"] = lib.pgt_moe_swiglu_fwd(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), 1, 0, 1, GRID, None)
    return results


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the CPU")
    from test_torch_flash_emulated import build_library

    out_dir = tmp_path_factory.mktemp("moe_rows_emu")
    lib = build_library(out_dir, names=("moe_rows",))
    result = out_dir / "result.json"
    subprocess.run([sys.executable, __file__, str(lib), str(result)], check=True, timeout=600)
    return json.loads(result.read_text())


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_row_kernels_match_plain_versions_on_the_held_rows(emulated, case):
    errs = emulated[case]
    tol = TOL[CASES[case][6]]
    for name in OUTPUTS:
        err, n_bad, _ = errs[name]
        assert n_bad == 0, f"{case}: {name} has {n_bad} entries off by more than {tol} (max {err})"


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_row_kernels_leave_the_rows_past_the_held_count(emulated, case):
    """Rows past offs[-1] of xs, a, dws, do and dh stay as they were."""
    errs = emulated[case]
    written = {name: errs[name][2] for name in OUTPUTS if errs[name][2]}
    assert not written, f"{case}: entries written past the held count {errs['n']}: {written}"


def test_emulated_cases_reach_both_ends_of_the_held_count(emulated):
    """The routings give what their names say: a held count of 0, and one
    equal to the dispatch bound M."""
    assert emulated["T16-none-held-bf16"]["n"] == 0
    assert emulated["T16-none-held-bf16"]["per-token outputs zero"]
    for case in ("T16-all-held-bf16", "T16-all-held-f32-odd"):
        assert emulated[case]["n"] == emulated[case]["M"] > 0
    for case in ("T40-d64-f32-bf16", "T24-k6-of-64-held8-bf16"):
        assert 0 < emulated[case]["n"] < emulated[case]["M"]


def test_emulated_entry_refuses_a_size_below_one(emulated):
    """f = 0 comes back as cudaErrorInvalidValue (1), with no launch: the
    wrapper turns it into a raise."""
    assert emulated["a size below 1"] == 1


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    Path(sys.argv[2]).write_text(json.dumps(run_cases(sys.argv[1])))
