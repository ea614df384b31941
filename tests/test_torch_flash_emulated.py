"""The port's flash kernels, built for the CPU and held to their plain versions.

The CUDA sources in pygrid_tpu_torch/csrc are compiled by g++ against the
CPU stand-in headers in tests/cuda_emu: every CUDA thread of a block is a
host thread, and the PTX primitives of csrc/tc_common.cuh (ldmatrix,
mma.sync, cp.async) are emulated with their fragment layouts. So the bf16
tensor-core kernels' own index arithmetic -- fragment addressing, masks,
the double-buffered pipeline, the layout preconditions -- runs here, on the
tile and layout edges chip_smoke.py holds them to on the card, through the
same C entries and the wrapper's layout step (`_layout`). The f32 FMA
kernels ride along.

The emulated mma sums its 16 products in order in f32, not as the tensor
cores do, so this is a check of the kernels' logic, not of their rounding;
the tolerances are chip_smoke.py's (bf16 atol 1e-2 + rtol 1e-2, f32 1e-4).
The emulator runs in a subprocess with a time limit, because a kernel fault
there is an abort or a stuck barrier.

Run as a script (``python tests/test_torch_flash_emulated.py LIB OUT``) it
runs every case against the built library LIB and writes the errors to OUT.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "pygrid_tpu_torch" / "csrc"
EMU = Path(__file__).resolve().parent / "cuda_emu"

# id: (B, Lq, Lk, H, D, Dv, causal, q/k/v as views of one [B, L, 3, H, D], dtype)
CASES = {
    "L64-D64-causal": (1, 64, 64, 2, 64, 64, True, False, "bfloat16"),
    "L65-D40-causal": (1, 65, 65, 2, 40, 40, True, False, "bfloat16"),
    "L129-D128-causal": (1, 129, 129, 1, 128, 128, True, False, "bfloat16"),
    "L127-D128": (1, 127, 127, 1, 128, 128, False, False, "bfloat16"),
    "Lq64-Lk129-D64": (1, 64, 129, 2, 64, 64, False, False, "bfloat16"),
    "L129-D36-padded-copy": (1, 129, 129, 1, 36, 36, True, False, "bfloat16"),
    "L65-D64-qkv-views": (2, 65, 65, 1, 64, 64, True, True, "bfloat16"),
    "L65-D40-f32": (1, 65, 65, 1, 40, 40, True, False, "float32"),
    # Lk off dQ's 64-key tile: a ragged last key tile
    "L97-D64-causal": (1, 97, 97, 2, 64, 64, True, False, "bfloat16"),
    "Lq65-Lk97-D48": (1, 65, 97, 1, 48, 48, False, False, "bfloat16"),
    # D past 128: the wide kernels' D-slice grid axis and streamed chunks
    "L65-D160-causal": (1, 65, 65, 1, 160, 160, True, False, "bfloat16"),
    "Lq64-Lk33-D160": (1, 64, 33, 1, 160, 160, False, False, "bfloat16"),
    "L63-D256-causal": (1, 63, 63, 1, 256, 256, True, False, "bfloat16"),
    "Lq65-Lk97-D256": (1, 65, 97, 1, 256, 256, False, False, "bfloat16"),
    "L65-D160-f32-causal": (1, 65, 65, 1, 160, 160, True, False, "float32"),
    "L63-D256-f32": (1, 63, 63, 1, 256, 256, False, False, "float32"),
    # values narrower than queries and keys: the narrow-V path (one block
    # owns O and dV at Dv, dK and dQ at D); the views case takes v as the
    # first Dv columns of its slice of the [B, L, 3, H, D] tensor
    "L65-Dqk192-Dv128-causal": (1, 65, 65, 2, 192, 128, True, False, "bfloat16"),
    "Lq65-Lk97-Dqk192-Dv128": (1, 65, 97, 1, 192, 128, False, False, "bfloat16"),
    "L97-Dqk160-Dv96-causal": (1, 97, 97, 1, 160, 96, True, False, "bfloat16"),
    "L65-Dqk192-Dv128-qkv-views": (2, 65, 65, 1, 192, 128, True, True, "bfloat16"),
    # D_v well under 128: S runs most of its k-steps past dP's
    "Lq64-Lk65-Dqk192-Dv40": (1, 64, 65, 1, 192, 40, False, False, "bfloat16"),
    # Dv < D off the narrow-V shapes: one width, v zero-padded (f32 too)
    "L65-Dqk192-Dv128-f32": (1, 65, 65, 1, 192, 128, True, False, "float32"),
}
TOL = {"bfloat16": 1e-2, "float32": 1e-4}  # atol and rtol
OUTPUTS = ("out", "lse", "dk", "dv", "dq")


def build_library(out_dir: Path, names=("flash_fwd", "flash_bwd")) -> Path:
    """g++ build of the csrc/ sources ``names`` (flash_fwd.cu and
    flash_bwd.cu by default) with the PTX block of tc_common.cuh replaced by
    the emulated primitives and every ``<<<grid, threads, smem, stream>>>``
    launch by ``emu_launch``."""
    for src in CSRC.glob("*.cuh"):
        text = src.read_text()
        if src.name == "tc_common.cuh":
            text, n = re.subn(
                r"// ---- PTX primitives.*?// ---- end of PTX primitives ----",
                '#include "tc_primitives.inc"', text, flags=re.S)
            assert n == 1, "tc_common.cuh lost its PTX block markers"
        (out_dir / src.name).write_text(text)
    sources = []
    for name in names:
        text = re.sub(r"((?:\w+::)*\w+(?:<[^<>]*>)?)<<<([^>]*)>>>\(", r"::emu_launch(\1, \2, ",
                      (CSRC / f"{name}.cu").read_text())
        (out_dir / f"{name}.cpp").write_text(text)
        sources.append(str(out_dir / f"{name}.cpp"))
    lib = out_dir / f"lib{'_'.join(names)}_emu.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
         f"-I{out_dir}", f"-I{EMU}", "-o", str(lib), *sources],
        check=True, capture_output=True, text=True, timeout=300,
    )
    return lib


def run_cases(lib_path: str, cases: dict = CASES) -> dict:
    """Each case through the emulated kernels, launched as the wrappers in
    pygrid_tpu_torch.parallel.flash_attention launch them, against the plain
    versions: {case: {output: [max abs err, elements outside tolerance]}}
    and whether dK/dV and dQ each gave the same bits twice. A case may end
    in (H_kv, window): k and v at H_kv heads, and the band's width (None:
    none); without them k and v hold H heads and there is no window."""
    import ctypes

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from pygrid_tpu_torch.kernels import build
    from pygrid_tpu_torch.parallel import flash_attention as fa

    lib = ctypes.CDLL(lib_path)
    for lib_name in ("flash_fwd", "flash_bwd"):
        for fn, argtypes in build.LIBRARIES[lib_name][1].items():
            getattr(lib, fn).argtypes = argtypes
    results = {}
    for case, (B, Lq, Lk, H, D, Dv, causal, views, dt, *band) in cases.items():
        Hk, window = band or (H, None)
        dtype = getattr(torch, dt)
        rng = np.random.default_rng(Lq * 1000 + D + Dv)

        def rnd(*shape):
            return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)

        if views:
            qkv = rnd(B, Lq, 3, H, D)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2, :, :Dv]
        else:
            q, k, v = rnd(B, Lq, H, D), rnd(B, Lk, Hk, D), rnd(B, Lk, Hk, Dv)
        do = rnd(B, Lq, H, Dv)
        scale = D**-0.5
        out_r, lse_r = fa.flash_fwd_reference(q, k, v, causal, scale, window)
        delta = fa.softmax_delta(out_r, do).contiguous()
        dk_r, dv_r = fa.flash_bwd_dkv_reference(q, k, v, do, lse_r, delta, causal, scale, window)
        dq_r = fa.flash_bwd_dq_reference(q, k, v, do, lse_r, delta, causal, scale, window)

        qp, kp, vp, dop, Dk, Dvk = fa._layout(q, k, v, do)
        tail = (float(scale), int(causal), fa._DTYPES[dtype], Hk, window or 0, None)
        widths = (B, H, Lq, Lk, Dk, Dvk)

        def nan(L, width, heads=H):
            return torch.full((B, L, heads, width), float("nan")).to(dtype)

        out, lse = nan(Lq, Dvk), torch.full((B * H, Lq), float("nan"))
        build.check(lib.pgt_flash_fwd(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(), lse.data_ptr(),
            *widths, *fa._strides(qp), *fa._strides(kp), *fa._strides(vp), *tail),
            "pgt_flash_fwd")
        dkv = []
        for _ in range(2):
            dk, dv = nan(Lk, Dk, Hk), nan(Lk, Dvk, Hk)
            build.check(lib.pgt_flash_bwd_dkv(
                qp.data_ptr(), dop.data_ptr(), lse_r.data_ptr(), delta.data_ptr(),
                kp.data_ptr(), vp.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *widths, *fa._strides(qp), *fa._strides(dop), *fa._strides(kp),
                *fa._strides(vp), *tail), "pgt_flash_bwd_dkv")
            dkv.append((dk, dv))
        dqs = []
        for _ in range(2):
            dq = nan(Lq, Dk)
            build.check(lib.pgt_flash_bwd_dq(
                qp.data_ptr(), dop.data_ptr(), lse_r.data_ptr(), delta.data_ptr(),
                kp.data_ptr(), vp.data_ptr(), dq.data_ptr(),
                *widths, *fa._strides(qp), *fa._strides(dop), *fa._strides(kp),
                *fa._strides(vp), *tail), "pgt_flash_bwd_dq")
            dqs.append(dq)

        got = (out[..., :Dv], lse, dkv[0][0][..., :D], dkv[0][1][..., :Dv], dqs[0][..., :D])
        want = (out_r, lse_r, dk_r, dv_r, dq_r)
        tol = TOL[dt]
        errs = {}
        for name, a, b in zip(OUTPUTS, got, want):
            a, b = a.float(), b.float()
            bad = ~torch.isfinite(a) | ((a - b).abs() > tol + tol * b.abs())
            errs[name] = [float((a - b).abs().max()), int(bad.sum())]
        errs["dkv_same_bits"] = all(torch.equal(x, y) for x, y in zip(dkv[0], dkv[1]))
        errs["dq_same_bits"] = torch.equal(dqs[0], dqs[1])
        errs["widths"] = [Dk, Dvk]
        results[case] = errs
    return results


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the CPU")
    out_dir = tmp_path_factory.mktemp("flash_emu")
    lib = build_library(out_dir)
    result = out_dir / "result.json"
    subprocess.run([sys.executable, __file__, str(lib), str(result)],
                   check=True, timeout=600)
    return json.loads(result.read_text())


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernels_match_plain_versions(emulated, case):
    errs = emulated[case]
    for name in OUTPUTS:
        max_err, n_bad = errs[name]
        assert n_bad == 0, f"{case} {name}: {n_bad} elements off, max abs err {max_err:.3e}"
    assert errs["dkv_same_bits"], f"{case}: dK/dV differ between two launches"


def test_emulated_narrow_v_cases_run_at_their_own_widths(emulated):
    """The bf16 cases with Dv <= 128 < D <= 192 launch the narrow-V path
    (q, k at D and v, dO at Dv, unpadded); every other case one width."""
    for case, (_, _, _, _, D, Dv, _, _, dt) in CASES.items():
        bf16, w = dt == "bfloat16", max(D, Dv)
        want = [D, Dv] if bf16 and Dv <= 128 < D <= 192 else [w + (-w) % 8 if bf16 else w] * 2
        assert emulated[case]["widths"] == want, case


def test_emulated_dq_is_bit_identical_across_launches(emulated):
    """dQ is written once per tile from registers, with no atomics: two
    launches on the same inputs give the same bits in every case."""
    differ = [case for case, errs in emulated.items() if not errs["dq_same_bits"]]
    assert not differ, f"dQ differs between two launches in {differ}"


if __name__ == "__main__":
    Path(sys.argv[2]).write_text(json.dumps(run_cases(sys.argv[1])))
