"""SMPC: fixed-precision additive sharing and the Beaver matmul, on the card.

The port's twin of ``examples/smpc_demo.py``: encode floats into the 2^64
ring, split them into additive shares held by alice, bob and charlie with
james as the crypto provider (four parties in all), run add, sub, mul and
matmul on the shares, and reconstruct. Every share is one int64 tensor on
``--device``; on the card each Beaver matmul launches the hand-written
ring-matmul kernel (``pygrid_tpu_torch/csrc/ring_matmul.cu``).

    python examples_torch/smpc_demo.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout

import numpy as np

PARTIES = ("alice", "bob", "charlie")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda",
                        help="where shares live: cuda (default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)

    from pygrid_tpu_torch.device import resolve
    from pygrid_tpu_torch.smpc import CryptoProvider
    from pygrid_tpu_torch.smpc.additive import fix_prec

    device = resolve(args.device)
    provider = CryptoProvider(id="james", device=device)
    x = np.array([[0.1, 0.2], [0.3, 0.4]], dtype="float64")
    y = np.array([[2.0, 0.5], [1.0, -1.0]], dtype="float64")

    sx = fix_prec(x).share(*PARTIES, crypto_provider=provider, device=device)
    sy = fix_prec(y).share(*PARTIES, crypto_provider=provider, device=device)
    print(f"x shared over {len(PARTIES)} parties; one share of x[0,0]: "
          f"{int(sx.shares[0].reshape(-1)[0]) & (2**64 - 1)} (mod 2^64 — reveals nothing)")

    results = {
        "x + y": (sx + sy).get(),
        "x - y": (sx - sy).get(),
        "x * y (Beaver)": (sx * sy).get(),
        "x @ y (Beaver)": (sx @ sy).get(),
    }
    expect = {
        "x + y": x + y,
        "x - y": x - y,
        "x * y (Beaver)": x * y,
        "x @ y (Beaver)": x @ y,
    }
    ok = True
    for op, result in results.items():
        err = float(np.abs(np.asarray(result) - expect[op]).max())
        print(f"{op:>16}: max err {err:.2e}")
        ok &= err < 1e-2
    print(f"reconstructed x @ y: {np.asarray(results['x @ y (Beaver)']).ravel().tolist()}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
