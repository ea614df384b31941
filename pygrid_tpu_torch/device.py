"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. A CUDA
device that is not there is an error, never a quiet move to the CPU: the
CPU runs only when the caller asks for it, as the tests do.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
