"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. A CUDA
device that is not there is an error, never a quiet move to the CPU: the
CPU runs only when the caller asks for it, as the tests do.

f32 is computed as f32. PyTorch lets cuDNN run f32 convolutions in TF32
(a 10-bit mantissa) unless told otherwise, and a caller may turn TF32 on
for matmuls too; the JAX package's op-list dialect computes f32 in f32 and
the port is held to it at rtol 2e-4 / atol 2e-5. So :func:`resolve` pins
both flags off whenever it hands out a CUDA device. The flags are
process-global, which is why they are set once here and not toggled around
each convolution: the node's handlers run on several executor threads, and
a context manager restoring the flags on one thread would switch TF32 back
on under another thread's convolution.
"""

from __future__ import annotations

import torch


def pin_f32() -> None:
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls, so f32
    work on the card rounds as f32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    GPU is present, and pins f32 (:func:`pin_f32`) when it is CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA GPU is available; "
                "pass device='cpu' to run on the CPU"
            )
        pin_f32()
    return dev
