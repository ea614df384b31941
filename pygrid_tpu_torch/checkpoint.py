"""Checkpoint export and import for FL model parameter lists.

Counterpart of :mod:`pygrid_tpu.checkpoint`, which writes an orbax
StandardCheckpoint directory. The port's machine has no orbax; its
counterpart in PyTorch's own toolchain is a directory holding a
``torch.save`` file of the list of tensors, read back with
``weights_only=True`` (no pickled code runs on import). The errors are the
reference's: the path must not exist, an empty list raises, and a
checkpoint that is not a list of tensors raises.

    from pygrid_tpu_torch.checkpoint import export_checkpoint, import_checkpoint
    export_checkpoint(params, "/ckpts/mnist")
    params = import_checkpoint("/ckpts/mnist")            # on the card
    params = import_checkpoint("/ckpts/mnist", device="cpu")
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.utils.exceptions import PyGridError

#: the file inside a checkpoint directory
PARAMS_FILE = "params.pt"


def export_checkpoint(params: Sequence, path: str | os.PathLike) -> None:
    """Save a parameter list (tensors on any device, or numpy arrays) as a
    checkpoint directory at ``path``, which must not exist."""
    tensors = [p.detach().cpu() if isinstance(p, torch.Tensor) else torch.from_numpy(
        np.array(p)) for p in params]
    if not tensors:
        raise PyGridError("nothing to export")
    path = os.path.abspath(os.fspath(path))
    os.makedirs(path)  # raises if it exists
    torch.save(tensors, os.path.join(path, PARAMS_FILE))


def import_checkpoint(path: str | os.PathLike,
                      device: str | torch.device = "cuda") -> list[torch.Tensor]:
    """Load a checkpoint directory back into the list of tensors every
    hosting API takes, on ``device`` (default ``"cuda"``: raises without a
    GPU unless ``device="cpu"``)."""
    dev = resolve(device)
    restored = torch.load(os.path.join(os.path.abspath(os.fspath(path)), PARAMS_FILE),
                          map_location="cpu", weights_only=True)
    if not isinstance(restored, (list, tuple)) or not all(
            isinstance(t, torch.Tensor) for t in restored):
        raise PyGridError(
            "checkpoint is not a list of tensors; re-export it as a flat parameter list")
    return [t.to(dev) for t in restored]
