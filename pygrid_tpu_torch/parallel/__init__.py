"""FedAvg round builders and attention for the port.

The flash kernels live in :mod:`pygrid_tpu_torch.parallel.flash_attention`
(import ``flash_attention`` from there: the package attribute of that name
is the module)."""

from pygrid_tpu_torch.parallel.fedavg import (
    make_round,
    make_scanned_rounds,
    run_rounds,
)
from pygrid_tpu_torch.parallel.fedavg_fused import (
    make_fused_round,
    make_fused_rounds,
)
from pygrid_tpu_torch.parallel.ring_attention import attention

__all__ = [
    "attention",
    "make_fused_round",
    "make_fused_rounds",
    "make_round",
    "make_scanned_rounds",
    "run_rounds",
]
