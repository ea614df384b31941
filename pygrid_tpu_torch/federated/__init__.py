"""Model-centric federated learning: the port's copy of
:mod:`pygrid_tpu.federated` — FLController, the cycle manager and its
managers, with the host-side aggregation helpers (compression, robust and
secure aggregation, server optimizers, privacy, selection, auth)."""

from pygrid_tpu_torch.federated.controller import FLController  # noqa: F401
from pygrid_tpu_torch.federated.cycle_manager import CycleManager  # noqa: F401
from pygrid_tpu_torch.federated.managers import (  # noqa: F401
    ModelManager,
    PlanManager,
    ProcessManager,
    ProtocolManager,
    WorkerManager,
)
from pygrid_tpu_torch.federated import auth, schemas, secagg, tasks  # noqa: F401
from pygrid_tpu_torch.federated.secagg_service import SecAggService  # noqa: F401
