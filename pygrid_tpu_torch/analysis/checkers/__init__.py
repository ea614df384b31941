"""The gridlint checker registry for the port.

Checkers are classes; every run instantiates fresh ones (GL2/GL4 carry
cross-file state between ``check_module`` and ``finalize``)."""

from __future__ import annotations

from pygrid_tpu_torch.analysis.checkers.gl1_trace import TraceSafetyChecker
from pygrid_tpu_torch.analysis.checkers.gl2_conc import ConcurrencyGraphChecker
from pygrid_tpu_torch.analysis.checkers.gl2_locks import LockDisciplineChecker
from pygrid_tpu_torch.analysis.checkers.gl3_async import AsyncHygieneChecker
from pygrid_tpu_torch.analysis.checkers.gl4_contracts import ContractDriftChecker
from pygrid_tpu_torch.analysis.checkers.gl5_cuda import CudaBoundsChecker
from pygrid_tpu_torch.analysis.checkers.gl6_flow import DataFlowChecker
from pygrid_tpu_torch.analysis.checkers.gl7_proto import ProtocolChecker

#: two classes share the GL2 family: the per-class lock rules
#: (GL201–203) and the whole-program concurrency pass (GL204–206) —
#: ``--select GL2`` runs both
ALL_CHECKERS = (
    TraceSafetyChecker,
    LockDisciplineChecker,
    ConcurrencyGraphChecker,
    AsyncHygieneChecker,
    ContractDriftChecker,
    CudaBoundsChecker,
    DataFlowChecker,
    ProtocolChecker,
)

__all__ = [
    "ALL_CHECKERS",
    "AsyncHygieneChecker",
    "ConcurrencyGraphChecker",
    "ContractDriftChecker",
    "CudaBoundsChecker",
    "DataFlowChecker",
    "LockDisciplineChecker",
    "ProtocolChecker",
    "TraceSafetyChecker",
]
