"""The port's own copies of the typed errors its SMPC plane raises.

Counterparts of ``PyGridError`` and ``EmptyCryptoPrimitiveStoreError`` in
:mod:`pygrid_tpu.utils.exceptions`, with the same names, default messages
and the same ``kwargs_`` contract: the empty-store error carries what a
crypto provider needs to deal the missing primitives (op, shapes,
n_instances, n_parties), so a caller can refill and retry.
"""

from __future__ import annotations


class PyGridError(Exception):
    def __init__(self, message: str = "") -> None:
        super().__init__(message or self.__class__.__doc__ or self.__class__.__name__)


class EmptyCryptoPrimitiveStoreError(PyGridError):
    """Crypto primitive store is empty — a triple refill round is required.

    Carries the kwargs a crypto provider needs to synthesize the missing
    primitives (the syft refill protocol).
    """

    def __init__(self, kwargs_=None) -> None:
        super().__init__("")
        self.kwargs_ = dict(kwargs_ or {})
