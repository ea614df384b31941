"""Typed grid errors: the port's own copy of :mod:`pygrid_tpu.utils.exceptions`.

Error-name parity with reference ``apps/node/src/app/main/core/exceptions.py``
(error class names leak into wire responses as ``{"error": str(e)}``, so the
names and default messages are part of the observable surface), plus the
execution-plane errors the reference imports from syft
(``GetNotPermittedError``, ``ResponseSignatureError``,
``EmptyCryptoPrimitiveStoreError`` — consumed at reference
``events/data_centric/syft_events.py:7-9,34-44``).
"""


class PyGridError(Exception):
    def __init__(self, message: str = "") -> None:
        super().__init__(message or self.__class__.__doc__ or self.__class__.__name__)


class AuthorizationError(PyGridError):
    """User is not authorized for this operation!"""


class WorkerNotFoundError(PyGridError):
    """Worker ID not found!"""


class RoleNotFoundError(PyGridError):
    """Role ID not found!"""


class UserNotFoundError(PyGridError):
    """User not found!"""


class GroupNotFoundError(PyGridError):
    """Group ID not found!"""


class CycleNotFoundError(PyGridError):
    """Cycle not found!"""


class FLProcessNotFoundError(PyGridError):
    """Federated learning process not found!"""


class FLProcessConflict(PyGridError):
    """FL Process already exists!"""


class ProtocolNotFoundError(PyGridError):
    """Protocol ID not found!"""


class PlanNotFoundError(PyGridError):
    """Plan ID not found!"""


class PlanInvalidError(PyGridError):
    """Plan is not valid!"""


class PlanTranslationError(PyGridError):
    """Failed to translate Plan!"""


class ModelNotFoundError(PyGridError):
    """Model ID not found!"""


class ProcessNotFoundError(PyGridError):
    """Process ID not found!"""


class ProcessFoundError(PyGridError):
    """Process already exists!"""


class ConfigsNotFoundError(PyGridError):
    """Configs not found!"""


class CheckPointNotFound(PyGridError):
    """Checkpoint not found!"""


class InvalidRequestKeyError(PyGridError):
    """Invalid request key!"""


class InvalidCredentialsError(PyGridError):
    """Invalid credentials!"""


class MissingRequestKeyError(PyGridError):
    """Missing request key!"""


class MaxCycleLimitExceededError(PyGridError):
    """There are no cycles remaining for this process."""

    def __init__(self, message: str = "") -> None:
        super().__init__(message)
        self.name = message  # reference carries the process name here


class ServerBusyError(PyGridError):
    """Server busy — generation queue is at its depth limit, retry later.

    The serving engine's backpressure signal (this framework's
    extension): admission past the bounded queue answers this typed
    error instead of piling unbounded work onto the node."""


# --- execution-plane errors (syft surface rebuilt here) ---------------------


class GetNotPermittedError(PyGridError):
    """You are not permitted to call .get() on this tensor."""


class ResponseSignatureError(PyGridError):
    """Response did not match the expected signature."""

    def __init__(self, ids_generated=None) -> None:
        super().__init__("")
        self.ids_generated = ids_generated


class EmptyCryptoPrimitiveStoreError(PyGridError):
    """Crypto primitive store is empty — a triple refill round is required.

    Carries the kwargs a crypto provider needs to synthesize the missing
    primitives (mirrors the syft refill protocol the reference relies on at
    events/data_centric/syft_events.py:34-38).
    """

    def __init__(self, kwargs_=None) -> None:
        super().__init__("")
        self.kwargs_ = dict(kwargs_ or {})


class ObjectNotFoundError(PyGridError):
    """Object not found in the store."""
