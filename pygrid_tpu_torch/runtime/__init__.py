"""The data-centric party runtime: ``VirtualWorker`` parties whose stored
tensors live on their device, the object store, pointers and the wire
messages (the port's counterpart of :mod:`pygrid_tpu.runtime`)."""

from pygrid_tpu_torch.runtime.store import ObjectStore, StoredObject  # noqa: F401
from pygrid_tpu_torch.runtime.worker import VirtualWorker  # noqa: F401
from pygrid_tpu_torch.runtime.pointers import PointerTensor, send  # noqa: F401
from pygrid_tpu_torch.runtime import messages  # noqa: F401
