"""The SMPC compute plane of the port: Z_2^64 ring arithmetic as int64
tensors, fixed-point encoding, Beaver rounds, the crypto provider and
``AdditiveSharingTensor``, with the exact ring matmul as a hand-written
CUDA kernel (:mod:`pygrid_tpu_torch.smpc.ring_matmul`); and its protocol
plane over party workers: ``RemoteSharedTensor`` with the cross-worker
Beaver round (:mod:`pygrid_tpu_torch.smpc.remote`) and encrypted inference
of a plan's op-list (:mod:`pygrid_tpu_torch.smpc.encrypted_model`).

The package attribute ``ring_matmul`` is that module; the function of the
same name is :func:`pygrid_tpu_torch.smpc.ring.ring_matmul`."""

from pygrid_tpu_torch.smpc.ring import (  # noqa: F401
    from_ring,
    from_ring_signed,
    ring_add,
    ring_div_const,
    ring_div_const_signed,
    ring_mul,
    ring_mul_const,
    ring_neg,
    ring_random,
    ring_sub,
    to_ring,
)
from pygrid_tpu_torch.smpc.fixed import FixedPointEncoder  # noqa: F401
from pygrid_tpu_torch.smpc.provider import CryptoProvider, CryptoStore  # noqa: F401
from pygrid_tpu_torch.smpc.additive import (  # noqa: F401
    AdditiveSharingTensor,
    FixedPrecisionTensor,
    fix_prec,
)
from pygrid_tpu_torch.smpc.remote import (  # noqa: F401
    RemoteCryptoProvider,
    RemoteSharedTensor,
    fix_prec_share_to_nodes,
    share_to_nodes,
)
from pygrid_tpu_torch.smpc.encrypted_model import (  # noqa: F401
    EncryptedModel,
    SharedTensorRef,
    publish_encrypted_model,
    run_encrypted_oplist,
)
