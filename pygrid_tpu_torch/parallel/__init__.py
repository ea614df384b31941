"""The port's parallel plane: FedAvg round builders, attention and the
multi-device programs on ``torch.distributed`` (meshes, the sharded
rounds, ring and Ulysses attention, pipeline, FSDP, the SecAgg
simulation), with the collectives they are built from in
:mod:`pygrid_tpu_torch.parallel.collectives`.

The flash kernels live in :mod:`pygrid_tpu_torch.parallel.flash_attention`
(import ``flash_attention`` from there: the package attribute of that name
is the module)."""

from pygrid_tpu_torch.parallel.mesh import (
    client_sharding,
    initialize_distributed,
    make_mesh,
    replicated,
)
from pygrid_tpu_torch.parallel.fedavg import (
    make_round,
    make_scanned_rounds,
    make_sharded_round,
    run_rounds,
)
from pygrid_tpu_torch.parallel.fedavg_fused import (
    make_fused_round,
    make_fused_rounds,
    make_sharded_fused_round,
)
from pygrid_tpu_torch.parallel.ring_attention import (
    attention,
    ring_attention,
    ulysses_attention,
)
from pygrid_tpu_torch.parallel.pipeline import (
    make_pipeline_training_step,
    pipeline_apply,
    sequential_apply,
)
from pygrid_tpu_torch.parallel.distributed import (
    data_sharding,
    host_array,
    hybrid_mesh,
    local_batch_slice,
)
from pygrid_tpu_torch.parallel.fsdp import (
    make_fsdp_training_step,
    shard_params,
    unshard_params,
)
from pygrid_tpu_torch.parallel.secagg_sim import (
    make_sharded_masked_sum,
    mask_clients,
    masked_sum,
    simulate_secagg_round,
)

__all__ = [
    "attention",
    "client_sharding",
    "data_sharding",
    "host_array",
    "hybrid_mesh",
    "initialize_distributed",
    "local_batch_slice",
    "make_fsdp_training_step",
    "make_fused_round",
    "make_fused_rounds",
    "make_mesh",
    "make_pipeline_training_step",
    "make_round",
    "make_scanned_rounds",
    "make_sharded_fused_round",
    "make_sharded_masked_sum",
    "make_sharded_round",
    "mask_clients",
    "masked_sum",
    "pipeline_apply",
    "replicated",
    "ring_attention",
    "run_rounds",
    "sequential_apply",
    "shard_params",
    "simulate_secagg_round",
    "ulysses_attention",
    "unshard_params",
]
