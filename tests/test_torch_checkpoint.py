"""Port parity: pygrid_tpu_torch.checkpoint against pygrid_tpu.checkpoint.

Mirrors tests/unit/test_checkpoint.py: a list of tensors round-trips bit
for bit (dtype, shape and values), an empty list and a non-list refuse with
the same error type as the JAX package's, and an existing path is refused.
The JAX package writes orbax and the port torch.save, so the two formats do
not cross; what crosses is the parameter list, through the wire (the
retrieve, export, import, host loop of the reference's third case).
"""

import numpy as np
import pytest
import torch

from pygrid_tpu.utils.exceptions import PyGridError as JPyGridError
from pygrid_tpu_torch.checkpoint import PARAMS_FILE, export_checkpoint, import_checkpoint
from pygrid_tpu_torch.utils.exceptions import PyGridError


def _params():
    return [
        torch.arange(12, dtype=torch.float32).reshape(3, 4),
        torch.full((4,), 0.5),
        torch.arange(8, dtype=torch.float32).reshape(2, 2, 2),
        torch.randn(5, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16),
        torch.tensor(3, dtype=torch.int64),
    ]


def test_roundtrip(tmp_path):
    params = _params()
    export_checkpoint(params, tmp_path / "ckpt")
    back = import_checkpoint(tmp_path / "ckpt", device="cpu")
    assert len(back) == len(params)
    for a, b in zip(back, params):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    # numpy arrays export too, as the JAX package's list-of-arrays takes them
    export_checkpoint([np.arange(6, dtype=np.float32).reshape(2, 3)], tmp_path / "np")
    (x,) = import_checkpoint(tmp_path / "np", device="cpu")
    np.testing.assert_array_equal(x.numpy(), np.arange(6, dtype=np.float32).reshape(2, 3))
    with pytest.raises(FileExistsError):
        export_checkpoint(params, tmp_path / "ckpt")


def test_empty_and_non_list_rejected(tmp_path):
    from pygrid_tpu.checkpoint import export_checkpoint as j_export

    assert PyGridError.__name__ == JPyGridError.__name__
    with pytest.raises(PyGridError, match="nothing to export"):
        export_checkpoint([], tmp_path / "empty")
    with pytest.raises(JPyGridError, match="nothing to export"):
        j_export([], tmp_path / "empty_jax")
    (tmp_path / "odd").mkdir()
    torch.save({"not": "a list"}, tmp_path / "odd" / PARAMS_FILE)
    with pytest.raises(PyGridError, match="not a list"):
        import_checkpoint(tmp_path / "odd", device="cpu")


def test_checkpoint_of_a_wire_model_hosts_again(tmp_path):
    """retrieve -> export -> import -> host: the parameters of a model blob
    the JAX package wrote come back from the port's checkpoint bit for bit,
    and serialize again to a blob the JAX package reads as the same list."""
    from pygrid_tpu.plans.state import serialize_model_params as j_serialize
    from pygrid_tpu.plans.state import unserialize_model_params as j_unserialize
    from pygrid_tpu_torch.plans.state import serialize_model_params, unserialize_model_params

    rng = np.random.default_rng(2)
    params = [rng.standard_normal((6, 4)).astype(np.float32), np.zeros(4, np.float32)]
    retrieved = unserialize_model_params(j_serialize(params), device="cpu")
    export_checkpoint(retrieved, tmp_path / "mlp")
    hosted = serialize_model_params(import_checkpoint(tmp_path / "mlp", device="cpu"))
    for a, b in zip(j_unserialize(hosted), params):
        np.testing.assert_array_equal(a, b)
