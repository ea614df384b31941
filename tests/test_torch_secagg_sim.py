"""The single-chip half of the SecAgg simulation (``parallel/secagg_sim.py``)
against the JAX package's, on the CPU: the same keys give the same pairwise
masks bit for bit (the port's threefry against ``jax.random.bits``), so the
masked batch, its sum mod 2^32 and a whole simulated round are identical,
and the sum is the plain quantised sum (as ``tests/unit/test_secagg.py``
checks for the JAX package). The mesh path runs here on a world of one
rank."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygrid_tpu.parallel import secagg_sim as jsim
from pygrid_tpu_torch.federated import secagg
from pygrid_tpu_torch.parallel import secagg_sim
from pygrid_tpu_torch.utils import prng


def _key(seed):
    return prng.PRNGKey(seed, device="cpu")


def _plain_sum(q):
    expected = np.zeros(q.shape[1:], np.uint32)
    for row in q:
        np.add(expected, row, out=expected)
    return expected


@pytest.mark.parametrize("K, shape, seed", [(16, (33,), 7), (5, (4, 3), 2), (1, (8,), 0)])
def test_masks_and_masked_sum_are_bit_identical_to_the_jax_package(K, shape, seed):
    q = np.random.default_rng(4 + K).integers(0, 1 << 32, (K, *shape), dtype=np.uint32)
    jmasked = np.asarray(jsim.mask_clients(jax.random.PRNGKey(seed), jnp.asarray(q)))
    masked = secagg_sim.mask_clients(_key(seed), torch.from_numpy(q.astype(np.int64)))
    np.testing.assert_array_equal(masked.numpy().astype(np.uint32), jmasked)
    assert K == 1 or not np.array_equal(jmasked, q)  # the masks are not zero
    total = secagg_sim.masked_sum(_key(seed), q, device="cpu")
    assert total.dtype == torch.int64 and int(total.min()) >= 0 and int(total.max()) < 1 << 32
    np.testing.assert_array_equal(total.numpy().astype(np.uint32),
                                  np.asarray(jsim.masked_sum(jax.random.PRNGKey(seed),
                                                             jnp.asarray(q))))
    np.testing.assert_array_equal(total.numpy().astype(np.uint32), _plain_sum(q))


def test_simulated_round_is_bit_identical_to_the_jax_package():
    diffs = np.random.default_rng(6).normal(0, 0.01, (8, 5, 3)).astype(np.float32)
    got = secagg_sim.simulate_secagg_round(_key(1), diffs, clip_range=0.1, device="cpu")
    want = jsim.simulate_secagg_round(jax.random.PRNGKey(1), diffs, clip_range=0.1)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    step = 1.0 / secagg.choose_scale(0.1, 8)
    np.testing.assert_allclose(got, diffs.mean(0), atol=8 * step + 1e-8)
    from_tensor = secagg_sim.simulate_secagg_round(_key(1), torch.from_numpy(diffs), 0.1,
                                                   device="cpu")
    np.testing.assert_array_equal(from_tensor, want)


def test_the_mesh_path_waits_for_multi_device(tmp_path):
    """The mesh path no longer waits for multi-device: on a world of one
    gloo rank, ``make_sharded_masked_sum`` and ``simulate_secagg_round(mesh=)``
    are bit-identical to the single-device path and the JAX package's
    (``tests/test_torch_sharded_rounds.py`` runs them on a world of 4)."""
    import torch.distributed as dist

    from pygrid_tpu_torch.parallel import initialize_distributed, make_mesh

    diffs = np.random.default_rng(6).normal(0, 0.01, (8, 5, 3)).astype(np.float32)
    q = np.random.default_rng(5).integers(0, 1 << 32, (4, 17), dtype=np.uint32)
    initialize_distributed(init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0,
                           device="cpu")
    try:
        mesh = make_mesh(device="cpu")
        total = secagg_sim.make_sharded_masked_sum(mesh)(_key(9), q)
        np.testing.assert_array_equal(total.numpy().astype(np.uint32), _plain_sum(q))
        got = secagg_sim.simulate_secagg_round(_key(1), diffs, 0.1, mesh=mesh, device="cpu")
    finally:
        dist.destroy_process_group()
    want = jsim.simulate_secagg_round(jax.random.PRNGKey(1), diffs, clip_range=0.1)
    np.testing.assert_array_equal(got, want)
