"""The port's collectives, meshes, ``parallel/distributed.py`` and
``ring.ring_psum`` in a gloo world of 4 rank processes (``torch_world.mesh``),
against the JAX package's ``lax`` collectives under ``shard_map`` on a
4-device sub-mesh of the 8 virtual CPU devices: every collective's value
and its gradient (the slice/gather pair at a program's edge, ``psum``'s
identity backward, a replicated input's psum backward, ``psum_scatter``,
``all_to_all`` and ``ppermute``), mirroring ``tests/unit/test_distributed.py``
for the hybrid mesh, and the exact mod-2^64 collective sum."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from pygrid_tpu.parallel.compat import shard_map
from pygrid_tpu.parallel.distributed import hybrid_mesh as jax_hybrid_mesh

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_world import world  # noqa: E402

RING = [(i, (i + 1) % 4) for i in range(4)]
CHAIN = [(0, 1), (1, 2), (2, 3)]


def _inputs():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    ring_parties = rng.integers(0, 2**64, size=(8, 16), dtype=np.uint64)
    ring_parties[0] = np.uint64(0xFFFFFFFFFFFFFFFF)  # all-ones limbs: maximal carries
    ring_parties[1] = np.uint64(0xFFFF0001FFFF0001)
    return {
        "x": f32(8, 6), "cot": f32(8, 6), "cot_block": f32(2, 6),
        "x_wide": f32(32, 6), "cot_scatter": f32(8, 6),
        "x_a2a": f32(16, 8), "cot_a2a": f32(64, 2),
        "x_hosts": np.arange(4.0, dtype=np.float32).reshape(2, 2),
        "local": np.arange(16.0, dtype=np.float32).reshape(4, 4),
        "ring_vals": rng.integers(0, 2**64, size=(4, 16), dtype=np.uint64),
        "ring_parties": ring_parties,
        "ring_seeds": np.stack([np.random.default_rng(s).integers(0, 2**64, size=(8, 16),
                                                                  dtype=np.uint64)
                                for s in range(30)]),
    }


@pytest.fixture(scope="module")
def w(tmp_path_factory):
    return world(tmp_path_factory, "mesh", _inputs)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:4]), ("i",))


def _jax_value_and_grad(f, x, cot):
    x = jnp.asarray(x)
    g = jax.grad(lambda x: (f(x) * cot).sum())(x)
    return np.asarray(f(x)), np.asarray(g)


def _check(got, f, x, cot, atol=1e-6):
    out, grad = _jax_value_and_grad(f, x, cot)
    np.testing.assert_allclose(got["out"], out, rtol=1e-6, atol=atol)
    np.testing.assert_allclose(got["grad"], grad, rtol=1e-6, atol=atol)


def test_psum_and_its_identity_backward(w, mesh):
    f = shard_map(lambda b: lax.psum(b, "i"), mesh=mesh, in_specs=P("i"), out_specs=P())
    _check(w("psum"), f, w.inputs["x"], w.inputs["cot_block"])


def test_pmean(w, mesh):
    f = shard_map(lambda b: lax.pmean(b, "i"), mesh=mesh, in_specs=P("i"), out_specs=P())
    _check(w("pmean"), f, w.inputs["x"], w.inputs["cot_block"])


def test_replicated_input_backward_is_a_psum(w, mesh):
    f = shard_map(lambda b: lax.psum(b * (lax.axis_index("i") + 1.0), "i"), mesh=mesh,
                  in_specs=P(), out_specs=P())
    _check(w("replicated_input"), f, w.inputs["x"], w.inputs["cot"])


def test_all_gather_backward_takes_the_own_block(w, mesh):
    f = shard_map(lambda b: lax.all_gather(b * (lax.axis_index("i") + 1.0), "i", tiled=True),
                  mesh=mesh, in_specs=P("i"), out_specs=P(), check_vma=False)
    _check(w("all_gather"), f, w.inputs["x"], w.inputs["cot"])


def test_psum_scatter(w, mesh):
    f = shard_map(lambda b: lax.psum_scatter(b, "i", tiled=True), mesh=mesh, in_specs=P("i"),
                  out_specs=P("i"))
    _check(w("psum_scatter"), f, w.inputs["x_wide"], w.inputs["cot_scatter"], atol=1e-5)


def test_all_to_all(w, mesh):
    f = shard_map(lambda b: lax.all_to_all(b, "i", 1, 0, tiled=True), mesh=mesh,
                  in_specs=P("i"), out_specs=P("i"))
    _check(w("all_to_all"), f, w.inputs["x_a2a"], w.inputs["cot_a2a"])


@pytest.mark.parametrize("name, perm", [("ppermute_ring", RING), ("ppermute_chain", CHAIN)])
def test_ppermute_and_its_inverse_backward(w, mesh, name, perm):
    f = shard_map(lambda b: lax.ppermute(b, "i", perm) * 2.0, mesh=mesh, in_specs=P("i"),
                  out_specs=P("i"))
    _check(w(name), f, w.inputs["x"], w.inputs["cot"])


def test_replicated_outputs_agree_on_every_rank(w):
    for name in ("psum", "pmean", "replicated_input", "all_gather", "ppermute_ring"):
        ranks = w.ranks(name)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["out"], ranks[0]["out"])
            np.testing.assert_array_equal(r["grad"], ranks[0]["grad"])


def test_axis_index_is_the_row_major_mesh_coordinate(w):
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("a", "b"))
    f = shard_map(lambda: jnp.stack([lax.axis_index("a"), lax.axis_index("b")])[None, None],
                  mesh=jmesh, in_specs=(), out_specs=P("a", "b"))
    want = np.asarray(f()).reshape(4, 2)  # device order: row-major over (a, b)
    for r in w.ranks("axis_index"):
        np.testing.assert_array_equal(r["index"], want[int(r["rank"])])
        np.testing.assert_array_equal(r["size"], [2, 2])


def test_make_mesh_checks_and_default_axis(w):
    got = w("make_mesh_checks")
    assert got["names"].tolist() == ["clients"] and got["shape"].tolist() == [4]


def test_make_mesh_needs_an_initialised_world():
    from pygrid_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="not initialised"):
        make_mesh(device="cpu")


def test_initialize_distributed_is_a_no_op_without_the_env(monkeypatch):
    import torch.distributed as dist

    from pygrid_tpu_torch.parallel import initialize_distributed

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert initialize_distributed(device="cpu") is None
    assert not dist.is_initialized()


def test_single_host_mesh_shape(w):
    jmesh = jax_hybrid_mesh(ici_axes=("model",), devices=jax.devices()[:4])
    got = w("hybrid_single_host")
    assert tuple(got["names"]) == jmesh.axis_names == ("data", "model")
    assert tuple(got["shape"]) == tuple(jmesh.devices.shape) == (1, 4)


def test_simulated_multihost_split(w):
    jmesh = jax_hybrid_mesh(ici_axes=("model",), ici_shape=(2,), num_hosts=2,
                            devices=jax.devices()[:4])
    got = w("hybrid_simulated_multihost")
    assert tuple(got["shape"]) == jmesh.devices.shape == (2, 2)
    np.testing.assert_array_equal(got["ranks"], [[d.id for d in row] for row in jmesh.devices])


def test_mesh_rejects_bad_split(w):
    with pytest.raises(ValueError):
        jax_hybrid_mesh(ici_axes=("model",), ici_shape=(3,), num_hosts=2,
                        devices=jax.devices()[:4])
    w("hybrid_rejects_bad_split")  # the port raised ValueError for both splits


def test_local_batch_slice(w):
    for rank, got in enumerate(w.ranks("local_batch_slice")):
        host = rank // 2
        assert got["slice"].tolist() == [16 * host, 16 * (host + 1)]


def test_data_sharding_psum_over_dcn_axis(w):
    jmesh = jax_hybrid_mesh(dcn_axis="hosts", ici_axes=("clients",), ici_shape=(2,),
                            num_hosts=2, devices=jax.devices()[:4])
    x = jnp.asarray(w.inputs["x_hosts"])
    want = shard_map(lambda x: lax.psum(x, "hosts"), mesh=jmesh, in_specs=P("hosts", "clients"),
                     out_specs=P(None, "clients"))(x)
    for got in w.ranks("data_sharding_psum_over_dcn_axis"):
        np.testing.assert_allclose(got["out"], np.asarray(want))


def test_host_array_roundtrip(w):
    local = w.inputs["local"]
    for got in w.ranks("host_array"):
        np.testing.assert_array_equal(got["one"], local)
        np.testing.assert_array_equal(got["whole"], local)
        np.testing.assert_array_equal(got["replicated"], local)


def _u64_sum(rows):
    total = np.zeros(rows.shape[1:], np.uint64)
    for r in rows:
        total += r  # numpy's uint64 add wraps mod 2^64
    return total


def test_ring_psum_is_the_exact_host_sum(w):
    inp = w.inputs
    for got in w.ranks("ring_psum"):
        np.testing.assert_array_equal(got["no_local"], _u64_sum(inp["ring_vals"]))
        np.testing.assert_array_equal(got["local"], _u64_sum(inp["ring_parties"]))
        np.testing.assert_array_equal(got["seeds"],
                                      np.stack([_u64_sum(v) for v in inp["ring_seeds"]]))


@pytest.mark.cuda
def test_mesh_programs_over_nccl_on_the_card(tmp_path):
    """On the card, a world of one NCCL rank: the sharded Beaver round
    launches the ring kernel 4 times and opens exactly, Ulysses with the
    flash kernel equals flash_attention, and ring_psum is exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: NCCL and the kernels run on the card only")
    import torch.distributed as dist

    from pygrid_tpu_torch.parallel import initialize_distributed, make_mesh, ulysses_attention
    from pygrid_tpu_torch.parallel import flash_attention as fa
    from pygrid_tpu_torch.smpc import ring as R
    from pygrid_tpu_torch.smpc import ring_matmul as rm
    from pygrid_tpu_torch.smpc.kernels import share_kernel
    from pygrid_tpu_torch.smpc.sharded import make_sharded_open, sharded_beaver
    from pygrid_tpu_torch.utils import prng

    initialize_distributed(init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0,
                           device="cuda")
    try:
        mesh = make_mesh(axes=("parties",))
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randint(0, 2**32, (4, 32, 32), generator=g, device="cuda")
        x_sh = share_kernel(g, x, 3)
        rm.reset_launch_counts()
        z = sharded_beaver(mesh, prng.PRNGKey(1), x_sh, x_sh)
        assert rm.launch_counts()["ring_matmul"] == 4
        assert torch.equal(make_sharded_open(mesh)(z), rm.ring_matmul_reference(x, x))
        vals = np.random.default_rng(0).integers(0, 2**64, size=(3, 8), dtype=np.uint64)
        total = R.ring_psum(R.to_ring(vals), mesh, "parties")
        np.testing.assert_array_equal(R.from_ring(total), vals.sum(axis=0, dtype=np.uint64))
        q = torch.randn(2, 128, 4, 64, generator=g, device="cuda").to(torch.bfloat16)
        seq = make_mesh(axes=("seq",))
        out = ulysses_attention(q, q, q, seq, causal=True, attn_fn=fa.flash_attention)
        assert torch.equal(out, fa.flash_attention(q, q, q, causal=True))
    finally:
        dist.destroy_process_group()
