"""Mesh-sharded SMPC (``smpc/sharded.py``) in a gloo world of 4 rank
processes (``torch_world.sharded_smpc``) against the JAX package's on a
4-device sub-mesh, mirroring ``tests/unit/test_smpc_sharded.py``: the open
is the exact mod-2^64 host sum (all-ones carries, 30 random share sets),
the combine on given triples and ``deal_triples`` for the same key are bit
for bit the JAX package's, and a full round opens to the ring product, on
a 4-rank party axis and on a party axis of one rank."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from pygrid_tpu.smpc import ring as JR
from pygrid_tpu.smpc.kernels import share_kernel
from pygrid_tpu.smpc.sharded import (
    deal_triples,
    make_sharded_beaver,
    make_sharded_open,
    party_sharding,
    sharded_beaver,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_world import world  # noqa: E402

P_, B = 8, 4


def _u64(r):
    return np.asarray(JR.from_ring(r))


def _vshare(key, values_u64, n_parties):
    """[B, ...] values → shares stacked [P, B, ...] (party-major)."""
    return jax.vmap(lambda v: share_kernel(key, v, n_parties), in_axes=0, out_axes=1)(
        JR.to_ring(values_u64))


def _beaver_inputs(op):
    shape = (6, 6) if op == "matmul" else (3, 7)
    kx, ky, kd = jax.random.split(jax.random.PRNGKey(42), 3)
    x = np.asarray(jax.random.randint(kx, (B,) + shape, 0, 1000, dtype=jnp.uint32)).astype(np.uint64)
    y = np.asarray(jax.random.randint(ky, (B,) + shape, 0, 1000, dtype=jnp.uint32)).astype(np.uint64)
    key = jax.random.fold_in(kd, 2)
    a_sh, b_sh, c_sh = deal_triples(key, shape, shape, P_, op=op, batch=B)
    out = {"x_sh": _vshare(jax.random.fold_in(kd, 0), x, P_),
           "y_sh": _vshare(jax.random.fold_in(kd, 1), y, P_),
           "a_sh": a_sh, "b_sh": b_sh, "c_sh": c_sh}
    out = {f"{op}_{k}": _u64(v) for k, v in out.items()}
    out[f"{op}_key"] = np.asarray(key)
    return out


def _round_inputs(prefix, P, B_, N, hi, seed, key):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, hi, size=(B_, N, N), dtype=np.uint64)
    y = rng.integers(0, hi, size=(B_, N, N), dtype=np.uint64)
    return {f"{prefix}_x": x, f"{prefix}_y": y,
            f"{prefix}_x_sh": _u64(_vshare(jax.random.fold_in(key, 0), x, P)),
            f"{prefix}_y_sh": _u64(_vshare(jax.random.fold_in(key, 1), y, P)),
            f"{prefix}_key": np.asarray(jax.random.fold_in(key, 2))}


def _inputs():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 2**64, size=(P_, 16), dtype=np.uint64)
    vals[0] = np.uint64(0xFFFFFFFFFFFFFFFF)  # all-ones limbs force maximal carries
    vals[1] = np.uint64(0xFFFF0001FFFF0001)
    out = {"open_vals": vals, "deal_key": np.asarray(jax.random.PRNGKey(11)),
           "seed_vals": np.stack([np.random.default_rng(s).integers(0, 2**64, size=(P_, 16),
                                                                    dtype=np.uint64)
                                  for s in range(30)])}
    out.update(_beaver_inputs("mul"))
    out.update(_beaver_inputs("matmul"))
    key = jax.random.PRNGKey(1)
    e2e = _round_inputs("e2e", P_, 2, 5, 2**16, 7, jax.random.fold_in(key, 10))
    e2e["e2e_key"] = np.asarray(jax.random.fold_in(key, 12))
    out.update(e2e)
    out.update(_round_inputs("one", 3, 2, 4, 2**20, 3, jax.random.PRNGKey(5)))
    return out


@pytest.fixture(scope="module")
def w(tmp_path_factory):
    return world(tmp_path_factory, "sharded_smpc", _inputs)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:4]), ("parties",))


def _place(mesh, *rings):
    sharding = party_sharding(mesh)
    return [jax.tree.map(lambda a: jax.device_put(a, sharding), r) for r in rings]


def _host_sum(rows):
    total = np.zeros(rows.shape[1:], np.uint64)
    for r in rows:
        total += r  # numpy's uint64 add wraps mod 2^64
    return total


def test_ring_psum_exact_collective_sum(w, mesh):
    vals = w.inputs["open_vals"]
    want = _u64(make_sharded_open(mesh)(*_place(mesh, JR.to_ring(vals))))
    np.testing.assert_array_equal(want, _host_sum(vals))
    for got in w.ranks("open_adversarial"):
        np.testing.assert_array_equal(got["total"], want)


@pytest.mark.parametrize("op", ["mul", "matmul"])
def test_sharded_beaver_matches_the_jax_mesh_kernel_bit_for_bit(w, mesh, op):
    inp = w.inputs
    rings = [JR.to_ring(inp[f"{op}_{n}"]) for n in ("x_sh", "y_sh", "a_sh", "b_sh", "c_sh")]
    want = _u64(make_sharded_beaver(mesh, op=op)(*_place(mesh, *rings)))
    for got in w.ranks(f"beaver_{op}"):
        np.testing.assert_array_equal(got["z"], want)
    # and it opens to the elementwise / matrix product of the secrets
    opened = _host_sum(want)
    x, y = _host_sum(inp[f"{op}_x_sh"]), _host_sum(inp[f"{op}_y_sh"])
    prod = x * y if op == "mul" else np.einsum("bij,bjk->bik", x, y)
    np.testing.assert_array_equal(opened, prod)


@pytest.mark.parametrize("op", ["mul", "matmul"])
def test_deal_triples_equal_the_jax_packages_for_the_same_key(w, op):
    inp = w.inputs
    got = w(f"beaver_{op}")
    for name in "abc":
        np.testing.assert_array_equal(got[name], inp[f"{op}_{name}_sh"])
    shape = (5, 5) if op == "matmul" else (3, 7)
    want = deal_triples(jnp.asarray(inp["deal_key"]), shape, shape, 3, op=op)
    unbatched = w("deal_unbatched")
    for name, t in zip("abc", want):
        np.testing.assert_array_equal(unbatched[f"{op}_{name}"], _u64(t))


def test_sharded_beaver_end_to_end_product(w, mesh):
    inp = w.inputs
    x_sh, y_sh = JR.to_ring(inp["e2e_x_sh"]), JR.to_ring(inp["e2e_y_sh"])
    want = _u64(sharded_beaver(mesh, jnp.asarray(inp["e2e_key"]), x_sh, y_sh))
    expected = np.einsum("bij,bjk->bik", inp["e2e_x"], inp["e2e_y"])  # u64 wraps mod 2^64
    for got in w.ranks("end_to_end"):
        np.testing.assert_array_equal(got["z"], want)
        np.testing.assert_array_equal(got["open"], expected)


def test_sharded_beaver_single_device_mesh(w):
    inp = w.inputs
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("parties",))
    x_sh, y_sh = JR.to_ring(inp["one_x_sh"]), JR.to_ring(inp["one_y_sh"])
    want = _u64(sharded_beaver(mesh1, jnp.asarray(inp["one_key"]), x_sh, y_sh))
    for got in w.ranks("single_device_mesh"):
        np.testing.assert_array_equal(got["z"], want)
        np.testing.assert_array_equal(got["open"],
                                      np.einsum("bij,bjk->bik", inp["one_x"], inp["one_y"]))


def test_property_ring_psum_matches_host_sum(w):
    """30 random 8-party share sets (full uint64 range, carry-heavy): the
    limb psum equals numpy's wrapping uint64 sum, always."""
    want = np.stack([_host_sum(v) for v in w.inputs["seed_vals"]])
    for got in w.ranks("open_property"):
        np.testing.assert_array_equal(got["totals"], want)
