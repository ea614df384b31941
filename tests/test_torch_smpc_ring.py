"""Port parity: the port's Z_2^64 ring (one int64 tensor per value) against
the JAX package's ``Ring64`` (uint32 limb pairs) and against numpy uint64.

The same numpy inputs go to both packages; the port runs on the CPU, where
``ring_matmul_kernel`` takes its plain version (float64 16-bit-limb
products). The JAX side's matmul is ``pallas_ring_matmul`` in interpret
mode, as tests/unit/test_pallas_kernels.py runs it. Ring arithmetic is
exact, so every comparison is bit for bit: no tolerance.
"""

import numpy as np
import pytest
import torch

from pygrid_tpu.smpc import ring as JR
from pygrid_tpu.smpc.pallas_kernels import pallas_ring_matmul
from pygrid_tpu_torch.smpc import ring as R
from pygrid_tpu_torch.smpc import ring_matmul as RM

torch.set_num_threads(1)

U64 = np.uint64
EDGES = np.array([0, 1, 2, 2**63 - 1, 2**63, 2**64 - 1], dtype=U64)


def _operands(seed=0, n_random=24):
    """Every pair of edge values, then random pairs: (a, b) uint64."""
    rng = np.random.default_rng(seed)
    ea, eb = np.meshgrid(EDGES, EDGES)
    ra = rng.integers(0, 2**64, size=n_random, dtype=U64)
    rb = rng.integers(0, 2**64, size=n_random, dtype=U64)
    return np.concatenate([ea.ravel(), ra]), np.concatenate([eb.ravel(), rb])


def _port(x):
    return R.to_ring(x, "cpu")


def _both(jax_fn, port_fn, *xs):
    """(JAX result, port result) as uint64 arrays."""
    j = JR.from_ring(jax_fn(*[JR.to_ring(x) for x in xs]))
    p = R.from_ring(port_fn(*[_port(x) for x in xs]))
    return j, p


@pytest.mark.parametrize(
    "name,truth",
    [
        ("add", lambda a, b: a + b),
        ("sub", lambda a, b: a - b),
        ("mul", lambda a, b: a * b),
    ],
)
def test_binary_ops_match_jax_and_numpy(name, truth):
    a, b = _operands()
    j, p = _both(getattr(JR, f"ring_{name}"), getattr(R, f"ring_{name}"), a, b)
    with np.errstate(over="ignore"):
        want = truth(a, b)
    np.testing.assert_array_equal(p, want)
    np.testing.assert_array_equal(p, j)


def test_neg_and_mul_const_match_jax_and_numpy():
    a, _ = _operands(1)
    j, p = _both(JR.ring_neg, R.ring_neg, a)
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(p, U64(0) - a)
    np.testing.assert_array_equal(p, j)
    for c in (0, 1, 3, -1, -7, 2**63, 2**64 - 1, 2**64 + 5, 123456789123456789):
        j, p = _both(lambda r: JR.ring_mul_const(r, c), lambda r: R.ring_mul_const(r, c), a)
        with np.errstate(over="ignore"):
            np.testing.assert_array_equal(p, a * U64(c % 2**64))
        np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 1000, 4096, 65521, 65535])
def test_div_const_unsigned_and_signed_match_jax_and_numpy(d):
    a, _ = _operands(2)
    j, p = _both(lambda r: JR.ring_div_const(r, d), lambda r: R.ring_div_const(r, d), a)
    np.testing.assert_array_equal(p, a // U64(d))
    np.testing.assert_array_equal(p, j)
    j, p = _both(
        lambda r: JR.ring_div_const_signed(r, d), lambda r: R.ring_div_const_signed(r, d), a
    )
    signed = [int(v) for v in a.view(np.int64)]
    # toward zero, taken mod 2^64
    want = np.array(
        [(-(-v // d) if v < 0 else v // d) % 2**64 for v in signed], dtype=U64
    )
    np.testing.assert_array_equal(p, want)
    np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("d", [0, -3, 2**16, 2**20])
def test_div_const_rejects_divisors_outside_16_bits_like_jax(d):
    x = np.arange(3, dtype=U64)
    with pytest.raises(ValueError):
        JR.ring_div_const(JR.to_ring(x), d)
    with pytest.raises(ValueError):
        R.ring_div_const(_port(x), d)
    with pytest.raises(ValueError):
        R.ring_div_const_signed(_port(x), d)


def test_host_conversion_round_trips_and_matches_jax():
    a, _ = _operands(3)
    t = _port(a)
    assert t.dtype == torch.int64 and t.shape == a.shape
    np.testing.assert_array_equal(R.from_ring(t), a)
    np.testing.assert_array_equal(R.from_ring_signed(t), JR.from_ring_signed(JR.to_ring(a)))
    # signed host ints wrap into the ring as in the reference
    v = np.array([-1, -(2**63), 5], dtype=np.int64)
    np.testing.assert_array_equal(R.from_ring(_port(v)), JR.from_ring(JR.to_ring(v)))
    assert R.from_ring(_port(np.uint64(7))).shape == ()


def test_ring_random_draws_the_full_range_reproducibly():
    g = torch.Generator().manual_seed(5)
    r = R.ring_random(g, (4096,))
    assert r.dtype == torch.int64 and r.shape == (4096,)
    u = R.from_ring(r)
    bits = np.array([(u >> U64(i)) & U64(1) for i in range(64)], dtype=np.float64)
    # every one of the 64 bits, the sign bit included, is set about half the time
    assert np.all(np.abs(bits.mean(axis=1) - 0.5) < 0.05), bits.mean(axis=1)
    again = R.ring_random(torch.Generator().manual_seed(5), (4096,))
    assert torch.equal(r, again)
    assert not torch.equal(r, R.ring_random(torch.Generator().manual_seed(6), (4096,)))


# --------------------------------------------------------------------------
# the ring matmul: the plain version against pallas_ring_matmul and numpy
# --------------------------------------------------------------------------


def _np_matmul(a, b):
    with np.errstate(over="ignore"):
        return np.matmul(a, b)


def _jax_matmul(a, b):
    return JR.from_ring(pallas_ring_matmul(JR.to_ring(a), JR.to_ring(b), interpret=True))


@pytest.mark.parametrize(
    "sa,sb",
    [
        ((1, 1), (1, 1)),
        ((4, 8), (8, 4)),
        ((33, 300), (300, 17)),
        ((3, 8, 8), (3, 8, 8)),
        ((2, 9, 130), (2, 130, 5)),
    ],
)
def test_plain_ring_matmul_matches_pallas_interpret_and_numpy(sa, sb):
    rng = np.random.default_rng(sum(sa) * 100 + sum(sb))
    a = rng.integers(0, 2**64, size=sa, dtype=U64)
    b = rng.integers(0, 2**64, size=sb, dtype=U64)
    got = R.from_ring(RM.ring_matmul_kernel(_port(a), _port(b)))
    np.testing.assert_array_equal(got, _np_matmul(a, b))
    np.testing.assert_array_equal(got, _jax_matmul(a, b))
    np.testing.assert_array_equal(R.from_ring(R.ring_matmul(_port(a), _port(b))), got)


def test_plain_ring_matmul_all_ones_carries_match_pallas():
    """All-ones operands, K = 1600: the most carries in every limb fold."""
    a = np.full((8, 1600), 2**64 - 1, dtype=U64)
    b = np.full((1600, 8), 2**64 - 1, dtype=U64)
    got = R.from_ring(RM.ring_matmul_reference(_port(a), _port(b)))
    np.testing.assert_array_equal(got, _np_matmul(a, b))
    np.testing.assert_array_equal(got, _jax_matmul(a, b))


def test_plain_ring_matmul_two_batch_axes_strides_and_k_chunks(monkeypatch):
    """4-D operands (a batch of party-stacked rounds), a stride-0 operand
    from ``expand``, a transposed operand, and K split into chunks."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 2**64, size=(2, 3, 5, 7), dtype=U64)
    b = rng.integers(0, 2**64, size=(2, 3, 7, 4), dtype=U64)
    want = _np_matmul(a, b)
    np.testing.assert_array_equal(R.from_ring(RM.ring_matmul_kernel(_port(a), _port(b))), want)
    d = rng.integers(0, 2**64, size=(2, 5, 7), dtype=U64)
    d_exp = _port(d).unsqueeze(1).expand(2, 3, 5, 7)
    assert d_exp.stride(1) == 0
    np.testing.assert_array_equal(
        R.from_ring(RM.ring_matmul_kernel(d_exp, _port(b))),
        _np_matmul(np.broadcast_to(d[:, None], (2, 3, 5, 7)), b),
    )
    bt = _port(np.ascontiguousarray(b.swapaxes(-1, -2))).transpose(-1, -2)
    np.testing.assert_array_equal(R.from_ring(RM.ring_matmul_kernel(_port(a), bt)), want)
    monkeypatch.setattr(RM, "CHUNK_K", 3)
    np.testing.assert_array_equal(R.from_ring(RM.ring_matmul_kernel(_port(a), _port(b))), want)


@pytest.mark.parametrize(
    "sa,sb",
    [
        ((4, 8), (7, 4)),         # contraction mismatch
        ((2, 4, 8), (3, 8, 4)),   # batch mismatch
        ((8,), (8,)),             # 1-D
        ((2, 4, 8), (8, 4)),      # two ranks
    ],
)
def test_ring_matmul_raises_the_value_errors_of_pallas(sa, sb):
    a, b = np.zeros(sa, dtype=U64), np.zeros(sb, dtype=U64)
    with pytest.raises(ValueError):
        pallas_ring_matmul(JR.to_ring(a), JR.to_ring(b), interpret=True)
    with pytest.raises(ValueError):
        RM.ring_matmul_kernel(_port(a), _port(b))
    with pytest.raises(ValueError):
        RM.ring_matmul_reference(_port(a), _port(b))


def test_ring_matmul_takes_int64_only_and_counts_no_cpu_launch():
    RM.reset_launch_counts()
    with pytest.raises(TypeError):
        RM.ring_matmul_kernel(torch.zeros(2, 2), torch.zeros(2, 2))
    RM.ring_matmul_kernel(torch.ones(2, 2, dtype=torch.int64), torch.ones(2, 2, dtype=torch.int64))
    assert RM.launch_counts() == {"ring_matmul": 0}


@pytest.mark.cuda
def test_ring_matmul_kernel_matches_plain_version_and_numpy_on_card():
    """The CUDA kernel against its plain version and numpy uint64 on the
    card, bit for bit: 2-D, ragged, batched, a stride-0 batch and two batch
    axes; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    cases = [((1, 1), (1, 1)), ((130, 600), (600, 70)), ((4, 9, 130), (4, 130, 5)),
             ((2, 3, 65, 64), (2, 3, 64, 66))]
    for sa, sb in cases:
        a = rng.integers(0, 2**64, size=sa, dtype=U64)
        b = rng.integers(0, 2**64, size=sb, dtype=U64)
        ta, tb = R.to_ring(a, "cuda"), R.to_ring(b, "cuda")
        RM.reset_launch_counts()
        got = RM.ring_matmul_kernel(ta, tb)
        torch.cuda.synchronize()
        assert RM.launch_counts() == {"ring_matmul": 1}
        assert torch.equal(got, RM.ring_matmul_reference(ta, tb))
        np.testing.assert_array_equal(R.from_ring(got), _np_matmul(a, b))
    d = R.to_ring(rng.integers(0, 2**64, size=(40, 33), dtype=U64), "cuda")
    b = R.to_ring(rng.integers(0, 2**64, size=(5, 33, 21), dtype=U64), "cuda")
    got = RM.ring_matmul_kernel(d.expand(5, 40, 33), b)
    assert torch.equal(got, RM.ring_matmul_reference(d.expand(5, 40, 33).contiguous(), b))
