"""Port parity: the port's SMPC plane (fixed point, protocol steps, crypto
provider, AdditiveSharingTensor) against the JAX package's, bit for bit.

Every random quantity a protocol step consumes (input shares, Beaver
triples, truncation pairs) is drawn once with numpy and injected into both
packages: the JAX side as ``Ring64`` values, the port's through
``convert.ring_from_numpy``; providers run with ``strict_store=True`` so
that nothing else is drawn. Both packages then compute the same ring
values, so shares are compared bit for bit and decoded outputs exactly.
The port runs on the CPU (its ring matmul takes the plain version).
"""

import numpy as np
import pytest
import torch

from pygrid_tpu.smpc import additive as JA
from pygrid_tpu.smpc import kernels as JK
from pygrid_tpu.smpc import ring as JR
from pygrid_tpu.smpc.fixed import FixedPointEncoder as JEncoder
from pygrid_tpu.smpc.provider import CryptoProvider as JProvider
from pygrid_tpu.smpc.provider import CryptoStore as JStore
from pygrid_tpu.utils.exceptions import EmptyCryptoPrimitiveStoreError as JEmpty
from pygrid_tpu_torch import convert
from pygrid_tpu_torch.smpc import (
    AdditiveSharingTensor,
    CryptoProvider,
    CryptoStore,
    FixedPointEncoder,
    fix_prec,
)
from pygrid_tpu_torch.smpc import kernels as K
from pygrid_tpu_torch.smpc import ring as R
from pygrid_tpu_torch.utils.exceptions import EmptyCryptoPrimitiveStoreError

torch.set_num_threads(1)

U64 = np.uint64
PARTIES = ("alice", "bob", "charlie")


def np_shares(rng, v, n=3):
    """``n`` additive uint64 shares of ``v``, stacked on axis 0."""
    v = np.asarray(v, dtype=U64)
    r = rng.integers(0, 2**64, size=(n - 1,) + v.shape, dtype=U64)
    with np.errstate(over="ignore"):
        return np.concatenate([r, (v - r.sum(axis=0, dtype=U64))[None]])


def np_triple(rng, op, sx, sy, n=3):
    a = rng.integers(0, 2**64, size=sx, dtype=U64)
    b = rng.integers(0, 2**64, size=sy, dtype=U64)
    with np.errstate(over="ignore"):
        c = a * b if op == "mul" else np.matmul(a, b)
    return [np_shares(rng, v, n) for v in (a, b, c)]


def np_trunc_pair(rng, shape, scale, n=3):
    r = rng.integers(0, 2**62, size=shape, dtype=U64)
    return [np_shares(rng, r, n), np_shares(rng, r // U64(scale), n)]


def jax_ring(x):
    return JR.to_ring(np.asarray(x, dtype=U64))


def port_ring(x):
    return R.to_ring(np.asarray(x, dtype=U64), "cpu")


def inject(jprov, pprov, key, arrays):
    """One primitive into both stores: JAX Ring64s, and the same values
    carried over by convert.ring_from_numpy."""
    item = tuple(jax_ring(a) for a in arrays)
    jprov.store.put(key, item)
    pprov.store.put(key, convert.ring_from_numpy(item, "cpu"))


def same_bits(jax_value, port_tensor):
    np.testing.assert_array_equal(R.from_ring(port_tensor), JR.from_ring(jax_value))


def providers(**kw):
    return JProvider(seed=0, **kw), CryptoProvider(seed=0, device="cpu", **kw)


# --------------------------------------------------------------------------
# fixed point
# --------------------------------------------------------------------------


def test_fixed_point_encoding_matches_jax():
    x = np.array([[1.5, -2.25, 0.0], [0.001, -0.999, 123.4567]])
    for base, prec in ((10, 3), (2, 12), (10, 0)):
        je, pe = JEncoder(base, prec), FixedPointEncoder(base, prec)
        same_bits(je.encode(x), pe.encode(x, "cpu"))
        np.testing.assert_array_equal(pe.decode(pe.encode(x, "cpu")), je.decode(je.encode(x)))
        same_bits(je.truncate(je.encode(x * 50)), pe.truncate(pe.encode(x * 50, "cpu")))
    # rounds half to even, as np.round
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5])
    assert list(FixedPointEncoder(10, 0).decode(FixedPointEncoder(10, 0).encode(halves, "cpu"))) \
        == [0.0, 2.0, 2.0, -0.0, -2.0, -2.0]
    for enc in (JEncoder, FixedPointEncoder):
        with pytest.raises(ValueError):
            enc(10, 5)  # scale 10^5 >= 2^16


# --------------------------------------------------------------------------
# protocol steps on stacked shares
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,dim", [(2, 0), (3, 0), (5, 0), (3, 1)])
def test_share_reconstruct_round_trip(n, dim):
    rng = np.random.default_rng(n)
    v = rng.integers(0, 2**64, size=(4, 5), dtype=U64)
    g = torch.Generator().manual_seed(n)
    sh = K.share_kernel(g, port_ring(v), n, dim=dim)
    assert sh.shape == ((n, 4, 5) if dim == 0 else (4, n, 5))
    np.testing.assert_array_equal(R.from_ring(K.reconstruct_kernel(sh, dim)), v)
    assert not torch.equal(sh.select(dim, 0), port_ring(v))


@pytest.mark.parametrize("op,sx,sy", [("mul", (4, 5), (4, 5)), ("matmul", (4, 6), (6, 5))])
def test_beaver_combine_matches_jax_bit_for_bit(op, sx, sy):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**64, size=sx, dtype=U64)
    y = rng.integers(0, 2**64, size=sy, dtype=U64)
    sh = [np_shares(rng, x), np_shares(rng, y)] + np_triple(rng, op, sx, sy)
    z_j = JK.beaver_combine(*[jax_ring(s) for s in sh], op)
    z_p = K.beaver_combine(*[port_ring(s) for s in sh], op)
    same_bits(z_j, z_p)
    with np.errstate(over="ignore"):
        want = x * y if op == "mul" else np.matmul(x, y)
    np.testing.assert_array_equal(R.from_ring(K.reconstruct_kernel(z_p)), want)


def test_masked_truncate_matches_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    scale = 1000
    z = rng.integers(-(2**40), 2**40, size=(4, 5)).astype(np.int64)
    z_sh = np_shares(rng, z.astype(U64))
    r_sh, rp_sh = np_trunc_pair(rng, z.shape, scale)
    out_j = JK.masked_truncate(jax_ring(z_sh), jax_ring(r_sh), jax_ring(rp_sh), scale)
    out_p = K.masked_truncate(port_ring(z_sh), port_ring(r_sh), port_ring(rp_sh), scale)
    same_bits(out_j, out_p)
    got = R.from_ring_signed(K.reconstruct_kernel(out_p))
    err = got - np.floor_divide(z, scale)
    assert set(np.unique(err)) <= {0, 1}


def test_reshare_truncated_opens_to_the_jax_value():
    rng = np.random.default_rng(3)
    z = rng.integers(-(2**50), 2**50, size=(4, 5)).astype(np.int64)
    z_sh = np_shares(rng, z.astype(U64))
    jprov, pprov = providers(trusted_dealer=True)
    out_j = JK.reconstruct_kernel(jprov.reshare_truncated(jax_ring(z_sh), 1000, 3))
    out_p = K.reconstruct_kernel(pprov.reshare_truncated(port_ring(z_sh), 1000, 3))
    same_bits(out_j, out_p)
    toward_zero = np.where(z < 0, -((-z) // 1000), z // 1000)
    np.testing.assert_array_equal(R.from_ring_signed(out_p), toward_zero)


@pytest.mark.parametrize("op,sx,sy", [("matmul", (5, 7), (7, 3)), ("mul", (6,), (6,))])
def test_batched_beaver_reconstructs_the_exact_product(op, sx, sy):
    rng = np.random.default_rng(4)
    B, P = 4, 3
    x = rng.integers(0, 2**64, size=(B,) + sx, dtype=U64)
    y = rng.integers(0, 2**64, size=(B,) + sy, dtype=U64)
    g = torch.Generator().manual_seed(4)
    x_sh = K.share_kernel(g, port_ring(x), P, dim=1)
    y_sh = K.share_kernel(g, port_ring(y), P, dim=1)
    z_sh = K.batched_beaver(g, x_sh, y_sh, op, P)
    assert z_sh.shape[:2] == (B, P)
    with np.errstate(over="ignore"):
        want = x * y if op == "mul" else np.matmul(x, y)
    np.testing.assert_array_equal(R.from_ring(K.reconstruct_kernel(z_sh, dim=1)), want)
    with pytest.raises(ValueError):
        K.batched_beaver(g, x_sh, y_sh, op, n_parties=4)


# --------------------------------------------------------------------------
# the class API
# --------------------------------------------------------------------------


def _forward(x, w1, b1, w2, b2):
    """examples/encrypted_inference.py's CryptoNets-style MLP, returning
    every intermediate: affine, square, affine."""
    h = x @ w1 + b1
    h2 = h * h
    return [h, h2, h2 @ w2 + b2]


def _shared_pair(rng, value, jprov, pprov):
    """The same fixed-point shares of ``value`` as a JAX and a port tensor."""
    sh = np_shares(rng, JR.from_ring(JEncoder().encode(value)))
    j = JA.AdditiveSharingTensor(jax_ring(sh), PARTIES, JEncoder(), jprov)
    p = AdditiveSharingTensor(port_ring(sh), PARTIES, FixedPointEncoder(), pprov)
    return j, p


def _mlp_inputs(rng, B=4, widths=(6, 5, 3)):
    x = rng.uniform(0, 1, (B, widths[0]))
    ws = []
    for n_in, n_out in zip(widths[:-1], widths[1:]):
        ws += [rng.standard_normal((n_in, n_out)) * (2.0 / n_in) ** 0.5,
               np.broadcast_to(rng.uniform(-0.2, 0.2, n_out), (B, n_out))]
    return [x] + ws


def test_encrypted_forward_matches_jax_bit_for_bit():
    """The 2-layer encrypted forward at small widths with every triple and
    truncation pair injected: the same shares after each step, the same
    decoded output, and close to the float64 plaintext."""
    rng = np.random.default_rng(5)
    B, widths = 4, (6, 5, 3)
    plain = _mlp_inputs(rng, B, widths)
    jprov, pprov = providers(strict_store=True)
    pairs = [_shared_pair(rng, v, jprov, pprov) for v in plain]
    scale = FixedPointEncoder().scale
    keys = []
    for op, sx, sy, trunc in (("matmul", (B, 6), (6, 5), (B, 5)),
                              ("mul", (B, 5), (B, 5), (B, 5)),
                              ("matmul", (B, 5), (5, 3), (B, 3))):
        keys += [JStore.key(op, sx, sy, 3), JStore.key("trunc", trunc, (scale,), 3)]
        inject(jprov, pprov, keys[-2], np_triple(rng, op, sx, sy))
        inject(jprov, pprov, keys[-1], np_trunc_pair(rng, trunc, scale))
    outs_j = _forward(*[j for j, _ in pairs])
    outs_p = _forward(*[p for _, p in pairs])
    for oj, op_ in zip(outs_j, outs_p):
        same_bits(oj.shares, op_.shares)
        np.testing.assert_array_equal(op_.get(), oj.get())
    assert not any(pprov.store.count(k) for k in keys)  # every injected primitive spent
    # fixed-point error: 1e-3 encodings and truncations through two layers
    np.testing.assert_allclose(outs_p[-1].get(), _forward(*plain)[-1], atol=3e-2)


#: seeds of shares and triples behind chip_smoke.MLP_JAX_ERR
MLP_SEEDS = 5


@pytest.mark.slow
def test_mlp_limit_is_what_the_jax_package_meets():
    """Where chip_smoke.py's encrypted-MLP limit comes from: chip_smoke's
    784→392→10 forward (batch 256, the inputs of ``mlp_plaintext``) through
    the JAX package, with a fresh provider and share keys per seed, decodes
    within MLP_JAX_ERR of float64 at worst over MLP_SEEDS seeds; the port
    on the CPU stays within MLP_ATOL on the same seeds. ``pytest -m slow -s``
    prints each seed's error (~30 s)."""
    import jax

    import chip_smoke

    plain = chip_smoke.mlp_plaintext()
    want = chip_smoke.mlp_forward(*plain)[-1]
    worst_j = worst_p = 0.0
    for seed in range(MLP_SEEDS):
        jprov = JProvider(seed=seed)
        shared = [JA.fix_prec(v).share(*PARTIES, crypto_provider=jprov,
                                       key=jax.random.PRNGKey(100 * seed + i))
                  for i, v in enumerate(plain)]
        err_j = float(np.abs(chip_smoke.mlp_forward(*shared)[-1].get() - want).max())
        pprov = CryptoProvider(seed=seed, device="cpu")
        g = torch.Generator().manual_seed(seed)
        shared = [fix_prec(v).share(*PARTIES, crypto_provider=pprov, generator=g, device="cpu")
                  for v in plain]
        err_p = float(np.abs(chip_smoke.mlp_forward(*shared)[-1].get() - want).max())
        print(f"seed {seed}: max abs err vs float64: JAX package {err_j:.6e}, port {err_p:.6e}")
        worst_j, worst_p = max(worst_j, err_j), max(worst_p, err_p)
    print(f"largest over {MLP_SEEDS} seeds: JAX package {worst_j:.6e}, port {worst_p:.6e}")
    assert worst_j <= chip_smoke.MLP_JAX_ERR
    assert worst_p <= chip_smoke.MLP_ATOL


def test_trusted_dealer_forward_decodes_like_jax():
    """With trusted_dealer=True each rescale re-shares with the provider's
    own randomness, so shares differ; the opened values are exact and equal."""
    rng = np.random.default_rng(6)
    plain = _mlp_inputs(rng)
    jprov, pprov = providers(strict_store=True, trusted_dealer=True)
    pairs = [_shared_pair(rng, v, jprov, pprov) for v in plain]
    for op, sx, sy in (("matmul", (4, 6), (6, 5)), ("mul", (4, 5), (4, 5)),
                       ("matmul", (4, 5), (5, 3))):
        inject(jprov, pprov, JStore.key(op, sx, sy, 3), np_triple(rng, op, sx, sy))
    for oj, op_ in zip(_forward(*[j for j, _ in pairs]), _forward(*[p for _, p in pairs])):
        np.testing.assert_array_equal(op_.get(), oj.get())


def test_share_local_ops_match_jax_bit_for_bit():
    rng = np.random.default_rng(7)
    jprov, pprov = providers()
    (jx, px), (jy, py) = (_shared_pair(rng, rng.uniform(-3, 3, (2, 3)), jprov, pprov)
                          for _ in range(2))
    c = np.array([1.25, -2.0, 0.5])
    for fj, fp in ((jx + jy, px + py), (jx - jy, px - py), (jx + c, px + c), (jx - c, px - c),
                   (jx * 3, px * 3), (jx * np.array([2, -3, 4]), px * np.array([2, -3, 4]))):
        same_bits(fj.shares, fp.shares)
    # integer shares without an encoder
    v = np.array([1, -2, 3000], dtype=np.int64)
    ast = AdditiveSharingTensor.share(v, PARTIES, pprov, device="cpu",
                                      generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(ast.get(), v)
    np.testing.assert_allclose(
        fix_prec(c).share(*PARTIES, crypto_provider=pprov, device="cpu").get(), c, atol=1e-3)


def test_class_api_errors_match_jax():
    jprov, pprov = providers()
    jx = JA.fix_prec(np.ones(2)).share("alice", "bob", crypto_provider=jprov)
    jy = JA.fix_prec(np.ones(2)).share(*PARTIES, crypto_provider=jprov)
    px = fix_prec(np.ones(2)).share("alice", "bob", crypto_provider=pprov, device="cpu")
    py = fix_prec(np.ones(2)).share(*PARTIES, crypto_provider=pprov, device="cpu")
    pz = AdditiveSharingTensor.share(np.ones(2, dtype=np.int64), PARTIES, pprov, device="cpu")
    jz = JA.AdditiveSharingTensor.share(np.ones(2, dtype=np.int64), PARTIES, jprov)
    cases = [
        (ValueError, lambda x, y, z: x + y),        # other parties
        (ValueError, lambda x, y, z: y + z),        # encoder against none
        (TypeError, lambda x, y, z: y * 0.5),       # float public multiplier
        (TypeError, lambda x, y, z: y @ np.ones((2, 2))),
    ]
    for exc, fn in cases:
        with pytest.raises(exc):
            fn(jx, jy, jz)
        with pytest.raises(exc):
            fn(px, py, pz)
    no_provider = fix_prec(np.ones(2)).share(*PARTIES, device="cpu")
    with pytest.raises(ValueError, match="crypto_provider"):
        _ = no_provider * no_provider
    with pytest.raises(ValueError, match="2 parties"):
        fix_prec(np.ones(2)).share("alice", device="cpu")
    with pytest.raises(ValueError, match="unknown triple op"):
        pprov.triple("conv", (2,), (2,), 3)


def test_strict_store_refill_raises_the_same_kwargs_as_jax():
    rng = np.random.default_rng(9)
    x, y = rng.uniform(-2, 2, (4, 6)), rng.uniform(-2, 2, (6, 5))
    jprov, pprov = providers(strict_store=True)
    jx, jy = (JA.fix_prec(v).share(*PARTIES, crypto_provider=jprov) for v in (x, y))
    px, py = (fix_prec(v).share(*PARTIES, crypto_provider=pprov, device="cpu") for v in (x, y))
    dry = []
    for _ in range(2):  # the triple first; with it, the rescale's truncation pair
        with pytest.raises(JEmpty) as ej:
            _ = jx @ jy
        with pytest.raises(EmptyCryptoPrimitiveStoreError) as ep:
            _ = px @ py
        kw = ep.value.kwargs_
        assert kw == ej.value.kwargs_
        dry.append(kw["op"])
        for prov in (jprov, pprov):
            prov.provide(kw["op"], tuple(kw["shapes"][0]), tuple(kw["shapes"][1]),
                         kw["n_parties"])
    assert dry == ["matmul", "trunc"]
    key = CryptoStore.key("matmul", (4, 6), (6, 5), 3)
    assert pprov.store.count(key) == 0  # the second try spent its triple
    for prov in (jprov, pprov):
        prov.provide(*key)
    np.testing.assert_allclose((px @ py).get(), x @ y, atol=2e-2)
    np.testing.assert_allclose((jx @ jy).get(), x @ y, atol=2e-2)


def test_bufferize_crosses_between_packages():
    rng = np.random.default_rng(8)
    jprov, pprov = providers()
    jx, px = _shared_pair(rng, np.array([[7.125, -3.5]]), jprov, pprov)
    jbuf, pbuf = jx._bufferize(), px._bufferize()
    assert set(pbuf) == set(jbuf)
    for k in ("lo", "hi"):
        assert pbuf[k].dtype == np.uint32
        np.testing.assert_array_equal(pbuf[k], jbuf[k])
    from_j = AdditiveSharingTensor._unbufferize(jbuf, device="cpu")
    np.testing.assert_array_equal(from_j.get(), jx.get())
    assert from_j.owners == PARTIES and from_j.crypto_provider_id == "crypto_provider"
    np.testing.assert_array_equal(JA.AdditiveSharingTensor._unbufferize(pbuf).get(), px.get())
    with pytest.raises(ValueError):
        convert.ring_from_numpy((jbuf["lo"].astype(np.int64), jbuf["hi"]), "cpu")
    assert [a.dtype for a in convert.ring_to_numpy(px.shares)] == [np.uint32, np.uint32]


def test_entry_points_without_device_cpu_raise_on_a_gpu_less_host():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        R.to_ring(np.arange(3))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        fix_prec(np.ones(2)).share(*PARTIES)
    provider = CryptoProvider(seed=1)  # exists without touching a device
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        provider.triple("matmul", (2, 2), (2, 2), 3)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        AdditiveSharingTensor._unbufferize(
            {"lo": np.zeros(2, np.uint32), "hi": np.zeros(2, np.uint32), "owners": PARTIES,
             "base": None, "precision": None})
