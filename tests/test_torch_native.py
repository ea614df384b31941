"""Port parity: pygrid_tpu_torch.native against the JAX package's native
library, in both of the port's backends (the compiled C++ and the numpy
fallback, which uses bit arithmetic where the JAX package uses ml_dtypes).

Mirrors tests/unit/test_native.py case for case, and holds every result bit
for bit to the JAX package's compiled path (and, for bf16, to ml_dtypes):
XOR masking, f32 -> bf16 round-to-nearest-even with its ties, NaN, inf and
subnormals, bf16 -> f32, the f64 accumulate folds and base64.
"""

from __future__ import annotations

import base64

import ml_dtypes
import numpy as np
import pytest

import pygrid_tpu.native as jnative
import pygrid_tpu_torch.native as native
from pygrid_tpu_torch.plans.state import serialize_model_params, unserialize_model_params
from pygrid_tpu_torch.serde import deserialize, serialize

BACKENDS = ["native", "numpy"]


@pytest.fixture(params=BACKENDS)
def backend(request, monkeypatch):
    """The port's module in one of its two backends."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "_lib", None)
    return request.param


def _f32_cases(n=8192, seed=7):
    """Normals over 60 decades, then the edges: signed zeros, infinities,
    NaNs (quiet, signalling, with payloads, negative), subnormals, the
    largest finite value, and exact round-to-even ties in both directions."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * 10.0 ** rng.integers(-30, 30, n)).astype(np.float32)
    edges = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 1.0,
                      3.4028235e38, -3.4028235e38, 1.17549435e-38], dtype=np.float32)
    bits = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FA00000, 0xFFFFFFFF,
                     0x3F808000,  # 1 + 2^-8: a tie, rounds down to even
                     0x3F818000,  # 1 + 3·2^-8: a tie, rounds up to even
                     0x3F808001, 0x3F807FFF, 0x7F7F8000, 0x00008000, 0x80018000],
                    dtype=np.uint32).view(np.float32)
    return np.concatenate([edges, bits, x])


def test_native_backend_compiled():
    """g++ is on the host, so the compiled path is live in both packages."""
    assert native.BACKEND == "native" and jnative.BACKEND == "native"


@pytest.mark.parametrize("size", [0, 1, 3, 4, 7, 8, 63, 1024, 4099])
def test_xor_mask_roundtrip_and_parity(size, backend):
    rng = np.random.default_rng(size)
    data = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
    mask = bytes(rng.integers(0, 256, size=4, dtype=np.uint8))
    masked = bytes(native.xor_mask(data, mask))
    assert masked == bytes(jnative.xor_mask(data, mask))
    assert bytes(native.xor_mask(masked, mask)) == data
    buf = bytearray(b"head" + data)
    native.xor_mask_inplace(buf, mask, offset=4)
    assert bytes(buf) == b"head" + masked
    with pytest.raises(ValueError):
        native.xor_mask(data, b"abc")


def test_xor_mask_unaligned_buffer_offsets(backend):
    data = bytes(range(256)) * 3
    mask = b"\xde\xad\xbe\xef"
    expect = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
    assert bytes(native.xor_mask(data, mask)) == expect


def test_f32_to_bf16_matches_jax_package_and_ml_dtypes(backend):
    """Bit for bit against the JAX package's compiled path on every value,
    NaN payloads included; against ml_dtypes on every value but NaNs with
    a payload (ml_dtypes makes every NaN the canonical 0x7fc0, the C++ of
    both packages keeps the payload's top bits and quiets it)."""
    x = _f32_cases()
    got = native.f32_to_bf16(x)
    np.testing.assert_array_equal(got, jnative.f32_to_bf16(x))
    truth = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan], truth[~nan])
    assert np.isnan(got[nan].view(ml_dtypes.bfloat16).astype(np.float32)).all()
    assert ((got[nan] >> 15) == (x[nan].view(np.uint32) >> 31)).all()  # sign kept
    # an unaligned view (a wire buffer at an odd offset) converts the same
    raw = bytearray(b"\x00" + x[:64].tobytes())
    odd = np.frombuffer(raw, dtype=np.float32, offset=1)
    np.testing.assert_array_equal(native.f32_to_bf16(odd), got[:64])


def test_bf16_to_f32_exact(backend):
    bits = np.arange(0, 2**16, dtype=np.uint16)
    got = native.bf16_to_f32(bits)
    np.testing.assert_array_equal(got.view(np.uint32), jnative.bf16_to_f32(bits).view(np.uint32))
    truth = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(got, truth)


def test_wire_bf16_halves_payload_and_roundtrips(backend):
    x = np.random.default_rng(0).normal(size=(256, 128)).astype(np.float32)
    full = serialize(x)
    half = serialize(x, bf16_floats=True)
    assert len(half) < len(full) * 0.55
    back = deserialize(half)
    assert back.dtype == np.float32 and back.shape == x.shape
    np.testing.assert_array_equal(back, x.astype(ml_dtypes.bfloat16).astype(np.float32))
    ints = np.arange(10, dtype=np.int64)
    np.testing.assert_array_equal(deserialize(serialize(ints, bf16_floats=True)), ints)


def test_model_params_bf16_wire(backend):
    params = [
        np.random.default_rng(1).normal(size=(784, 392)).astype(np.float32),
        np.zeros(392, np.float32),
    ]
    blob = serialize_model_params(params, bf16=True)
    assert len(blob) < len(serialize_model_params(params)) * 0.55
    out = unserialize_model_params(blob, device="cpu")
    for a, b in zip(out, params):
        assert a.dtype.is_floating_point and a.element_size() == 4
        np.testing.assert_array_equal(a.numpy(), b.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_accum_f32_matches_numpy_fold_and_jax_package(backend):
    rng = np.random.default_rng(7)
    acc = np.zeros((97, 13), np.float64)
    jacc, ref = acc.copy(), acc.copy()
    for w in (1.0, 0.25, 3.5):
        src = rng.normal(size=(97, 13)).astype(np.float32)
        native.accum_f32(acc, src, w)
        jnative.accum_f32(jacc, src, w)
        ref += w * src.astype(np.float64)
    np.testing.assert_array_equal(acc, ref)  # bit-exact: the same f64 ops
    np.testing.assert_array_equal(acc, jacc)


def test_accum_f32_accepts_raw_buffer(backend):
    src = np.arange(64, dtype=np.float32)
    acc = np.zeros(64, np.float64)
    native.accum_f32(acc, memoryview(src.tobytes()))
    np.testing.assert_array_equal(acc, src.astype(np.float64))
    with pytest.raises(ValueError):
        native.accum_f32(np.zeros(3, np.float64), src)


def test_accum_bf16_matches_decode_then_fold(backend):
    rng = np.random.default_rng(9)
    bits = jnative.f32_to_bf16(rng.normal(size=801).astype(np.float32))
    acc = np.full(801, 0.5, np.float64)
    jacc = acc.copy()
    ref = acc + 2.0 * jnative.bf16_to_f32(bits).astype(np.float64)
    native.accum_bf16(acc, bits.tobytes(), 2.0)
    jnative.accum_bf16(jacc, bits.tobytes(), 2.0)
    np.testing.assert_array_equal(acc, ref)
    np.testing.assert_array_equal(acc, jacc)
    with pytest.raises(ValueError):
        native.accum_bf16(np.zeros(3, np.float64), bits)


def test_b64_decode_roundtrip_all_pad_lengths(backend):
    rng = np.random.default_rng(3)
    for n in list(range(0, 12)) + [1000, 4096, 123_457]:
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        encoded = base64.b64encode(payload)
        assert native.b64_decode(encoded) == payload
        assert native.b64_decode(encoded.decode()) == payload
        assert bytes(native.b64_decode_view(encoded.decode())) == payload
        assert native.b64_decode(encoded) == jnative.b64_decode(encoded)


def test_b64_decode_rejects_malformed(backend):
    for bad in (b"abc", b"a===", b"ab=c", b"!!!!", b"aGk\n", "péz="):
        with pytest.raises((ValueError, UnicodeEncodeError)):
            native.b64_decode(bad)
        with pytest.raises((ValueError, UnicodeEncodeError)):
            jnative.b64_decode(bad)

