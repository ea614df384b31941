"""Port parity: pygrid_tpu_torch.serde (with its own msgpack, packer.py)
against pygrid_tpu.serde, byte for byte.

Mirrors tests/unit/test_serde.py and tests/unit/test_wire_v2.py (all but
the federated model-blob cache and the client's codec check, whose modules
are not ported yet), then holds the two packages to each other: for every
object drawn (nested structures, ndarrays of every dtype including 0-d,
States with fixed PlaceHolder ids, bf16_floats), the port's bytes equal the
JAX package's and each package decodes the other's blobs; the port's
msgpack writer equals ``msgpack.packb(obj, use_bin_type=True)`` and its
reader raises ValueError on truncated and garbage input where msgpack
does; wire-v2 frames cross in both directions; a shared tensor crosses in
both directions and opens to the same integers.
"""

from __future__ import annotations

import zlib

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from pygrid_tpu import serde as J
from pygrid_tpu.plans import PlaceHolder as JPlaceHolder
from pygrid_tpu.plans import State as JState
from pygrid_tpu.plans.state import serialize_model_params as j_serialize_params
from pygrid_tpu_torch import serde
from pygrid_tpu_torch.plans import PlaceHolder, State
from pygrid_tpu_torch.plans.state import serialize_model_params, unserialize_model_params
from pygrid_tpu_torch.serde import packer
from pygrid_tpu_torch.serde import wire as wire_mod

torch.set_num_threads(1)

DTYPES = [np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32,
          np.uint64, np.float16, np.float32, np.float64, np.complex64, np.complex128]
SETTINGS = settings(max_examples=60, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])


def _same_wire(obj, bf16=False):
    """The port writes the JAX package's bytes, and each package decodes
    the other's blob to an object it writes back to those bytes."""
    blob = serde.serialize(obj, bf16_floats=bf16)
    assert blob == J.serialize(obj, bf16_floats=bf16)
    assert J.serialize(serde.deserialize(blob, device="cpu")) == J.serialize(J.deserialize(blob))
    assert serde.serialize(J.deserialize(blob)) == serde.serialize(
        serde.deserialize(blob, device="cpu"))
    return blob


# --------------------------------------------------------------------------
# test_serde.py, case for case
# --------------------------------------------------------------------------


def test_scalar_and_structure_roundtrip():
    obj = {"a": 1, "b": [1.5, "x", None, True], "c": {"nested": [1, 2]}}
    assert serde.deserialize(serde.serialize(obj)) == obj
    _same_wire(obj)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint32, np.uint8, np.bool_, np.int8])
def test_ndarray_roundtrip(dtype):
    arr = (np.arange(24).reshape(2, 3, 4) % 2).astype(dtype)
    out = serde.deserialize(serde.serialize(arr))
    assert out.dtype == arr.dtype and out.shape == arr.shape
    np.testing.assert_array_equal(out, arr)
    _same_wire(arr)


def test_zero_dim_array_roundtrip():
    arr = np.asarray(np.float32(3.5))
    out = serde.deserialize(serde.serialize(arr))
    assert out.shape == () and out == np.float32(3.5)
    _same_wire(arr)


def test_torch_tensor_serializes_as_its_ndarray():
    """A torch tensor (the JAX package's jax.Array case) writes the bytes
    of its numpy copy, and decodes as numpy."""
    x = torch.arange(6.0).reshape(2, 3)
    out = serde.deserialize(serde.serialize(x))
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, x.numpy())
    assert serde.serialize(x) == J.serialize(x.numpy())
    assert serde.serialize(x.t()) == J.serialize(np.ascontiguousarray(x.t().numpy()))
    assert serde.serialize(torch.tensor(2)) == J.serialize(np.asarray(np.int64(2)))


def test_bf16_tensor_writes_the_ml_dtypes_bytes_and_decodes_as_void():
    """The quirk the port keeps: the JAX package writes an ml_dtypes
    bfloat16 array with dtype string '<V2' and either package decodes it as
    raw void '|V2'; a torch.bfloat16 tensor writes the same bytes."""
    x = np.array([[1.5, -2.0, 3.25]], dtype=np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    blob = serde.serialize(t)
    assert blob == J.serialize(x.astype(ml_dtypes.bfloat16))
    assert b"<V2" in blob
    for out in (serde.deserialize(blob), J.deserialize(blob)):
        assert out.dtype == np.dtype("|V2") and out.shape == (1, 3)
        np.testing.assert_array_equal(out.view(np.uint16), t.view(torch.int16).numpy().view(np.uint16))
    # bf16_floats=True leaves a bf16 tensor as it is: only float32 shrinks
    assert serde.serialize(t, bf16_floats=True) == blob


def test_placeholder_and_state_roundtrip():
    ph = PlaceHolder(np.ones((2, 2), np.float32), tags={"#x"}, description="d")
    out = serde.deserialize(serde.serialize(ph))
    assert out.id == ph.id and out.tags == {"#x"} and out.description == "d"
    np.testing.assert_array_equal(out.tensor, ph.tensor)
    state = State.from_tensors([np.ones(3), np.zeros((2, 2))])
    out = serde.deserialize(serde.serialize(state))
    assert isinstance(out, State) and len(out) == 2
    assert [p.id for p in out.state_placeholders] == [p.id for p in state.state_placeholders]


def test_model_params_serde():
    params = [torch.randn(4, 3), torch.zeros(3), torch.randn(5).to(torch.bfloat16)]
    out = unserialize_model_params(serialize_model_params(params), device="cpu")
    assert len(out) == 3
    for a, b in zip(params, out):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np_params = [p.numpy() for p in params[:2]]
    assert serialize_model_params(np_params) != j_serialize_params(np_params)  # random ids
    out = unserialize_model_params(j_serialize_params(np_params), device="cpu")
    for a, b in zip(np_params, out):
        np.testing.assert_array_equal(a, b.numpy())


def test_deserialized_arrays_are_readonly_views_by_default():
    view = serde.deserialize(serde.serialize(np.zeros((2, 2), np.float32)))
    assert not view.flags.writeable


def test_deserialize_copy_returns_writable_arrays():
    out = serde.deserialize(serde.serialize(np.zeros((2, 2), np.float32)), copy=True)
    out[0, 0] = 5.0
    assert out[0, 0] == 5.0


def test_placeholder_ids_collision_safe():
    ids = {PlaceHolder().id for _ in range(1000)}
    assert len(ids) == 1000 and all(i.bit_length() <= 63 for i in ids)


def test_hex_wrappers():
    obj = {"model": np.arange(4)}
    np.testing.assert_array_equal(serde.from_hex(serde.to_hex(obj))["model"], np.arange(4))
    assert serde.to_hex(obj) == J.to_hex(obj)
    np.testing.assert_array_equal(J.from_hex(serde.to_hex(obj))["model"], np.arange(4))


def test_unknown_type_raises():
    class Foo:
        pass

    with pytest.raises(TypeError):
        serde.serialize(Foo())
    with pytest.raises(TypeError):
        serde.serialize({"big": 2**64})  # past uint64, as msgpack refuses
    with pytest.raises(TypeError, match="unknown wire type"):
        serde.deserialize(packer.packb(packer.ExtType(
            wire_mod.EXT_OBJECT, packer.packb("no.such.Type") + packer.packb({}))))


def test_state_raw_tensors_zero_copy_fast_path():
    rng = np.random.default_rng(0)
    params = [rng.normal(size=(784, 392)).astype(np.float32), np.zeros(392, np.float32),
              np.float32(3.25).reshape(())]
    for bf16 in (False, True):
        blob = serialize_model_params(params, bf16=bf16)
        raws = serde.state_raw_tensors(blob)
        jraws = J.state_raw_tensors(blob)
        assert raws is not None and len(raws) == 3
        for rt, jrt, p in zip(raws, jraws, params):
            assert rt.shape == p.shape and rt.kind == ("bf16" if bf16 else "<f4")
            assert (rt.kind, rt.shape, bytes(rt.raw)) == (jrt.kind, jrt.shape, bytes(jrt.raw))
        assert isinstance(raws[0].raw, memoryview)


def test_state_raw_tensors_rejects_non_state():
    assert serde.state_raw_tensors(serde.serialize({"not": "a state"})) is None
    assert serde.state_raw_tensors(b"\x00garbage") is None
    assert serde.state_raw_tensors(b"") is None
    assert serde.state_raw_tensors(serde.serialize({"__pygrid_sparse_diff__": True})) is None


def test_state_raw_tensors_consistent_with_decode():
    params = [np.arange(24, dtype=np.float32).reshape(4, 6)]
    blob = serialize_model_params(params)
    raws = serde.state_raw_tensors(blob)
    decoded = unserialize_model_params(blob, device="cpu")
    got = np.frombuffer(raws[0].raw, np.float32).reshape(raws[0].shape)
    np.testing.assert_array_equal(got, decoded[0].numpy())


# --------------------------------------------------------------------------
# test_wire_v2.py, case for case (the federated and client cases wait for
# their modules)
# --------------------------------------------------------------------------

SHAPES = [(), (1,), (7,), (3, 5), (2, 3, 4), (1, 1, 1, 6), (0, 4)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_])
def test_roundtrip_dtype_shape(dtype):
    rng = np.random.default_rng(42)
    for shape in SHAPES:
        arr = np.asarray((rng.standard_normal(shape) * 10).astype(dtype))
        out = serde.deserialize(serde.serialize({"t": arr}))["t"]
        assert out.dtype == arr.dtype and out.shape == arr.shape
        np.testing.assert_array_equal(out, arr)
        _same_wire({"t": arr})


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("codec", [None] + list(serde.available_codecs()))
def test_state_roundtrip_through_frames(bf16, codec):
    rng = np.random.default_rng(7)
    for shapes in ([(4, 3), (3,)], [(17,)], [(2, 2, 2), (1,), (5, 1)]):
        params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        blob = serialize_model_params(params, bf16=bf16)
        out = unserialize_model_params(bytes(serde.decode_frame(serde.encode_frame(blob, codec))),
                                       device="cpu")
        for got, want in zip(out, params):
            assert got.shape == want.shape
            want = want.astype(ml_dtypes.bfloat16).astype(np.float32) if bf16 else want
            np.testing.assert_array_equal(got.numpy(), want)


def test_state_fast_path_preserves_placeholder_identity():
    ph = PlaceHolder(tensor=np.arange(6, dtype=np.float32).reshape(2, 3), id=1234567,
                     tags={"a", "b"}, description="weights")
    out = serde.deserialize(serde.serialize(State([ph])))
    assert isinstance(out, State)
    got = out.state_placeholders[0]
    assert (got.id, got.tags, got.description) == (1234567, {"a", "b"}, "weights")
    np.testing.assert_array_equal(got.tensor, ph.tensor)


def test_deserialize_views_are_read_only_and_zero_copy():
    blob = serialize_model_params([np.random.rand(64, 32).astype(np.float32)])
    before = serde.tensor_copy_count()
    tensors = serde.deserialize(blob).tensors()
    assert serde.tensor_copy_count() == before
    assert not tensors[0].flags.writeable
    with pytest.raises((ValueError, RuntimeError)):
        tensors[0][0, 0] = 1.0
    assert tensors[0].base is not None


def test_deserialize_copy_opt_in_is_writable_and_counted():
    blob = serde.serialize({"x": np.random.rand(8, 8).astype(np.float32)})
    before = serde.tensor_copy_count()
    out = serde.deserialize(blob, copy=True)["x"]
    assert serde.tensor_copy_count() == before + 1
    out[0, 0] = 42.0
    assert out[0, 0] == 42.0


def test_transformer_sized_checkpoint_decodes_with_zero_copies():
    rng = np.random.default_rng(3)
    shapes = [(8192, 64), (64, 192), (192,), (64, 256), (256, 64), (64, 8192)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    blob = serialize_model_params(params)
    before = serde.tensor_copy_count()
    out = serde.deserialize(blob)
    assert serde.tensor_copy_count() == before
    for got, want in zip(out.tensors(), params):
        np.testing.assert_array_equal(got, want)


def test_frame_raw_is_zero_copy_view():
    frame = serde.encode_frame(b"x" * 1000)
    assert frame[0] == wire_mod.FRAME_RAW
    body = serde.decode_frame(frame)
    assert isinstance(body, memoryview) and bytes(body) == b"x" * 1000


def test_frame_compression_only_when_it_wins():
    compressible = b"\x00" * 100_000
    frame = serde.encode_frame(compressible, "zlib")
    assert frame[0] == wire_mod.FRAME_ZLIB and len(frame) < 1000
    assert bytes(serde.decode_frame(frame)) == compressible
    noisy = np.random.default_rng(0).bytes(100_000)
    assert serde.encode_frame(noisy, "zlib")[0] == wire_mod.FRAME_RAW
    assert serde.encode_frame(b"\x00" * 100, "zlib")[0] == wire_mod.FRAME_RAW


def test_frame_rejects_garbage():
    for bad in (b"", b"\x7fjunk", bytes([wire_mod.FRAME_ZLIB]) + b"not-zlib",
                bytes([wire_mod.FRAME_RAW | wire_mod.FRAME_TRACE_FLAG]) + b"short"):
        with pytest.raises(ValueError):
            serde.decode_frame(bad)
        with pytest.raises(ValueError):
            J.decode_frame(bad)


def test_truncated_zlib_frame_is_typed_error():
    whole = zlib.compress(b"\x01" * 10_000)
    with pytest.raises(ValueError):
        serde.decode_frame(bytes([wire_mod.FRAME_ZLIB]) + whole[: len(whole) // 2])


def test_decompression_bomb_capped(monkeypatch):
    monkeypatch.setattr(wire_mod, "MAX_DECOMPRESSED_BYTES", 4096)
    bomb = bytes([wire_mod.FRAME_ZLIB]) + zlib.compress(b"\x00" * 1_000_000)
    with pytest.raises(ValueError):
        serde.decode_frame(bomb)


def test_wire_version_bumped():
    assert serde.WIRE_VERSION == J.WIRE_VERSION >= 2


def test_offer_and_select_matrix():
    """The negotiation helpers give the JAX package's answers for every
    offer and selection."""
    for codec in ("auto", None, *serde.available_codecs()):
        assert serde.offered_subprotocols(codec) == J.offered_subprotocols(codec)
    with pytest.raises(ValueError):
        serde.offered_subprotocols("nope")
    v2, tr = serde.WS_SUBPROTOCOL_V2, serde.WS_SUBPROTOCOL_V2_TRACE
    for proto in (None, "", "graphql-ws", v2, tr, f"{v2}+zlib", f"{tr}+zlib", f"{v2}+zstd",
                  f"{tr}+zstd", f"{v2}+brotli", f"{tr}+brotli"):
        assert serde.subprotocol_codec(proto) == J.subprotocol_codec(proto)
        assert serde.subprotocol_traced(proto) == J.subprotocol_traced(proto)
    assert serde.offered_subprotocols(None) == [tr, v2]


# --------------------------------------------------------------------------
# the two packages against each other
# --------------------------------------------------------------------------

_leaf = st.one_of(
    st.none(), st.booleans(), st.integers(-(2**63), 2**64 - 1),
    st.floats(allow_nan=True, allow_infinity=True), st.text(max_size=40),
    st.binary(max_size=300),
)
_arrays = st.sampled_from(DTYPES).flatmap(
    lambda dt: hnp.arrays(dt, hnp.array_shapes(min_dims=0, max_dims=3, min_side=0, max_side=5)))
_objects = st.recursive(
    st.one_of(_leaf, _arrays),
    lambda kids: st.one_of(
        st.lists(kids, max_size=5), st.tuples(kids, kids),
        st.dictionaries(st.one_of(st.text(max_size=8), st.integers(-5, 300)), kids, max_size=5)),
    max_leaves=12,
)


@SETTINGS
@given(obj=_objects, bf16=st.booleans())
def test_drawn_objects_have_the_jax_package_bytes_both_ways(obj, bf16):
    _same_wire(obj, bf16)


@SETTINGS
@given(arr=_arrays)
def test_drawn_arrays_decode_in_either_package_to_the_same_array(arr):
    blob = _same_wire(arr)
    for out in (serde.deserialize(blob), J.deserialize(blob), serde.deserialize(blob, copy=True)):
        assert out.dtype == arr.dtype and out.shape == arr.shape
        assert out.tobytes() == arr.tobytes()


@SETTINGS
@given(shapes=st.lists(hnp.array_shapes(min_dims=0, max_dims=3, max_side=6), min_size=1,
                       max_size=4),
       ids=st.lists(st.integers(0, 2**63 - 1), min_size=4, max_size=4, unique=True),
       tags=st.sets(st.text(min_size=1, max_size=5), max_size=3), bf16=st.booleans(),
       seed=st.integers(0, 2**16))
def test_drawn_states_with_fixed_ids_cross_both_ways(shapes, ids, tags, bf16, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    port = State([PlaceHolder(a, id=i, tags=tags, description="w") for a, i in zip(arrays, ids)])
    ref = JState([JPlaceHolder(a, id=i, tags=tags, description="w") for a, i in zip(arrays, ids)])
    blob = serde.serialize(port, bf16_floats=bf16)
    assert blob == J.serialize(ref, bf16_floats=bf16)
    for out in (serde.deserialize(blob), J.deserialize(blob)):
        assert [p.id for p in out.state_placeholders] == ids[:len(arrays)]
        assert all(p.tags == set(tags) for p in out.state_placeholders)
    raws, jraws = serde.state_raw_tensors(blob), J.state_raw_tensors(blob)
    assert [(r.kind, r.shape, bytes(r.raw)) for r in raws] == \
        [(r.kind, r.shape, bytes(r.raw)) for r in jraws]


_msgpack_leaf = st.one_of(
    st.none(), st.booleans(), st.integers(-(2**63), 2**64 - 1), st.floats(),
    st.text(max_size=300), st.binary(max_size=70_000))


@settings(max_examples=100, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(obj=st.recursive(
    _msgpack_leaf,
    lambda kids: st.one_of(
        st.lists(kids, max_size=20), st.tuples(kids),
        st.dictionaries(st.one_of(st.text(max_size=4), st.integers(-(2**63), 2**64 - 1)), kids,
                        max_size=20),
        st.builds(lambda c, d: ("ext", c, d), st.integers(0, 127), st.binary(max_size=300))),
    max_leaves=30))
def test_packer_writes_msgpack_bytes_and_reads_them_back(obj):
    """packer.packb against msgpack.packb(use_bin_type=True) on every
    type the wire uses, ext included (every fixext and ext8/16 length),
    and packer.unpackb against msgpack.unpackb on the result."""
    def conv(o, ext):
        if isinstance(o, tuple) and len(o) == 3 and o[0] == "ext":
            return ext(o[1], o[2])
        if isinstance(o, (list, tuple)):
            return type(o)(conv(v, ext) for v in o)
        if isinstance(o, dict):
            return {k: conv(v, ext) for k, v in o.items()}
        return o

    mine = packer.packb(conv(obj, packer.ExtType))
    theirs = msgpack.packb(conv(obj, msgpack.ExtType), use_bin_type=True)
    assert mine == theirs
    back = packer.unpackb(mine)
    want = msgpack.unpackb(mine, raw=False, strict_map_key=False, timestamp=0)
    assert packer.packb(back) == msgpack.packb(want, use_bin_type=True)


def test_packer_edges_match_msgpack():
    cases = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33,
             -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63), 1.5, np.float64(2.5),
             "", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "é" * 40000, b"", b"b" * 255,
             b"b" * 256, b"b" * 65536, bytearray(b"xy"), memoryview(b"mv"), [None] * 15,
             [None] * 16, [0] * 65536, {i: i for i in range(15)}, {i: i for i in range(16)},
             {(1, 2): "tuple key"}, True, False, None]
    for c in cases:
        assert packer.packb(c) == msgpack.packb(c, use_bin_type=True), repr(c)[:40]
    for n in (0, 1, 2, 3, 4, 5, 8, 16, 17, 255, 256, 70000):
        assert packer.packb(packer.ExtType(5, b"e" * n)) == msgpack.packb(
            msgpack.ExtType(5, b"e" * n))
    assert packer.packb({1, 3, 2}, default=sorted) == msgpack.packb({1, 3, 2}, default=sorted)
    # non-string map keys read back; an array key is unhashable in both
    keyed = msgpack.packb({1: "a", -2.5: "b", b"k": "c", None: "d", True: "e"})
    assert packer.unpackb(keyed) == msgpack.unpackb(keyed, strict_map_key=False)
    for reader in (packer.unpackb, lambda b: msgpack.unpackb(b, strict_map_key=False)):
        with pytest.raises(TypeError):
            reader(msgpack.packb({(1, 2): "tuple key"}))
    with pytest.raises(TypeError):
        packer.packb(object())
    with pytest.raises(OverflowError):
        packer.packb(2**64)
    with pytest.raises(ValueError):
        nested: list = []
        for _ in range(600):
            nested = [nested]
        packer.packb(nested)


def _outcome(fn, blob, ser):
    """("ok", the decoded object written back by ``ser``) or ("raise", the
    error's kind)."""
    try:
        return ("ok", ser(fn(blob)))
    except (ValueError, TypeError) as err:
        return ("raise", type(err).__mro__[1] if isinstance(err, ValueError) else TypeError)


def test_reader_raises_on_every_truncation_as_the_jax_package_does():
    """Every proper prefix of a State blob, a nested blob, a shared-tensor
    blob and a bf16 blob: both packages refuse it with a ValueError (the
    fast State path falls back to the general parser, which raises)."""
    rng = np.random.default_rng(0)
    blobs = [
        serialize_model_params([rng.standard_normal((3, 4)).astype(np.float32)]),
        serialize_model_params([rng.standard_normal((5,)).astype(np.float32)], bf16=True),
        serde.serialize({"a": [1, 2.5, "x", np.arange(6).reshape(2, 3)], "b": {"c": None}}),
    ]
    for blob in blobs:
        for n in range(len(blob)):
            for dec in (serde.deserialize, J.deserialize):
                with pytest.raises(ValueError):
                    dec(blob[:n])
        assert serde.state_raw_tensors(blob[: len(blob) // 2]) is None


def test_reader_agrees_with_the_jax_package_on_garbage():
    """Random bytes, random single-byte corruptions of a real blob, the
    reserved byte 0xc1, trailing bytes and over-deep nesting: the port
    raises where the JAX package raises (ValueError), and where both decode
    they decode to the same object."""
    rng = np.random.default_rng(1)
    real = serde.serialize({"w": np.arange(12, dtype=np.float32), "k": [1, "two", 3.0]})
    blobs = [rng.bytes(int(n)) for n in rng.integers(1, 48, 300)]
    for i in rng.integers(0, len(real), 200):
        b = bytearray(real)
        b[int(i)] = int(rng.integers(0, 256))
        blobs.append(bytes(b))
    blobs += [b"\xc1", real + b"\x00", b"\x91" * 2000 + b"\xc0", b"\xdd\xff\xff\xff\xff"]
    for blob in blobs:
        port = _outcome(lambda b: serde.deserialize(b, device="cpu"), blob, serde.serialize)
        ref = _outcome(J.deserialize, blob, J.serialize)
        assert port[0] == ref[0], (blob[:16], port, ref)
        if port[0] == "ok":
            assert port == ref


def test_frames_cross_both_ways():
    blob = serialize_model_params([np.zeros((64, 64), np.float32),
                                   np.random.default_rng(2).standard_normal(1000).astype(np.float32)])
    trace = bytes(range(24))
    for codec in (None, *serde.available_codecs()):
        for tr in (None, trace):
            mine = serde.encode_frame(blob, codec, trace=tr)
            assert mine == J.encode_frame(blob, codec, trace=tr)
            body, got_trace = J.decode_frame_traced(mine)
            assert bytes(body) == blob and got_trace == tr
            body, got_trace = serde.decode_frame_traced(J.encode_frame(blob, codec, trace=tr))
            assert bytes(body) == blob and got_trace == tr
    with pytest.raises(ValueError):
        serde.encode_frame(blob, trace=b"short")


def test_shared_tensor_crosses_between_packages():
    """An AdditiveSharingTensor serialized by either package decodes in the
    other (the port's onto the device it is given) and opens to the same
    integers; the port writes the JAX package's bytes for the same shares."""
    from pygrid_tpu.smpc import additive as JA
    from pygrid_tpu.smpc.provider import CryptoProvider as JProvider
    from pygrid_tpu_torch.smpc import AdditiveSharingTensor, CryptoProvider, fix_prec

    x = np.array([[1.5, -2.25, 0.0], [3.0, 1e3, -7.125]])
    px = fix_prec(x).share("alice", "bob", "charlie", device="cpu",
                           crypto_provider=CryptoProvider(seed=0, device="cpu"))
    jx = JA.fix_prec(x).share("alice", "bob", "charlie", crypto_provider=JProvider(seed=0))
    from_port = J.deserialize(serde.serialize(px))
    from_jax = serde.deserialize(J.serialize(jx), device="cpu")
    assert isinstance(from_jax, AdditiveSharingTensor)
    np.testing.assert_array_equal(from_port.get(), px.get())
    np.testing.assert_array_equal(from_jax.get(), jx.get())
    assert serde.serialize(from_jax) == J.serialize(jx)
    assert J.serialize(from_port) == serde.serialize(px)
    ints = AdditiveSharingTensor.share(np.array([5, -7, 2**40], np.int64), ("a", "b"),
                                       device="cpu", generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(J.deserialize(serde.serialize(ints)).get(), ints.get())
