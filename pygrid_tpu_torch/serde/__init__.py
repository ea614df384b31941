"""Wire serde: the port's own copy of :mod:`pygrid_tpu.serde` (the same
bytes on the wire, no ``msgpack`` package needed)."""

from pygrid_tpu_torch.serde.wire import (  # noqa: F401
    TRACE_HEADER_BYTES,
    WIRE_VERSION,
    WS_SUBPROTOCOL_V2,
    WS_SUBPROTOCOL_V2_TRACE,
    RawTensor,
    available_codecs,
    decode_frame,
    decode_frame_traced,
    deserialize,
    encode_frame,
    from_hex,
    offered_subprotocols,
    register_serde,
    serialize,
    state_raw_tensors,
    subprotocol_codec,
    subprotocol_traced,
    tensor_copy_count,
    to_hex,
)
