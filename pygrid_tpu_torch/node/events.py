"""WS event handlers + dispatch table for the Node.

Parity surface: reference ``apps/node/src/app/main/events/`` — the routes
table (``events/__init__.py:23-57``), ``route_requests`` (JSON dispatch by
``type``; **binary frames → forward_binary_message**, ``:61-107``), the
model-centric FL events (``model_centric/fl_events.py``), the data-centric
syft/model/control events (``data_centric/*.py``), and the user/role/group WS
twins. Handlers are transport-agnostic: they take (ctx, message, conn) and
return a dict; the WS endpoint (pygrid_tpu_torch.node.ws) does the framing.

The port's counterpart of :mod:`pygrid_tpu.node.events`, with the same
handlers, messages and typed errors. Tensors go to the node's explicit
``ctx.device`` (handlers run on executor threads). Generation runs the
port's ``models.decode.generate`` on that device where the reference built
``jax.jit`` programs: there is nothing to compile, so nothing is cached.
"""

from __future__ import annotations

import base64
import binascii
import logging
import os
import uuid
from typing import Any, Callable

import numpy as np
import torch

from pygrid_tpu_torch import telemetry
from pygrid_tpu_torch.datacentric.object_storage import recover_objects
from pygrid_tpu_torch.federated.auth import verify_token
from pygrid_tpu_torch.node import NodeContext, __version__
from pygrid_tpu_torch.telemetry import trace
from pygrid_tpu_torch.node.sockets import SocketHandler
from pygrid_tpu_torch.serde import deserialize, serialize
from pygrid_tpu_torch.users.events import USER_HANDLERS
from pygrid_tpu_torch.utils import exceptions as E
from pygrid_tpu_torch.utils.codes import (
    CONTROL_EVENTS,
    CYCLE,
    MODEL_CENTRIC_FL_EVENTS,
    MSG_FIELD,
    REQUEST_MSG,
)

logger = logging.getLogger(__name__)

SUCCESS = "success"
ERROR = "error"


class Connection:
    """Per-WebSocket state: the data-centric login session and the FL
    worker id bound to this socket."""

    def __init__(self, ctx: NodeContext, socket: Any = None) -> None:
        self.ctx = ctx
        self.socket = socket
        self.session = None  # UserSession after `authentication`
        self.worker_id: str | None = None
        #: wire-v2 negotiation result (set by the WS endpoint after the
        #: subprotocol handshake); False/None on legacy connections and
        #: HTTP-route synthetic connections
        self.wire_v2: bool = False
        self.wire_codec: str | None = None
        #: True while dispatching a binary (msgpack) frame — handlers that
        #: return raw payload bytes (get-model) use it to pick base64 for
        #: the JSON framing
        self.binary_frame: bool = False
        #: one-shot hint from a handler to the WS endpoint: the response
        #: already embeds a pre-compressed payload (the per-checkpoint
        #: blob cache), so the per-frame codec pass would be K-per-round
        #: wasted work — skip it for THIS response only
        self.suppress_frame_codec: bool = False
        #: one-shot trace context extracted from a wire-v2 frame header
        #: by the WS endpoint (consumed by route_requests); and the span
        #: this connection served the current message under (set by
        #: route_requests, consumed by the WS endpoint for the response
        #: frame's trace header)
        self.incoming_trace = None
        self.last_trace = None

    @property
    def worker(self):
        if self.session is None:
            raise E.AuthorizationError("authentication required")
        return self.session.worker

    def codec_label(self) -> str:
        """The wire-codec label telemetry attributes this message's
        payload bytes to — one definition so the download and report
        counters can never disagree."""
        if self.binary_frame and self.wire_codec:
            return self.wire_codec
        return "binary" if self.binary_frame else "json"


# ── model-centric FL events (reference fl_events.py) ─────────────────────────


def _unhex(value: str | None) -> bytes | None:
    if value is None:
        return None
    return binascii.unhexlify(value.encode())


def host_federated_training(
    ctx: NodeContext, message: dict, conn: Connection
) -> dict:
    """(reference fl_events.py:27-75) deserialize hex model/plans/protocols/
    avg-plan and create the FLProcess + first cycle."""
    data = message.get(MSG_FIELD.DATA) or {}
    response: dict[str, Any] = {}
    try:
        model_blob = _unhex(data.get(MSG_FIELD.MODEL))
        client_plans = {
            k: _unhex(v) for k, v in (data.get(CYCLE.PLANS) or {}).items()
        }
        client_protocols = {
            k: _unhex(v) for k, v in (data.get(CYCLE.PROTOCOLS) or {}).items()
        }
        avg_plan = _unhex(data.get(CYCLE.AVG_PLAN))
        client_config = data.get(CYCLE.CLIENT_CONFIG) or {}
        server_config = data.get(CYCLE.SERVER_CONFIG) or {}
        ctx.fl.create_process(
            model_blob=model_blob,
            client_plans=client_plans,
            name=client_config.get("name", ""),
            version=client_config.get("version", ""),
            client_config=client_config,
            server_config=server_config,
            server_averaging_plan=avg_plan,
            client_protocols=client_protocols,
        )
        response[CYCLE.STATUS] = SUCCESS
    except Exception as err:  # noqa: BLE001 — protocol boundary
        logger.exception("host-training failed")
        response[ERROR] = str(err)
    return {
        MSG_FIELD.TYPE: MODEL_CENTRIC_FL_EVENTS.HOST_FL_TRAINING,
        MSG_FIELD.DATA: response,
    }


def requires_speed_test(ctx: NodeContext, name: str, version: str | None) -> bool:
    """(reference fl_events.py:112-128) true when the process sets bandwidth
    minimums."""
    filters = {"name": name}
    if version:
        filters["version"] = version
    process = ctx.fl.process_manager.first(**filters)
    server_config = ctx.fl.process_manager.get_configs(
        fl_process_id=process.id, is_server_config=True
    )
    return (
        server_config.get("minimum_upload_speed") is not None
        or server_config.get("minimum_download_speed") is not None
    )


def assign_worker_id(ctx: NodeContext, conn: Connection, handler: SocketHandler):
    """(reference fl_events.py:77-109) uuid4 worker id + socket binding."""
    worker_id = str(uuid.uuid4())
    handler.new_connection(worker_id, conn.socket)
    conn.worker_id = worker_id
    ctx.fl.worker_manager.create(worker_id)
    return worker_id


def authenticate(ctx: NodeContext, message: dict, conn: Connection) -> dict:
    """(reference fl_events.py:131-166) JWT verification → worker id."""
    data = message.get(MSG_FIELD.DATA) or {}
    response: dict[str, Any] = {}
    try:
        name = data.get("model_name")
        version = data.get("model_version")
        filters = {"name": name}
        if version:
            filters["version"] = version
        process = ctx.fl.process_manager.first(**filters)
        server_config = ctx.fl.process_manager.get_configs(
            fl_process_id=process.id, is_server_config=True
        )
        verify_token(data.get("auth_token"), server_config)
        worker_id = assign_worker_id(ctx, conn, _handler_of(ctx))
        response[CYCLE.STATUS] = SUCCESS
        response[MSG_FIELD.WORKER_ID] = worker_id
        response[MSG_FIELD.REQUIRES_SPEED_TEST] = requires_speed_test(
            ctx, name, version
        )
    except Exception as err:  # noqa: BLE001 — protocol boundary
        response[ERROR] = str(err)
    return {
        MSG_FIELD.TYPE: MODEL_CENTRIC_FL_EVENTS.AUTHENTICATE,
        MSG_FIELD.DATA: response,
    }


def cycle_request(ctx: NodeContext, message: dict, conn: Connection) -> dict:
    """(reference fl_events.py:169-234) speed-field validation → assign."""
    data = message.get(MSG_FIELD.DATA) or {}
    response: dict[str, Any] = {}
    try:
        worker_id = data.get(MSG_FIELD.WORKER_ID)
        name = data.get(MSG_FIELD.MODEL)
        version = data.get(CYCLE.VERSION)
        worker = ctx.fl.worker_manager.get(id=worker_id)
        fields_map = {
            CYCLE.PING: "ping",
            CYCLE.DOWNLOAD: "avg_download",
            CYCLE.UPLOAD: "avg_upload",
        }
        speed_required = requires_speed_test(ctx, name, version)
        for request_field, db_field in fields_map.items():
            if request_field in data:
                value = data.get(request_field)
                if not isinstance(value, (float, int)) or isinstance(
                    value, bool
                ) or value < 0:
                    raise E.PyGridError(
                        f"'{request_field}' needs to be a positive number"
                    )
                setattr(worker, db_field, float(value))
            elif speed_required:
                raise E.PyGridError(f"'{request_field}' is required")
        ctx.fl.worker_manager.update(worker)
        response = ctx.fl.assign(name, version, worker)
    except E.CycleNotFoundError:
        response[CYCLE.STATUS] = CYCLE.REJECTED
    except E.MaxCycleLimitExceededError as err:
        response[CYCLE.STATUS] = CYCLE.REJECTED
        response[MSG_FIELD.MODEL] = getattr(err, "name", None)
    except Exception as err:  # noqa: BLE001 — protocol boundary
        response[CYCLE.STATUS] = CYCLE.REJECTED
        response[ERROR] = str(err)
    return {
        MSG_FIELD.TYPE: MODEL_CENTRIC_FL_EVENTS.CYCLE_REQUEST,
        MSG_FIELD.DATA: response,
    }


def get_model(ctx: NodeContext, message: dict, conn: Connection) -> dict:
    """WS twin of GET /model-centric/get-model: request-key-gated download
    of the current checkpoint, served from the ModelManager's per-
    checkpoint wire-blob cache (serialized once per round, not once per
    worker). Over binary framing the blob travels as raw bytes; over JSON
    it goes out base64 (JSON cannot carry bytes)."""
    data = message.get(MSG_FIELD.DATA) or {}
    response: dict[str, Any] = {}
    try:
        model_id = int(data.get(MSG_FIELD.MODEL_ID))
        model = ctx.fl.model_manager.get(id=model_id)
        cycle = ctx.fl.cycle_manager.last(model.fl_process_id)
        worker = ctx.fl.worker_manager.get(id=data.get(MSG_FIELD.WORKER_ID))
        ctx.fl.cycle_manager.validate(
            worker.id, cycle.id, data.get(CYCLE.KEY)
        )
        if conn.binary_frame and conn.wire_codec:
            # serve the checkpoint as a pre-compressed v2 frame straight
            # from the per-checkpoint blob cache — compressed once per
            # round, not once per worker — and tell the WS endpoint not
            # to re-compress the envelope around it
            blob = ctx.fl.model_manager.load_encoded(
                model_id,
                precision=data.get("precision"),
                codec=conn.wire_codec,
            )
            response["model_wire"] = "v2-frame"
            conn.suppress_frame_codec = True
        else:
            blob = ctx.fl.model_manager.load_encoded(
                model_id, precision=data.get("precision")
            )
        codec = conn.codec_label()
        telemetry.timeline.add_bytes(cycle.id, "download", codec, len(blob))
        telemetry.incr("model_download_bytes_total", len(blob), codec=codec)
        response[CYCLE.STATUS] = SUCCESS
        response[MSG_FIELD.MODEL] = (
            blob if conn.binary_frame else base64.b64encode(blob).decode()
        )
    except Exception as err:  # noqa: BLE001 — protocol boundary
        response[ERROR] = str(err)
    return {
        MSG_FIELD.TYPE: MODEL_CENTRIC_FL_EVENTS.GET_MODEL,
        MSG_FIELD.DATA: response,
    }


def report(ctx: NodeContext, message: dict, conn: Connection) -> dict:
    """(reference fl_events.py:237-271) base64 diff → submit."""
    data = message.get(MSG_FIELD.DATA) or {}
    response: dict[str, Any] = {}
    try:
        raw = data.get(CYCLE.DIFF) or b""
        # JSON framing carries the diff base64'd (reference wire contract,
        # fl_events.py:237-271); binary msgpack framing carries raw bytes —
        # no +33% inflation, no megabyte JSON parse. b64decode takes the
        # str directly (no explicit .encode() copy of the megabyte field);
        # raw bytes pass through uncopied.
        if isinstance(raw, str):
            from pygrid_tpu_torch.native import b64_decode_view

            diff = b64_decode_view(raw)  # one C pass, no final copy
        else:
            diff = raw if isinstance(raw, bytes) else bytes(raw)
        ctx.fl.submit_diff(
            data.get(MSG_FIELD.WORKER_ID), data.get(CYCLE.KEY), diff,
            wire_codec=conn.codec_label(),
        )
        response[CYCLE.STATUS] = SUCCESS
    except Exception as err:  # noqa: BLE001 — protocol boundary
        response[ERROR] = str(err)
    return {
        MSG_FIELD.TYPE: MODEL_CENTRIC_FL_EVENTS.REPORT,
        MSG_FIELD.DATA: response,
    }


def report_partial(ctx: NodeContext, message: dict, conn: Connection) -> dict:
    """A sub-aggregator's subtree report (docs/AGGREGATION.md): one
    count-weighted partial diff sum plus the (worker_id, request_key)
    pairs it folded — the node validates every pair exactly like a
    direct report, then merges the sum into the cycle accumulator
    straight from the zero-copy wire view."""
    data = message.get(MSG_FIELD.DATA) or {}
    response: dict[str, Any] = {}
    try:
        raw = data.get(CYCLE.DIFF) or b""
        if isinstance(raw, str):
            from pygrid_tpu_torch.native import b64_decode_view

            diff = b64_decode_view(raw)
        else:
            diff = raw if isinstance(raw, bytes) else bytes(raw)
        workers = data.get("workers")
        if not isinstance(workers, (list, tuple)):
            raise E.PyGridError(
                "partial report needs a 'workers' list of "
                "[worker_id, request_key] pairs"
            )
        entries = []
        for pair in workers:
            if not isinstance(pair, (list, tuple)) or len(pair) != 2:
                raise E.PyGridError(
                    "each 'workers' entry must be a "
                    "[worker_id, request_key] pair"
                )
            entries.append((str(pair[0]), str(pair[1])))
        count = data.get("count", len(entries))
        weight_sum = data.get("weight_sum")
        if weight_sum is not None and (
            isinstance(weight_sum, bool)
            or not isinstance(weight_sum, (int, float))
        ):
            raise E.PyGridError("weight_sum must be a JSON number")
        ctx.fl.submit_partial(
            entries,
            diff,
            count,
            weight_sum=weight_sum,
            masked=bool(data.get("masked")),
            wire_codec=conn.codec_label(),
        )
        response[CYCLE.STATUS] = SUCCESS
    except Exception as err:  # noqa: BLE001 — protocol boundary
        response[ERROR] = str(err)
    return {
        MSG_FIELD.TYPE: MODEL_CENTRIC_FL_EVENTS.REPORT_PARTIAL,
        MSG_FIELD.DATA: response,
    }


def report_metrics(ctx: NodeContext, message: dict, conn: Connection) -> dict:
    """Client-reported training metrics for an assignment (this
    framework's extension — the reference has no structured metrics,
    SURVEY §5.5). Sample-weighted per-cycle aggregation is served by
    GET /model-centric/cycle-metrics."""
    data = message.get(MSG_FIELD.DATA) or {}
    response: dict[str, Any] = {}
    try:
        ctx.fl.cycle_manager.submit_worker_metrics(
            data.get(MSG_FIELD.WORKER_ID),
            data.get(CYCLE.KEY),
            data.get("metrics") or {},
        )
        response[CYCLE.STATUS] = SUCCESS
    except Exception as err:  # noqa: BLE001 — protocol boundary
        response[ERROR] = str(err)
    return {
        MSG_FIELD.TYPE: MODEL_CENTRIC_FL_EVENTS.REPORT_METRICS,
        MSG_FIELD.DATA: response,
    }


# ── secure-aggregation rounds (this framework's extension; secagg_service) ───


def _secagg_event(msg_type: str, fn) -> Callable:
    """Wrap a SecAggService call in the standard {type, data} envelope with
    protocol-boundary error capture (the shape every FL event returns)."""

    def handler(ctx: NodeContext, message: dict, conn: Connection) -> dict:
        data = message.get(MSG_FIELD.DATA) or {}
        response: dict[str, Any] = {}
        try:
            response = fn(ctx.fl.cycle_manager.secagg, data)
        except Exception as err:  # noqa: BLE001 — protocol boundary
            response = {ERROR: str(err)}
        return {MSG_FIELD.TYPE: msg_type, MSG_FIELD.DATA: response}

    return handler


secagg_advertise = _secagg_event(
    MODEL_CENTRIC_FL_EVENTS.SECAGG_ADVERTISE,
    lambda svc, d: svc.advertise(
        d.get(MSG_FIELD.WORKER_ID), d.get(CYCLE.KEY), d.get("public_key")
    ),
)
secagg_roster = _secagg_event(
    MODEL_CENTRIC_FL_EVENTS.SECAGG_ROSTER,
    lambda svc, d: svc.roster(d.get(MSG_FIELD.WORKER_ID), d.get(CYCLE.KEY)),
)
secagg_shares = _secagg_event(
    MODEL_CENTRIC_FL_EVENTS.SECAGG_SHARES,
    lambda svc, d: svc.submit_shares(
        d.get(MSG_FIELD.WORKER_ID), d.get(CYCLE.KEY), d.get("shares") or {}
    ),
)
secagg_status = _secagg_event(
    MODEL_CENTRIC_FL_EVENTS.SECAGG_STATUS,
    lambda svc, d: svc.status(d.get(MSG_FIELD.WORKER_ID), d.get(CYCLE.KEY)),
)
secagg_unmask = _secagg_event(
    MODEL_CENTRIC_FL_EVENTS.SECAGG_UNMASK,
    lambda svc, d: svc.submit_unmask_shares(
        d.get(MSG_FIELD.WORKER_ID),
        d.get(CYCLE.KEY),
        d.get("b_shares") or {},
        d.get("sk_shares") or {},
    ),
)


# ── data-centric control events (reference control_events.py) ────────────────


def get_node_infos(ctx: NodeContext, message: dict, conn: Connection) -> dict:
    return {
        MSG_FIELD.NODE_ID: ctx.local_worker.id,
        MSG_FIELD.SYFT_VERSION: __version__,
    }


def authentication(ctx: NodeContext, message: dict, conn: Connection) -> dict:
    """(reference control_events.py:28-42) credentials → per-user session."""
    try:
        session, token = ctx.sessions.login(
            message.get(MSG_FIELD.USERNAME_FIELD),
            message.get(MSG_FIELD.PASSWORD_FIELD),
        )
    except E.PyGridError:
        return {ERROR: "Invalid username/password!"}
    conn.session = session
    # federate the user's worker with the node's singleton so pointers to
    # either store resolve over this connection
    ctx.local_worker.add_worker(session.worker)
    # grid peers dialed before this login become reachable from this session
    for peer_id, peer in ctx.local_worker._known_workers.items():
        session.worker._known_workers.setdefault(peer_id, peer)
    # session workers answer crypto-deal requests with the node's dealer
    session.worker.crypto_provider = ctx.crypto_provider
    return {SUCCESS: "True", MSG_FIELD.NODE_ID: session.worker.id, "token": token}


def connect_grid_nodes(ctx: NodeContext, message: dict, conn: Connection) -> dict:
    """(reference control_events.py:44-54) node-to-node mesh: dial the peer
    and register it as a known worker."""
    peer_id = message.get("id")
    if peer_id not in ctx.local_worker._known_workers:
        from pygrid_tpu_torch.client.data_centric import DataCentricFLClient

        peer = DataCentricFLClient(
            message.get("address"), id=peer_id, device=ctx.device
        )
        ctx.local_worker._known_workers[peer_id] = peer
        # session workers route through the same peer (tensors live there)
        for session in ctx.sessions.all_sessions():
            if session._worker is not None:
                session._worker._known_workers.setdefault(peer_id, peer)
    return {"status": "Succesfully connected."}


def socket_ping(ctx: NodeContext, message: dict, conn: Connection) -> dict:
    return {MSG_FIELD.ALIVE: "True"}


# ── data-centric syft events (reference syft_events.py) ──────────────────────


def forward_binary_message(
    ctx: NodeContext,
    message: bytes | bytearray,
    conn: Connection,
    decoded: Any = None,
) -> bytes:
    """(reference syft_events.py:18-45) binary wire msg → per-user worker.
    ``decoded`` carries the already-deserialized message when the WS
    dispatcher peeked at the frame (one decode per frame, not two)."""
    if conn.session is None:
        return serialize(
            {"error_type": "AuthorizationError", "message": "login required"}
        )
    worker = conn.worker
    if len(worker.store) == 0:
        recover_objects(worker, ctx.kv)
    if decoded is not None:
        return worker.recv_decoded_msg(decoded, user=conn.session.username)
    return worker._recv_msg(bytes(message), user=conn.session.username)


def syft_command(ctx: NodeContext, message: dict, conn: Connection) -> dict:
    """JSON variant of the binary path (reference syft_events.py:49-59)."""
    msg = deserialize(
        binascii.unhexlify(message[MSG_FIELD.DATA]), device=ctx.device
    )
    response = conn.worker.recv_obj_msg(msg, user=conn.session.username)
    return {MSG_FIELD.DATA: binascii.hexlify(serialize(response)).decode()}


# ── data-centric model events (reference model_events.py) ────────────────────


def _authenticated(conn: Connection) -> None:
    if conn.session is None:
        raise E.AuthorizationError("authentication required")


def host_model(ctx: NodeContext, message: dict, conn: Connection) -> dict:
    _authenticated(conn)
    try:
        # missing fields bounce typed, not as a cryptic KeyError string
        # from the dispatch boundary (gridlint GL4 satellite audit)
        for field_name in (MSG_FIELD.MODEL, MSG_FIELD.MODEL_ID):
            if field_name not in message:
                raise E.MissingRequestKeyError(
                    f"missing required field '{field_name}'"
                )
        serialized = message[MSG_FIELD.MODEL]
        if isinstance(serialized, str):
            # native single-pass decode straight into the stored buffer —
            # the old base64.b64decode → bytes(...) round trip copied the
            # megabyte model twice
            from pygrid_tpu_torch.native import b64_decode

            try:
                serialized = b64_decode(serialized)
            except ValueError:
                # line-wrapped / whitespace-laced base64 (MIME tooling,
                # encodebytes) decoded under the old permissive path and
                # must keep working — the strict kernel is the fast path,
                # not a contract change
                try:
                    serialized = base64.b64decode(serialized)
                except (binascii.Error, ValueError) as err:
                    # formerly escaped as an untyped binascii.Error
                    raise E.PyGridError(
                        f"model field is not valid base64: {err}"
                    ) from err
        elif not isinstance(serialized, bytes):
            serialized = bytes(serialized)
        return ctx.models.save(
            ctx.local_worker.id,
            serialized,
            message[MSG_FIELD.MODEL_ID],
            allow_download=str(message.get(MSG_FIELD.ALLOW_DOWNLOAD)) == "True",
            allow_remote_inference=str(
                message.get(MSG_FIELD.ALLOW_REMOTE_INFERENCE)
            )
            == "True",
            mpc=str(message.get(MSG_FIELD.MPC)) == "True",
        )
    except E.PyGridError as err:
        return {SUCCESS: False, ERROR: str(err)}


#: KV-cache allocation cap for run-generation (elements, k+v combined):
#: 2^28 ≈ 268M elements = 1 GB at f32 — generous for serving, far below
#: what would OOM the node's chip/host from one hostile frame
_MAX_GENERATION_CACHE_ELEMENTS = 1 << 28

def _prepare_generation(ctx: NodeContext, message: dict):
    """Validate a run-generation message end to end. Returns either an
    error-response dict or ``(hosted, prompt, n_new, temperature,
    seed)`` with the hosted bundle parsed into
    ``hosted.generation_cache``. Shared by the WS handler and the async
    HTTP route so the two doors cannot drift on the typed-error
    contract."""
    import math

    got = _servable_and_data(ctx, message)
    if isinstance(got, dict):
        return got
    hosted, prompt = got
    from pygrid_tpu_torch.models import decode

    # parse + device-upload the bundle ONCE per hosted model (the
    # HostedModel lives in the node's ModelCache, so every later
    # request reuses the on-device params)
    if hosted.generation_cache is None:
        hosted.generation_cache = decode.from_bundle(
            hosted.model, device=ctx.device
        )
    cfg, _params = hosted.generation_cache
    prompt = np.asarray(prompt)
    if (
        prompt.ndim != 2
        or prompt.shape[0] < 1
        or prompt.shape[1] < 1
        or not np.issubdtype(prompt.dtype, np.integer)
    ):
        return {
            SUCCESS: False,
            ERROR: "prompt must be non-empty int tokens [B, P]",
        }
    # bound what the untrusted B actually sizes — per-request KV work is
    # 2 × [layers, B, max_len, H, dh] (B is the only request-controlled
    # factor; the rest is the hosted config), so the cap is on total
    # cache elements, mirroring the MAX_OPLIST_ELEMENTS posture in
    # plans/translators.py. The batch engine's cache is allocated per
    # SLOT, not per request, but the same cap bounds how many rows one
    # frame may enqueue.
    cache_elems = (
        2 * cfg.n_layers * prompt.shape[0] * cfg.max_len * cfg.d_model
    )
    if cache_elems > _MAX_GENERATION_CACHE_ELEMENTS:
        return {
            SUCCESS: False,
            ERROR: (
                f"prompt batch of {prompt.shape[0]} would need a "
                f"{cache_elems:,}-element KV cache (cap "
                f"{_MAX_GENERATION_CACHE_ELEMENTS:,})"
            ),
        }
    if prompt.min() < 0 or prompt.max() >= cfg.vocab:
        return {
            SUCCESS: False,
            ERROR: f"prompt token out of range [0, {cfg.vocab})",
        }
    raw_n_new = message.get("n_new", 16)
    # same wire contract as temperature below: a JSON integer — bools,
    # strings ("8" would int()-coerce) and fractional floats all bounce
    if (
        isinstance(raw_n_new, bool)
        or not isinstance(raw_n_new, (int, float))
        or (isinstance(raw_n_new, float) and not math.isfinite(raw_n_new))
        or int(raw_n_new) != raw_n_new
    ):
        return {SUCCESS: False, ERROR: "n_new must be a JSON integer"}
    n_new = int(raw_n_new)
    if n_new < 1:
        return {SUCCESS: False, ERROR: "n_new must be >= 1"}
    raw_temp = message.get("temperature", 0.0)
    if isinstance(raw_temp, bool) or not isinstance(
        raw_temp, (int, float)
    ):
        # float() would coerce JSON true to 1.0 (silently sampling) and
        # numeric strings to their value — the wire contract is a JSON
        # number, everything else bounces typed
        return {
            SUCCESS: False,
            ERROR: "temperature must be a JSON number (bool/string rejected)",
        }
    temperature = float(raw_temp)
    # `== 0 or > 0` rejects both negatives AND NaN (NaN fails both);
    # isfinite rejects Infinity, which would otherwise collapse the
    # logits to zero and silently serve uniform-random tokens
    if not math.isfinite(temperature) or not (
        temperature == 0.0 or temperature > 0.0
    ):
        return {SUCCESS: False, ERROR: "temperature must be finite and >= 0"}
    seed = message.get("seed")
    if seed is not None:
        if (
            isinstance(seed, bool)
            or not isinstance(seed, (int, float))
            or (isinstance(seed, float) and not math.isfinite(seed))
            or int(seed) != seed
        ):
            return {SUCCESS: False, ERROR: "seed must be a JSON integer"}
        seed = int(seed)
        # PRNGKey overflows int64 with an uncaught OverflowError —
        # bound the client-supplied value to the typed-error contract
        if not 0 <= seed < 2**63:
            return {
                SUCCESS: False,
                ERROR: "seed must be in [0, 2**63)",
            }
    return hosted, prompt, n_new, temperature, seed


def _legacy_generate(ctx: NodeContext, hosted, prompt, n_new: int,
                     temperature, seed):
    """The pre-engine per-request path — one whole ``decode.generate``
    call per request on the node's device — kept as the
    ``PYGRID_SERVING=off`` escape hatch and as the baseline the batch
    engine is measured against."""
    from pygrid_tpu_torch.models import decode
    from pygrid_tpu_torch.utils import prng

    cfg, params = hosted.generation_cache
    x = torch.from_numpy(np.ascontiguousarray(prompt)).to(ctx.device)
    if temperature > 0.0:
        if seed is None:
            # unseeded sampling must actually vary across requests
            seed = int.from_bytes(os.urandom(4), "big")
        toks = decode.generate(
            params, x, n_new, cfg, temperature=float(temperature),
            key=prng.PRNGKey(int(seed), device=ctx.device),
        )
    else:
        toks = decode.generate(params, x, n_new, cfg)
    return toks.cpu().numpy()


def run_generation(ctx: NodeContext, message: dict, conn: Connection) -> dict:
    """Autoregressive generation from a hosted transformer bundle —
    the serving twin of ``run_inference`` for the generative model
    family. Message fields: ``model_id``, ``data`` (serialized int
    prompt [B, P]), ``n_new``, optional ``temperature`` + ``seed``.
    Gated by the same ``allow_remote_inference`` flag.

    Since the serving engine (``serving/``, docs/SERVING.md)
    this handler is a thin enqueue-and-await wrapper: the request joins
    the model's continuous batch and this (executor) thread blocks on
    the result future while the engine's dedicated thread drives the
    device — concurrent requests share one persistent batch instead of
    serializing whole-generation calls, and a full queue
    answers a typed busy error instead of piling up. Greedy results are
    bit-identical to the direct ``decode.generate`` path;
    ``PYGRID_SERVING=off`` restores the legacy per-request path."""
    _authenticated(conn)
    try:
        prep = _prepare_generation(ctx, message)
        if isinstance(prep, dict):
            return prep
        hosted, prompt, n_new, temperature, seed = prep
        if os.environ.get("PYGRID_SERVING", "").lower() in ("off", "0"):
            toks = _legacy_generate(
                ctx, hosted, prompt, n_new, temperature, seed
            )
        else:
            engine = ctx.serving.engine_for(
                str(message[MSG_FIELD.MODEL_ID]), hosted
            )
            toks = engine.submit(prompt, n_new, temperature, seed)
        return {SUCCESS: True, "tokens": np.asarray(toks).tolist()}
    except E.ServerBusyError as err:
        return {SUCCESS: False, "busy": True, ERROR: str(err)}
    except (E.PyGridError, ValueError, TypeError) as err:
        return {SUCCESS: False, ERROR: str(err)}


def delete_model(ctx: NodeContext, message: dict, conn: Connection) -> dict:
    _authenticated(conn)
    try:
        result = ctx.models.delete(
            ctx.local_worker.id, message[MSG_FIELD.MODEL_ID]
        )
        # the serving engine holds the bundle's device params + slot
        # cache — deleting the model must release them
        ctx.serving.evict(str(message[MSG_FIELD.MODEL_ID]))
        return result
    except E.PyGridError as err:
        return {SUCCESS: False, ERROR: str(err)}


def get_models(ctx: NodeContext, message: dict, conn: Connection) -> dict:
    _authenticated(conn)
    return {MSG_FIELD.MODELS: ctx.models.models(ctx.local_worker.id)}


#: shared by run_inference / run_generation: both routes gate on the
#: same allow_remote_inference flag and accept the same base64-or-bytes
#: serialized data field
_NOT_ALLOWED = {
    SUCCESS: False,
    "not_allowed": True,
    ERROR: "You're not allowed to run inferences on this model.",
}


def _servable_and_data(ctx: NodeContext, message: dict):
    """(hosted_model, deserialized_data) for an inference-family route,
    or an error-response dict when the permission gate rejects. Missing
    fields raise typed PyGridErrors so the caller's error contract
    (every defect -> {success: False, error: ...}) holds."""
    for field_name in (MSG_FIELD.MODEL_ID, MSG_FIELD.DATA):
        if field_name not in message:
            raise E.PyGridError(f"missing required field '{field_name}'")
    if len(ctx.local_worker.store) == 0:
        recover_objects(ctx.local_worker, ctx.kv)
    hosted = ctx.models.get(ctx.local_worker.id, message[MSG_FIELD.MODEL_ID])
    if not hosted.allow_remote_inference:
        return dict(_NOT_ALLOWED)
    blob = message[MSG_FIELD.DATA]
    if isinstance(blob, str):
        try:
            blob = base64.b64decode(blob)
        except (binascii.Error, ValueError) as err:
            # formerly escaped as an untyped binascii.Error string
            raise E.PyGridError(
                f"data field is not valid base64: {err}"
            ) from err
    try:
        payload = deserialize(bytes(blob), device=ctx.device)
    except Exception as err:  # noqa: BLE001 — msgpack raises its own zoo
        raise E.PyGridError(
            f"data field is not a valid serialized payload: {err}"
        ) from err
    return hosted, payload


def run_inference(ctx: NodeContext, message: dict, conn: Connection) -> dict:
    """(reference model_events.py:77-129) run a hosted model on submitted
    data; predictions return as a plain list. A hosted plan runs on the
    node's device from its op list — never from its ``torch_blob`` (loading
    one can unpickle), as on a worker."""
    _authenticated(conn)
    from pygrid_tpu_torch.plans.plan import Plan
    from pygrid_tpu_torch.runtime.worker import run_received_plan

    try:
        got = _servable_and_data(ctx, message)
        if isinstance(got, dict):
            return got
        hosted, data = got
        if isinstance(hosted.model, Plan):
            output = run_received_plan(hosted.model, [data], ctx.device)
        else:
            output = hosted.model(data)
        if isinstance(output, (tuple, list)):
            output = output[0]
        if isinstance(output, torch.Tensor):
            output = output.detach().cpu().numpy()
        return {SUCCESS: True, "prediction": np.asarray(output).tolist()}
    except E.PyGridError as err:
        return {SUCCESS: False, ERROR: str(err)}


# ── user / role / group WS twins (reference {user,role,group}_related.py) ────
# handlers live in pygrid_tpu_torch.users.events so a Network app serves the
# identical RBAC surface (the reference duplicates them per app)

_USER_HANDLERS = USER_HANDLERS

# ── dispatch ─────────────────────────────────────────────────────────────────

ROUTES: dict[str, Callable[[NodeContext, dict, Connection], dict]] = {
    CONTROL_EVENTS.SOCKET_PING: socket_ping,
    MODEL_CENTRIC_FL_EVENTS.HOST_FL_TRAINING: host_federated_training,
    MODEL_CENTRIC_FL_EVENTS.AUTHENTICATE: authenticate,
    MODEL_CENTRIC_FL_EVENTS.CYCLE_REQUEST: cycle_request,
    MODEL_CENTRIC_FL_EVENTS.GET_MODEL: get_model,
    MODEL_CENTRIC_FL_EVENTS.REPORT: report,
    MODEL_CENTRIC_FL_EVENTS.REPORT_PARTIAL: report_partial,
    MODEL_CENTRIC_FL_EVENTS.REPORT_METRICS: report_metrics,
    MODEL_CENTRIC_FL_EVENTS.SECAGG_ADVERTISE: secagg_advertise,
    MODEL_CENTRIC_FL_EVENTS.SECAGG_ROSTER: secagg_roster,
    MODEL_CENTRIC_FL_EVENTS.SECAGG_SHARES: secagg_shares,
    MODEL_CENTRIC_FL_EVENTS.SECAGG_STATUS: secagg_status,
    MODEL_CENTRIC_FL_EVENTS.SECAGG_UNMASK: secagg_unmask,
    REQUEST_MSG.GET_ID: get_node_infos,
    REQUEST_MSG.CONNECT_NODE: connect_grid_nodes,
    REQUEST_MSG.HOST_MODEL: host_model,
    REQUEST_MSG.RUN_INFERENCE: run_inference,
    REQUEST_MSG.RUN_GENERATION: run_generation,
    REQUEST_MSG.DELETE_MODEL: delete_model,
    REQUEST_MSG.LIST_MODELS: get_models,
    REQUEST_MSG.AUTHENTICATE: authentication,
    "syft-command": syft_command,
    **_USER_HANDLERS,
}

_socket_handlers: dict[int, SocketHandler] = {}


def _handler_of(ctx: NodeContext) -> SocketHandler:
    return _socket_handlers.setdefault(id(ctx), SocketHandler())


def _record_handler_failure(ctx: NodeContext, event: str, err: Exception):
    """An exception that LEAKED past a handler (the typed validation
    paths return error dicts and never reach here) is a defect worth a
    postmortem: note it on the flight-recorder ring and trigger a
    rate-limited crash dump on a side thread — the dispatch path pays
    one dict append, never file I/O. Best-effort by contract: the
    boundary's promise is the typed error dict, and a recorder failure
    (thread exhaustion during the very storm this exists for) must not
    replace the exception being reported."""
    if not telemetry.recorder.enabled():
        return
    try:
        telemetry.recorder.note(
            "handler.exception",
            event=event,
            error=str(err),
            error_type=type(err).__name__,
        )
        # rate-limit check FIRST: during a storm, everything past this
        # line (engine-lock snapshot, redaction, a writer thread) runs
        # at most once per interval, not once per exception
        if telemetry.recorder.should_dump("handler_exception"):
            telemetry.recorder.dump_soon(
                "handler_exception",
                snapshot={"event": event, "serving": ctx.serving.stats()},
                error=err,
            )
    except Exception:  # noqa: BLE001 — telemetry must not mask the error
        logger.exception("flight-recorder capture failed")


def _incoming_trace(conn: Connection, parsed: Any):
    """The message's trace context: the wire-v2 frame header (one-shot,
    set by the WS endpoint) wins; legacy framing carries a ``trace``
    field on the envelope; absence means the server synthesizes a root
    (``trace.serve``) so a legacy client's cycle is still traced."""
    incoming, conn.incoming_trace = conn.incoming_trace, None
    if incoming is None and isinstance(parsed, dict):
        incoming = trace.parse_header(parsed.get("trace"))
    return incoming


def _traced_call(conn: Connection, parsed: Any, event: str, fn):
    """Dispatch one event under a served span: adopts (or synthesizes)
    the trace, records the handler span + latency histogram, and leaves
    the span on ``conn.last_trace`` for the response frame's header."""
    import time

    incoming = _incoming_trace(conn, parsed)
    t0 = time.perf_counter()
    with trace.serve(incoming) as tctx:
        conn.last_trace = tctx
        result = fn()
    dt = time.perf_counter() - t0
    telemetry.observe("node_event_seconds", dt, event=event)
    telemetry.record(
        "node.event",
        name=event,
        trace_id=tctx.trace_id,
        span_id=tctx.span_id,
        parent_id=incoming.span_id if incoming is not None else None,
        duration_s=dt,
    )
    return result


def route_requests(
    ctx: NodeContext, message: str | bytes | bytearray, conn: Connection
):
    """(reference events/__init__.py:61-87) one message in, one response out.
    Binary frames carrying a ``{type: ...}`` dict are the msgpack twins of
    the JSON events (the fast wire for FL reports: raw diff bytes, no
    base64, no megabyte JSON parse); any other binary frame routes to the
    per-user worker as before. JSON dispatches on `type`; request_id echoes
    back in either framing."""
    import json

    if isinstance(message, (bytes, bytearray, memoryview)):
        conn.binary_frame = True
        try:
            try:
                parsed = deserialize(message, device=ctx.device)
            except Exception:  # noqa: BLE001 — let the worker frame the error
                return _traced_call(
                    conn, None, "syft-binary",
                    lambda: forward_binary_message(ctx, message, conn),
                )
            if isinstance(parsed, dict) and parsed.get(MSG_FIELD.TYPE) in ROUTES:
                request_id = parsed.get(MSG_FIELD.REQUEST_ID)
                event = parsed[MSG_FIELD.TYPE]

                def _dispatch():
                    try:
                        return ROUTES[event](ctx, parsed, conn)
                    except Exception as err:  # noqa: BLE001 — protocol boundary
                        _record_handler_failure(ctx, event, err)
                        return {ERROR: str(err)}

                response = _traced_call(conn, parsed, event, _dispatch)
                if request_id:
                    response[MSG_FIELD.REQUEST_ID] = request_id
                return serialize(response)
            return _traced_call(
                conn, parsed, "syft-binary",
                lambda: forward_binary_message(
                    ctx, message, conn, decoded=parsed
                ),
            )
        finally:
            conn.binary_frame = False

    request_id = None
    try:
        parsed = json.loads(message)
        request_id = parsed.get(MSG_FIELD.REQUEST_ID)
        event = parsed[MSG_FIELD.TYPE]
        handler = ROUTES[event]

        def _dispatch_json():
            try:
                return handler(ctx, parsed, conn)
            except Exception as err:  # noqa: BLE001 — protocol boundary
                _record_handler_failure(ctx, event, err)
                return {ERROR: str(err)}

        response = _traced_call(conn, parsed, event, _dispatch_json)
    except Exception as err:  # noqa: BLE001 — protocol boundary
        response = {ERROR: str(err)}
    if request_id:
        response[MSG_FIELD.REQUEST_ID] = request_id
    return json.dumps(response, default=_json_bytes)


def _json_bytes(obj: Any) -> str:
    """JSON framing of handler responses that carry payload bytes (the
    handlers base64 for JSON themselves via ``conn.binary_frame``; this
    default is the safety net so a bytes leak degrades to base64 text
    instead of a 500)."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return base64.b64encode(bytes(obj)).decode()
    # json.dumps' default-hook contract REQUIRES TypeError (anything
    # else aborts serialization differently); json internals call this,
    # not the route dispatch, so GL604's boundary reachability holds
    raise TypeError(f"not JSON serializable: {type(obj)!r}")
