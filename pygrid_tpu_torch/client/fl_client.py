"""FLClient / FLJob — the edge-worker training client.

Parity surface: the PySyft ``FLClient``/``FLJob`` pair the reference's
execute-plan notebook drives (``examples/model-centric/02-ExecutePlan.ipynb``
cells 7-15, SURVEY.md §3.3): authenticate (JWT) → optional speed test →
cycle-request → on *accepted* download model checkpoint + plans → local
training → ``job.report(diff)``; *rejected* carries a retry timeout. Events
surface as ACCEPTED / REJECTED / ERROR listener callbacks.

The port's counterpart of :mod:`pygrid_tpu.client.fl_client`: HTTP through
:mod:`pygrid_tpu_torch.web.client`, downloaded params as tensors on the
client's ``device`` (default ``"cuda"``), where the job trains.
"""

from __future__ import annotations

import base64
import time
from typing import Any, Callable

import torch

from pygrid_tpu_torch.client.base import GridWSClient
from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.plans.state import serialize_model_params, unserialize_model_params
from pygrid_tpu_torch.serde import deserialize
from pygrid_tpu_torch.telemetry import trace
from pygrid_tpu_torch.utils.codes import CYCLE, MODEL_CENTRIC_FL_EVENTS, MSG_FIELD
from pygrid_tpu_torch.utils.exceptions import PyGridError
from pygrid_tpu_torch.web import client as http


class FLJob:
    EVENT_ACCEPTED = "accepted"
    EVENT_REJECTED = "rejected"
    EVENT_ERROR = "error"

    def __init__(
        self,
        client: "FLClient",
        model_name: str,
        model_version: str | None = None,
    ) -> None:
        self.client = client
        self.model_name = model_name
        self.model_version = model_version
        self._listeners: dict[str, list[Callable]] = {
            self.EVENT_ACCEPTED: [],
            self.EVENT_REJECTED: [],
            self.EVENT_ERROR: [],
        }
        #: the job's trace root: every request this job makes (download,
        #: report — and the training gap between them) shares this
        #: trace_id, so the node can stitch the whole round into one
        #: trace (GET /telemetry/cycles/<id> lists it)
        self.trace_ctx = trace.TraceContext(
            trace.new_trace_id(), trace.new_span_id()
        )
        # filled on accept
        self.worker_id: str | None = None
        self.request_key: str | None = None
        self.model_params: list | None = None
        self.plans: dict[str, Any] = {}
        self.client_config: dict = {}
        self.timeout: int | None = None  # retry window on reject
        #: worker-side overrides; otherwise the hosted process's
        #: client_config ("diff_precision" / "diff_compression") decides
        self.diff_precision: str | None = None
        self.diff_compression: dict | None = None

    def add_listener(self, event: str, callback: Callable) -> None:
        self._listeners[event].append(callback)

    def _emit(self, event: str, *args: Any) -> None:
        for cb in self._listeners[event]:
            cb(self, *args)

    # ── the cycle flow (SURVEY §3.3 steps 1-6) ─────────────────────────────

    def start(self, ping: float = 1.0, download: float = 1000.0,
              upload: float = 1000.0) -> None:
        try:
            with trace.use(self.trace_ctx):
                self._start_traced(ping, download, upload)
        except Exception as err:  # noqa: BLE001 — event boundary
            self._emit(self.EVENT_ERROR, err)

    def _start_traced(
        self, ping: float, download: float, upload: float
    ) -> None:
        auth = self.client.authenticate(
            self.model_name, self.model_version
        )
        if auth.get("error"):
            raise PyGridError(auth["error"])
        self.worker_id = auth[MSG_FIELD.WORKER_ID]
        if auth.get(MSG_FIELD.REQUIRES_SPEED_TEST):
            ping, download, upload = self.client.speed_test(self.worker_id)
        cycle = self.client.cycle_request(
            self.worker_id, self.model_name, self.model_version,
            ping=ping, download=download, upload=upload,
        )
        if cycle.get(CYCLE.STATUS) == CYCLE.ACCEPTED:
            self.request_key = cycle[CYCLE.KEY]
            self.client_config = cycle.get(CYCLE.CLIENT_CONFIG) or {}
            model_id = cycle[MSG_FIELD.MODEL_ID]
            with trace.span("client.download", model=self.model_name):
                self.model_params = self.client.get_model(
                    self.worker_id,
                    self.request_key,
                    model_id,
                    precision=self.client_config.get("model_precision"),
                )
                self.plans = {
                    name: self.client.get_plan(
                        self.worker_id, self.request_key, plan_id
                    )
                    for name, plan_id in (cycle.get(CYCLE.PLANS) or {}).items()
                }
            self._emit(self.EVENT_ACCEPTED)
        else:
            self.timeout = cycle.get(CYCLE.TIMEOUT)
            self._emit(self.EVENT_REJECTED, self.timeout)

    def report(self, diff_params: list) -> dict:
        """Upload the weight diff (reference fl_events.py report:237-271).

        ``client_config["diff_precision"] = "bf16"`` ships bfloat16 — half
        the upload bytes. ``client_config["diff_compression"] = {"name":
        "topk", "fraction": f}`` ships only the top-f fraction of entries
        per tensor, with the dropped remainder carried into this client's
        next report (error feedback — federated/compression.py)."""
        with trace.use(self.trace_ctx):
            with trace.span("client.report", model=self.model_name):
                return self._report_traced(diff_params)

    def _report_traced(self, diff_params: list) -> dict:
        import numpy as np

        def host(d):  # a diff on the card crosses to the host once
            if isinstance(d, torch.Tensor):
                return d.detach().cpu().numpy()
            return np.asarray(d)

        local_dp = self.client_config.get("local_dp")
        if local_dp:
            # client-side clip + noise BEFORE anything ships — composes
            # with secure aggregation, unlike server-side DP
            from pygrid_tpu_torch.federated.privacy import local_dp_noise

            diff_params = local_dp_noise(
                [host(d) for d in diff_params],
                float(local_dp["clip_norm"]),
                float(local_dp.get("noise_multiplier", 0.0)),
            )
        precision = self.diff_precision or self.client_config.get("diff_precision")
        bf16 = precision == "bf16"
        compression = (
            self.diff_compression
            or self.client_config.get("diff_compression")
            or {}
        )
        if compression.get("name") == "topk":
            from pygrid_tpu_torch.federated.compression import topk_compress
            from pygrid_tpu_torch.serde import serialize

            diffs = [host(d) for d in diff_params]
            res_key = (self.model_name, self.model_version)
            residual = self.client._residuals.get(res_key)
            if residual is not None and (
                len(residual) != len(diffs)
                or any(
                    np.shape(r) != np.shape(d)
                    for r, d in zip(residual, diffs)
                )
            ):
                residual = None  # model changed under the same name: reset
            payload, new_residual = topk_compress(
                diffs,
                float(compression.get("fraction", 0.1)),
                residual=residual,
            )
            blob = serialize(payload, bf16_floats=bf16)
            response = self.client.report(
                self.worker_id, self.request_key, blob
            )
            if not response.get("error"):
                # error feedback's invariant — everything not yet applied
                # server-side lives in the residual — only holds if the
                # residual commits AFTER the report landed
                self.client._residuals[res_key] = new_residual
            return response
        blob = serialize_model_params(list(diff_params), bf16=bf16)
        # version rides the fold-group hint: two processes hosting
        # different versions of one model name must never share a
        # sub-aggregator partial sum
        hint = self.model_name
        if self.model_version:
            hint = f"{hint}@{self.model_version}"
        return self.client.report(
            self.worker_id, self.request_key, blob,
            model_name=hint,
        )


class FLClient:
    """``wire="json"`` speaks the reference's base64-in-JSON contract
    (syft.js-era clients pin it); ``wire="binary"`` speaks the msgpack twin
    — raw diff bytes, bf16 payload floats — for clients built against this
    framework. ``wire="auto"`` (the default) OFFERS the wire-v2 binary
    subprotocol at the websocket handshake and transparently falls back to
    the JSON contract when the node doesn't take it — new nodes get the
    fast path, old nodes keep working, no configuration. Same events, same
    node, one semantic.

    ``codec`` rides the same handshake: "auto" offers every compression
    codec this build has (zstd when installed, zlib always), a name forces
    one, None disables frame compression."""

    def __init__(
        self,
        url: str,
        auth_token: str | None = None,
        verbose: bool = False,
        timeout: float = 60.0,
        wire: str = "auto",
        codec: str | None = None,
        aggregator_url: str | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        #: where downloaded checkpoints land and the job trains
        self.device = resolve(device)
        if wire not in ("json", "binary", "auto"):
            raise ValueError("wire must be 'json', 'binary' or 'auto'")
        if codec not in (None, "auto"):
            from pygrid_tpu_torch.serde import available_codecs

            # a forced codec this build can't DECODE would fail on the
            # first download — reject at construction on every wire mode
            # (the WS offer path only validates when it actually offers)
            if codec not in available_codecs():
                raise ValueError(
                    f"codec {codec!r} not available "
                    f"(have {available_codecs()})"
                )
        # a json-pinned client must be wire-identical to a v1 build: it
        # never offers the subprotocol (the negotiation tests rely on this
        # to impersonate old clients)
        self.ws = GridWSClient(
            url,
            timeout=timeout,
            offer_wire_v2=wire != "json",
            codec=codec,
        )
        self.address = self.ws.address
        self.auth_token = auth_token
        self.verbose = verbose
        self.wire = wire
        self.codec = codec
        self._timeout = timeout
        # plans are immutable per id once hosted (PlanManager stores the
        # variants at host time), so refetching across cycles is pure waste
        self._plan_cache: dict[tuple[int, str], Any] = {}
        # top-k error-feedback residuals per (model, version), carried
        # across cycles
        self._residuals: dict[tuple, list] = {}
        # keep-alive HTTP: checkpoint downloads happen once per cycle
        # per worker — both fresh TCP connects and requests' per-call
        # bookkeeping cost more than the transfer on loopback grids
        from pygrid_tpu_torch.client.ws_transport import KeepAliveHTTP

        self._http = KeepAliveHTTP(self.address, timeout=timeout)
        #: sub-aggregator report routing (docs/AGGREGATION.md): when the
        #: network's placement assigns one, reports dial it instead of
        #: the node; any failure falls back to a direct node report —
        #: the hierarchy is an optimization, never a correctness gate
        self.aggregator_url = aggregator_url
        self._agg_ws: GridWSClient | None = None
        #: the address _agg_ws was dialed to — a cached socket is only
        #: reused while placement still names the same sub-aggregator
        self._agg_ws_url: str | None = None

    def new_job(self, model_name: str, model_version: str | None = None) -> FLJob:
        return FLJob(self, model_name, model_version)

    def _binary_framing(self) -> bool:
        """Whether events go out as msgpack frames. "binary" always;
        "auto" only once the handshake negotiated wire v2 (connecting to
        decide is exactly the point of the handshake); "json" never."""
        if self.wire == "binary":
            return True
        if self.wire == "auto":
            self.ws.connect()
            return self.ws.wire_v2
        return False

    def _send_event(self, msg_type: str, data: dict) -> dict:
        if self._binary_framing():
            return self.ws.send_msg_binary(msg_type, data=data)
        return self.ws.send_json(msg_type, data=data)

    # ── protocol steps ─────────────────────────────────────────────────────

    def authenticate(self, model_name: str, model_version: str | None) -> dict:
        response = self._send_event(
            MODEL_CENTRIC_FL_EVENTS.AUTHENTICATE,
            data={
                "auth_token": self.auth_token,
                "model_name": model_name,
                "model_version": model_version,
            },
        )
        return response.get(MSG_FIELD.DATA, response)

    def speed_test(
        self, worker_id: str, sample_bytes: int = 1024 * 1024
    ) -> tuple[float, float, float]:
        """Measure ping/download/upload against /model-centric/speed-test
        (reference routes.py:62-99; 64MB default sample trimmed via ?size=)."""
        url = f"{self.address}/model-centric/speed-test"
        params = {"worker_id": worker_id, "random": "1"}
        t0 = time.monotonic()
        http.get(url, params={**params, "is_ping": "1"}, timeout=30)
        ping_ms = (time.monotonic() - t0) * 1000
        t0 = time.monotonic()
        resp = http.get(
            url, params={**params, "size": str(sample_bytes)}, timeout=60
        )
        dl = len(resp.content) / max(time.monotonic() - t0, 1e-9) / 125_000
        t0 = time.monotonic()
        http.post(url, params=params, data=b"x" * sample_bytes, timeout=60)
        ul = sample_bytes / max(time.monotonic() - t0, 1e-9) / 125_000
        return ping_ms, dl, ul  # ms, Mbps, Mbps

    def cycle_request(
        self,
        worker_id: str,
        model_name: str,
        model_version: str | None,
        ping: float,
        download: float,
        upload: float,
    ) -> dict:
        response = self._send_event(
            MODEL_CENTRIC_FL_EVENTS.CYCLE_REQUEST,
            data={
                MSG_FIELD.WORKER_ID: worker_id,
                MSG_FIELD.MODEL: model_name,
                CYCLE.VERSION: model_version,
                CYCLE.PING: ping,
                CYCLE.DOWNLOAD: download,
                CYCLE.UPLOAD: upload,
            },
        )
        return response.get(MSG_FIELD.DATA, response)

    def get_model(
        self,
        worker_id: str,
        request_key: str,
        model_id: int,
        precision: str | None = None,
    ) -> list:
        """Download the current checkpoint. ``precision="bf16"`` asks the
        node to re-encode float32 params as bfloat16 on the way out — half
        the download, the dtype client training runs in on TPU anyway.

        On a negotiated wire-v2 connection the checkpoint rides the SAME
        websocket as the rest of the cycle (raw msgpack bytes, frame
        compression per the handshake) — no second TCP connection, no
        base64. Otherwise: keep-alive HTTP, optionally asking the node for
        a compressed body via ``?codec=`` (detected by response header, so
        an old node that ignores the param still interoperates)."""
        if self._binary_framing() and self.ws.wire_v2:
            response = self._send_event(
                MODEL_CENTRIC_FL_EVENTS.GET_MODEL,
                data={
                    MSG_FIELD.WORKER_ID: worker_id,
                    CYCLE.KEY: request_key,
                    MSG_FIELD.MODEL_ID: model_id,
                    **({"precision": precision} if precision else {}),
                },
            )
            data = response.get(MSG_FIELD.DATA, response)
            if data.get("error"):
                raise PyGridError(data["error"])
            blob = data[MSG_FIELD.MODEL]
            if isinstance(blob, str):  # JSON framing fallback: base64
                blob = base64.b64decode(blob)
            if data.get("model_wire") == "v2-frame":
                # the node served the checkpoint pre-compressed from its
                # per-checkpoint blob cache — one frame envelope to unwrap
                from pygrid_tpu_torch.serde import decode_frame

                return unserialize_model_params(
                    decode_frame(bytes(blob)), device=self.device
                )
            return unserialize_model_params(bytes(blob), device=self.device)
        params = {
            "worker_id": worker_id,
            "request_key": request_key,
            "model_id": str(model_id),
        }
        if precision:
            params["precision"] = precision
        if self.codec:
            from pygrid_tpu_torch.serde import available_codecs

            want = (
                available_codecs()[0] if self.codec == "auto" else self.codec
            )
            params["codec"] = want
        # X-PyGrid-Trace ties the HTTP checkpoint download into the same
        # trace as the WS cycle events (the node's middleware adopts it)
        hdr = trace.header()
        status, body = self._http.get(
            "/model-centric/get-model",
            params,
            headers={trace.TRACE_HEADER: hdr} if hdr else None,
        )
        if status != 200:
            raise PyGridError(body.decode(errors="replace"))
        if self._http.last_headers.get("x-pygrid-wire") == "v2-frame":
            from pygrid_tpu_torch.serde import decode_frame

            body = decode_frame(body)
        return unserialize_model_params(body, device=self.device)

    def get_plan(
        self,
        worker_id: str,
        request_key: str,
        plan_id: int,
        receive_operations_as: str = "xla",
    ) -> Any:
        cached = self._plan_cache.get((plan_id, receive_operations_as))
        if cached is not None:
            return cached
        status, body = self._http.get(
            "/model-centric/get-plan",
            {
                "worker_id": worker_id,
                "request_key": request_key,
                "plan_id": str(plan_id),
                "receive_operations_as": receive_operations_as,
            },
        )
        if status != 200:
            raise PyGridError(body.decode(errors="replace"))
        plan = deserialize(body, device=self.device)
        self._plan_cache[(plan_id, receive_operations_as)] = plan
        return plan

    def report_metrics(
        self,
        worker_id: str,
        request_key: str,
        loss: float | None = None,
        acc: float | None = None,
        n_samples: int = 1,
    ) -> dict:
        """Attach local training metrics to this assignment — the node
        aggregates them sample-weighted per cycle (GET
        /model-centric/cycle-metrics). Accepted after the cycle closes."""
        metrics: dict = {"n_samples": n_samples}
        if loss is not None:
            metrics["loss"] = float(loss)
        if acc is not None:
            metrics["acc"] = float(acc)
        response = self._send_event(
            MODEL_CENTRIC_FL_EVENTS.REPORT_METRICS,
            data={
                MSG_FIELD.WORKER_ID: worker_id,
                CYCLE.KEY: request_key,
                "metrics": metrics,
            },
        )
        return response.get(MSG_FIELD.DATA, response)

    def report(
        self,
        worker_id: str,
        request_key: str,
        diff_blob: bytes,
        model_name: str | None = None,
    ) -> dict:
        if self.aggregator_url:
            response = self._report_via_aggregator(
                worker_id, request_key, diff_blob, model_name
            )
            if response is not None:
                return response
            # sub-aggregator unreachable or refusing (killed mid-cycle,
            # unsupported envelope): drop the assignment and report
            # direct — the node's slot for this key is still open
            self.aggregator_url = None
        if self._binary_framing():
            response = self._send_event(
                MODEL_CENTRIC_FL_EVENTS.REPORT,
                data={
                    MSG_FIELD.WORKER_ID: worker_id,
                    CYCLE.KEY: request_key,
                    CYCLE.DIFF: diff_blob,
                },
            )
        else:
            # spliced framing: wire-identical to a plain JSON report, but
            # the megabyte base64 field skips the dumps escape scan
            response = self.ws.send_json_spliced(
                MODEL_CENTRIC_FL_EVENTS.REPORT,
                data={
                    MSG_FIELD.WORKER_ID: worker_id,
                    CYCLE.KEY: request_key,
                },
                raw_key=CYCLE.DIFF,
                raw_value=base64.b64encode(diff_blob),
            )
        return response.get(MSG_FIELD.DATA, response)

    def _report_via_aggregator(
        self,
        worker_id: str,
        request_key: str,
        diff_blob: bytes,
        model_name: str | None,
    ) -> dict | None:
        """One report through the assigned sub-aggregator; None means
        "fall back to a direct node report" (dead or refusing
        aggregator). The ``model`` hint keys the sub-aggregator's fold
        group so concurrent FL processes never share a partial sum."""
        from pygrid_tpu_torch.utils.codes import MODEL_CENTRIC_FL_EVENTS

        try:
            if (
                self._agg_ws is not None
                and self._agg_ws_url != self.aggregator_url
            ):
                # placement re-assigned this worker between cycles: a
                # socket cached for the PREVIOUS sub-aggregator must
                # not swallow reports meant for the new one
                self._agg_ws.close()
                self._agg_ws = None
            if self._agg_ws is None:
                self._agg_ws = GridWSClient(
                    self.aggregator_url,
                    timeout=self._timeout,
                    offer_wire_v2=True,
                )
                self._agg_ws_url = self.aggregator_url
            response = self._agg_ws.send_msg_binary(
                MODEL_CENTRIC_FL_EVENTS.REPORT,
                data={
                    MSG_FIELD.WORKER_ID: worker_id,
                    CYCLE.KEY: request_key,
                    CYCLE.DIFF: diff_blob,
                    **({MSG_FIELD.MODEL: model_name} if model_name else {}),
                },
            )
            data = response.get(MSG_FIELD.DATA, response)
            if data.get("error"):
                # a refusing aggregator won't be dialed again (caller
                # clears aggregator_url) — drop the socket now rather
                # than holding it for the client's remaining lifetime
                self._agg_ws.close()
                self._agg_ws = None
                return None
            return data
        except Exception:  # noqa: BLE001 — fallback is the contract
            try:
                if self._agg_ws is not None:
                    self._agg_ws.close()
            finally:
                self._agg_ws = None
            return None

    def close(self) -> None:
        self.ws.close()
        self._http.close()
        if self._agg_ws is not None:
            self._agg_ws.close()
