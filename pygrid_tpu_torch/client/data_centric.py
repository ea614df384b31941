"""DataCentricFLClient — remote-node handle for data scientists.

Parity surface: syft 0.2.9 ``DataCentricFLClient`` as the reference uses it
(tests ``tests/data_centric/test_basic_syft_operations.py``, node-to-node
mesh at ``events/data_centric/control_events.py:44-54``, serve/query flows
in the data-centric notebooks). The client IS a pointer *location*: it
implements ``recv_obj_msg`` by shipping the same serde bytes the in-process
:class:`VirtualWorker` consumes, so ``x.send(client)``, pointer arithmetic,
``.get()``, ``.move(other_client)`` and SMPC share placement work unchanged
against a remote node.

The port's counterpart of :mod:`pygrid_tpu.client.data_centric`: HTTP
through :mod:`pygrid_tpu_torch.web.client`; objects that hold tensors (a
downloaded model, a shared tensor in a response) decode onto the client's
``device`` (default ``"cuda"``). Values fetched through pointers arrive as
numpy arrays, as from any wire location.
"""

from __future__ import annotations

import base64
from typing import Any, Iterable

import numpy as np
import torch

from pygrid_tpu_torch.client.base import GridWSClient
from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.runtime import messages as M
from pygrid_tpu_torch.runtime.pointers import PointerTensor, _raise_if_error
from pygrid_tpu_torch.runtime.pointers import send as _send
from pygrid_tpu_torch.serde import deserialize, serialize
from pygrid_tpu_torch.utils.codes import CONTROL_EVENTS, MSG_FIELD, REQUEST_MSG
from pygrid_tpu_torch.utils.exceptions import PyGridError
from pygrid_tpu_torch.web import client as http


class DataCentricFLClient:
    def __init__(
        self,
        address: str,
        id: str | None = None,
        username: str = "admin",
        password: str = "admin",
        auto_login: bool = True,
        timeout: float = 30.0,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve(device)
        self.ws = GridWSClient(address, timeout=timeout)
        self.address = self.ws.address
        self._auth_token: str | None = None
        self.id = id or ""
        if auto_login:
            self.login(username, password)
        if not self.id:
            self.id = self.get_node_infos()[MSG_FIELD.NODE_ID]

    # ── control events ──────────────────────────────────────────────────────

    def login(self, username: str, password: str) -> None:
        response = self.ws.send_json(
            REQUEST_MSG.AUTHENTICATE,
            **{
                MSG_FIELD.USERNAME_FIELD: username,
                MSG_FIELD.PASSWORD_FIELD: password,
            },
        )
        if "error" in response:
            raise PyGridError(response["error"])
        self._auth_token = response.get("token")
        self._session_worker = response.get(MSG_FIELD.NODE_ID)

    def get_node_infos(self) -> dict:
        return self.ws.send_json(REQUEST_MSG.GET_ID)

    def connect_nodes(self, other: "DataCentricFLClient") -> dict:
        """Mesh this node to another (reference control_events.py:44-54)."""
        return self.ws.send_json(
            REQUEST_MSG.CONNECT_NODE,
            id=other.id,
            address=other.address,
        )

    def ping(self) -> bool:
        return (
            self.ws.send_json(CONTROL_EVENTS.SOCKET_PING).get(
                MSG_FIELD.ALIVE
            )
            == "True"
        )

    def close(self) -> None:
        self.ws.close()

    # ── the pointer location interface ──────────────────────────────────────

    def recv_obj_msg(self, msg: Any, user: str | None = None) -> Any:
        """Serialize → binary WS frame → deserialize; typed errors raise
        (mirrors VirtualWorker.recv_obj_msg semantics for callers)."""
        response = deserialize(
            self.ws.send_binary(serialize(msg)), device=self.device
        )
        return _raise_if_error(response)

    # ── tensor API (syft-style) ─────────────────────────────────────────────

    def send(
        self,
        x: Any,
        tags: Iterable[str] = (),
        description: str = "",
        allowed_users: Iterable[str] | None = None,
        garbage_collect_data: bool = True,
    ) -> PointerTensor:
        return _send(
            x,
            self,
            tags=tags,
            description=description,
            allowed_users=allowed_users,
            garbage_collect_data=garbage_collect_data,
        )

    def search(self, *query: str) -> list[PointerTensor]:
        found = self.recv_obj_msg(M.SearchMessage(query=list(query)))
        return [
            PointerTensor(
                location=self,
                id_at_location=p.id_at_location,
                shape=tuple(p.shape),
                tags=p.tags,
            )
            for p in found
        ]

    def run_plan(self, plan_ptr: PointerTensor, *args: Any) -> PointerTensor:
        from pygrid_tpu_torch.plans.placeholder import fresh_id

        resp = self.recv_obj_msg(
            M.RunPlanMessage(
                plan_id=plan_ptr.id_at_location,
                args=[
                    M.ref(a.id_at_location)
                    if isinstance(a, PointerTensor)
                    else np.asarray(a)
                    for a in args
                ],
                return_id=fresh_id(),
            )
        )
        return PointerTensor(
            location=self,
            id_at_location=resp.id_at_location,
            shape=tuple(resp.shape),
        )

    # ── hosted-model API (reference model_events.py) ────────────────────────

    def serve_model(
        self,
        model: Any,
        model_id: str,
        allow_download: bool = False,
        allow_remote_inference: bool = False,
        mpc: bool = False,
    ) -> dict:
        blob = model if isinstance(model, (bytes, bytearray)) else serialize(model)
        return self.ws.send_json(
            REQUEST_MSG.HOST_MODEL,
            **{
                MSG_FIELD.MODEL: base64.b64encode(bytes(blob)).decode(),
                MSG_FIELD.MODEL_ID: model_id,
                MSG_FIELD.ALLOW_DOWNLOAD: str(allow_download),
                MSG_FIELD.ALLOW_REMOTE_INFERENCE: str(allow_remote_inference),
                MSG_FIELD.MPC: str(mpc),
            },
        )

    def download_model(self, model_id: str) -> Any:
        """Fetch a hosted model/plan blob (requires ``allow_download`` on the
        hosted model and a session token)."""
        resp = http.get(
            f"{self.address}/data-centric/serve-model/",
            params={"model_id": model_id},
            headers={"token": self._auth_token or ""},
            timeout=self.ws.timeout,
        )
        if resp.status_code != 200:
            raise PyGridError(resp.text)
        return deserialize(resp.content, device=self.device)

    def run_remote_inference(self, model_id: str, data: Any) -> Any:
        response = self.ws.send_json(
            REQUEST_MSG.RUN_INFERENCE,
            **{
                MSG_FIELD.MODEL_ID: model_id,
                MSG_FIELD.DATA: base64.b64encode(serialize(data)).decode(),
            },
        )
        if not response.get("success"):
            raise PyGridError(response.get("error", "inference failed"))
        return np.asarray(response["prediction"])

    def run_remote_generation(
        self,
        model_id: str,
        prompt: Any,
        n_new: int = 16,
        temperature: float = 0.0,
        seed: int | None = None,
    ) -> Any:
        """Autoregressive generation from a hosted transformer bundle
        (``models.decode.bundle``): int prompt [B, P] → int tokens
        [B, n_new]. Greedy at ``temperature=0``, else sampled (``seed``
        makes the server's sampling reproducible)."""
        payload = {
            MSG_FIELD.MODEL_ID: model_id,
            MSG_FIELD.DATA: base64.b64encode(
                serialize(np.asarray(prompt))
            ).decode(),
            "n_new": int(n_new),
            "temperature": float(temperature),
        }
        if seed is not None:
            payload["seed"] = int(seed)
        response = self.ws.send_json(REQUEST_MSG.RUN_GENERATION, **payload)
        if not response.get("success"):
            raise PyGridError(response.get("error", "generation failed"))
        return np.asarray(response["tokens"])

    def delete_model(self, model_id: str) -> dict:
        return self.ws.send_json(
            REQUEST_MSG.DELETE_MODEL, **{MSG_FIELD.MODEL_ID: model_id}
        )

    @property
    def models(self) -> list[str]:
        return self.ws.send_json(REQUEST_MSG.LIST_MODELS).get(
            MSG_FIELD.MODELS, []
        )

    def __repr__(self) -> str:
        return f"DataCentricFLClient(id={self.id!r}, address={self.address!r})"
