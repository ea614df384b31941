"""ModelCentricFLClient — the data scientist's FL hosting client.

Parity surface: syft 0.2.9 ``ModelCentricFLClient.host_federated_training``
as driven in reference ``examples/model-centric/01-Create-plan.ipynb``
(cell 39) and ``tests/model_centric/test_fl_process.py:46-97``: hex-encoded
model State, plan dict, optional protocols, avg plan, and the two configs on
the WS ``model-centric/host-training`` event; checkpoint retrieval over HTTP
``/model-centric/retrieve-model``.

The port's counterpart of :mod:`pygrid_tpu.client.model_centric`: HTTP
through :mod:`pygrid_tpu_torch.web.client`, retrieved checkpoints on the
client's ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

import binascii
from typing import Any, Sequence

import torch

from pygrid_tpu_torch.client.base import GridWSClient
from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.plans.state import serialize_model_params, unserialize_model_params
from pygrid_tpu_torch.serde import serialize
from pygrid_tpu_torch.utils.codes import CYCLE, MODEL_CENTRIC_FL_EVENTS, MSG_FIELD
from pygrid_tpu_torch.utils.exceptions import PyGridError
from pygrid_tpu_torch.web import client as http


def _hex(blob: bytes) -> str:
    return binascii.hexlify(blob).decode()


class ModelCentricFLClient:
    def __init__(
        self,
        address: str,
        timeout: float = 60.0,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve(device)
        self.ws = GridWSClient(address, timeout=timeout)
        self.address = self.ws.address

    def host_federated_training(
        self,
        model: Sequence[Any] | bytes,
        client_plans: dict[str, Any],
        client_config: dict,
        server_config: dict,
        server_averaging_plan: Any = None,
        client_protocols: dict[str, Any] | None = None,
    ) -> dict:
        """Host an FL process. ``model`` is a list of parameter arrays (or a
        pre-serialized State blob); plans may be Plan objects or blobs."""
        model_blob = (
            bytes(model)
            if isinstance(model, (bytes, bytearray))
            else serialize_model_params(list(model))
        )

        def _blob(p: Any) -> bytes:
            return bytes(p) if isinstance(p, (bytes, bytearray)) else serialize(p)

        data = {
            MSG_FIELD.MODEL: _hex(model_blob),
            CYCLE.PLANS: {k: _hex(_blob(v)) for k, v in client_plans.items()},
            CYCLE.PROTOCOLS: {
                k: _hex(_blob(v)) for k, v in (client_protocols or {}).items()
            },
            CYCLE.AVG_PLAN: _hex(_blob(server_averaging_plan))
            if server_averaging_plan is not None
            else None,
            CYCLE.CLIENT_CONFIG: client_config,
            CYCLE.SERVER_CONFIG: server_config,
        }
        response = self.ws.send_json(
            MODEL_CENTRIC_FL_EVENTS.HOST_FL_TRAINING, data=data
        )
        payload = response.get(MSG_FIELD.DATA, response)
        if payload.get("error"):
            raise PyGridError(payload["error"])
        return payload

    def retrieve_model(
        self,
        name: str,
        version: str | None = None,
        checkpoint: str | int | None = None,
    ) -> list:
        """Download a checkpoint's params by name/version/alias-or-number
        (reference routes.py:471-516), as tensors on the client's device."""
        params: dict[str, Any] = {"name": name}
        if version is not None:
            params["version"] = version
        if checkpoint is not None:
            params["checkpoint"] = str(checkpoint)
        resp = http.get(
            f"{self.address}/model-centric/retrieve-model", params=params,
            timeout=60,
        )
        if resp.status_code != 200:
            raise PyGridError(resp.text)
        return unserialize_model_params(resp.content, device=self.device)

    def cycle_metrics(
        self, name: str, version: str | None = None
    ) -> list[dict]:
        """Per-cycle sample-weighted training metrics the fleet reported
        (loss/acc/report counts) — the training curve without any raw
        data leaving workers."""
        params: dict[str, Any] = {"name": name}
        if version is not None:
            params["version"] = version
        resp = http.get(
            f"{self.address}/model-centric/cycle-metrics", params=params,
            timeout=30,
        )
        if resp.status_code != 200:
            raise PyGridError(resp.text)
        return resp.json()["cycles"]

    def close(self) -> None:
        self.ws.close()
