"""PublicGridNetwork — grid-wide discovery client.

Parity surface: syft 0.2.9 ``PublicGridNetwork`` as the reference's
data-centric MNIST example drives it
(``examples/data-centric/mnist/02-FL-mnist-train-model.ipynb`` cell 50:
``grid.search("#X", "#mnist")`` returning {node_id: [pointers]}), over the
Network's fan-out routes (reference ``apps/network/src/app/routes/
network.py``: /search, /search-model, /search-available-models,
/search-available-tags, /search-encrypted-model, /choose-model-host).

The port's counterpart of :mod:`pygrid_tpu.client.network`: HTTP through
:mod:`pygrid_tpu_torch.web.client`, and the node clients it dials are the
port's :class:`DataCentricFLClient` on ``device`` (default ``"cuda"``),
where the tensors those nodes send back land.
"""

from __future__ import annotations

from typing import Any

import torch

from pygrid_tpu_torch.client.data_centric import DataCentricFLClient
from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.runtime.pointers import PointerTensor
from pygrid_tpu_torch.utils.exceptions import PyGridError
from pygrid_tpu_torch.web import client as http


class PublicGridNetwork:
    def __init__(
        self,
        gateway_url: str,
        timeout: float = 30.0,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve(device)
        self.gateway_url = gateway_url.rstrip("/")
        self.timeout = timeout
        self._clients: dict[str, DataCentricFLClient] = {}

    def _get(self, path: str, **params: Any) -> Any:
        resp = http.get(
            self.gateway_url + path, params=params, timeout=self.timeout
        )
        if resp.status_code != 200:
            raise PyGridError(resp.text)
        return resp.json()

    def _post(self, path: str, body: dict) -> Any:
        resp = http.post(
            self.gateway_url + path, json=body, timeout=self.timeout
        )
        if resp.status_code != 200:
            raise PyGridError(resp.text)
        return resp.json()

    def _client(self, node_id: str, address: str) -> DataCentricFLClient:
        if node_id not in self._clients:
            self._clients[node_id] = DataCentricFLClient(
                address, id=node_id, timeout=self.timeout, device=self.device
            )
        return self._clients[node_id]

    # ── discovery ───────────────────────────────────────────────────────────

    def search(self, *query: str) -> dict[str, list[PointerTensor]]:
        """Dataset search across the grid (reference network.py:266-306 →
        per-node worker search), returning node_id → pointers."""
        matches = self._post("/search", {"query": list(query)})
        out: dict[str, list[PointerTensor]] = {}
        for node_id, address in matches.get("match-nodes", []):
            client = self._client(node_id, address)
            found = client.search(*query)
            if found:
                out[node_id] = found
        return out

    def search_available_models(self) -> list[str]:
        return self._get("/search-available-models").get("models", [])

    def search_available_tags(self) -> list[str]:
        return self._get("/search-available-tags").get("tags", [])

    def search_model(self, model_id: str) -> list[dict]:
        return self._post("/search-model", {"model_id": model_id}).get(
            "match-nodes", []
        )

    def search_encrypted_model(self, model_id: str) -> dict[str, dict]:
        """Share-holder discovery for an encrypted model (reference
        network.py:157-198)."""
        return self._post(
            "/search-encrypted-model", {"model_id": model_id}
        ).get("match-nodes", {})

    def choose_model_host(self, model_id: str | None = None) -> list:
        """[(node_id, address)] hosts (n_replica server-side; pass model_id
        to prefer nodes already hosting it — reference network.py:134-155)."""
        params = {"model_id": model_id} if model_id else {}
        return self._get("/choose-model-host", **params)

    def choose_encrypted_model_host(self) -> list:
        return self._get("/choose-encrypted-model-host")

    def connected_nodes(self) -> dict[str, str]:
        return self._get("/connected-nodes").get("grid-nodes", {})

    def close(self) -> None:
        for client in self._clients.values():
            client.close()
        self._clients.clear()
