"""Node registry.

Parity surface: reference ``apps/network/src/app/network/network_manager.py``
(register_new_node:11, delete_node:26, connected_nodes:44) over the
``GridNodes`` schema (``network/nodes.py:4-18``). The port's copy of
:mod:`pygrid_tpu.network.manager`, over the port's warehouse.
"""

from __future__ import annotations

from dataclasses import dataclass

from pygrid_tpu_torch.storage.warehouse import Database, Warehouse


@dataclass
class GridNode:
    id: str = ""
    address: str = ""


class NetworkManager:
    def __init__(self, db: Database) -> None:
        self._nodes = Warehouse(GridNode, db)

    def register_new_node(self, node_id: str, node_address: str) -> bool:
        if self._nodes.contains(id=node_id):
            return False
        self._nodes.register(id=node_id, address=node_address)
        return True

    def delete_node(self, node_id: str, node_address: str) -> bool:
        if not self._nodes.contains(id=node_id, address=node_address):
            return False
        self._nodes.delete(id=node_id)
        return True

    def connected_nodes(self) -> dict[str, str]:
        return {n.id: n.address for n in self._nodes.query()}
