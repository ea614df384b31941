"""Client SDK — the grid's user-facing surface, the port's counterpart of
:mod:`pygrid_tpu.client`.

Parity surface: the syft 0.2.9 grid clients the reference consumes
(SURVEY.md §2.4 'Grid clients'): ``ModelCentricFLClient``
(.host_federated_training), ``DataCentricFLClient`` (tensor send/get, model
host/inference, node mesh) and ``FLClient``/``FLJob`` (the edge-worker
training loop with accepted/rejected/error events). All speak the same
JSON-WS/HTTP protocol the Node serves, over the port's own transports
(``client.ws_transport``, :mod:`pygrid_tpu_torch.web.client`), and put
downloaded params on their ``device`` (default ``"cuda"``), and
``PublicGridNetwork`` (grid-wide discovery through a Network), and
``SecAggSession``, a worker's half of a secure-aggregation cycle.
"""

from pygrid_tpu_torch.client.base import GridWSClient
from pygrid_tpu_torch.client.data_centric import DataCentricFLClient
from pygrid_tpu_torch.client.fl_client import FLClient, FLJob
from pygrid_tpu_torch.client.model_centric import ModelCentricFLClient
from pygrid_tpu_torch.client.network import PublicGridNetwork
from pygrid_tpu_torch.client.secagg import SecAggRefusal, SecAggSession

__all__ = [
    "GridWSClient",
    "DataCentricFLClient",
    "FLClient",
    "FLJob",
    "ModelCentricFLClient",
    "PublicGridNetwork",
    "SecAggRefusal",
    "SecAggSession",
]
