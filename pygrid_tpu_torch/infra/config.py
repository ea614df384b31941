"""Deployment configuration model — the port's counterpart of
:mod:`pygrid_tpu.infra.config`, for GPU hosts.

Parity: the reference builds an ad-hoc ``Config`` attribute bag in the CLI
(``apps/infrastructure/cli/utils.py``, filled by ``cli.py:53-113``) and the
API re-reads it as nested dicts (``api/__main__.py:17-28``). Here the shape
is explicit dataclasses with the same field names (provider,
deployment_type, websockets, app{name,id,host,port,network}, credentials)
plus the accelerator block the reference's AWS ``vpc`` section becomes:
here :class:`GpuConfig` (``DeployConfig.gpu``, a ``"gpu"`` block in
:meth:`DeployConfig.from_dict`) where the JAX package has its ``TpuConfig``.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any

PROVIDERS = ("gcp", "local", "aws", "azure")
APPS = ("node", "network", "worker")
DEPLOYMENT_TYPES = ("serverfull", "serverless")


@dataclass
class AppConfig:
    """The grid app being deployed (reference cli.py:115-154)."""

    name: str = "node"
    id: str | None = None
    host: str = "0.0.0.0"
    port: int = 5000
    network: str | None = None
    num_replicas: int = 1

    def __post_init__(self) -> None:
        if self.name not in APPS:
            raise ValueError(f"unknown app {self.name!r}; expected {APPS}")
        if self.name == "node" and self.id is None:
            self.id = "node"


@dataclass
class GpuConfig:
    """The accelerator block — what the reference's AWS ``vpc`` prompt
    (``cli/provider_utils/aws.py``) becomes on a GPU host: machine and
    card instead of subnet shape. ``device`` is the ``--device`` the start
    command passes to the node and the worker."""

    machine_type: str = "a3-highgpu-1g"
    accelerator_type: str = "nvidia-h100-80gb"
    accelerator_count: int = 1
    zone: str = "us-central1-a"
    project: str = "pygrid-tpu"
    #: hosts; >1 ⇒ one instance each, joined by torch.distributed's
    #: env:// rendezvous (MASTER_ADDR/MASTER_PORT/WORLD_SIZE/NODE_RANK)
    num_hosts: int = 1
    preemptible: bool = False
    device: str = "cuda"


@dataclass
class DbConfig:
    """Database prompt (reference ``aws.get_db_config`` — username/password
    for Aurora). Here: a sqlite path or cloud-sql instance name."""

    engine: str = "sqlite"
    url: str = "grid.db"
    username: str | None = None
    password: str | None = None


@dataclass
class DeployConfig:
    provider: str = "gcp"
    deployment_type: str = "serverfull"
    websockets: bool = True
    app: AppConfig = field(default_factory=AppConfig)
    gpu: GpuConfig = field(default_factory=GpuConfig)
    db: DbConfig = field(default_factory=DbConfig)
    #: opaque provider credentials (reference: parsed credentials.json)
    credentials: dict[str, Any] = field(default_factory=dict)
    root_dir: str | None = None

    def __post_init__(self) -> None:
        self.provider = self.provider.lower()
        self.deployment_type = self.deployment_type.lower()
        if self.provider not in PROVIDERS:
            raise ValueError(
                f"unknown provider {self.provider!r}; expected {PROVIDERS}"
            )
        if self.deployment_type not in DEPLOYMENT_TYPES:
            raise ValueError(
                f"unknown deployment_type {self.deployment_type!r}"
            )

    @classmethod
    def from_dict(cls, data: dict) -> "DeployConfig":
        data = dict(data)
        app = data.pop("app", {})
        gpu = data.pop("gpu", {})
        db = data.pop("db", {})
        known = {k: v for k, v in data.items() if k in cls.__dataclass_fields__}
        return cls(
            app=AppConfig(**app) if isinstance(app, dict) else app,
            gpu=GpuConfig(**gpu) if isinstance(gpu, dict) else gpu,
            db=DbConfig(**db) if isinstance(db, dict) else db,
            **known,
        )

    def to_dict(self) -> dict:
        return asdict(self)
