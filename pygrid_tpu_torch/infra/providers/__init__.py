"""Provider registry — the port's counterpart of
:mod:`pygrid_tpu.infra.providers`.

Parity: the dispatch table in reference ``api/__main__.py:22-35``
(provider × deployment_type → builder class; azure/gcp were empty stubs
there — here GCP is the first-class GPU target, and AWS *and* Azure
render runnable stacks for the coordination plane, closing the last
cloud-target asymmetry with the reference's CLI surface)."""

from __future__ import annotations

from pygrid_tpu_torch.infra.config import DeployConfig
from pygrid_tpu_torch.infra.providers.base import Provider, server_command
from pygrid_tpu_torch.infra.providers.aws import AWSServerfull, AWSServerless
from pygrid_tpu_torch.infra.providers.azure import AzureServerfull, AzureServerless
from pygrid_tpu_torch.infra.providers.gcp import GCPServerfull, GCPServerless
from pygrid_tpu_torch.infra.providers.local import LocalProvider

__all__ = ["build_provider", "Provider", "server_command"]

_REGISTRY = {
    ("aws", "serverfull"): AWSServerfull,
    ("aws", "serverless"): AWSServerless,
    ("azure", "serverfull"): AzureServerfull,
    ("azure", "serverless"): AzureServerless,
    ("gcp", "serverfull"): GCPServerfull,
    ("gcp", "serverless"): GCPServerless,
    ("local", "serverfull"): LocalProvider,
    ("local", "serverless"): LocalProvider,
}


def build_provider(config: DeployConfig) -> Provider:
    key = (config.provider, config.deployment_type)
    if key not in _REGISTRY:
        raise NotImplementedError(
            f"provider {config.provider!r} ({config.deployment_type}) is not "
            "implemented; available: "
            + ", ".join("/".join(k) for k in sorted(_REGISTRY))
        )
    return _REGISTRY[key](config)
