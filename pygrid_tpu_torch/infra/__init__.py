"""Infrastructure plane — deploy CLI, deploy API, provider builders; the
port's counterpart of :mod:`pygrid_tpu.infra`, deploying
``pygrid_tpu_torch`` onto GPU hosts.

Parity surface: reference ``apps/infrastructure/`` — the ``pygrid`` click
wizard (``cli/cli.py:37-162``), the Flask deploy API
(``api/__main__.py:11-40``), terrascript→terraform providers
(``api/providers/provider.py:25-30``, ``api/tf.py:11-24``) and the
hand-written HCL under ``deploy/``.

Redesign: the reference deploys Flask apps to AWS Lambda/EC2; the JAX
package deploys onto a TPU host; here the unit of deployment is a **GPU
host** — provider builders emit terraform JSON for GCP GPU VMs
(``google_compute_instance`` with an H100 as ``guest_accelerator``), with
the port's node/network server (``python -m pygrid_tpu_torch.node
--device cuda``) in the startup script, plus a ``local`` provider that
actually spawns the port's grid processes for development. Terraform is
invoked when present; otherwise ``deploy()`` is a dry run that returns the
rendered artifacts (what CI exercises).
"""

from __future__ import annotations

from pygrid_tpu_torch.infra.config import DeployConfig
from pygrid_tpu_torch.infra.providers import build_provider
from pygrid_tpu_torch.infra.tf import Terraform

__all__ = ["DeployConfig", "build_provider", "Terraform", "handle_deploy"]


def handle_deploy(data: dict) -> dict:
    """Core of the deploy API: config dict → provider → deploy.

    Mirrors reference ``api/__main__.py:11-40`` (parse request → provider
    dispatch → deploy). Returns ``{"message", "provider", "artifacts"}``.
    """
    config = DeployConfig.from_dict(data)
    provider = build_provider(config)
    artifacts = provider.deploy(apply=data.get("apply", False))
    return {
        "message": "Deployment successful",
        "provider": config.provider,
        "deployment_type": config.deployment_type,
        "app": config.app.name,
        "artifacts": artifacts,
    }
