"""Regenerate the checked-in exemplar Terraform stacks of the PyTorch port.

``deploy/`` holds the JAX package's stacks (TPU VMs); these are their
counterparts on GPU hosts, RENDERED by the port's provider builders
(``pygrid_tpu_torch.infra.providers``) with the same stack names and app
settings, so the checked-in configs can never drift from what
``python -m pygrid_tpu_torch.infra deploy`` writes. A test
(tests/test_torch_infra.py) asserts the rendered output matches these
files. Beside the eight counterparts, ``gcp-serverfull-node-multihost``
renders two GPU hosts joined by torch.distributed's env:// rendezvous.

Run from the repo root:  python deploy_torch/regenerate.py
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from pygrid_tpu_torch.infra.config import DeployConfig  # noqa: E402
from pygrid_tpu_torch.infra.providers import build_provider  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent

#: the exemplar stacks — the reference's three deploy/ directories plus the
#: serverless-network twin it also ships
STACKS: dict[str, dict] = {
    "gcp-serverfull-node": {
        "provider": "gcp",
        "deployment_type": "serverfull",
        "app": {"name": "node", "id": "alice", "port": 5000,
                "network": "http://network.example.com:7000"},
    },
    "gcp-serverfull-network": {
        "provider": "gcp",
        "deployment_type": "serverfull",
        "app": {"name": "network", "port": 7000},
    },
    "gcp-serverless-node": {
        "provider": "gcp",
        "deployment_type": "serverless",
        "app": {"name": "node", "id": "alice", "port": 5000},
    },
    "gcp-serverless-network": {
        "provider": "gcp",
        "deployment_type": "serverless",
        "app": {"name": "network", "port": 7000},
    },
    # the reference's own concrete cloud target (its deploy/serverless-node
    # stack) — coordination plane on AWS; GPU compute stays on GCP
    "aws-serverless-node": {
        "provider": "aws",
        "deployment_type": "serverless",
        "app": {"name": "node", "id": "alice", "port": 5000},
    },
    "aws-serverfull-node": {
        "provider": "aws",
        "deployment_type": "serverfull",
        "app": {"name": "node", "id": "alice", "port": 5000,
                "network": "http://network.example.com:7000"},
    },
    # the reference's CLI listed azure but only ever shipped a stub class
    # (api/providers/azure/azure.py:1-10) — these are working twins
    "azure-serverfull-node": {
        "provider": "azure",
        "deployment_type": "serverfull",
        "app": {"name": "node", "id": "alice", "port": 5000,
                "network": "http://network.example.com:7000"},
    },
    "azure-serverless-node": {
        "provider": "azure",
        "deployment_type": "serverless",
        "app": {"name": "node", "id": "alice", "port": 5000},
    },
    # two GPU hosts, one node process each, rank from instance metadata
    "gcp-serverfull-node-multihost": {
        "provider": "gcp",
        "deployment_type": "serverfull",
        "app": {"name": "node", "id": "alice", "port": 5000,
                "network": "http://network.example.com:7000"},
        "gpu": {"num_hosts": 2},
    },
}


def render_stack(name: str) -> dict[str, str]:
    spec = dict(STACKS[name])
    config = DeployConfig.from_dict(
        {
            **spec,
            "gpu": {
                "machine_type": "a3-highgpu-1g",
                "accelerator_type": "nvidia-h100-80gb",
                "zone": "us-central1-a",
                "project": "pygrid-tpu-demo",
                **spec.get("gpu", {}),
            },
            "db": {"url": "grid.db"},
        }
    )
    return build_provider(config).render()


def main() -> None:
    for name in STACKS:
        out = HERE / name
        out.mkdir(parents=True, exist_ok=True)
        for fname, contents in render_stack(name).items():
            (out / fname).write_text(contents)
            print(f"wrote deploy_torch/{name}/{fname}")


if __name__ == "__main__":
    main()
