"""GCP GPU providers — the port's counterpart of
:mod:`pygrid_tpu.infra.providers.gcp`, on GPU hosts.

Parity: reference ``api/providers/aws/serverless.py:26-351`` builds the
whole AWS stack (S3 + Lambda layer + API Gateway + EFS) as terrascript;
``serverfull.py:22-23`` is a stub; ``deploy/serverless-node/*.tf`` is the
hand-written equivalent. The JAX package renders TPU VMs; the port renders
the same stacks on GPU VMs:

- **serverfull** → a ``google_compute_instance`` per grid app (the JAX
  package's ``google_tpu_v2_vm``), with the card as a
  ``guest_accelerator`` and ``on_host_maintenance = "TERMINATE"`` (a VM
  with a GPU cannot live-migrate). It boots a public image that carries
  the NVIDIA driver, CUDA and PyTorch (the Deep Learning VM family
  ``deeplearning-platform-release/pytorch-latest-gpu``); the startup
  script launches the node/network server on the host's card. With
  ``num_hosts > 1`` it renders that many instances, and the script
  exports the rendezvous ``torch.distributed``'s ``env://`` init reads
  (``MASTER_ADDR`` = host 0's instance name on the VPC's internal DNS,
  ``MASTER_PORT``, ``WORLD_SIZE``, and ``NODE_RANK``/``RANK`` from the
  instance's metadata). This stands in for the JAX package's
  ``PYGRID_TPU_MULTIHOST``, which nothing reads.
- **serverless** → Cloud Run for the coordination plane (it is pure
  asyncio/SQL, the analog of the reference's Lambda'd Flask app) plus a
  spot GPU ``google_compute_instance`` the node uses for burst compute —
  the counterpart of the JAX package's ``google_tpu_v2_queued_resource``:
  a GPU has no queued resource, and a spot VM (preemptible, deleted on
  preemption) is the elastic, pay-while-used form of GPU capacity.
"""

from __future__ import annotations

from pygrid_tpu_torch.infra.config import DeployConfig
from pygrid_tpu_torch.infra.providers.base import (
    CONTAINER_IMAGE,
    Provider,
    bootstrap_script,
    coordination_config,
    server_command,
)

#: public image family with the NVIDIA driver, CUDA and PyTorch
#: (Google's Deep Learning VM images); nothing is downloaded at render time
GPU_IMAGE = "projects/deeplearning-platform-release/global/images/family/pytorch-latest-gpu"

#: torch.distributed's rendezvous port on host 0 (torchrun's default)
MASTER_PORT = 29500

#: a host's rank, read at boot from the instance's own metadata
_RANK_FROM_METADATA = (
    "export NODE_RANK=\"$(curl -sf -H 'Metadata-Flavor: Google' "
    "http://metadata.google.internal/computeMetadata/v1/instance/"
    "attributes/node-rank)\"",
    'export RANK="$NODE_RANK"',
)


def _vm_name(config: DeployConfig) -> str:
    app = config.app
    return f"pygrid-{app.name}-{app.id or app.name}"


def _startup_script(config: DeployConfig) -> str:
    gpu = config.gpu
    if gpu.num_hosts <= 1:
        return bootstrap_script(config)
    # one server process per host; host 0 is the rendezvous
    return bootstrap_script(
        config,
        extra_env={
            "MASTER_ADDR": f"{_vm_name(config)}-0",
            "MASTER_PORT": str(MASTER_PORT),
            "WORLD_SIZE": str(gpu.num_hosts),
        },
        extra_lines=_RANK_FROM_METADATA,
    )


def _gpu_instance(config: DeployConfig, name: str, preemptible: bool,
                  startup: str | None) -> dict:
    """One GPU VM: the machine, its card(s), a driver-carrying boot image
    and a scheduling block GPU VMs accept (no live migration)."""
    gpu = config.gpu
    doc = {
        "name": name,
        "zone": gpu.zone,
        "machine_type": gpu.machine_type,
        "guest_accelerator": [
            {"type": gpu.accelerator_type, "count": gpu.accelerator_count}
        ],
        "scheduling": {
            "on_host_maintenance": "TERMINATE",
            "automatic_restart": not preemptible,
            "preemptible": preemptible,
        },
        "boot_disk": {
            "initialize_params": {"image": GPU_IMAGE, "size": 200}
        },
        "network_interface": [
            {"network": "default", "access_config": [{}]}
        ],
        "metadata": {"install-nvidia-driver": "True"},
    }
    if preemptible:
        doc["scheduling"].update(
            {"provisioning_model": "SPOT",
             "instance_termination_action": "DELETE"}
        )
    if startup is not None:
        doc["metadata"]["startup-script"] = startup
    return doc


class GCPServerfull(Provider):
    """GPU VM deployment — the workhorse path."""

    name = "gcp-serverfull"

    def render(self) -> dict[str, str]:
        cfg, gpu, app = self.config, self.config.gpu, self.config.app
        vm_name = _vm_name(cfg)
        startup = _startup_script(cfg)
        if gpu.num_hosts <= 1:
            instances = {
                "grid_app": _gpu_instance(cfg, vm_name, gpu.preemptible,
                                          startup)
            }
            endpoint = "${google_compute_instance.grid_app.network_interface}"
        else:
            instances = {}
            for rank in range(gpu.num_hosts):
                vm = _gpu_instance(cfg, f"{vm_name}-{rank}", gpu.preemptible,
                                   startup)
                vm["metadata"]["node-rank"] = str(rank)
                instances[f"grid_app_{rank}"] = vm
            endpoint = "${google_compute_instance.grid_app_0.network_interface}"
        resources = {
            "google_compute_instance": instances,
            "google_compute_firewall": {
                "grid_ingress": {
                    "name": f"{vm_name}-ingress",
                    "network": "default",
                    "allow": [
                        {"protocol": "tcp", "ports": [str(app.port)]}
                    ],
                    "source_ranges": ["0.0.0.0/0"],
                }
            },
        }
        if gpu.num_hosts > 1:
            # the rendezvous and NCCL between the hosts, inside the VPC
            resources["google_compute_firewall"]["grid_rendezvous"] = {
                "name": f"{vm_name}-rendezvous",
                "network": "default",
                "allow": [{"protocol": "tcp", "ports": ["0-65535"]}],
                "source_tags": [vm_name],
                "target_tags": [vm_name],
            }
            for vm in instances.values():
                vm["tags"] = [vm_name]
        doc = {
            "terraform": {
                "required_providers": {
                    "google": {"source": "hashicorp/google"}
                }
            },
            "provider": {
                "google": {"project": gpu.project, "zone": gpu.zone}
            },
            "resource": resources,
            "output": {"endpoint": {"value": endpoint}},
        }
        return {
            "main.tf.json": self._json(doc),
            "startup.sh": startup,
        }


class GCPServerless(Provider):
    """Cloud Run coordination plane + a spot GPU VM for compute."""

    name = "gcp-serverless"

    def render(self) -> dict[str, str]:
        cfg, gpu, app = self.config, self.config.gpu, self.config.app
        svc_name = f"pygrid-{app.name}"
        compute = _gpu_instance(cfg, f"{svc_name}-compute", True, None)
        doc = {
            "terraform": {
                "required_providers": {
                    "google": {"source": "hashicorp/google"}
                }
            },
            "provider": {
                "google": {"project": gpu.project, "zone": gpu.zone}
            },
            "resource": {
                "google_cloud_run_v2_service": {
                    "grid_app": {
                        "name": svc_name,
                        "location": gpu.zone.rsplit("-", 1)[0],
                        "template": {
                            "containers": [
                                {
                                    "image": CONTAINER_IMAGE,
                                    # no card in the container: the
                                    # node's tensors stay on the host
                                    "args": server_command(
                                        coordination_config(cfg)
                                    )[1:],
                                    "ports": [
                                        {"container_port": app.port}
                                    ],
                                    "env": [
                                        {
                                            "name": "DATABASE_URL",
                                            "value": cfg.db.url,
                                        }
                                    ],
                                }
                            ]
                        },
                    }
                },
                "google_compute_instance": {"grid_compute": compute},
            },
        }
        return {"main.tf.json": self._json(doc)}
