"""Azure providers — closing the last cloud-target asymmetry; the port's
counterpart of :mod:`pygrid_tpu.infra.providers.azure`.

Parity: the reference wired an Azure provider into its CLI but only ever
shipped the import scaffold
(``api/providers/azure/azure.py:1-10`` — a stub class, no ``deploy``).
Here both modes render runnable terraform JSON in the same
``Provider.deploy`` flow as AWS/GCP:

- **serverfull** → an Ubuntu VM (NIC + public IP + NSG opening the app
  port) running the node/network server via cloud-init, the shape of
  ``AWSServerfull``'s EC2 instance. Like the AWS modes this serves the
  COORDINATION plane on a host without a card (the node and worker run
  ``--device cpu``); GPU compute stays on the GCP providers.
- **serverless** → an Azure Container Instances group running the grid
  container image with a public IP — the ACI analog of the AWS
  container-Lambda / Cloud Run modes. A ``postgres://`` db config flows
  into ``DATABASE_URL`` exactly like the AWS stack (ACI containers are
  ephemeral; a client-server DB is the durable posture there).
"""

from __future__ import annotations

from pygrid_tpu_torch.infra.config import DeployConfig
from pygrid_tpu_torch.infra.providers.base import (
    Provider,
    bootstrap_script,
    coordination_config,
    server_command,
)


def _location(config: DeployConfig) -> str:
    """Accept an Azure location via the shared zone field; anything
    GCP/AWS-shaped falls back to eastus."""
    zone = config.gpu.zone or ""
    if zone and " " not in zone and "-" not in zone:
        return zone  # azure locations are single tokens ("westeurope")
    return "eastus"


class AzureServerfull(Provider):
    """Ubuntu VM running the server via cloud-init (custom_data)."""

    name = "azure-serverfull"

    def render(self) -> dict[str, str]:
        cfg, app = self.config, self.config.app
        name = f"pygrid-{app.name}-{app.id or app.name}"
        loc = _location(cfg)
        doc = {
            "terraform": {
                "required_providers": {
                    "azurerm": {"source": "hashicorp/azurerm"}
                }
            },
            "provider": {"azurerm": {"features": {}}},
            "variable": {
                "admin_ssh_key": {
                    "type": "string",
                    "description": "SSH public key for the admin user",
                }
            },
            "resource": {
                "azurerm_resource_group": {
                    "grid": {"name": f"{name}-rg", "location": loc}
                },
                "azurerm_virtual_network": {
                    "grid": {
                        "name": f"{name}-vnet",
                        "address_space": ["10.10.0.0/16"],
                        "location": loc,
                        "resource_group_name": (
                            "${azurerm_resource_group.grid.name}"
                        ),
                    }
                },
                "azurerm_subnet": {
                    "grid": {
                        "name": f"{name}-subnet",
                        "resource_group_name": (
                            "${azurerm_resource_group.grid.name}"
                        ),
                        "virtual_network_name": (
                            "${azurerm_virtual_network.grid.name}"
                        ),
                        "address_prefixes": ["10.10.1.0/24"],
                    }
                },
                "azurerm_public_ip": {
                    "grid": {
                        "name": f"{name}-ip",
                        "location": loc,
                        "resource_group_name": (
                            "${azurerm_resource_group.grid.name}"
                        ),
                        "allocation_method": "Static",
                    }
                },
                "azurerm_network_security_group": {
                    "grid": {
                        "name": f"{name}-nsg",
                        "location": loc,
                        "resource_group_name": (
                            "${azurerm_resource_group.grid.name}"
                        ),
                        "security_rule": [
                            {
                                "name": "grid-app",
                                "priority": 100,
                                "direction": "Inbound",
                                "access": "Allow",
                                "protocol": "Tcp",
                                "source_port_range": "*",
                                "destination_port_range": str(app.port),
                                "source_address_prefix": "*",
                                "destination_address_prefix": "*",
                                "description": "grid WS/HTTP",
                                "destination_address_prefixes": [],
                                "destination_application_security_group_ids": [],
                                "destination_port_ranges": [],
                                "source_address_prefixes": [],
                                "source_application_security_group_ids": [],
                                "source_port_ranges": [],
                            }
                        ],
                    }
                },
                "azurerm_network_interface": {
                    "grid": {
                        "name": f"{name}-nic",
                        "location": loc,
                        "resource_group_name": (
                            "${azurerm_resource_group.grid.name}"
                        ),
                        "ip_configuration": {
                            "name": "primary",
                            "subnet_id": "${azurerm_subnet.grid.id}",
                            "private_ip_address_allocation": "Dynamic",
                            "public_ip_address_id": (
                                "${azurerm_public_ip.grid.id}"
                            ),
                        },
                    }
                },
                "azurerm_network_interface_security_group_association": {
                    "grid": {
                        "network_interface_id": (
                            "${azurerm_network_interface.grid.id}"
                        ),
                        "network_security_group_id": (
                            "${azurerm_network_security_group.grid.id}"
                        ),
                    }
                },
                "azurerm_linux_virtual_machine": {
                    "grid_app": {
                        "name": name,
                        "location": loc,
                        "resource_group_name": (
                            "${azurerm_resource_group.grid.name}"
                        ),
                        "size": "Standard_B2s",
                        "admin_username": "pygrid",
                        "network_interface_ids": [
                            "${azurerm_network_interface.grid.id}"
                        ],
                        "admin_ssh_key": {
                            "username": "pygrid",
                            "public_key": "${var.admin_ssh_key}",
                        },
                        "os_disk": {
                            "caching": "ReadWrite",
                            "storage_account_type": "Standard_LRS",
                        },
                        "source_image_reference": {
                            "publisher": "Canonical",
                            "offer": "ubuntu-24_04-lts",
                            "sku": "server",
                            "version": "latest",
                        },
                        "custom_data": (
                            "${base64encode(file("
                            '"${path.module}/user_data.sh"))}'
                        ),
                    }
                },
            },
            "output": {
                "endpoint": {
                    "value": "${azurerm_public_ip.grid.ip_address}"
                }
            },
        }
        return {
            "main.tf.json": self._json(doc),
            "user_data.sh": bootstrap_script(
                coordination_config(cfg), python="python3"
            ),
        }


class AzureServerless(Provider):
    """Azure Container Instances group running the grid image."""

    name = "azure-serverless"

    def render(self) -> dict[str, str]:
        cfg, app = self.config, self.config.app
        name = f"pygrid-{app.name}"
        loc = _location(cfg)
        env = {"PORT": str(app.port)}
        db = cfg.db
        if db.url.startswith(("postgres://", "postgresql://")):
            env["DATABASE_URL"] = db.url
        else:
            # ACI containers are ephemeral — default to an explicit
            # in-container sqlite path (4 slashes = absolute /tmp) so
            # the operator sees the non-durability instead of silently
            # losing :memory: state
            env["DATABASE_URL"] = "sqlite:////tmp/grid.db"
        doc = {
            "terraform": {
                "required_providers": {
                    "azurerm": {"source": "hashicorp/azurerm"}
                }
            },
            "provider": {"azurerm": {"features": {}}},
            "variable": {
                "image_uri": {
                    "type": "string",
                    "description": (
                        "registry URI of the grid container image "
                        "(e.g. <acr>.azurecr.io/pygrid-tpu-torch:latest)"
                    ),
                }
            },
            "resource": {
                "azurerm_resource_group": {
                    "grid": {"name": f"{name}-rg", "location": loc}
                },
                "azurerm_container_group": {
                    "grid_app": {
                        "name": name,
                        "location": loc,
                        "resource_group_name": (
                            "${azurerm_resource_group.grid.name}"
                        ),
                        "os_type": "Linux",
                        "ip_address_type": "Public",
                        "dns_name_label": name,
                        "exposed_port": [
                            {"port": app.port, "protocol": "TCP"}
                        ],
                        "container": [
                            {
                                "name": "grid",
                                "image": "${var.image_uri}",
                                "cpu": 1,
                                "memory": 2,
                                "ports": [
                                    {
                                        "port": app.port,
                                        "protocol": "TCP",
                                    }
                                ],
                                "commands": server_command(
                                    coordination_config(cfg)
                                ),
                                "environment_variables": env,
                            }
                        ],
                    }
                },
            },
            "output": {
                "endpoint": {
                    "value": (
                        "${azurerm_container_group.grid_app.fqdn}"
                    )
                }
            },
        }
        return {"main.tf.json": self._json(doc)}
