"""AWS providers — the reference's concrete cloud target, translated; the
port's counterpart of :mod:`pygrid_tpu.infra.providers.aws`.

Parity: reference ``api/providers/aws/serverless.py:26-351`` builds
S3 + Lambda layer + API Gateway over EFS-mounted deps with terrascript,
and ``deploy/serverless-node/*.tf`` is its hand-written twin;
``serverfull.py:22-23`` is an empty ``deploy(): pass`` stub. Here both
modes render runnable terraform JSON (same ``Provider.deploy`` flow as
GCP — write configs, ``terraform init/apply``):

- **serverless** → a container-image Lambda (VPC-attached, image from
  ECR via ``-var image_uri=...``) fronted by a Lambda Function URL
  (the modern replacement for the reference's API Gateway +
  layer-on-EFS packaging; the coordination plane is pure asyncio/SQL
  and fits Lambda exactly like the reference's Flask app did), with
  the grid DB on an EFS access point + mount target — the same
  durability role EFS plays in the reference stack.
- **serverfull** → an EC2 instance running the node/network server via
  user-data (the reference never implemented this mode at all). Like
  the JAX package's, this mode serves the COORDINATION plane on an
  instance without a card, so its node and worker run ``--device cpu``;
  GPU compute stays on the GCP providers — a cross-cloud grid registers
  AWS-hosted nodes with the network like any other address.
"""

from __future__ import annotations

from pygrid_tpu_torch.infra.config import DeployConfig
from pygrid_tpu_torch.infra.providers.base import (
    Provider,
    bootstrap_script,
    coordination_config,
    server_command,
)


def _user_data(config: DeployConfig) -> str:
    # AL2023 ships python3 with no pip (and no `python` alias at all) —
    # the preinstall step and interpreter name differ from GCP's GPU
    # image; the boot sequence itself is the shared bootstrap
    return bootstrap_script(
        coordination_config(config),
        python="python3",
        preinstall=("dnf install -y python3-pip",),
    )


def _region(config: DeployConfig) -> str:
    """The shared config carries a GCP-style zone by default; accept an
    AWS region (``us-east-1``) or availability zone (``eu-west-2a`` →
    region ``eu-west-2``); anything GCP-shaped (``us-central1-a``) falls
    back to us-east-1."""
    import re

    m = re.fullmatch(r"([a-z]{2}(?:-[a-z]+)+-\d+)([a-z])?", config.gpu.zone)
    return m.group(1) if m else "us-east-1"


class AWSServerfull(Provider):
    """EC2-hosted node/network server (the mode the reference stubbed).

    Exposure: the app port's ingress defaults to 0.0.0.0/0 — the grid's
    per-process JWT auth is OPTIONAL, and host-training/admin routes ride
    the same endpoint, so restrict ``-var 'ingress_cidr=["10.0.0.0/8"]'``
    to the clients' networks unless the process-level authentication
    config is in force (the reference's serverless sat behind API
    Gateway for the same reason)."""

    name = "aws-serverfull"

    def render(self) -> dict[str, str]:
        cfg, app = self.config, self.config.app
        name = f"pygrid-{app.name}-{app.id or app.name}"
        doc = {
            "terraform": {
                "required_providers": {
                    "aws": {"source": "hashicorp/aws"}
                }
            },
            "provider": {"aws": {"region": _region(cfg)}},
            "variable": {
                "ingress_cidr": {
                    "type": "list(string)",
                    "default": ["0.0.0.0/0"],
                    "description": (
                        "CIDRs allowed to reach the grid port; default "
                        "open — narrow it unless per-process JWT auth "
                        "is configured (see class docstring)"
                    ),
                }
            },
            "resource": {
                "aws_security_group": {
                    "grid_ingress": {
                        "name": f"{name}-ingress",
                        "ingress": [
                            {
                                "from_port": app.port,
                                "to_port": app.port,
                                "protocol": "tcp",
                                "cidr_blocks": "${var.ingress_cidr}",
                                "description": "grid WS/HTTP",
                                "ipv6_cidr_blocks": [],
                                "prefix_list_ids": [],
                                "security_groups": [],
                                "self": False,
                            }
                        ],
                        "egress": [
                            {
                                "from_port": 0,
                                "to_port": 0,
                                "protocol": "-1",
                                "cidr_blocks": ["0.0.0.0/0"],
                                "description": "all egress",
                                "ipv6_cidr_blocks": [],
                                "prefix_list_ids": [],
                                "security_groups": [],
                                "self": False,
                            }
                        ],
                    }
                },
                "aws_instance": {
                    "grid_app": {
                        "ami": "${data.aws_ami.al2023.id}",
                        "instance_type": "t3.medium",
                        "vpc_security_group_ids": [
                            "${aws_security_group.grid_ingress.id}"
                        ],
                        "user_data": _user_data(cfg),
                        "tags": {"Name": name},
                    }
                },
            },
            "data": {
                "aws_ami": {
                    "al2023": {
                        "most_recent": True,
                        "owners": ["amazon"],
                        "filter": [
                            {
                                "name": "name",
                                "values": ["al2023-ami-*-x86_64"],
                            }
                        ],
                    }
                }
            },
            "output": {
                "endpoint": {
                    "value": "${aws_instance.grid_app.public_dns}"
                }
            },
        }
        return {
            "main.tf.json": self._json(doc),
            "user_data.sh": _user_data(cfg),
        }


class AWSServerless(Provider):
    """Container Lambda + Function URL + EFS-backed grid database.

    Lambda with an EFS mount MUST be VPC-attached with a mount target
    reachable from its subnets — the stack wires the account's default
    VPC (data sources) rather than minting one, mirroring the
    reference's reuse of an existing VPC in its hand-written HCL. The
    container image is a terraform variable (``-var image_uri=...``):
    it must live in ECR and bundle the AWS Lambda Web Adapter (the
    request/response bridge container Lambdas need to front an HTTP
    server; ``AWS_LWA_PORT`` is wired for it) — the repo's
    ``Dockerfile.lambda`` builds exactly that image.

    Exposure: the Function URL uses ``authorization_type = NONE`` —
    public by design, like the reference's unauthenticated API Gateway
    stage — so a production deployment should configure per-process JWT
    auth (``server_config.authentication``) or front the URL with IAM
    auth/CloudFront; host-training/admin routes ride the same endpoint.

    Scope honesty: a Function URL speaks request/response HTTP only —
    NO WebSockets. The node's full model-centric flow has HTTP mirrors
    (authenticate / cycle-request / report POSTs + GET downloads,
    node/routes.py), so HTTP-wire FL clients work against this stack;
    WS clients and the data-centric binary plane need the serverfull
    (EC2/GPU-VM) deployment — the same coordination-plane-only posture
    the reference's Lambda mode had in practice."""

    name = "aws-serverless"

    def render(self) -> dict[str, str]:
        cfg, app = self.config, self.config.app
        name = f"pygrid-{app.name}"
        doc = {
            "terraform": {
                "required_providers": {
                    "aws": {"source": "hashicorp/aws"}
                }
            },
            "provider": {"aws": {"region": _region(cfg)}},
            "variable": {
                "image_uri": {
                    "type": "string",
                    "description": (
                        "ECR URI of the grid container image "
                        "(e.g. <acct>.dkr.ecr.<region>.amazonaws.com/"
                        "pygrid-tpu-torch:latest)"
                    ),
                }
            },
            "data": {
                "aws_vpc": {"default": {"default": True}},
                "aws_subnets": {
                    "default": {
                        "filter": [
                            {
                                "name": "vpc-id",
                                "values": ["${data.aws_vpc.default.id}"],
                            }
                        ]
                    }
                },
            },
            "resource": {
                "aws_security_group": {
                    "grid_efs": {
                        "name": f"{name}-efs",
                        "vpc_id": "${data.aws_vpc.default.id}",
                        "ingress": [
                            {
                                "from_port": 2049,
                                "to_port": 2049,
                                "protocol": "tcp",
                                "cidr_blocks": [
                                    "${data.aws_vpc.default.cidr_block}"
                                ],
                                "description": "NFS from the VPC",
                                "ipv6_cidr_blocks": [],
                                "prefix_list_ids": [],
                                "security_groups": [],
                                "self": True,
                            }
                        ],
                        "egress": [
                            {
                                "from_port": 0,
                                "to_port": 0,
                                "protocol": "-1",
                                "cidr_blocks": ["0.0.0.0/0"],
                                "description": "all egress",
                                "ipv6_cidr_blocks": [],
                                "prefix_list_ids": [],
                                "security_groups": [],
                                "self": False,
                            }
                        ],
                    }
                },
                "aws_efs_file_system": {
                    "grid_db": {"tags": {"Name": f"{name}-db"}}
                },
                "aws_efs_mount_target": {
                    "grid_db": {
                        "file_system_id": (
                            "${aws_efs_file_system.grid_db.id}"
                        ),
                        "subnet_id": (
                            "${data.aws_subnets.default.ids[0]}"
                        ),
                        "security_groups": [
                            "${aws_security_group.grid_efs.id}"
                        ],
                    }
                },
                "aws_efs_access_point": {
                    "grid_db": {
                        "file_system_id": (
                            "${aws_efs_file_system.grid_db.id}"
                        ),
                        "root_directory": {
                            "path": "/pygrid",
                            "creation_info": {
                                "owner_uid": 1000,
                                "owner_gid": 1000,
                                "permissions": "0755",
                            },
                        },
                        "posix_user": {"uid": 1000, "gid": 1000},
                    }
                },
                "aws_iam_role": {
                    "grid_lambda": {
                        "name": f"{name}-lambda-role",
                        "assume_role_policy": (
                            '{"Version": "2012-10-17", "Statement": '
                            '[{"Action": "sts:AssumeRole", "Effect": '
                            '"Allow", "Principal": {"Service": '
                            '"lambda.amazonaws.com"}}]}'
                        ),
                    }
                },
                "aws_iam_role_policy_attachment": {
                    "grid_lambda_vpc": {
                        "role": "${aws_iam_role.grid_lambda.name}",
                        "policy_arn": (
                            "arn:aws:iam::aws:policy/service-role/"
                            "AWSLambdaVPCAccessExecutionRole"
                        ),
                    },
                    "grid_lambda_efs": {
                        "role": "${aws_iam_role.grid_lambda.name}",
                        "policy_arn": (
                            "arn:aws:iam::aws:policy/"
                            "AmazonElasticFileSystemClientReadWriteAccess"
                        ),
                    },
                },
                "aws_lambda_function": {
                    "grid_app": {
                        "function_name": name,
                        "package_type": "Image",
                        "image_uri": "${var.image_uri}",
                        "role": "${aws_iam_role.grid_lambda.arn}",
                        "timeout": 900,
                        "memory_size": 1024,
                        # one execution environment: the grid DB is
                        # sqlite on EFS, and SQLite's POSIX locks are
                        # not reliable over NFS across concurrent
                        # writers — serialize at the Lambda layer
                        "reserved_concurrent_executions": 1,
                        # the stack's app/id/port configuration drives
                        # the container via the image command override;
                        # AWS_LWA_PORT points the web adapter (which the
                        # image must bundle — see the class docstring)
                        # at the server
                        "image_config": {
                            "command": server_command(
                                coordination_config(cfg)
                            )
                        },
                        "environment": {
                            "variables": {
                                "DATABASE_URL": "sqlite:////mnt/pygrid/grid.db",
                                "AWS_LWA_PORT": str(app.port),
                                "PORT": str(app.port),
                            }
                        },
                        "vpc_config": {
                            "subnet_ids": (
                                "${data.aws_subnets.default.ids}"
                            ),
                            "security_group_ids": [
                                "${aws_security_group.grid_efs.id}"
                            ],
                        },
                        "file_system_config": {
                            "arn": (
                                "${aws_efs_access_point.grid_db.arn}"
                            ),
                            "local_mount_path": "/mnt/pygrid",
                        },
                        "depends_on": ["aws_efs_mount_target.grid_db"],
                    }
                },
                "aws_lambda_function_url": {
                    "grid_url": {
                        "function_name": (
                            "${aws_lambda_function.grid_app.function_name}"
                        ),
                        "authorization_type": "NONE",
                    }
                },
            },
            "output": {
                "endpoint": {
                    "value": (
                        "${aws_lambda_function_url.grid_url.function_url}"
                    )
                }
            },
        }
        if self._wants_postgres():
            self._postgresize(doc, name)
        return {"main.tf.json": self._json(doc)}

    def _wants_postgres(self) -> bool:
        db = self.config.db
        return db.engine in ("postgres", "postgresql") or db.url.startswith(
            ("postgres://", "postgresql://")
        )

    def _postgresize(self, doc: dict, name: str) -> None:
        """Swap the EFS-sqlite grid database for a client-server
        postgres one — the reference's Aurora-serverless posture
        (``deploy/serverless-node/database.tf:1-6``). With an external
        DB the Lambda concurrency pin disappears: horizontal scale was
        the whole point of the serverless mode, and SQLite-on-EFS was
        what forced ``reserved_concurrent_executions = 1``. An explicit
        ``postgres://`` db.url is used as-is (bring-your-own database);
        otherwise the stack provisions an in-VPC RDS postgres instance
        and assembles the URL from it (password via the sensitive
        ``db_password`` variable)."""
        res = doc["resource"]
        fn = res["aws_lambda_function"]["grid_app"]
        del fn["reserved_concurrent_executions"]
        del fn["file_system_config"]
        fn["depends_on"] = []
        for efs_res in (
            "aws_efs_file_system", "aws_efs_mount_target",
            "aws_efs_access_point",
        ):
            res.pop(efs_res, None)
        # least privilege: the EFS client policy grant dies with EFS
        res["aws_iam_role_policy_attachment"].pop("grid_lambda_efs", None)
        db = self.config.db
        if db.url.startswith(("postgres://", "postgresql://")):
            # bring-your-own database: the VPC attachment existed only
            # to reach EFS/RDS — a VPC Lambda in the default VPC has no
            # internet egress, so an EXTERNAL database requires dropping
            # it (an in-VPC BYO database should use db.engine=postgres
            # with no URL and let the stack provision RDS instead)
            fn.pop("vpc_config", None)
            res["aws_security_group"].pop("grid_efs", None)
            # out of the VPC, the role only needs log delivery (the VPC
            # policy was a superset that also granted ENI management)
            res["aws_iam_role_policy_attachment"]["grid_lambda_vpc"][
                "policy_arn"
            ] = (
                "arn:aws:iam::aws:policy/service-role/"
                "AWSLambdaBasicExecutionRole"
            )
            fn["environment"]["variables"]["DATABASE_URL"] = db.url
            return
        user = db.username or "pygrid"
        # the Lambda keeps its VPC attachment (now to reach RDS); the
        # EFS security group becomes the app SG — no ingress (the NFS
        # rule dies with EFS; a Lambda SG needs egress only) — and a DB
        # SG admits 5432 from it alone
        res["aws_security_group"]["grid_efs"]["ingress"] = []
        res["aws_security_group"]["grid_db"] = {
            "name": f"{name}-db",
            "vpc_id": "${data.aws_vpc.default.id}",
            "ingress": [
                {
                    "from_port": 5432,
                    "to_port": 5432,
                    "protocol": "tcp",
                    "cidr_blocks": [],
                    "description": "postgres from the app SG",
                    "ipv6_cidr_blocks": [],
                    "prefix_list_ids": [],
                    "security_groups": [
                        "${aws_security_group.grid_efs.id}"
                    ],
                    "self": False,
                }
            ],
            "egress": [],
        }
        res["aws_db_subnet_group"] = {
            "grid_db": {
                "name": f"{name}-db",
                "subnet_ids": "${data.aws_subnets.default.ids}",
            }
        }
        res["aws_db_instance"] = {
            "grid_db": {
                "identifier": f"{name}-db",
                "engine": "postgres",
                "instance_class": "db.t4g.micro",
                "allocated_storage": 20,
                "db_name": "pygrid",
                "username": user,
                "password": "${var.db_password}",
                "db_subnet_group_name": (
                    "${aws_db_subnet_group.grid_db.name}"
                ),
                "vpc_security_group_ids": [
                    "${aws_security_group.grid_db.id}"
                ],
                "skip_final_snapshot": True,
            }
        }
        doc["variable"]["db_password"] = {
            "type": "string",
            "sensitive": True,
            "description": "master password for the grid postgres DB",
        }
        # urlencode: parse_pg_url percent-decodes the password, and RDS
        # allows %/#/? in master passwords
        fn["environment"]["variables"]["DATABASE_URL"] = (
            f"postgres://{user}:${{urlencode(var.db_password)}}"
            "@${aws_db_instance.grid_db.address}:5432/pygrid"
        )
