"""Provider base: render artifacts → (optionally) terraform apply — the
port's counterpart of :mod:`pygrid_tpu.infra.providers.base`, whose start
command runs the port's servers (``python -m pygrid_tpu_torch.node|
network|worker``, the node and the worker with ``--device``).

Parity: reference ``api/providers/provider.py:16-30`` — builds a
terrascript document, dumps ``main.tf.json`` into ``~/.pygrid/api`` and
shells out to terraform. Here artifacts are plain dicts (terraform JSON
needs no terrascript), the root dir is configurable (never defaults outside
the working tree), and ``deploy(apply=False)`` is a dry run returning the
rendered files."""

from __future__ import annotations

import copy
import json
import os
from pathlib import Path

from pygrid_tpu_torch.infra.config import DeployConfig
from pygrid_tpu_torch.infra.tf import Terraform

#: the grid container image the serverless stacks run (the port's image;
#: the JAX package's stacks run ``pygrid-tpu/grid``)
CONTAINER_IMAGE = "pygrid-tpu/grid-torch:latest"


class Provider:
    name = "base"

    def __init__(self, config: DeployConfig) -> None:
        self.config = config
        root = config.root_dir or os.environ.get(
            "PYGRID_TPU_HOME", os.getcwd()
        )
        # everything lives under <root>/.pygrid_tpu — same home the CLI
        # writes its config dumps to (cli.py), one layout for operators
        self.root_dir = str(Path(root) / ".pygrid_tpu" / "api" / self.name)
        self.tf = Terraform()

    def render(self) -> dict[str, str]:
        """filename → file contents (terraform JSON, manifests, scripts)."""
        raise NotImplementedError

    def deploy(self, apply: bool = False) -> dict:
        os.makedirs(self.root_dir, exist_ok=True)
        files = self.render()
        for fname, contents in files.items():
            with open(os.path.join(self.root_dir, fname), "w") as f:
                f.write(contents)
        applied = False
        validated: bool | None = None  # None = terraform binary absent
        if self.tf.available() and "main.tf.json" in files:
            self.tf.init(self.root_dir)
            # a dry run still validates: the rendered configs must be
            # terraform-acceptable, not just well-formed JSON (reference
            # apply path: api/tf.py:11-24)
            validated = self.tf.validate(self.root_dir) == 0
            if apply and validated:
                applied = self.tf.apply(self.root_dir) == 0
        return {
            "root_dir": self.root_dir,
            "files": sorted(files),
            "validated": validated,
            "applied": applied,
        }

    def destroy(self) -> bool:
        if self.tf.available():
            return self.tf.destroy(self.root_dir) == 0
        return False

    @staticmethod
    def _json(doc: dict) -> str:
        return json.dumps(doc, indent=2, sort_keys=False)


def shell_line(argv: list[str]) -> str:
    import shlex

    return " ".join(shlex.quote(a) for a in argv)


def bootstrap_script(
    config: "DeployConfig",
    python: str = "python",
    preinstall: tuple[str, ...] = (),
    extra_env: dict[str, str] | None = None,
    extra_lines: tuple[str, ...] = (),
) -> str:
    """The shared VM boot script (cloud-init user-data / startup-script):
    install the package, export config env, exec the grid server. Each
    provider parameterizes the interpreter name and distro preinstall
    steps instead of copying the sequence (AL2023 ships python3 and no
    pip; GCP's GPU images ship both). ``extra_lines`` are shell lines run
    before the server starts (a rank read from instance metadata)."""
    import shlex

    cmd = server_command(config)
    cmd[0] = python
    lines = ["#!/bin/bash", "set -e", *preinstall,
             f"{python} -m pip install pygrid-tpu",
             f"export DATABASE_URL={shlex.quote(config.db.url)}"]
    for key, value in (extra_env or {}).items():
        lines.append(f"export {key}={shlex.quote(value)}")
    lines += extra_lines
    lines.append(f"exec {shell_line(cmd)}")
    return "\n".join(lines) + "\n"


def coordination_config(config: DeployConfig) -> DeployConfig:
    """``config`` for a host without a card — the coordination plane on
    EC2, Lambda, an Azure VM, ACI or Cloud Run: the node and the worker
    keep their tensors on the host (``--device cpu``), since the port's
    default ``cuda`` raises where there is no GPU."""
    out = copy.deepcopy(config)
    out.gpu.device = "cpu"
    return out


def server_command(config: DeployConfig) -> list[str]:
    """The grid server argv for this app — shared by every provider's
    startup script (the analog of reference ``apps/node/entrypoint.sh``)."""
    app = config.app
    if app.name == "node":
        cmd = [
            "python",
            "-m",
            "pygrid_tpu_torch.node",
            "--id",
            str(app.id),
            "--host",
            app.host,
            "--port",
            str(app.port),
            "--device",
            config.gpu.device,
        ]
        if app.network:
            cmd += ["--network", app.network]
        if app.num_replicas and app.num_replicas > 1:
            cmd += ["--num_replicas", str(app.num_replicas)]
        return cmd
    if app.name == "network":
        return [
            "python",
            "-m",
            "pygrid_tpu_torch.network",
            "--host",
            app.host,
            "--port",
            str(app.port),
        ]
    # worker: ephemeral compute joining a node (reference apps/worker is a
    # stub; ours trains against a node address on the host's card); the
    # network holds no tensor and takes no --device
    return [
        "python",
        "-m",
        "pygrid_tpu_torch.worker",
        "--node",
        app.network or f"http://127.0.0.1:{app.port}",
        "--device",
        config.gpu.device,
    ]
