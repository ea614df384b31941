"""``pygrid-tpu`` deploy CLI — the port's counterpart of
:mod:`pygrid_tpu.infra.cli`, with the GPU block.

Parity: reference ``apps/infrastructure/cli/cli.py:37-162`` — the
interactive wizard (provider/app/serverless?/websockets?/app args/db),
config dump to ``~/.pygrid/cli/config_<ts>.json``, POST to the deploy API
(through :mod:`pygrid_tpu_torch.web.client`: no ``requests`` beside the
card).
Here every prompt is also a flag so the wizard is scriptable
(``--yes`` skips all prompts); ``--direct`` builds and runs the provider
in-process instead of POSTing (no API server needed for a dry run)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from pygrid_tpu_torch.infra.config import (
    APPS,
    DEPLOYMENT_TYPES,
    PROVIDERS,
    AppConfig,
    DbConfig,
    DeployConfig,
    GpuConfig,
)


def _prompt(text: str, default, interactive: bool, cast=str):
    if not interactive:
        return default
    raw = input(f"{text} [{default}]: ").strip()
    return cast(raw) if raw else default


def _confirm(text: str, default: bool, interactive: bool) -> bool:
    if not interactive:
        return default
    raw = input(f"{text} [{'Y/n' if default else 'y/N'}]: ").strip().lower()
    if not raw:
        return default
    return raw in ("y", "yes")


def build_config(args, interactive: bool) -> DeployConfig:
    app = AppConfig(
        name=args.app,
        id=_prompt("Grid app id", args.id or args.app, interactive),
        host=_prompt("Host", args.host, interactive),
        port=_prompt("Port", args.port, interactive, int),
        network=args.network
        if not interactive or args.app != "node"
        else (_prompt("Grid Network address", args.network or "", interactive) or None),
        num_replicas=args.num_replicas,
    )
    gpu = GpuConfig(
        machine_type=_prompt("Machine type", args.machine_type, interactive),
        accelerator_type=_prompt(
            "GPU accelerator type", args.accelerator_type, interactive
        ),
        accelerator_count=_prompt(
            "GPUs per host", args.accelerator_count, interactive, int
        ),
        zone=_prompt("GCP zone", args.zone, interactive),
        project=_prompt("GCP project", args.project, interactive),
        num_hosts=args.num_hosts,
        preemptible=args.preemptible,
        device=_prompt("Torch device of the grid app", args.device,
                       interactive),
    )
    deployment_type = (
        "serverless"
        if _confirm(
            "Do you want to deploy serverless?",
            args.deployment_type == "serverless",
            interactive,
        )
        else "serverfull"
    )
    websockets = _confirm(
        "Will you need to support Websockets?", True, interactive
    )
    credentials = {}
    if args.credentials:
        with open(args.credentials) as f:
            credentials = json.load(f)
    return DeployConfig(
        provider=args.provider,
        deployment_type=deployment_type,
        websockets=websockets,
        app=app,
        gpu=gpu,
        db=DbConfig(url=args.database_url),
        credentials=credentials,
        root_dir=args.root_dir,
    )


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m pygrid_tpu_torch.infra",
        description="pygrid-tpu infrastructure CLI for the PyTorch port (e.g. "
        "`python -m pygrid_tpu_torch.infra deploy --provider gcp --app node`)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    d = sub.add_parser("deploy", help="deploy a grid app")
    d.add_argument("--provider", choices=PROVIDERS, default="gcp")
    d.add_argument("--app", choices=APPS, default="node")
    d.add_argument("--deployment-type", choices=DEPLOYMENT_TYPES,
                   default="serverfull")
    d.add_argument("--id", default=None)
    d.add_argument("--host", default="0.0.0.0")
    d.add_argument("--port", type=int, default=5000)
    d.add_argument("--network", default=None)
    d.add_argument("--num_replicas", type=int, default=1)
    d.add_argument("--machine-type", default="a3-highgpu-1g")
    d.add_argument("--accelerator-type", default="nvidia-h100-80gb")
    d.add_argument("--accelerator-count", type=int, default=1)
    d.add_argument("--device", default="cuda",
                   help="--device of the deployed node/worker (cuda or cpu)")
    d.add_argument("--zone", default="us-central1-a")
    d.add_argument("--project", default="pygrid-tpu")
    d.add_argument("--num-hosts", type=int, default=1)
    d.add_argument("--preemptible", action="store_true")
    d.add_argument("--database-url", default="grid.db")
    d.add_argument("--credentials", default=None,
                   help="path to provider credentials json")
    d.add_argument("--root-dir", default=None,
                   help="artifact dir (default ./.pygrid_tpu)")
    d.add_argument("--api-url", default="http://localhost:5005/")
    d.add_argument("--direct", action="store_true",
                   help="run the provider in-process (no deploy API)")
    d.add_argument("--apply", action="store_true",
                   help="actually apply (terraform/spawn); default dry run")
    d.add_argument("--dry-run", action="store_true",
                   help="render + terraform-validate in-process and exit "
                        "(implies --direct --yes, never applies)")
    d.add_argument("--yes", "-y", action="store_true",
                   help="non-interactive: accept defaults/flags")
    d.add_argument("--output-file", default=None)
    return parser


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.dry_run:
        args.direct, args.yes, args.apply = True, True, False
    interactive = not args.yes and sys.stdin.isatty()
    config = build_config(args, interactive)

    # config dump (reference cli.py:157-162)
    root = Path(config.root_dir or os.getcwd()) / ".pygrid_tpu" / "cli"
    root.mkdir(parents=True, exist_ok=True)
    out = args.output_file or str(
        root / f"config_{time.strftime('%Y-%m-%d_%H%M%S')}.json"
    )
    payload = config.to_dict()
    payload["apply"] = args.apply
    with open(out, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2)
    print(f"Wrote config to {out}")

    if args.direct:
        from pygrid_tpu_torch.infra import handle_deploy

        result = handle_deploy(payload)
        print(json.dumps(result, indent=2))
        return 0

    from pygrid_tpu_torch.web import client as http

    r = http.post(args.api_url, json=payload, timeout=600)
    if r.status_code == 200:
        print(f"Your grid {config.app.name} was deployed successfully")
        return 0
    print(
        f"There was an issue deploying your grid {config.app.name}: "
        f"{r.status_code} {r.text}"
    )
    return 1


if __name__ == "__main__":
    sys.exit(main())
