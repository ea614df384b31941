"""The port's deploy plane (pygrid_tpu_torch.infra) on GPU hosts: the
sixteen cases of the JAX package's ``tests/unit/test_infra.py`` against
the port's builders, plus a structural cross-stack check (for every
provider, deployment type and app the port's terraform has the
reference's resource types, ports and env, apart from the accelerator
map), a port node spawned by ``LocalProvider(apply=True)`` answering
``/healthz``, the deploy API over the port's web layer, and
``deploy_torch/`` equal to what its ``regenerate.py`` renders."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import socket
import time

import pytest

from pygrid_tpu_torch import web
from pygrid_tpu_torch.infra import handle_deploy
from pygrid_tpu_torch.infra.cli import main as cli_main
from pygrid_tpu_torch.infra.config import AppConfig, DbConfig, DeployConfig, GpuConfig
from pygrid_tpu_torch.infra.providers import build_provider, server_command
from pygrid_tpu_torch.infra.providers.local import LocalProvider
from pygrid_tpu_torch.web import client as http

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _node_config(tmp_path, **kw) -> DeployConfig:
    return DeployConfig(
        app=AppConfig(name="node", id="alice", port=5001,
                      network="http://net:7000"),
        root_dir=str(tmp_path),
        **kw,
    )


def test_server_command_node(tmp_path):
    cmd = server_command(_node_config(tmp_path))
    assert "pygrid_tpu_torch.node" in cmd
    assert ["--id", "alice"] == cmd[cmd.index("--id"):cmd.index("--id") + 2]
    assert "--network" in cmd
    assert cmd[cmd.index("--device") + 1] == "cuda"


def test_gcp_serverfull_renders_gpu_vm(tmp_path):
    provider = build_provider(_node_config(tmp_path))
    artifacts = provider.deploy(apply=False)
    assert artifacts["applied"] is False
    main_tf = json.load(open(f"{artifacts['root_dir']}/main.tf.json"))
    vm = main_tf["resource"]["google_compute_instance"]["grid_app"]
    assert vm["machine_type"] == "a3-highgpu-1g"
    assert vm["guest_accelerator"] == [{"type": "nvidia-h100-80gb", "count": 1}]
    # a VM with a GPU cannot live-migrate
    assert vm["scheduling"]["on_host_maintenance"] == "TERMINATE"
    assert "pytorch-latest-gpu" in vm["boot_disk"]["initialize_params"]["image"]
    startup = vm["metadata"]["startup-script"]
    assert "pygrid_tpu_torch.node" in startup and "--device cuda" in startup
    fw = main_tf["resource"]["google_compute_firewall"]["grid_ingress"]
    assert {"protocol": "tcp", "ports": ["5001"]} in fw["allow"]


def test_gcp_serverless_renders_cloud_run(tmp_path):
    cfg = _node_config(tmp_path, deployment_type="serverless")
    artifacts = build_provider(cfg).deploy()
    main_tf = json.load(open(f"{artifacts['root_dir']}/main.tf.json"))
    assert "google_cloud_run_v2_service" in main_tf["resource"]
    # the queued TPU resource's counterpart: a spot GPU VM
    compute = main_tf["resource"]["google_compute_instance"]["grid_compute"]
    assert compute["scheduling"]["preemptible"] is True
    assert compute["scheduling"]["provisioning_model"] == "SPOT"
    args = main_tf["resource"]["google_cloud_run_v2_service"]["grid_app"][
        "template"]["containers"][0]["args"]
    # no card in the Cloud Run container: its node stays on the host
    assert args[args.index("--device") + 1] == "cpu"


def test_multihost_startup_sets_distributed_env(tmp_path):
    cfg = _node_config(tmp_path)
    cfg.gpu = GpuConfig(num_hosts=4)
    files = build_provider(cfg).render()
    script = files["startup.sh"]
    for line in ("export MASTER_ADDR=pygrid-node-alice-0", "export MASTER_PORT=29500",
                 "export WORLD_SIZE=4"):
        assert line in script
    assert "export NODE_RANK=" in script and 'export RANK="$NODE_RANK"' in script
    doc = json.loads(files["main.tf.json"])
    vms = doc["resource"]["google_compute_instance"]
    assert sorted(vms) == [f"grid_app_{r}" for r in range(4)]
    assert [vms[f"grid_app_{r}"]["metadata"]["node-rank"] for r in range(4)] == ["0", "1", "2", "3"]
    assert vms["grid_app_0"]["name"] == "pygrid-node-alice-0"


def test_local_provider_dry_run(tmp_path):
    cfg = _node_config(tmp_path, provider="local")
    provider = build_provider(cfg)
    assert isinstance(provider, LocalProvider)
    result = provider.deploy(apply=False)
    assert result["applied"] is False and "run.sh" in result["files"]


def test_unknown_provider_rejected(tmp_path):
    with pytest.raises(ValueError):
        DeployConfig(provider="ibm")
    # azure graduated from the reference's stub to a working provider
    assert build_provider(
        _node_config(tmp_path, provider="azure")
    ).name == "azure-serverfull"


def test_handle_deploy_roundtrip(tmp_path):
    """The deploy API core: CLI config dict → artifacts on disk (reference
    api/__main__.py:17-40 contract)."""
    payload = _node_config(tmp_path).to_dict()
    result = handle_deploy(payload)
    assert result["message"] == "Deployment successful"
    assert result["provider"] == "gcp"
    assert "main.tf.json" in result["artifacts"]["files"]


def test_cli_direct_dry_run(tmp_path, capsys):
    rc = cli_main([
        "deploy", "--yes", "--direct", "--provider", "gcp", "--app",
        "network", "--port", "7000", "--root-dir", str(tmp_path),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Deployment successful" in out
    configs = list((tmp_path / ".pygrid_tpu" / "cli").glob("config_*.json"))
    assert len(configs) == 1
    written = json.load(open(configs[0]))
    assert written["app"]["name"] == "network"
    assert written["gpu"]["accelerator_type"] == "nvidia-h100-80gb"


def test_azure_serverfull_renders_vm(tmp_path):
    cfg = _node_config(tmp_path, provider="azure")
    files = build_provider(cfg).render()
    doc = json.loads(files["main.tf.json"])
    vm = doc["resource"]["azurerm_linux_virtual_machine"]["grid_app"]
    assert vm["size"].startswith("Standard_")
    nsg = doc["resource"]["azurerm_network_security_group"]["grid"]
    assert nsg["security_rule"][0]["destination_port_range"] == str(
        cfg.app.port
    )
    assert "pip install pygrid-tpu" in files["user_data.sh"]
    # the coordination plane has no card
    assert "pygrid_tpu_torch.node" in files["user_data.sh"]
    assert "--device cpu" in files["user_data.sh"]


def test_azure_serverless_renders_container_group(tmp_path):
    cfg = _node_config(
        tmp_path, provider="azure", deployment_type="serverless",
        db=DbConfig(engine="postgres", url="postgres://u:p@db.corp/grid"),
    )
    files = build_provider(cfg).render()
    doc = json.loads(files["main.tf.json"])
    grp = doc["resource"]["azurerm_container_group"]["grid_app"]
    container = grp["container"][0]
    assert container["image"] == "${var.image_uri}"
    assert "pygrid_tpu_torch.node" in " ".join(container["commands"])
    assert (
        container["environment_variables"]["DATABASE_URL"]
        == "postgres://u:p@db.corp/grid"
    )
    assert grp["ip_address_type"] == "Public"


def _regenerate():
    spec = importlib.util.spec_from_file_location(
        "regenerate_torch", ROOT / "deploy_torch" / "regenerate.py"
    )
    regen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(regen)
    return regen


def test_checked_in_stacks_match_builders():
    """deploy_torch/<stack>/* are rendered by the live provider builders —
    regeneration must be a no-op."""
    regen = _regenerate()
    for stack in regen.STACKS:
        rendered = regen.render_stack(stack)
        for fname, contents in rendered.items():
            on_disk = (ROOT / "deploy_torch" / stack / fname).read_text()
            assert on_disk == contents, f"deploy_torch/{stack}/{fname} drifted"


def test_cli_dry_run_flag(tmp_path, capsys):
    """`python -m pygrid_tpu_torch.infra deploy --provider gcp --app node
    --dry-run` writes the terraform configs without applying."""
    rc = cli_main([
        "deploy", "--dry-run", "--provider", "gcp", "--app", "node",
        "--id", "alice", "--root-dir", str(tmp_path),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Deployment successful" in out
    tf = tmp_path / ".pygrid_tpu" / "api" / "gcp-serverfull" / "main.tf.json"
    assert tf.exists()
    doc = json.load(open(tf))
    assert "google_compute_instance" in doc["resource"]
    assert "google_tpu_v2_vm" not in doc["resource"]


def test_aws_serverfull_renders_ec2(tmp_path):
    cfg = _node_config(tmp_path, provider="aws")
    files = build_provider(cfg).render()
    doc = json.loads(files["main.tf.json"])
    inst = doc["resource"]["aws_instance"]["grid_app"]
    assert "pip install pygrid-tpu" in inst["user_data"]
    assert "pygrid_tpu_torch.node" in inst["user_data"]
    sg = doc["resource"]["aws_security_group"]["grid_ingress"]
    assert sg["ingress"][0]["from_port"] == cfg.app.port
    assert doc["provider"]["aws"]["region"]  # zone mapped or default


def test_aws_serverless_renders_lambda_with_efs(tmp_path):
    cfg = _node_config(tmp_path, provider="aws", deployment_type="serverless")
    files = build_provider(cfg).render()
    doc = json.loads(files["main.tf.json"])
    fn = doc["resource"]["aws_lambda_function"]["grid_app"]
    assert fn["package_type"] == "Image"
    assert fn["file_system_config"]["local_mount_path"] == "/mnt/pygrid"
    assert "aws_lambda_function_url" in doc["resource"]
    assert "aws_efs_file_system" in doc["resource"]
    # sqlite-on-EFS cannot take concurrent writers: the pin must stay
    assert fn["reserved_concurrent_executions"] == 1
    command = fn["image_config"]["command"]
    assert command[command.index("--device") + 1] == "cpu"


def test_aws_serverless_postgres_lifts_concurrency_pin(tmp_path):
    """With a client-server DB the Lambda scales horizontally: the stack
    provisions in-VPC RDS postgres, drops EFS, and removes the
    reserved-concurrency pin (the reference's Aurora posture,
    deploy/serverless-node/database.tf:1-6)."""
    cfg = _node_config(
        tmp_path, provider="aws", deployment_type="serverless",
        db=DbConfig(engine="postgres"),
    )
    files = build_provider(cfg).render()
    doc = json.loads(files["main.tf.json"])
    fn = doc["resource"]["aws_lambda_function"]["grid_app"]
    assert "reserved_concurrent_executions" not in fn
    assert "file_system_config" not in fn
    assert "aws_efs_file_system" not in doc["resource"]
    rds = doc["resource"]["aws_db_instance"]["grid_db"]
    assert rds["engine"] == "postgres"
    assert doc["variable"]["db_password"]["sensitive"] is True
    url = fn["environment"]["variables"]["DATABASE_URL"]
    assert url.startswith("postgres://") and "grid_db.address" in url
    assert "urlencode(var.db_password)" in url
    # least privilege: the EFS policy grant and NFS ingress die with EFS
    assert "grid_lambda_efs" not in doc["resource"][
        "aws_iam_role_policy_attachment"
    ]
    assert doc["resource"]["aws_security_group"]["grid_efs"]["ingress"] == []


def test_aws_serverless_byo_postgres_url(tmp_path):
    """An explicit postgres:// db.url is wired through verbatim — no RDS
    is provisioned (bring-your-own database)."""
    cfg = _node_config(
        tmp_path, provider="aws", deployment_type="serverless",
        db=DbConfig(engine="postgres", url="postgres://u:p@db.corp:5432/grid"),
    )
    files = build_provider(cfg).render()
    doc = json.loads(files["main.tf.json"])
    fn = doc["resource"]["aws_lambda_function"]["grid_app"]
    assert "reserved_concurrent_executions" not in fn
    assert "aws_db_instance" not in doc["resource"]
    env = fn["environment"]["variables"]
    assert env["DATABASE_URL"] == "postgres://u:p@db.corp:5432/grid"
    # an external DB is unreachable from a default-VPC Lambda: the BYO
    # branch must drop the VPC attachment (and the now-unused app SG)
    assert "vpc_config" not in fn
    assert "grid_efs" not in doc["resource"]["aws_security_group"]


# ── cross-stack structure ───────────────────────────────────────────────

#: the documented accelerator map: (type, name) in the JAX package's
#: terraform → its counterpart in the port's
ACCELERATOR_MAP = {
    ("google_tpu_v2_vm", "grid_app"): ("google_compute_instance", "grid_app"),
    ("google_tpu_v2_queued_resource", "grid_compute"): ("google_compute_instance", "grid_compute"),
}
_PORT_KEYS = ("ports", "port", "container_port", "from_port", "to_port",
              "destination_port_range")


def _resources(doc: dict, mapped: bool) -> set:
    out = {(kind, name) for kind, block in doc.get("resource", {}).items() for name in block}
    return {ACCELERATOR_MAP.get(r, r) for r in out} if mapped else out


def _items(x):
    """Every (key, value) pair of a nested terraform document."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield k, v
            yield from _items(v)
    elif isinstance(x, list):
        for v in x:
            yield from _items(v)


def _ports(doc: dict) -> list:
    """Every port value in a terraform document, as strings, sorted."""
    found = []
    for k, v in _items(doc):
        if k in _PORT_KEYS and isinstance(v, (str, int)):
            found.append(str(v))
        elif k == "ports" and isinstance(v, list) and all(isinstance(p, (str, int)) for p in v):
            found.extend(str(p) for p in v)
    return sorted(found)


def _envs(doc: dict) -> list:
    """The env handed to the grid process: Cloud Run's env list, the
    Lambda's variables, the container group's environment_variables."""
    found = []
    for k, v in _items(doc):
        if k == "env" and isinstance(v, list):
            found.append({e["name"]: e["value"] for e in v})
        elif k == "environment_variables" or (k == "variables" and isinstance(v, dict)
                                               and "PORT" in v):
            found.append(dict(v))
    return found


def _commands(doc: dict) -> list:
    return [list(v) for k, v in _items(doc)
            if k in ("args", "command", "commands") and isinstance(v, list)]


def _embedded_scripts(doc: dict) -> list:
    return [v for k, v in _items(doc) if k in ("startup-script", "user_data")
            and isinstance(v, str)]


def _as_reference(argv: list) -> list:
    """A port server argv in the JAX package's words: its module names,
    and no ``--device`` (the JAX servers take none)."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--device":
            skip = True
        else:
            out.append(a.replace("pygrid_tpu_torch.", "pygrid_tpu."))
    return out


def _script_in_reference_words(text: str) -> str:
    import shlex

    lines = []
    for line in text.splitlines():
        if line.startswith("exec "):
            line = "exec " + " ".join(shlex.quote(a) for a in _as_reference(shlex.split(line[5:])))
        lines.append(line)
    return "\n".join(lines) + ("\n" if text.endswith("\n") else "")


@pytest.mark.parametrize("app", ("node", "network", "worker"))
@pytest.mark.parametrize("deployment_type", ("serverfull", "serverless"))
@pytest.mark.parametrize("provider", ("gcp", "aws", "azure", "local"))
def test_port_stacks_have_the_reference_structure(tmp_path, provider, deployment_type, app):
    """For one (provider, deployment type, app), the port's render has the
    JAX package's files, resource types and names (through the accelerator
    map only), ports, process env and server commands (the port's module
    names, plus ``--device``: ``cuda`` on a GPU VM, ``cpu`` on the
    coordination plane's hosts)."""
    from pygrid_tpu.infra.config import AppConfig as JAppConfig
    from pygrid_tpu.infra.config import DeployConfig as JDeployConfig
    from pygrid_tpu.infra.providers import build_provider as jbuild

    app_kw = {"name": app, "id": "alice" if app == "node" else None, "port": 5003,
              "network": "http://net:7000" if app != "network" else None}
    common = {"provider": provider, "deployment_type": deployment_type}
    port = build_provider(DeployConfig(app=AppConfig(**app_kw), root_dir=str(tmp_path / "p"),
                                       **common)).render()
    ref = jbuild(JDeployConfig(app=JAppConfig(**app_kw), root_dir=str(tmp_path / "j"),
                               **common)).render()
    assert sorted(port) == sorted(ref)
    for fname in ref:
        if fname.endswith(".sh"):
            assert _script_in_reference_words(port[fname]) == ref[fname], fname
            continue
        pdoc, jdoc = json.loads(port[fname]), json.loads(ref[fname])
        assert _resources(pdoc, mapped=False) == _resources(jdoc, mapped=True)
        assert _ports(pdoc) == _ports(jdoc)
        assert _envs(pdoc) == _envs(jdoc)
        assert [_as_reference(c) for c in _commands(pdoc)] == _commands(jdoc)
        assert [_script_in_reference_words(s) for s in _embedded_scripts(pdoc)] == \
            _embedded_scripts(jdoc)
        on_gpu = provider == "gcp" and deployment_type == "serverfull"
        for cmd in _commands(pdoc):
            if "--device" in cmd:
                assert cmd[cmd.index("--device") + 1] == "cpu"
        for script in _embedded_scripts(pdoc):
            if app != "network":
                assert ("--device cuda" if on_gpu else "--device cpu") in script


# ── the local provider and the deploy API, live ─────────────────────────


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_local_provider_apply_spawns_a_node_that_answers_healthz(tmp_path):
    """``LocalProvider.deploy(apply=True)`` with ``device="cpu"`` spawns
    the port's node with ``sys.executable``; it answers ``/healthz`` and
    ``destroy()`` ends it."""
    port = _free_port()
    cfg = DeployConfig(provider="local",
                       app=AppConfig(name="node", id="alice", host="127.0.0.1", port=port),
                       gpu=GpuConfig(device="cpu"), root_dir=str(tmp_path))
    provider = build_provider(cfg)
    result = provider.deploy(apply=True)
    try:
        assert result["applied"] is True and result["pid"] == provider.processes[0].pid
        assert provider.command()[1:3] == ["-m", "pygrid_tpu_torch.node"]
        deadline = time.monotonic() + 60
        status = None
        while time.monotonic() < deadline:
            assert provider.processes[0].poll() is None, "the node exited"
            try:
                resp = http.get(f"http://127.0.0.1:{port}/healthz", timeout=2)
                status = resp.status_code
                if status == 200:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        assert status == 200
        assert resp.json() == {"status": "ok"}
    finally:
        proc = provider.processes[0]
        assert provider.destroy() is True
    assert proc.poll() is not None and provider.processes == []


def test_deploy_api_serves_the_double_encoded_contract(tmp_path):
    """The deploy API on the port's web layer: a config POSTed as a
    JSON-encoded string (the reference CLI's double encoding) or as an
    object deploys; a bad provider answers 400 with the error."""
    from pygrid_tpu_torch.infra.api import create_app

    server = web.BackgroundServer(create_app()).start()
    try:
        payload = _node_config(tmp_path).to_dict()
        for body in (json.dumps(payload), payload):
            resp = http.post(server.url + "/", json=body, timeout=30)
            assert resp.status_code == 200
            out = resp.json()
            assert out["message"] == "Deployment successful"
            assert out["artifacts"]["files"] == ["main.tf.json", "startup.sh"]
        bad = http.post(server.url + "/", json={**payload, "provider": "ibm"}, timeout=30)
        assert bad.status_code == 400 and "unknown provider" in bad.json()["error"]
        # the CLI's non-direct path POSTs through the port's client
        rc = cli_main(["deploy", "--yes", "--provider", "gcp", "--app", "network",
                       "--root-dir", str(tmp_path), "--api-url", server.url + "/"])
        assert rc == 0
    finally:
        server.stop()
