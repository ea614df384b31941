"""The port stands alone: pygrid_tpu_torch imports neither ``jax`` nor
anything of ``pygrid_tpu``, nor the packages the card's machine lacks
(``msgpack``, ``ml_dtypes``, ``orbax``, ``aiohttp``; ``websockets`` and
``requests`` only lazily, and the node's and the network's apps, the
workers and the clients not at all), and
its entry points never move to the CPU unless asked."""

import ast
import os
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import pygrid_tpu_torch
from pygrid_tpu_torch import convert
from pygrid_tpu_torch.models import mlp, transformer

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "pygrid_tpu_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules() -> list[str]:
    return [pygrid_tpu_torch.__name__] + [
        m.name
        for m in pkgutil.walk_packages(
            pygrid_tpu_torch.__path__, prefix="pygrid_tpu_torch."
        )
    ]


#: never imported by the port: the reference, and what the card's machine lacks
BANNED = ("jax", "jaxlib", "pygrid_tpu", "msgpack", "ml_dtypes", "orbax", "aiohttp")
#: imported only inside a function, where it is optional
LAZY = ("websockets", "requests")
#: the node's and the network's apps, the workers, the clients and the web
#: layer speak HTTP through the port's own ``web`` package: they never
#: import ``requests``, not even in a function
NO_REQUESTS = [PKG / d for d in ("web", "users", "client", "node", "network", "worker", "storm",
                                  "infra")] + [
    PKG / "telemetry" / f for f in ("__init__.py", "promtext.py", "slo.py")]


def _banned(name: str) -> bool:
    return name.split(".")[0] in BANNED


def meta_path_block(blocked) -> str:
    """Source that makes a fresh interpreter refuse every import whose
    top-level name is in ``blocked``, with the repo first on its path."""
    return textwrap.dedent(
        f"""
        import importlib, importlib.abc, sys
        sys.path.insert(0, {str(ROOT)!r})

        BLOCKED = {tuple(blocked)!r}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        """
    )


_BLOCKED_IMPORT = meta_path_block(BANNED + LAZY) + textwrap.dedent(
    f"""
    for mod in {_modules()!r} + ["chip_smoke"]:
        importlib.import_module(mod)

    # the wire and storage plane as the card's machine runs it
    import numpy as np, torch
    from pygrid_tpu_torch import native, serde
    from pygrid_tpu_torch.plans.state import serialize_model_params, unserialize_model_params
    from pygrid_tpu_torch.storage import Database, Warehouse
    from pygrid_tpu_torch.checkpoint import export_checkpoint, import_checkpoint
    params = [torch.randn(3, 4), torch.randn(5).to(torch.bfloat16)]
    for bf16 in (False, True):
        blob = serialize_model_params(params, bf16=bf16)
        back = unserialize_model_params(serde.decode_frame(serde.encode_frame(blob, "zlib")),
                                        device="cpu")
        assert torch.equal(back[1], params[1]) and back[0].shape == (3, 4)
        assert serde.state_raw_tensors(blob)[0].shape == (3, 4)
    assert torch.equal(back[0], params[0].to(torch.bfloat16).float())
    obj = {{"a": [1, 2.5, "x", None, np.arange(3)], "b": b"raw"}}
    assert serde.deserialize(serde.serialize(obj))["b"] == b"raw"
    acc = np.zeros(4)
    native.accum_bf16(acc, native.f32_to_bf16(np.ones(4, np.float32)))
    assert (acc == 1).all() and native.install_ws_masking() is False
    assert native.BACKEND in ("native", "numpy")

    # the FL cycle's modules, and a committed JAX-built plan decoded and run
    import pygrid_tpu_torch.federated, pygrid_tpu_torch.plans.plan
    import pygrid_tpu_torch.plans.translators, pygrid_tpu_torch.telemetry
    plan = serde.deserialize(open({str(PKG / "plans" / "fixtures" / "mlp_training_plan.bin")!r},
                                  "rb").read())
    x, y = np.zeros((64, 784), np.float32), np.eye(10, dtype=np.float32)[np.arange(64) % 10]
    params = [np.zeros((784, 392), np.float32), np.zeros(392, np.float32),
              np.zeros((392, 10), np.float32), np.zeros(10, np.float32)]
    out = plan(x, y, np.float32(0.005), *params, device="cpu")
    assert len(out) == 6 and out[2].device.type == "cpu"

    # the data-centric plane: encrypted inference of the committed JAX-built
    # CryptoNets plan over three in-process workers and a provider
    from pygrid_tpu_torch.runtime import VirtualWorker
    from pygrid_tpu_torch.smpc import (CryptoProvider, EncryptedModel, FixedPointEncoder,
                                       RemoteCryptoProvider, fix_prec_share_to_nodes)
    import pygrid_tpu_torch.datacentric
    plan = serde.deserialize(open({str(PKG / "plans" / "fixtures" / "cryptonets_plan.bin")!r},
                                  "rb").read(), device="cpu")
    holders = [VirtualWorker(n, device="cpu") for n in ("alice", "bob", "charlie")]
    dan = VirtualWorker("dan", device="cpu")
    dan.crypto_provider = CryptoProvider(seed=1, device="cpu")
    for h in holders:
        dan.add_worker(h)
    provider = RemoteCryptoProvider(dan)
    weights = [np.full(s["shape"], 0.01) for s in plan.input_specs[1:]]
    shared = [fix_prec_share_to_nodes(w, holders, crypto_provider=provider, device="cpu")
              for w in weights]
    model = EncryptedModel(plan, shared, holders, provider, FixedPointEncoder(), device="cpu")
    pred = model.predict(np.full((256, 784), 0.5, np.float32))
    assert pred.shape == (256, 10) and np.isfinite(pred).all()

    # generation serving: the paged engine against generate()
    from pygrid_tpu_torch.models import decode, transformer
    from pygrid_tpu_torch.serving import EngineConfig, GenerationEngine
    cfg = transformer.TransformerConfig(vocab=31, d_model=16, n_heads=2, n_layers=2, d_ff=32,
                                        max_len=32)
    tparams = transformer.init(cfg, device="cpu")
    engine = GenerationEngine(cfg, tparams, EngineConfig(max_slots=2, slot_buckets=(1, 2),
                                                         min_prompt_bucket=8, block_size=8,
                                                         spec_decode=True),
                              device="cpu")
    try:
        got = engine.submit(np.array([[3, 5, 2]]), 6)
    finally:
        engine.close()
    assert (got == decode.generate(tparams, torch.tensor([[3, 5, 2]]), 6, cfg).numpy()).all()
    # the node on the web layer, driven by the port's clients
    from pygrid_tpu_torch import web
    from pygrid_tpu_torch.client import DataCentricFLClient
    from pygrid_tpu_torch.node import create_app
    from pygrid_tpu_torch.web import client as http
    server = web.BackgroundServer(create_app("alice", device="cpu")).start()
    try:
        client = DataCentricFLClient(server.url, device="cpu")
        assert client.ping() and client.send(np.arange(3.0)).get().tolist() == [0.0, 1.0, 2.0]
        client.close()
        assert http.get(server.url + "/healthz", timeout=10).json() == {{"status": "ok"}}
    finally:
        server.stop()
    # the network on the web layer: a node joins it through join_network,
    # the monitor's sweep polls it over the async client, and the search
    # fan-out and PublicGridNetwork reach it
    import asyncio, time
    from pygrid_tpu_torch.client import PublicGridNetwork
    from pygrid_tpu_torch.network import create_app as create_network
    from pygrid_tpu_torch.node.__main__ import join_network
    network = web.BackgroundServer(create_network("net", monitor_interval=0.05)).start()
    node = web.BackgroundServer(create_app("bob", device="cpu")).start()
    try:
        asyncio.run(join_network(network.url, "bob", node.url))
        deadline = time.monotonic() + 30
        while network.app["network"].proxies["bob"].status != "online":
            assert time.monotonic() < deadline, "the monitor never reached bob"
            time.sleep(0.02)
        client = DataCentricFLClient(node.url, device="cpu")
        client.send(np.arange(2.0), tags={{"#iso"}})
        client.close()
        grid = PublicGridNetwork(network.url, device="cpu")
        assert list(grid.search("#iso")) == ["bob"]
        grid.close()
    finally:
        node.stop()
        network.stop()
    # secure aggregation: a port-built plan run from its op list, a masked
    # report envelope of tensors and the on-device simulation
    from pygrid_tpu_torch.client.secagg import SecAggSession
    from pygrid_tpu_torch.federated import secagg
    from pygrid_tpu_torch import parallel
    from pygrid_tpu_torch.parallel import secagg_sim
    from pygrid_tpu_torch.plans import Plan
    from pygrid_tpu_torch.utils import prng
    built = Plan(name="affine", fn=lambda x: x * 2.0 + 1.0).build(np.zeros((3,), np.float32))
    assert built.run_list(np.ones(3, np.float32), device="cpu").tolist() == [3.0, 3.0, 3.0]
    session = SecAggSession(None, "w0", "key")
    session.clip_range, session.mask_set = 0.5, ["w0"]
    assert len(secagg.decode_masked_diff(session.masked_blob([torch.ones(3)]))) == 1
    q = np.arange(12, dtype=np.uint32).reshape(4, 3)
    total = secagg_sim.masked_sum(prng.PRNGKey(0, device="cpu"), q, device="cpu")
    assert (total.numpy() == q.sum(0)).all()
    # the multi-device plane on a world of one gloo rank
    import tempfile
    import torch.distributed as dist
    from pygrid_tpu_torch.models import moe
    from pygrid_tpu_torch.parallel import (initialize_distributed, make_mesh, pipeline_apply,
                                           ring_attention, sequential_apply)
    from pygrid_tpu_torch.smpc import ring as R
    from pygrid_tpu_torch.smpc.sharded import make_sharded_open
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(init_method="file://" + tmp + "/rendezvous", world_size=1, rank=0,
                               device="cpu")
        try:
            mesh = make_mesh(device="cpu")
            assert (secagg_sim.make_sharded_masked_sum(mesh)(prng.PRNGKey(0, device="cpu"),
                                                            q).numpy() == q.sum(0)).all()
            shares = R.to_ring(np.full((3, 2), 2**63, np.uint64), device="cpu")
            assert R.from_ring(make_sharded_open(mesh, "clients")(shares)).tolist() == [2**63] * 2
            x = torch.randn(2, 8, 2, 4)
            seq = make_mesh(axes=("seq",), device="cpu")
            assert torch.allclose(ring_attention(x, x, x, seq, causal=True),
                                  parallel.attention(x, x, x, causal=True), atol=1e-6)
            stage = make_mesh(axes=("stage",), device="cpu")
            fn = lambda p, h: torch.tanh(h @ p[0])
            w = (torch.randn(1, 4, 4),)
            assert torch.allclose(pipeline_apply(fn, w, x[0, 0], stage),
                                  sequential_apply(fn, w, x[0, 0]))
            params = moe.init(4, 8, 2, device="cpu")
            assert moe.apply_expert_parallel(params, x[0, :, 0], make_mesh(axes=("expert",),
                                             device="cpu")).shape == (8, 4)
        finally:
            dist.destroy_process_group()
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("ok", len({_modules()!r}))
    """
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The module's fresh interpreters, all started at once (each spends
    its time importing torch): the import check with ``jax`` and the exact
    top-level name ``pygrid_tpu`` blocked, and chip_smoke.py run from the
    repo and from a directory holding nothing else of it. Each test waits
    on its own."""
    lone_dir = tmp_path_factory.mktemp("lone")
    lone = lone_dir / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cmds = {"blocked_import": ([sys.executable, "-c", _BLOCKED_IMPORT], ROOT)}
    if not torch.cuda.is_available():  # with a GPU the smoke would run in full
        cmds["smoke_in_repo"] = ([sys.executable, str(ROOT / "chip_smoke.py")], ROOT)
        cmds["smoke_alone"] = ([sys.executable, str(lone)], lone_dir)
    procs = {
        name: subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
        for name, (cmd, cwd) in cmds.items()
    }
    yield procs
    for proc in procs.values():
        proc.kill()
        proc.communicate()


def _wait(proc):
    stdout, stderr = proc.communicate(timeout=120)
    return proc.returncode, stdout, stderr


def test_every_module_imports_with_jax_and_pygrid_tpu_blocked(runs):
    """A fresh interpreter with a meta-path hook refusing ``jax``, the
    exact top-level name ``pygrid_tpu`` (not ``pygrid_tpu_torch``),
    ``msgpack``, ``ml_dtypes``, ``orbax``, ``websockets`` and ``requests``
    imports every module of the port and chip_smoke.py, and runs the port's
    serde, frame, native and model-params round trips, a committed JAX-built
    plan, an encrypted forward, a speculative paged engine, a node
    answering the port's clients over its own HTTP and WebSocket layer and
    a network that node joins, monitors and searches over the async client,
    as the card's machine would (no ``aiohttp``, no ``requests``)."""
    rc, stdout, stderr = _wait(runs["blocked_import"])
    assert rc == 0, stderr
    assert stdout.startswith("ok")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_pygrid_tpu_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _banned(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"
    for node in tree.body:  # module level: the lazy imports must not be here
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""])
            assert not [n for n in names if n.split(".")[0] in LAZY], \
                f"{path.name}:{node.lineno} imports {names} at module level"


def test_entry_points_without_device_cpu_raise_on_a_gpu_less_host(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = transformer.TransformerConfig(vocab=8, d_model=8, n_heads=2, n_layers=1,
                                        d_ff=8, max_len=4)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        transformer.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mlp.init((4, 2))
    arrays = [p.numpy() for p in mlp.init((4, 2), device="cpu")]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        convert.params_from_numpy(arrays, mlp_sizes=(4, 2))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pygrid_tpu_torch.resolve("cuda:0")
    assert pygrid_tpu_torch.resolve("cpu") == torch.device("cpu")
    from pygrid_tpu_torch.checkpoint import export_checkpoint, import_checkpoint
    from pygrid_tpu_torch.plans.state import serialize_model_params, unserialize_model_params

    blob = serialize_model_params([torch.ones(2)])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        unserialize_model_params(blob)
    assert torch.equal(unserialize_model_params(blob, device="cpu")[0], torch.ones(2))
    export_checkpoint([torch.ones(2)], tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        import_checkpoint(tmp_path / "ckpt")
    assert torch.equal(import_checkpoint(tmp_path / "ckpt", device="cpu")[0], torch.ones(2))
    # the network plane's entry points: each raises before it dials anything
    from pygrid_tpu_torch.client import PublicGridNetwork
    from pygrid_tpu_torch.smpc import EncryptedModel
    from pygrid_tpu_torch.worker import run_worker

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        EncryptedModel.discover("http://127.0.0.1:1", "m")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        PublicGridNetwork("http://127.0.0.1:1")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run_worker("http://127.0.0.1:1", "m")
    assert PublicGridNetwork("http://127.0.0.1:1", device="cpu").device == torch.device("cpu")
    # the SecAgg simulation's entry points
    from pygrid_tpu_torch.parallel import secagg_sim
    from pygrid_tpu_torch.utils import prng

    key, q = prng.PRNGKey(0, device="cpu"), np.arange(6, dtype=np.uint32).reshape(2, 3)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        secagg_sim.masked_sum(key, q)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        secagg_sim.simulate_secagg_round(key, np.zeros((2, 3), np.float32), 0.1)
    assert (secagg_sim.masked_sum(key, q, device="cpu").numpy() == q.sum(0)).all()
    # the multi-device plane: each raises before it touches torch.distributed
    from pygrid_tpu_torch.models import moe
    from pygrid_tpu_torch.parallel import hybrid_mesh, initialize_distributed, make_mesh

    for entry in (make_mesh, hybrid_mesh, initialize_distributed, lambda: moe.init(4, 8, 2)):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            entry()
    assert moe.init(4, 8, 2, device="cpu")[1].shape == (2, 4, 8)


def test_plan_and_oplist_with_device_cuda_raise_on_a_gpu_less_host():
    """A plan or an op list asked for the card never runs on the CPU
    instead: without a GPU, ``Plan.__call__`` and
    ``run_oplist(backend="torch")`` with the default ``device="cuda"``
    raise; ``device="cpu"`` runs."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from pygrid_tpu_torch import serde
    from pygrid_tpu_torch.plans import Plan
    from pygrid_tpu_torch.plans.translators import run_oplist

    oplist = {"constvars": [], "consts": [], "invars": [0],
              "eqns": [{"op": "neg", "in": [{"var": 0}], "out": [1], "params": {}}],
              "outvars": [{"var": 1}]}
    x = torch.ones(3)
    for dev in ("cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            run_oplist(oplist, x, device=dev)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run_oplist(oplist, x)
    assert torch.equal(run_oplist(oplist, x, device="cpu"), -x)
    listed = Plan(name="neg", oplist=oplist)
    built = Plan(name="neg", fn=torch.neg).build(x)
    live = Plan(name="neg", fn=torch.neg)
    for plan in (listed, serde.deserialize(serde.serialize(built)), live):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            plan(x)
        assert torch.equal(plan(x, device="cpu"), -x)


def test_chip_smoke_fails_without_a_gpu_and_outside_the_repo(runs):
    """chip_smoke.py exits non-zero and prints no result line where there
    is no GPU, and in a directory holding nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for name in ("smoke_in_repo", "smoke_alone"):
        rc, stdout, _ = _wait(runs[name])
        assert rc != 0, name
        assert '"ok"' not in stdout, name


def _imported_names(path: Path) -> list[tuple[int, str]]:
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append((node.lineno, node.module or ""))
    return found


@pytest.mark.parametrize("path", sorted(p for base in NO_REQUESTS
                                        for p in (base.rglob("*.py") if base.is_dir() else [base])),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_node_apps_and_clients_never_import_requests(path):
    """``requests`` appears in no import of the web layer, users/, client/,
    node/, network/, worker/, storm/, infra/ or the node's telemetry
    modules — at module level or inside a function."""
    bad = [(line, n) for line, n in _imported_names(path) if n.split(".")[0] == "requests"]
    assert not bad, f"{path.name} imports requests at {bad}"


#: the examples on the card import none of what its machine lacks
EXAMPLES_BANNED = BANNED + ("requests", "websockets")
EXAMPLE_FILES = sorted((ROOT / "examples_torch").rglob("*.py"))


@pytest.mark.parametrize("path", EXAMPLE_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_examples_import_no_jax_pygrid_tpu_requests_or_aiohttp(path):
    """``examples_torch/`` is scanned like the package: no ``jax``, nothing
    of ``pygrid_tpu``, no ``requests`` or ``aiohttp`` (nor what else the
    card's machine lacks), at module level or inside a function."""
    bad = [(line, n) for line, n in _imported_names(path)
           if n.split(".")[0] in EXAMPLES_BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_examples_cover_every_jax_example():
    """Every script of ``examples/`` has its twin at the same path."""
    jax_side = {p.relative_to(ROOT / "examples") for p in (ROOT / "examples").rglob("*.py")}
    port_side = {p.relative_to(ROOT / "examples_torch") for p in EXAMPLE_FILES}
    assert jax_side and jax_side <= port_side, sorted(map(str, jax_side - port_side))


def _raised_messages(tree: ast.Module) -> list[tuple[int, str]]:
    """(line, text) of every ``raise NotImplementedError(...)``: its string
    arguments, a module-level string constant it names included."""
    consts = {t.id: n.value.value for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name)
              and isinstance(n.value, ast.Constant) and isinstance(n.value.value, str)}
    found = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Raise) or node.exc is None:
            continue
        exc = node.exc.func if isinstance(node.exc, ast.Call) else node.exc
        if not (isinstance(exc, ast.Name) and exc.id == "NotImplementedError"):
            continue
        texts = [consts.get(n.id, "") if isinstance(n, ast.Name) else n.value
                 for n in ast.walk(node.exc) if isinstance(n, ast.Name)
                 or (isinstance(n, ast.Constant) and isinstance(n.value, str))]
        found.append((node.lineno, " ".join(texts)))
    return found


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_not_implemented_error_names_multi_device(path):
    """The multi-device plane is ported: no ``NotImplementedError`` of the
    port says it waits for it."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, text) for line, text in _raised_messages(tree)
           if "multi-device" in text or "parallel/mesh.py" in text]
    assert not bad, f"{path.name} still raises {bad}"
