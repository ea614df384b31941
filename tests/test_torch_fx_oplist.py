"""Port-built plans as op lists: ``fx_to_oplist`` lowers a ``torch.export``
program (after ``run_decompositions()``) to the JAX package's portable
dialect, and ``Plan.build`` stores the list beside the ``torch_blob``.

- The port's CNN and MLP training plans, run from their op lists by the
  port's interpreter (torch on the CPU, and numpy), by the JAX package's
  (``backend="jax"`` and ``"numpy"``) and against the direct
  ``training_step``, agree within the dialect's tolerance (rtol 2e-4,
  atol 2e-5): on random images, and on images half of which are zero, so
  that every ReLU of those rows sits at 0 (the gradient of ``maximum``
  there is 1/2) and every pool window is a tie of zeros (its gradient goes
  to the first element in row-major window order in every interpreter).
- The port-built CNN plan and the JAX-built one agree on the same inputs.
- The CryptoNets forward's op list equals ``jaxpr_to_oplist``'s, op for op,
  params and SSA ids included.
- An ATen op with no lowering, and a read of the pool's indices, raise a
  typed ``PlanTranslationError`` naming the op.
- A port-built CNN plan hosted on a JAX node is downloaded as ``"list"``
  and trained by a JAX ``FLClient`` to the checkpoint the port's direct
  step gives.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax

from pygrid_tpu.client import FLClient as JFLClient
from pygrid_tpu.client import ModelCentricFLClient as JModelCentricFLClient
from pygrid_tpu.federated import tasks as jtasks
from pygrid_tpu.models import cnn as jcnn
from pygrid_tpu.models import mlp as jmlp
from pygrid_tpu.node import create_app as j_create_app
from pygrid_tpu.plans.plan import Plan as JPlan
from pygrid_tpu.plans.state import serialize_model_params as j_serialize_params
from pygrid_tpu.plans.translators import run_oplist as j_run_oplist
from pygrid_tpu_torch import convert, serde
from pygrid_tpu_torch.models import cnn, mlp
from pygrid_tpu_torch.plans import Plan, fx_to_oplist
from pygrid_tpu_torch.plans.translators import run_oplist
from pygrid_tpu_torch.utils.exceptions import PlanTranslationError
from test_torch_network import restore_process_state  # noqa: F401 (an autouse fixture)
from test_torch_plans import cryptonets_forward
from test_torch_web import AioServer

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5  # the dialect's tolerance (tests/test_torch_federated.py)
B = 4
MLP_SIZES = (20, 8, 10)
LR = 0.1


def _inputs(kind, images, seed=3):
    """numpy X, y and params (the JAX package's init) for ``kind``; with
    ``images="half_zero"`` the first half of the batch is all zeros."""
    rng = np.random.RandomState(seed)
    shape = (B, 28, 28, 1) if kind == "cnn" else (B, MLP_SIZES[0])
    X = rng.rand(*shape).astype(np.float32)
    if images == "half_zero":
        X[: B // 2] = 0.0
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, B)]
    key = jax.random.PRNGKey(seed)
    params = jcnn.init(key) if kind == "cnn" else jmlp.init(key, MLP_SIZES)
    return X, y, [np.asarray(p) for p in params]


def _torch_params(kind, params):
    if kind == "cnn":
        return convert.params_from_numpy(params, "cpu", cnn=True)
    return convert.params_from_numpy(params, "cpu", mlp_sizes=MLP_SIZES)


@pytest.fixture(scope="module")
def port_plans():
    """The port's CNN and MLP training plans, built once at batch ``B``."""
    plans = {}
    for kind, model in (("cnn", cnn), ("mlp", mlp)):
        X, y, params = _inputs(kind, "random")
        plans[kind] = Plan(name="training_plan", fn=model.training_step).build(
            X, y, np.float32(LR), *params)
    return plans


def _assert_close(got, ref, what):
    assert len(got) == len(ref), what
    for i, (a, b) in enumerate(zip(got, ref)):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape, (what, i)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"{what} output {i}")


@pytest.mark.parametrize("kind", ["cnn", "mlp"])
@pytest.mark.parametrize("images", ["random", "half_zero"])
def test_training_plan_op_list_runs_alike_in_every_interpreter(port_plans, kind, images):
    plan = port_plans[kind]
    X, y, params = _inputs(kind, images)
    model = cnn if kind == "cnn" else mlp
    ref = model.training_step(torch.from_numpy(X), torch.from_numpy(y), torch.tensor(LR),
                              *_torch_params(kind, params))
    args = (X, y, np.float32(LR), *params)
    _assert_close(run_oplist(plan.oplist, *args, device="cpu"), ref, "port torch")
    _assert_close(run_oplist(plan.oplist, *args, backend="numpy"), ref, "port numpy")
    _assert_close(j_run_oplist(plan.oplist, *args, backend="jax"), ref, "jax")
    _assert_close(j_run_oplist(plan.oplist, *args, backend="numpy"), ref, "jax numpy")
    if images == "half_zero":  # the zero rows' ties reached the bias gradients
        assert float(ref[3].abs().sum() if kind == "cnn" else ref[2].abs().sum()) > 0


def test_tie_heavy_pool_gradient_is_the_same_in_every_interpreter():
    """All-zero images and zero biases: every conv output is exactly 0, so
    every ReLU is at its kink and every 2x2 pool window is four zeros. The
    bias gradients carry the routing: equal in every interpreter and to the
    JAX package's own training step."""
    X, y, params = _inputs("cnn", "random", seed=5)
    X[:] = 0.0
    plan = Plan(name="training_plan", fn=cnn.training_step).build(X, y, np.float32(LR), *params)
    args = (X, y, np.float32(LR), *params)
    ref = jcnn.training_step(*args)
    outs = {
        "port torch": run_oplist(plan.oplist, *args, device="cpu"),
        "port numpy": run_oplist(plan.oplist, *args, backend="numpy"),
        "jax": j_run_oplist(plan.oplist, *args, backend="jax"),
        "jax numpy": j_run_oplist(plan.oplist, *args, backend="numpy"),
        "direct": cnn.training_step(*[torch.from_numpy(np.array(a)) for a in args]),
    }
    for what, got in outs.items():
        _assert_close(got, ref, what)
    grad_b1 = (params[1] - np.asarray(ref[3])) / LR
    assert np.abs(grad_b1).max() > 0


def test_port_and_jax_built_cnn_plans_agree():
    X, y, params = _inputs("cnn", "half_zero", seed=7)
    args = (X, y, np.float32(LR), *params)
    port = Plan(name="training_plan", fn=cnn.training_step).build(*args)
    jplan = JPlan(name="training_plan", fn=jcnn.training_step)
    jplan.build(*args)
    ref = j_run_oplist(jplan.oplist, *args, backend="jax")
    _assert_close(j_run_oplist(port.oplist, *args, backend="jax"), ref, "port-built on jax")
    _assert_close(run_oplist(port.oplist, *args, device="cpu"), ref, "port-built on torch")
    _assert_close(run_oplist(jplan.oplist, *args, device="cpu"), ref, "jax-built on torch")
    ops = {e["op"] for e in port.oplist["eqns"]}
    assert {"conv_general_dilated", "rev", "reduce_window_max",
            "select_and_scatter_add"} <= ops
    sas = next(e for e in port.oplist["eqns"] if e["op"] == "select_and_scatter_add")
    assert sas["params"]["select_prim"] == {"__repr__": "ge"}


def test_cryptonets_op_list_equals_jaxpr_to_oplist():
    shapes = ((4, 16), (16, 8), (8,), (8, 4), (4,))
    zeros = [np.zeros(s, np.float32) for s in shapes]
    port = Plan(name="encrypted_forward", fn=cryptonets_forward).build(*zeros)
    jplan = JPlan(name="encrypted_forward", fn=cryptonets_forward)
    jplan.build(*zeros)
    assert [e["op"] for e in port.oplist["eqns"]] == [
        "dot_general", "broadcast_in_dim", "add", "mul", "dot_general", "broadcast_in_dim", "add"]
    assert port.oplist == jplan.oplist


def test_lifted_constants_become_consts():
    offset = torch.tensor([1.0, 2.0, 3.0])
    plan = Plan(name="shift", fn=lambda x: x * 2.0 + offset).build(np.zeros((2, 3), np.float32))
    ol = plan.oplist
    assert len(ol["consts"]) == 1 and np.array_equal(ol["consts"][0], offset.numpy())
    x = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    want = x * 2.0 + offset.numpy()
    np.testing.assert_array_equal(run_oplist(ol, x, device="cpu").numpy(), want)
    np.testing.assert_array_equal(np.asarray(j_run_oplist(ol, x, backend="jax")), want)


def test_an_op_without_a_lowering_raises_naming_it():
    with pytest.raises(PlanTranslationError, match="aten.sin.default"):
        Plan(name="sin", fn=torch.sin).build(np.zeros((3,), np.float32))

    def pool_indices(x):
        return F.max_pool2d(x, 2, return_indices=True)[1].to(torch.float32)

    with pytest.raises(PlanTranslationError, match="indices"):
        Plan(name="idx", fn=pool_indices).build(np.zeros((1, 1, 4, 4), np.float32))
    from torch.fx.experimental.proxy_tensor import make_fx

    x = torch.zeros(2, 3)
    graph = make_fx(lambda t: torch.cumsum(t, 1))(x)
    ep = torch.export.export(graph, (x,), strict=False)
    with pytest.raises(PlanTranslationError, match="aten.cumsum"):
        fx_to_oplist(ep.run_decompositions())


def test_port_built_cnn_plan_trains_on_a_jax_node_through_a_jax_client(port_plans):
    """The port-built plan's blob hosted on a JAX node: the node stores its
    "list" variant, a JAX FLClient downloads it, trains with the JAX
    package's interpreter and reports; the checkpoint is the old params
    minus the port's direct step's diff."""
    X, y, params = _inputs("cnn", "half_zero", seed=11)
    prev = jtasks._sync
    jtasks.set_sync(True)
    try:
        with AioServer(j_create_app("jax-node")) as url:
            mc = JModelCentricFLClient(url)
            assert mc.host_federated_training(
                model=params, client_plans={"training_plan": serde.serialize(port_plans["cnn"])},
                client_config={"name": "port-cnn", "version": "1.0", "lr": LR},
                server_config={"min_workers": 1, "max_workers": 1, "min_diffs": 1,
                               "max_diffs": 1, "num_cycles": 1},
            )["status"] == "success"
            client = JFLClient(url)
            wid = client.authenticate("port-cnn", "1.0")["worker_id"]
            cyc = client.cycle_request(wid, "port-cnn", "1.0", 1.0, 1000.0, 1000.0)
            assert cyc["status"] == "accepted", cyc
            key = cyc["request_key"]
            got = [np.asarray(p) for p in client.get_model(wid, key, cyc["model_id"])]
            oplist = client.get_plan(wid, key, cyc["plans"]["training_plan"],
                                     receive_operations_as="list")
            assert isinstance(oplist, dict) and oplist == port_plans["cnn"].oplist
            out = j_run_oplist(oplist, X, y, np.float32(LR), *got, backend="jax")
            diff = [p - np.asarray(n) for p, n in zip(got, out[2:])]
            assert not client.report(wid, key, j_serialize_params(diff)).get("error")
            client.close()
            latest = [np.asarray(t) for t in mc.retrieve_model("port-cnn", "1.0")]
            mc.close()
    finally:
        jtasks.set_sync(prev)
    ref = cnn.training_step(torch.from_numpy(X), torch.from_numpy(y), torch.tensor(LR),
                            *_torch_params("cnn", params))
    _assert_close(latest, ref[2:], "checkpoint")
    assert not np.array_equal(latest[0], params[0])
