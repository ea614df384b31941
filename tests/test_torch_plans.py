"""The port's plans against the JAX package's: the op-list dialect's two
tables (torch and numpy) op for op, the MLP, CNN and transformer training
plans through ``run_oplist(backend="torch")``, the bounds' typed errors,
JAX-built plan blobs re-serialized byte for byte, port-built plans
(``torch.export``) across serde and into a fresh process, and the committed
JAX-built fixtures the card's machine trains.

Tolerances: data movement, integer and comparison ops (max-pool-backward
ties included) must match bit for bit; f32 arithmetic within rtol 2e-4,
atol 2e-5 (the JAX package's own dialect tolerance, tests/unit/test_plans.py).

Writing the fixtures (JAX on the CPU)::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_plans.py
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pygrid_tpu import serde as jserde  # noqa: E402
from pygrid_tpu.models import cnn as jcnn  # noqa: E402
from pygrid_tpu.models import mlp as jmlp  # noqa: E402
from pygrid_tpu.models import transformer as jtransformer  # noqa: E402
from pygrid_tpu.plans import Plan as JPlan  # noqa: E402
from pygrid_tpu.plans import translate_plan as j_translate  # noqa: E402
from pygrid_tpu.plans.state import State as JState  # noqa: E402
from pygrid_tpu.plans.translators import _INTERP_TABLE, _NUMPY_TABLE  # noqa: E402
from pygrid_tpu.plans.translators import run_oplist as j_run  # noqa: E402
from pygrid_tpu_torch import serde  # noqa: E402
from pygrid_tpu_torch.models import cnn  # noqa: E402
from pygrid_tpu_torch.plans import Plan, func2plan, translate_plan  # noqa: E402
from pygrid_tpu_torch.plans import translators as T  # noqa: E402
from pygrid_tpu_torch.plans.state import State  # noqa: E402
from pygrid_tpu_torch.utils.exceptions import (  # noqa: E402
    PlanInvalidError,
    PlanTranslationError,
)

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "pygrid_tpu_torch" / "plans" / "fixtures"
RTOL, ATOL = 2e-4, 2e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _assert_same(ref, got, exact):
    ref, got = _np(ref), _np(got)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL, equal_nan=True)


def _one_eqn(op, n_in, params, lits=()):
    """A single-equation op list: inputs 0..n_in-1, then literal refs."""
    ins = [{"var": i} for i in range(n_in)] + list(lits)
    return {"constvars": [], "consts": [], "invars": list(range(n_in)),
            "eqns": [{"op": op, "in": ins, "out": [n_in], "params": params}],
            "outvars": [{"var": n_in}]}


# --- op by op -----------------------------------------------------------------

_R = np.random.RandomState(0)
F32 = _R.randn(3, 4, 5).astype(np.float32)
G32 = _R.randn(3, 4, 5).astype(np.float32)
POS = (_R.rand(3, 4, 5) + 0.1).astype(np.float32)
I32 = _R.randint(-9, 10, (3, 4, 5)).astype(np.int32)
J32 = np.where(_R.rand(3, 4, 5) < 0.5, -1, 1).astype(np.int32) * _R.randint(1, 5, (3, 4, 5)).astype(np.int32)
B1 = _R.rand(3, 4, 5) < 0.5
B2 = _R.rand(3, 4, 5) < 0.5
SPECIAL = np.array([np.nan, -np.inf, np.inf, -0.0, 0.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.7, -3.7],
                   np.float32)
TIES = _R.randint(0, 3, (4, 6)).astype(np.int32)
GS = {"dimension_numbers": [[1, 2], [0], [0], [], []], "slice_sizes": [1, 4, 3]}
IDX = np.array([[0], [4], [9], [-2]], np.int32)
GA = _R.randn(5, 4, 3).astype(np.float32)


def _mode(m):
    return {"__repr__": f"GatherScatterMode.{m}"}


def _conv_p(dn, strides=(1, 1), padding=((0, 0), (0, 0)), ldil=(1, 1), rdil=(1, 1),
            groups=1, bgroups=1):
    return {"window_strides": list(strides), "padding": [list(p) for p in padding],
            "lhs_dilation": list(ldil), "rhs_dilation": list(rdil),
            "dimension_numbers": [list(d) for d in dn], "feature_group_count": groups,
            "batch_group_count": bgroups, "precision": None, "preferred_element_type": None}


NHWC = ((0, 3, 1, 2), (3, 2, 0, 1), (0, 3, 1, 2))      # the CNN's forward conv
WGRAD = ((3, 0, 1, 2), (3, 0, 1, 2), (2, 3, 0, 1))     # its weight-gradient conv
IGRAD = ((0, 3, 1, 2), (2, 3, 0, 1), (0, 3, 1, 2))     # its input-gradient conv
POOL = {"window_dimensions": [1, 2, 2, 1], "window_strides": [1, 2, 2, 1],
        "padding": [[0, 0]] * 4, "base_dilation": [1] * 4, "window_dilation": [1] * 4}
SASA = {"select_prim": {"__repr__": "ge"}, "window_dimensions": [1, 2, 2, 1],
        "window_strides": [1, 2, 2, 1], "padding": [[0, 0]] * 4}
X_POOL = _R.randn(2, 6, 8, 3).astype(np.float32)
SRC = _R.randn(2, 3, 4, 3).astype(np.float32)

# (id, op, inputs, params, exact)
OP_CASES = [
    *[(op, op, [F32, G32], {}, False) for op in ("add", "add_any", "sub", "mul", "div",
                                                 "max", "min", "atan2")],
    ("pow", "pow", [POS, G32], {}, False),
    ("nextafter", "nextafter", [F32, G32], {}, True),
    ("rem-f32", "rem", [F32 * 7, G32], {}, False),
    *[(f"{op}-i32", op, [I32, J32], {}, True) for op in ("add", "sub", "mul", "max", "min",
                                                         "rem", "eq", "ne", "gt", "lt",
                                                         "ge", "le")],
    ("div-i32", "div", [I32, J32], {}, False),
    *[(op, op, [B1, B2], {}, True) for op in ("and", "or", "xor")],
    *[(op, op, [F32, G32], {}, True) for op in ("gt", "lt", "ge", "le", "eq", "ne")],
    *[(op, op, [F32], {}, False) for op in ("neg", "abs", "exp", "tanh", "logistic",
                                            "exp2", "square")],
    *[(op, op, [POS], {}, False) for op in ("log", "sqrt", "rsqrt")],
    *[(f"{op}-special", op, [SPECIAL], {}, True) for op in ("sign", "floor", "ceil",
                                                            "round", "is_finite", "abs",
                                                            "neg")],
    ("sign-i32", "sign", [I32], {}, True),
    ("stop_gradient", "stop_gradient", [F32], {}, True),
    ("copy", "copy", [I32], {}, True),
    ("integer_pow-3", "integer_pow", [F32], {"y": 3}, False),
    ("integer_pow-neg2", "integer_pow", [POS], {"y": -2}, False),
    ("integer_pow-0", "integer_pow", [F32], {"y": 0}, True),
    ("integer_pow-i32", "integer_pow", [I32], {"y": 5}, True),
    ("convert-f32-i32", "convert_element_type", [F32 * 3],
     {"new_dtype": {"__dtype__": "int32"}, "weak_type": False}, True),
    ("convert-i32-f32", "convert_element_type", [I32],
     {"new_dtype": {"__dtype__": "float32"}, "weak_type": False}, True),
    ("convert-f32-bool", "convert_element_type", [np.round(F32)],
     {"new_dtype": {"__dtype__": "bool"}, "weak_type": False}, True),
    ("convert-bool-f32", "convert_element_type", [B1],
     {"new_dtype": {"__dtype__": "float32"}, "weak_type": False}, True),
    ("clamp", "clamp", [np.float32(-0.5), F32, np.float32(0.7)], {}, True),
    ("cumsum", "cumsum", [F32], {"axis": 1, "reverse": False}, False),
    ("cumsum-rev-i32", "cumsum", [I32], {"axis": 2, "reverse": True}, True),
    ("reshape", "reshape", [F32], {"new_sizes": [5, 12], "dimensions": None}, True),
    ("squeeze", "squeeze", [F32[:, :1]], {"dimensions": [1]}, True),
    ("expand_dims", "expand_dims", [F32], {"dimensions": [0, 3]}, True),
    ("transpose", "transpose", [F32], {"permutation": [2, 0, 1]}, True),
    ("broadcast_in_dim", "broadcast_in_dim", [F32[:, 0, 0]],
     {"shape": [2, 3, 6], "broadcast_dimensions": [np.array(1)], "sharding": None}, True),
    ("slice-strided", "slice", [F32],
     {"start_indices": [0, 1, 1], "limit_indices": [3, 4, 5], "strides": [2, 1, 3]}, True),
    ("slice", "slice", [I32], {"start_indices": [1, 0, 2], "limit_indices": [2, 4, 5],
                               "strides": None}, True),
    ("rev", "rev", [F32], {"dimensions": [0, 2]}, True),
    ("reduce_sum", "reduce_sum", [F32], {"axes": [0, 2]}, False),
    ("reduce_sum-i32", "reduce_sum", [I32], {"axes": [1]}, True),
    ("reduce_sum-none", "reduce_sum", [I32], {"axes": []}, True),
    ("reduce_max", "reduce_max", [F32], {"axes": [1, 2]}, True),
    ("reduce_min-i32", "reduce_min", [I32], {"axes": [0]}, True),
    ("reduce_prod", "reduce_prod", [POS], {"axes": [0, 1]}, False),
    ("reduce_and", "reduce_and", [B1], {"axes": [2]}, True),
    ("reduce_or", "reduce_or", [B1], {"axes": [0, 2]}, True),
    ("argmax-ties", "argmax", [TIES], {"axes": [1], "index_dtype": {"__dtype__": "int32"}}, True),
    ("argmin-ties", "argmin", [TIES], {"axes": [0], "index_dtype": {"__dtype__": "int32"}}, True),
    ("argmax-f32", "argmax", [F32], {"axes": [2], "index_dtype": {"__dtype__": "int32"}}, True),
    ("select_n-bool", "select_n", [B1, F32, G32], {}, True),
    ("select_n-i32-2", "select_n", [(I32 > 0).astype(np.int32), F32, G32], {}, True),
    ("select_n-i32-3", "select_n", [np.abs(I32) % 4, F32, G32, F32 * 2], {}, True),
    ("dot_general", "dot_general", [F32.reshape(12, 5), G32.reshape(5, 12)],
     {"dimension_numbers": [[[1], [0]], [[], []]], "precision": None,
      "preferred_element_type": {"__dtype__": "float32"}}, False),
    ("dot_general-batched", "dot_general", [F32, G32],
     {"dimension_numbers": [[[2], [2]], [[0], [0]]], "precision": None,
      "preferred_element_type": None}, False),
    ("dot_general-2contract", "dot_general", [F32, G32.transpose(1, 2, 0)],
     {"dimension_numbers": [[[1, 2], [0, 1]], [[], []]], "precision": None,
      "preferred_element_type": None}, False),
    ("dot_general-i32", "dot_general", [I32, J32],
     {"dimension_numbers": [[[1], [1]], [[0], [0]]], "precision": None,
      "preferred_element_type": None}, True),
    ("conv-forward", "conv_general_dilated",
     [_R.rand(2, 9, 9, 3).astype(np.float32), _R.randn(3, 3, 3, 4).astype(np.float32)],
     _conv_p(NHWC), False),
    ("conv-weight-grad", "conv_general_dilated",
     [_R.rand(2, 9, 9, 3).astype(np.float32), _R.randn(2, 7, 7, 4).astype(np.float32)],
     _conv_p(WGRAD), False),
    ("conv-input-grad", "conv_general_dilated",
     [_R.randn(2, 7, 7, 4).astype(np.float32), _R.randn(3, 3, 3, 4).astype(np.float32)[::-1, ::-1]],
     _conv_p(IGRAD, padding=((2, 2), (2, 2))), False),
    ("conv-grouped-dilated", "conv_general_dilated",
     [_R.randn(2, 10, 12, 4).astype(np.float32), _R.randn(3, 3, 2, 6).astype(np.float32)],
     _conv_p(NHWC, strides=(2, 1), padding=((1, 2), (0, 1)), ldil=(1, 2), rdil=(2, 1),
             groups=2), False),
    ("conv-transpose-crop", "conv_general_dilated",
     [_R.randn(1, 5, 6, 2).astype(np.float32), _R.randn(2, 2, 2, 3).astype(np.float32)],
     _conv_p(NHWC, padding=((-1, 1), (1, -2)), ldil=(2, 2)), False),
    ("conv-batch-groups", "conv_general_dilated",
     [_R.randn(4, 6, 6, 3).astype(np.float32), _R.randn(3, 3, 3, 4).astype(np.float32)],
     _conv_p(NHWC, bgroups=2), False),
    ("reduce_window_max-pool", "reduce_window_max", [X_POOL], POOL, True),
    ("reduce_window_max-general", "reduce_window_max", [_R.randn(2, 9, 11, 3).astype(np.float32)],
     {"window_dimensions": [1, 3, 2, 1], "window_strides": [1, 2, 3, 1],
      "padding": [[0, 0], [1, 2], [0, 1], [0, 0]], "base_dilation": [1, 1, 1, 1],
      "window_dilation": [1, 2, 1, 1]}, True),
    ("reduce_window_max-base-dilation", "reduce_window_max", [_R.randn(5, 4).astype(np.float32)],
     {"window_dimensions": [2, 2], "window_strides": [1, 2], "padding": [[1, 0], [0, 1]],
      "base_dilation": [2, 1], "window_dilation": [1, 1]}, True),
    ("reduce_window_max-i32", "reduce_window_max", [I32],
     {"window_dimensions": [1, 2, 3], "window_strides": [1, 2, 1], "padding": [[0, 0]] * 3,
      "base_dilation": [1] * 3, "window_dilation": [1] * 3}, True),
    ("select_and_scatter_add-random", "select_and_scatter_add", [SRC, X_POOL], SASA, True),
    ("select_and_scatter_add-all-zero", "select_and_scatter_add",
     [SRC, np.zeros_like(X_POOL)], SASA, True),
    ("select_and_scatter_add-all-equal", "select_and_scatter_add",
     [SRC, np.full_like(X_POOL, 0.25)], SASA, True),
    ("select_and_scatter_add-heavy-ties", "select_and_scatter_add",
     [_R.randn(2, 4, 4, 2).astype(np.float32),
      _R.randint(0, 3, (2, 8, 8, 2)).astype(np.float32)], SASA, True),
    ("select_and_scatter_add-padded", "select_and_scatter_add",
     [_R.randn(2, 5, 5, 3).astype(np.float32), _R.randn(2, 9, 9, 3).astype(np.float32)],
     {**SASA, "padding": [[0, 0], [1, 0], [0, 1], [0, 0]]}, True),
    ("gather-clip", "gather", [GA, IDX],
     {**GS, "mode": _mode("CLIP"), "fill_value": None}, True),
    ("gather-fill", "gather", [GA, IDX],
     {**GS, "mode": _mode("FILL_OR_DROP"), "fill_value": -7.0}, True),
    ("gather-fill-none-f32", "gather", [GA, IDX],
     {**GS, "mode": _mode("FILL_OR_DROP"), "fill_value": None}, True),
    ("gather-fill-none-i32", "gather", [(GA * 10).astype(np.int32), IDX],
     {**GS, "mode": _mode("FILL_OR_DROP"), "fill_value": None}, True),
    ("gather-take-along", "gather",
     [F32[0], _R.randint(0, 5, (4, 1)).astype(np.int32)],
     {"dimension_numbers": [[], [1], [1], [0], [0]], "slice_sizes": [1, 1],
      "mode": _mode("FILL_OR_DROP"), "fill_value": None}, True),
    ("scatter-add-drop", "scatter-add",
     [np.zeros((5, 4, 3), np.float32), IDX, _R.randn(4, 4, 3).astype(np.float32)],
     {"dimension_numbers": [[1, 2], [0], [0], [], []], "mode": _mode("FILL_OR_DROP")}, True),
    ("scatter-add-clip-dups", "scatter-add",
     [np.zeros((5, 4, 3), np.int32), np.array([[1], [1], [9], [-3]], np.int32),
      _R.randint(-5, 5, (4, 4, 3)).astype(np.int32)],
     {"dimension_numbers": [[1, 2], [0], [0], [], []], "mode": _mode("CLIP")}, True),
    ("concatenate", "concatenate", [F32, G32[:, :2]], {"dimension": 1}, True),
    ("dynamic_slice", "dynamic_slice", [F32, np.int32(2), np.int32(-1), np.int32(3)],
     {"slice_sizes": [2, 3, 4]}, True),
    ("dynamic_update_slice", "dynamic_update_slice",
     [F32, G32[:2, :2, :2], np.int32(5), np.int32(1), np.int32(0)], {}, True),
]
OP_IDS = [c[0] for c in OP_CASES]


def test_tables_have_the_jax_package_vocabulary():
    assert set(T._TORCH_TABLE) == set(_INTERP_TABLE)
    assert set(T._NUMPY_TABLE) == set(_NUMPY_TABLE)
    assert T._CALL_OPS and T.MAX_OPLIST_DEPTH == 64 and T.MAX_OPLIST_ELEMENTS == 1 << 28


@pytest.mark.parametrize("case", OP_CASES, ids=OP_IDS)
def test_torch_op_matches_the_jax_interpreter(case):
    _, op, ins, params, exact = case
    ol = _one_eqn(op, len(ins), params)
    ref = j_run(ol, *ins)
    got = T.run_oplist(ol, *ins, device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    _assert_same(ref, got, exact)


@pytest.mark.parametrize("case", [c for c in OP_CASES if c[1] in _NUMPY_TABLE
                                  and not c[0].startswith(("conv-batch", "reduce_window_max-base"))],
                         ids=lambda c: c[0])
def test_numpy_op_matches_the_jax_package_numpy_table(case):
    _, op, ins, params, _ = case
    ol = _one_eqn(op, len(ins), params)
    ref = j_run(ol, *ins, backend="numpy")
    got = T.run_oplist(ol, *ins, backend="numpy")
    assert type(np.asarray(got)) is np.ndarray
    _assert_same(ref, got, exact=True)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_iota_and_literals(backend):
    """iota makes a new tensor; Python-scalar and 0-d-array literals keep
    the operand's f32 (no widening to f64), and a 0-d f32 input stays f32."""
    kw = {"device": "cpu"} if backend == "torch" else {}
    iota = {"constvars": [], "consts": [], "invars": [],
            "eqns": [{"op": "iota", "in": [], "out": [0], "params": {
                "dtype": {"__dtype__": "int32"}, "shape": [3, 4], "dimension": 1,
                "sharding": None}}], "outvars": [{"var": 0}]}
    _assert_same(j_run(iota), T.run_oplist(iota, backend=backend, **kw), exact=True)
    for lit in ({"lit": 2.5}, {"lit_arr": np.float32(2.5)}):
        ol = _one_eqn("mul", 1, {}, lits=[lit])
        _assert_same(j_run(ol, F32), T.run_oplist(ol, F32, backend=backend, **kw), exact=True)
    lr = {"constvars": [], "consts": [], "invars": [0, 1],
          "eqns": [{"op": "mul", "in": [{"var": 0}, {"var": 1}], "out": [2], "params": {}}],
          "outvars": [{"var": 2}]}
    out = T.run_oplist(lr, np.float32(0.1), F32, backend=backend, **kw)
    _assert_same(j_run(lr, np.float32(0.1), F32), out, exact=True)


def test_64_bit_inputs_are_canonicalised_as_jnp_asarray_does():
    ol = _one_eqn("add", 2, {})
    a, b = F32.astype(np.float64), I32.astype(np.int64)
    _assert_same(j_run(ol, a, a), T.run_oplist(ol, a, a, device="cpu"), exact=True)
    _assert_same(j_run(ol, b, b), T.run_oplist(ol, b, b, device="cpu"), exact=True)


# --- whole training plans -----------------------------------------------------


def _mlp_step(X, y, lr, w1, b1, w2, b2):
    """tests/unit/test_plans.py's training plan: forward, softmax-CE, SGD."""

    def forward(params):
        h = jnp.maximum(X @ params[0] + params[1], 0.0)
        return h @ params[2] + params[3]

    def loss_fn(params):
        logp = jax.nn.log_softmax(forward(params))
        return -jnp.mean(jnp.sum(y * logp, axis=-1))

    params = (w1, b1, w2, b2)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    acc = jnp.mean((jnp.argmax(forward(params), -1) == jnp.argmax(y, -1)).astype(jnp.float32))
    return (loss, acc) + tuple(p - lr * g for p, g in zip(params, grads))


def _plan_case(kind):
    rng = np.random.RandomState({"mlp": 2, "cnn": 7, "transformer": 11}[kind])
    if kind == "mlp":
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        params = [np.asarray(jax.random.normal(k1, (784, 392)) * 0.01), np.zeros(392, np.float32),
                  np.asarray(jax.random.normal(k2, (392, 10)) * 0.01), np.zeros(10, np.float32)]
        X = rng.randn(8, 784).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[np.arange(8) % 10]
        fn = _mlp_step
    elif kind == "cnn":
        params = [np.asarray(p) for p in jcnn.init(jax.random.PRNGKey(0))]
        X = rng.rand(2, 28, 28, 1).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 2)]
        fn = jcnn.training_step
    else:
        cfg = jtransformer.TransformerConfig(vocab=64, d_model=32, n_heads=2, d_ff=64,
                                             n_layers=2, max_len=16)
        fn = jtransformer.make_training_step(cfg)
        params = [np.asarray(p) for p in jtransformer.init(jax.random.PRNGKey(0), cfg)]
        X = rng.randint(0, cfg.vocab, (2, 16)).astype(np.int32)
        y = rng.randint(0, cfg.vocab, (2, 16)).astype(np.int32)
    args = (X, y, np.float32(0.1), *params)
    return JPlan(name="training_plan", fn=fn).build(*args), fn, args


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("kind", ["mlp", "cnn", "transformer"])
def test_training_plan_runs_like_the_jax_package(kind, backend):
    jplan, fn, args = _plan_case(kind)
    ref = fn(*args)
    oplist = serde.deserialize(jserde.serialize(j_translate(jplan, "list")))
    kw = {"device": "cpu"} if backend == "torch" else {}
    out = T.run_oplist(oplist, *args, backend=backend, **kw)
    assert len(out) == len(ref)
    for a, b in zip(ref, out):
        _assert_same(a, b, exact=False)
    if backend == "torch":  # the decoded Plan runs the same list on a call
        plan = serde.deserialize(jserde.serialize(jplan))
        for a, b in zip(out, plan(*args, device="cpu")):
            assert torch.equal(a, b)


# --- bounds and typed errors ----------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_bounds_and_unknown_ops_fail_typed(backend):
    kw = {"device": "cpu"} if backend == "torch" else {}
    bogus = _one_eqn("no_such_op", 1, {})
    with pytest.raises(PlanTranslationError, match="no_such_op"):
        T.run_oplist(bogus, np.ones(2, np.float32), backend=backend, **kw)
    with pytest.raises(PlanTranslationError, match="expects 1 args"):
        T.run_oplist(bogus, backend=backend, **kw)
    huge_pool = _one_eqn("reduce_window_max", 1, {
        "window_dimensions": [1], "window_strides": [1], "padding": [[0, 1 << 40]],
        "base_dilation": [1], "window_dilation": [1]})
    with pytest.raises(PlanTranslationError, match="allocation bound"):
        T.run_oplist(huge_pool, np.ones(4, np.float32), backend=backend, **kw)
    huge_iota = {"constvars": [], "consts": [], "invars": [],
                 "eqns": [{"op": "iota", "in": [], "out": [0], "params": {
                     "dtype": {"__dtype__": "int32"}, "shape": [1 << 20, 1 << 20],
                     "dimension": 0}}], "outvars": [{"var": 0}]}
    with pytest.raises(PlanTranslationError, match="allocation bound"):
        T.run_oplist(huge_iota, backend=backend, **kw)
    outer = _one_eqn("dot_general", 2, {"dimension_numbers": [[[], []], [[], []]]})
    with pytest.raises(PlanTranslationError, match="allocation bound"):
        T.run_oplist(outer, np.ones(1 << 15, np.float32), np.ones(1 << 14, np.float32),
                     backend=backend, **kw)
    evil_scatter = _one_eqn("scatter-add", 3, {
        "dimension_numbers": [[1], [0], [7], [], []], "mode": _mode("CLIP")})
    with pytest.raises(PlanTranslationError, match="invalid params|allocation bound"):
        T.run_oplist(evil_scatter, np.zeros((3, 4), np.float32), np.zeros((2, 1), np.int32),
                     np.zeros((2, 4), np.float32), backend=backend, **kw)
    nest = bogus
    for _ in range(T.MAX_OPLIST_DEPTH + 2):
        nest = {"constvars": [], "consts": [], "invars": [0],
                "eqns": [{"op": "pjit", "in": [{"var": 0}], "out": [1],
                          "params": {"jaxpr": {"__jaxpr__": nest}}}], "outvars": [{"var": 1}]}
    with pytest.raises(PlanTranslationError, match="nesting"):
        T.run_oplist(nest, np.ones(2, np.float32), backend=backend, **kw)
    with pytest.raises(PlanTranslationError, match="unsupported select"):
        T.run_oplist(_one_eqn("select_and_scatter_add", 2, {**SASA, "select_prim": "gt"}),
                     SRC, X_POOL, backend=backend, **kw)
    with pytest.raises(PlanTranslationError, match="backend"):
        T.run_oplist(bogus, np.ones(2), backend="jax")


def test_torch_conv_bounds_its_dilated_intermediate():
    lhs = torch.ones((1, 4, 1))
    p = {"window_strides": [1], "padding": [[0, -(3 * (1 << 27))]], "lhs_dilation": [1 << 27],
         "rhs_dilation": [1], "dimension_numbers": [[0, 2, 1], [2, 1, 0], [0, 2, 1]],
         "feature_group_count": 1, "batch_group_count": 1}
    with pytest.raises(PlanTranslationError, match="allocation bound"):
        T._t_conv(lhs, torch.ones((1, 1, 1)), p)


# --- plans across serde -----------------------------------------------------------


def _scale_plan():
    plan = JPlan(name="scale", fn=lambda x, w: x * w,
                 state=JState.from_tensors([np.full((3,), 5.0, np.float32)]))
    return plan.build(np.zeros((3,), np.float32))


@pytest.mark.parametrize("kind", ["mlp", "cnn", "transformer", "state"])
def test_jax_plan_blob_reserializes_byte_identical(kind):
    jplan = _scale_plan() if kind == "state" else _plan_case(kind)[0]
    blob = jserde.serialize(jplan)
    plan = serde.deserialize(blob)
    assert isinstance(plan, Plan) and plan.exported_blob == jplan.exported_blob
    assert plan.torch_blob is None and plan.is_built
    assert serde.serialize(plan) == blob
    assert serde.serialize(translate_plan(plan, "list")) == jserde.serialize(
        j_translate(jplan, "list"))
    assert translate_plan(plan, "torchscript") == jplan.exported_blob
    assert translate_plan(plan, "tfjs") == jplan.code
    if kind == "state":  # state injection runs the list with the carried state
        x = np.array([1.0, 2.0, 3.0], np.float32)
        np.testing.assert_array_equal(plan(x, device="cpu").numpy(), x * 5.0)


@pytest.fixture(scope="module")
def port_cnn_plan():
    params = cnn.init(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    X = torch.rand(4, 28, 28, 1, generator=g)
    y = torch.eye(10)[torch.randint(0, 10, (4,), generator=g)]
    args = (X, y, torch.tensor(0.1), *params)
    return Plan(name="training_plan", fn=cnn.training_step).build(*args), args


def test_port_built_plan_variants_and_serde(port_cnn_plan):
    plan, args = port_cnn_plan
    assert plan.is_built and plan.oplist is not None and plan.exported_blob is None
    assert "convolution" in plan.code and "max_pool2d" in plan.code
    assert translate_plan(plan, "torchscript") == plan.torch_blob
    assert translate_plan(plan, "list") is plan.oplist
    with pytest.raises(PlanTranslationError, match="no oplist"):
        translate_plan(Plan(name="blob-only", torch_blob=plan.torch_blob), "list")
    with pytest.raises(PlanTranslationError, match="unknown plan variant"):
        translate_plan(plan, "onnx")
    blob = serde.serialize(plan)
    back = serde.deserialize(blob)
    assert back.fn is None and back.torch_blob == plan.torch_blob
    assert serde.serialize(back) == blob
    ref = cnn.training_step(*args)
    for a, b in zip(ref, back(*args, device="cpu")):
        assert torch.equal(a, b)
    # the JAX package decodes the port's blob (the ninth key is ignored)
    jback = jserde.deserialize(blob)
    assert jback.exported_blob is None and jback.name == "training_plan"


def test_host_built_plan_runs_on_another_device(port_cnn_plan):
    """The devices a host trace bakes into the graph are rewritten to the
    call's device: the CPU-built plan runs on meta tensors (which cannot
    mix with CPU tensors), as it runs on the card."""
    plan, args = port_cnn_plan
    back = serde.deserialize(serde.serialize(plan))
    out = back(*[a.to("meta") for a in args], device="meta")
    assert all(o.device.type == "meta" for o in out)
    assert [tuple(o.shape) for o in out] == [tuple(o.shape) for o in cnn.training_step(*args)]


def test_port_plan_state_injection_and_func2plan():
    plan = Plan(name="scale", fn=lambda x, w: x * w,
                state=State.from_tensors([np.full((3,), 2.0, np.float32)]))
    plan.build(np.zeros((3,), np.float32))
    x = np.array([1.0, 2.0, 3.0], np.float32)
    back = serde.deserialize(serde.serialize(plan))
    back.state = State.from_tensors([np.full((3,), 5.0, np.float32)])
    np.testing.assert_array_equal(back(x, device="cpu").numpy(), x * 5.0)

    @func2plan(args_shape=[(4, 3), (3, 2)])
    def matmul_plan(a, b):
        return a @ b

    a, b = np.random.RandomState(0).randn(2, 4, 3).astype(np.float32)[0], np.ones((3, 2), np.float32)
    back = serde.deserialize(serde.serialize(matmul_plan))
    np.testing.assert_allclose(back(a, b, device="cpu").numpy(), a @ b, rtol=1e-6)
    assert matmul_plan.name == "matmul_plan" and matmul_plan.input_specs[0]["shape"] == [4, 3]
    with pytest.raises(PlanInvalidError):
        Plan(name="empty")(x, device="cpu")
    with pytest.raises(PlanInvalidError):
        Plan(name="empty").build(x)


_FRESH = """
import sys
import numpy as np
import torch
torch.set_num_threads({threads})  # the parent's: CPU kernels sum in its order
sys.path.insert(0, {root!r})
from pygrid_tpu_torch import serde
plan = serde.deserialize(open({blob!r}, "rb").read())
data = np.load({npz!r})
args = [data[f"a{{i}}"] for i in range(len(data.files) - {n_out})]
out = plan(*args, device="cpu")
for i, o in enumerate(out):
    assert np.array_equal(o.numpy(), data[f"r{{i}}"]), i
blocked = [m for m in sys.modules if m.split(".")[0] in ("jax", "pygrid_tpu")]
assert not blocked, blocked
print("ok", len(out))
"""


def test_port_built_plan_runs_in_a_fresh_process_with_only_the_port_serde(
        port_cnn_plan, tmp_path):
    plan, args = port_cnn_plan
    ref = cnn.training_step(*args)
    (tmp_path / "plan.bin").write_bytes(serde.serialize(plan))
    np.savez(tmp_path / "io.npz", **{f"a{i}": a.numpy() for i, a in enumerate(args)},
             **{f"r{i}": r.numpy() for i, r in enumerate(ref)})
    code = _FRESH.format(root=str(ROOT), blob=str(tmp_path / "plan.bin"),
                         npz=str(tmp_path / "io.npz"), n_out=len(ref),
                         threads=torch.get_num_threads())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ok 10")


# --- the committed JAX-built fixtures -------------------------------------------


#: the encrypted CryptoNets MLP's shapes: x, w1, b1, w2, b2 at batch 256
CRYPTONETS_SHAPES = ((256, 784), (784, 392), (392,), (392, 10), (10,))


def cryptonets_forward(x, w1, b1, w2, b2):
    """examples/encrypted_inference.py's ``forward``: the CryptoNets-style
    MLP, affine → square → affine."""
    h = x @ w1 + b1
    h = h * h
    return h @ w2 + b2


def build_cryptonets_plan(shapes=CRYPTONETS_SHAPES, plan_id="cryptonets-784-392-10-b256"):
    """The JAX-built encrypted-inference plan at ``shapes`` (a fixed id
    keeps the bytes stable)."""
    plan = JPlan(name="encrypted_forward", id=plan_id, fn=cryptonets_forward)
    plan.build(*[np.zeros(s, np.float32) for s in shapes])
    return plan


def build_fixture_plans() -> dict[str, bytes]:
    """The JAX-built plans the card's machine (which has no JAX) runs: the
    training plans of the example's MLP (784→392→10, batch 64, lr 0.005 —
    examples/model_centric/01_create_plan.py) and of the MNIST CNN at its
    published widths, batch 64; and the encrypted-inference plan of
    examples/encrypted_inference.py at 784→392→10, batch 256. Fixed plan
    ids keep the bytes stable."""
    mlp_params = [np.asarray(p) for p in jmlp.init(jax.random.PRNGKey(42), (784, 392, 10))]
    mlp_plan = JPlan(name="training_plan", id="mnist-mlp-784-392-10-b64", fn=jmlp.training_step)
    mlp_plan.build(np.zeros((64, 784), np.float32), np.zeros((64, 10), np.float32),
                   np.float32(0.005), *mlp_params)
    cnn_params = [np.asarray(p) for p in jcnn.init(jax.random.PRNGKey(42))]
    cnn_plan = JPlan(name="training_plan", id="mnist-cnn-b64", fn=jcnn.training_step)
    cnn_plan.build(np.zeros((64, 28, 28, 1), np.float32), np.zeros((64, 10), np.float32),
                   np.float32(0.005), *cnn_params)
    return {"mlp_training_plan.bin": jserde.serialize(mlp_plan),
            "cnn_training_plan.bin": jserde.serialize(cnn_plan),
            "cryptonets_plan.bin": jserde.serialize(build_cryptonets_plan())}


def write_fixtures(out_dir: Path = FIXTURES) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, blob in build_fixture_plans().items():
        (out_dir / name).write_bytes(blob)
        print(f"{out_dir / name}: {len(blob)} bytes")


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_committed_fixture_runs_like_the_jax_package(kind):
    blob = (FIXTURES / f"{kind}_training_plan.bin").read_bytes()
    plan = serde.deserialize(blob)
    jplan = jserde.deserialize(blob)
    assert serde.serialize(plan) == blob and plan.oplist is not None
    assert len(blob) < 64 * 1024
    # ops a run executes: call ops count as their bodies (phase fl prints it)
    assert T.count_ops(plan.oplist) == {"mlp": 70, "cnn": 121}[kind]
    assert len(plan.oplist["eqns"]) < T.count_ops(plan.oplist)
    rng = np.random.RandomState(5)
    if kind == "mlp":
        params = [np.asarray(p) for p in jmlp.init(jax.random.PRNGKey(1), (784, 392, 10))]
        X, fn = rng.rand(64, 784).astype(np.float32), jmlp.training_step
    else:
        params = [np.asarray(p) for p in jcnn.init(jax.random.PRNGKey(1))]
        X, fn = rng.rand(64, 28, 28, 1).astype(np.float32), jcnn.training_step
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 64)]
    args = (X, y, np.float32(0.005), *params)
    ref = fn(*args)
    out = plan(*args, device="cpu")
    for a, b, c in zip(ref, out, j_run(jplan.oplist, *args)):
        _assert_same(a, b, exact=False)
        _assert_same(c, b, exact=False)


if __name__ == "__main__":
    write_fixtures()
