"""The port's MNIST CNN against the JAX package's on the same numpy inputs
and params (rtol 2e-4, atol 2e-5): ``apply``, ``loss_and_acc`` and one
``training_step``, with random images and with all-zero images, whose
exact-zero activations make every ReLU and max-pool window a tie."""

import jax
import numpy as np
import pytest
import torch

from pygrid_tpu.models import cnn as jcnn
from pygrid_tpu_torch import convert
from pygrid_tpu_torch.models import cnn

RTOL, ATOL = 2e-4, 2e-5


def _inputs(batch, images, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(batch, 28, 28, 1).astype(np.float32)
    if images == "half_zero":
        X[: batch // 2] = 0.0
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, batch)]
    params = [np.asarray(p) for p in jcnn.init(jax.random.PRNGKey(seed))]
    return X, y, params


def _t(x):
    return torch.from_numpy(np.array(x))


CASES = [(2, "random"), (5, "random"), (4, "half_zero"), (8, "half_zero")]


@pytest.mark.parametrize("batch,images", CASES)
def test_apply_matches_the_jax_package(batch, images):
    X, _, params = _inputs(batch, images)
    ref = np.asarray(jcnn.apply(params, X))
    got = cnn.apply(convert.params_from_numpy(params, "cpu", cnn=True), _t(X))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("batch,images", CASES)
def test_training_step_matches_the_jax_package(batch, images):
    X, y, params = _inputs(batch, images, seed=3)
    ref = jcnn.training_step(X, y, np.float32(0.1), *params)
    got = cnn.training_step(_t(X), _t(y), torch.tensor(0.1),
                            *convert.params_from_numpy(params, "cpu", cnn=True))
    assert len(got) == len(ref) == 10
    for a, b in zip(ref, got):
        assert b.dtype == torch.float32 and tuple(b.shape) == np.shape(a)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)


def test_params_cross_through_convert_in_the_jax_layout():
    params = [np.asarray(p) for p in jcnn.init(jax.random.PRNGKey(1))]
    assert [p.shape for p in params] == [tuple(s) for s in cnn.PARAM_SHAPES]
    back = convert.params_to_numpy(convert.params_from_numpy(params, "cpu", cnn=True), cnn=True)
    assert all(np.array_equal(a, b) for a, b in zip(params, back))
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_numpy(params[::-1], "cpu", cnn=True)


def test_init_is_seeded_and_needs_device_cpu_without_a_gpu():
    a = cnn.init(torch.Generator().manual_seed(5), device="cpu")
    b = cnn.init(torch.Generator().manual_seed(5), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [tuple(p.shape) for p in a] == [tuple(s) for s in cnn.PARAM_SHAPES]
    assert float(a[4].std()) == pytest.approx((2.0 / 9216) ** 0.5, rel=0.05)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            cnn.init()
