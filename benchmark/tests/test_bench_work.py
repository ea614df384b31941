"""The frozen counts reproduce chip_smoke.py's bounds and the issue's FLOPs."""

import pytest

from benchmark.work import flash, model_flops, ring


def test_flash_bounds_at_the_flagship_shape():
    b = flash.bounds((32, 512, 4, 128), "bfloat16", causal=True)
    assert [round(b[k][0], 4) for k in flash.KERNELS] == [0.0201, 0.0302, 0.0252]
    assert all(b[k][1] == "bytes" for k in flash.KERNELS)


def test_ring_bound_at_the_beaver_shape():
    ms, by, ops, nbytes = ring.ring_bound(8, 512, 512, 512)
    assert round(ms, 4) == 0.0391 and by == "operations"
    assert ops == 36 * 2 * 8 * 512 ** 3 and nbytes == 8 * 8 * 3 * 512 * 512


def test_gpt2_small_round_flops():
    f = model_flops.transformer_round_flops(50257, 768, 3072, 12, 8 * 4 * 1024, 1024)
    assert f == pytest.approx(2.62e13, rel=5e-3)
    assert model_flops.transformer_matmul_params(50257, 768, 3072, 12) == 123532032


def test_mlp_step_flops():
    assert model_flops.mlp_step_flops([784, 392, 10], 64) == 6.0 * 64 * (784 * 392 + 392 * 10)
