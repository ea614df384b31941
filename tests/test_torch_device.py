"""The port's device policy (pygrid_tpu_torch.device): ``resolve`` hands
out a CUDA device only with f32 pinned — cuDNN's and cuBLAS's TF32 both
off — whatever the caller's script set before, and leaves the flags alone
for the CPU. The numerical effect shows only on the card (chip_smoke.py
phase fl); here the flags are checked with a GPU pretended present."""

import pytest
import torch

from pygrid_tpu_torch import device, resolve


@pytest.fixture
def flags():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


@pytest.mark.parametrize("name", ["cuda", "cuda:0", torch.device("cuda", 1)])
def test_resolve_cuda_pins_f32(monkeypatch, flags, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    _set_tf32(True)  # the worst a caller's script can do
    assert resolve(name).type == "cuda"
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_resolve_cpu_leaves_the_flags(flags):
    _set_tf32(True)
    assert resolve("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is True
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_resolve_without_a_gpu_raises_before_touching_the_flags(monkeypatch, flags):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _set_tf32(True)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve("cuda")
    assert torch.backends.cudnn.allow_tf32 is True


def test_pin_f32(flags):
    _set_tf32(True)
    device.pin_f32()
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_entry_points_resolve_through_the_pin(monkeypatch, flags):
    """A node context, a plan run and an op list all pass through
    ``resolve``: with a GPU pretended present, building the context pins
    the flags before anything touches the (absent) card."""
    from pygrid_tpu_torch.node import NodeContext

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    _set_tf32(True)
    try:
        NodeContext("pin-check", device="cuda")
    except Exception:  # noqa: BLE001 — there is no card behind the pretence
        pass
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
