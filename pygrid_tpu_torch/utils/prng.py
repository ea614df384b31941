"""Counter-based random numbers: the part of ``jax.random`` that serving uses.

The JAX package samples generation tokens with ``jax.random`` keys, one
key per row and per position, inside one batched program. ``torch.Generator``
has no per-row keys inside a batched op, so the port carries its own copy
of the threefry2x32 generator: ``PRNGKey``, ``split``, ``fold_in``,
``uniform``, ``gumbel`` and ``categorical`` (Gumbel-argmax), with the bit
layout of jax 0.9 under ``jax_threefry_partitionable=True`` (its default)
and 32-bit seeds (``jax_enable_x64`` off).

A key is two uint32 words carried in an int64 tensor ``[..., 2]``. Every
function takes a batch of keys ``[*B, 2]`` and acts on each key as the
``jax.random`` function of the same name does on one key, so a batched
call is ``jax.vmap`` of the reference. Integer hashing gives the same bits
on the CPU and on the card; only the Gumbel transform's ``log`` may differ
in the last place between platforms.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pygrid_tpu_torch.device import resolve

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the smallest normal f32, ``jnp.finfo(jnp.float32).tiny``
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds) on uint32 words held in
    int64 tensors; the key words broadcast against the counter words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _check_keys(keys: torch.Tensor) -> torch.Tensor:
    if keys.shape[-1:] != (2,):
        raise ValueError(f"a key is [..., 2] uint32 words, got shape {tuple(keys.shape)}")
    return keys.long()


def _hash(keys: torch.Tensor, shape: Sequence[int]) -> tuple[torch.Tensor, torch.Tensor]:
    """The two cipher words of every key in ``keys [*B, 2]`` at the counters
    of a row-major iota over ``shape``: ``[*B, *shape]`` each. The 64-bit
    counter splits into its high and low words, as ``iota_2x32_shape``."""
    keys = _check_keys(keys)
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    iota = torch.arange(n, dtype=torch.int64, device=keys.device).reshape(shape)
    hi, lo = iota >> 32, iota & _MASK
    extra = (None,) * len(shape)
    k1 = keys[..., 0][(..., *extra)]
    k2 = keys[..., 1][(..., *extra)]
    return threefry2x32(k1, k2, hi, lo)


def PRNGKey(seed: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=resolve(device))


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of each key: ``[*B, num, 2]``."""
    b1, b2 = _hash(keys, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` of each key; ``data`` is an int or
    an integer tensor broadcasting against ``keys[..., 0]``."""
    keys = _check_keys(keys)
    if isinstance(data, torch.Tensor):
        data = data.to(keys.device, torch.int64) & _MASK
    else:  # a Python int fills on the device: no host-to-device copy
        data = torch.full_like(keys[..., 0], int(data) & _MASK)
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def random_bits(keys: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """32 random bits per element, ``[*B, *shape]`` int64 in [0, 2**32)."""
    b1, b2 = _hash(keys, shape)
    return b1 ^ b2


def uniform(
    keys: torch.Tensor,
    shape: Sequence[int] = (),
    minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """``jax.random.uniform`` in f32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to [minval, maxval)."""
    bits = random_bits(keys, shape)
    one = 0x3F800000  # 1.0f
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    # the bounds stay host scalars (kernel arguments, no copy): each is
    # rounded to f32, and hi - lo is an f32 difference, as in the reference
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    # XLA fuses the scale and shift into one FMA: the f64 product of two
    # f32 values is exact, so the sum rounds (to f32) as the FMA does
    scaled = (floats.double() * span + float(lo)).float()
    return scaled.clamp_min(float(lo))


# XLA's single-precision erf_inv (Giles' polynomials in w = -log1p(-x²)),
# for w < 5 and for w >= 5, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``: each Horner step rounds once, as the FMA the
    reference's compiler emits (an f64 product of two f32 values is
    exact). Within 3 f32 ulps of it; the rest is ``log1p``'s."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()

    def coef(i):
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i]).float().double()

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = (coef(i) + p * w).float().double()
    out = p.float() * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, out)


def normal(keys: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.normal`` in f32: ``sqrt(2) * erf_inv(u)`` of a uniform
    ``u`` in (-1, 1). The uniform is the reference's bit for bit; the
    result within a few f32 ulps (:func:`_erfinv_f32`)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(keys, shape, minval=lo, maxval=1.0)
    return _erfinv_f32(u) * float(np.float32(np.sqrt(2)))


def gumbel(keys: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.gumbel`` (its default "low" mode) in f32."""
    return -torch.log(-torch.log(uniform(keys, shape, minval=_F32_TINY, maxval=1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis, by Gumbel-argmax.

    ``keys [*B, 2]`` and ``logits [*B, *S, vocab]``: each key draws the
    noise of ``logits[b]`` as one ``jax.random.categorical(key, logits[b])``
    call would. One key ``[2]`` over ``logits [w, vocab]`` is the
    reference's single-key call; ``[w, 2]`` over ``[w, vocab]`` is its
    ``vmap`` over rows. Returns int64 ``[*B, *S]``."""
    nb = keys.dim() - 1
    noise = gumbel(keys, tuple(logits.shape[nb:]))
    return torch.argmax(noise + logits, dim=-1)
