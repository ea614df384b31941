"""Mesh-sharded SMPC: the party axis split over a mesh axis.

Counterpart of :mod:`pygrid_tpu.smpc.sharded`. Parties are the leading
axis of stacked shares ``[P, B, ...]`` (party-major, then the instance
batch); that axis is split over a mesh axis, each rank holds its block of
parties, and the only cross-party traffic of a Beaver round, opening
d = x − a and e = y − b, is one exact collective sum
(:func:`pygrid_tpu_torch.smpc.ring.ring_psum`).

Every rank passes the whole stacked shares (the port's mesh programs take
whole inputs, :mod:`pygrid_tpu_torch.parallel.collectives`) and gets the
whole product shares back. A rank's party products are batched launches of
the ring-matmul kernel: d and e are broadcast over the rank's parties
(stride 0, never copied), so a combine is three launches (d∘b_i, a_i∘e,
d∘e) and :func:`sharded_beaver` adds one for the dealt triple's c = a∘b.

Triples are drawn with the port's threefry (:mod:`pygrid_tpu_torch.utils.prng`),
key for key as the reference draws them with ``jax.random``, so
:func:`deal_triples` gives the reference's triples bit for bit.
"""

from __future__ import annotations

from typing import Callable

import torch

from pygrid_tpu_torch.parallel import collectives as C
from pygrid_tpu_torch.parallel.mesh import Sharding
from pygrid_tpu_torch.smpc import ring as R
from pygrid_tpu_torch.utils import prng


def party_sharding(mesh, axis: str = "parties") -> Sharding:
    """The sharding that splits the leading (party) axis over ``axis``."""
    return Sharding(mesh, axis)


def make_sharded_open(mesh, axis: str = "parties") -> Callable[[torch.Tensor], torch.Tensor]:
    """Reconstruct ("open") whole shares ``[P, ...]`` split over ``axis``:
    each rank sums its block of parties, one exact collective sum adds the
    blocks; the result is replicated on every rank."""

    def open_(shares: torch.Tensor) -> torch.Tensor:
        return R.ring_psum(C.shard(mesh, axis, shares), mesh, axis, local_axis=0)

    return open_


def _ring_op(op: str) -> Callable:
    """The per-instance ring op lifted over the leading ``n`` shared axes."""
    if op == "mul":
        return lambda a, b, n: R.ring_mul(a, b)
    return lambda a, b, n: R.lead_matmul(a, b, n)


def make_sharded_beaver(mesh, op: str = "matmul", axis: str = "parties") -> Callable:
    """Beaver combine with the party axis split over ``axis``.

    Takes whole stacked shares ``x_sh, y_sh, a_sh, b_sh, c_sh`` of layout
    ``[P, B, ...]`` (triple shares from any dealer) and returns the whole
    product shares, same layout. The two opens are collectives; everything
    else is local to the rank's block of parties."""
    bop = _ring_op(op)

    def combine(x_sh, y_sh, a_sh, b_sh, c_sh):
        x_sh, y_sh, a_sh, b_sh, c_sh = C.shard(mesh, axis, x_sh, y_sh, a_sh, b_sh, c_sh)
        d = R.ring_psum(R.ring_sub(x_sh, a_sh), mesh, axis, local_axis=0)  # [B, ...]
        e = R.ring_psum(R.ring_sub(y_sh, b_sh), mesh, axis, local_axis=0)
        db = bop(d.unsqueeze(0).expand((b_sh.shape[0],) + tuple(d.shape)), b_sh, 2)
        ae = bop(a_sh, e.unsqueeze(0).expand((a_sh.shape[0],) + tuple(e.shape)), 2)
        z = R.ring_add(c_sh, R.ring_add(db, ae))
        # the public d∘e correction belongs to exactly one party: global
        # party 0, row 0 of the block on the axis' first rank
        if C.axis_index(mesh, axis) == 0:
            z[0] += bop(d, e, 1)
        return C.all_gather(z, mesh, axis)

    return combine


def _ring_random(keys: torch.Tensor, shape) -> torch.Tensor:
    """The reference's ``ring_random`` for each key of ``keys [*K, 2]``:
    the low and high 32 bits from the two halves of a split."""
    ks = prng.split(keys, 2)
    lo = prng.random_bits(ks[..., 0, :], shape)
    hi = prng.random_bits(ks[..., 1, :], shape)
    return (hi << 32) | lo


def _share(keys: torch.Tensor, value: torch.Tensor, n_parties: int, shape) -> torch.Tensor:
    """The reference's ``share_kernel`` for each key: P−1 draws from a
    split of the key and ``value`` minus their sum, stacked on axis 0."""
    ks = prng.split(keys, n_parties - 1)
    rs = [_ring_random(ks[..., i, :], shape) for i in range(n_parties - 1)]
    last = value
    for r in rs:
        last = R.ring_sub(last, r)
    return torch.stack(rs + [last])


def deal_triples(
    key: torch.Tensor,
    x_shape: tuple,
    y_shape: tuple,
    n_parties: int,
    op: str = "matmul",
    batch: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dealer-side triples for the sharded combine: ``(a_sh, b_sh, c_sh)``
    stacked ``[P, ...]`` (or ``[P, B, ...]``), on the key's device, equal
    to the reference's for the same key."""
    keys = key if batch is None else prng.split(key, batch)  # [2] or [B, 2]
    k = prng.split(keys, 3)
    a = _ring_random(k[..., 0, :], x_shape)
    b = _ring_random(k[..., 1, :], y_shape)
    c = _ring_op(op)(a, b, 0 if batch is None else 1)
    k3 = k[..., 2, :]
    return (
        _share(k3, a, n_parties, x_shape),
        _share(prng.fold_in(k3, 1), b, n_parties, y_shape),
        _share(prng.fold_in(k3, 2), c, n_parties, tuple(c.shape[0 if batch is None else 1:])),
    )


def sharded_beaver(
    mesh,
    key: torch.Tensor,
    x_sh: torch.Tensor,
    y_sh: torch.Tensor,
    op: str = "matmul",
    axis: str = "parties",
) -> torch.Tensor:
    """One full sharded Beaver round on whole shares ``[P, B, ...]``: deal
    triples from ``key``, then combine with collective opens."""
    a_sh, b_sh, c_sh = deal_triples(key, tuple(x_sh.shape[2:]), tuple(y_sh.shape[2:]),
                                    x_sh.shape[0], op=op, batch=x_sh.shape[1])
    return make_sharded_beaver(mesh, op=op, axis=axis)(x_sh, y_sh, a_sh, b_sh, c_sh)
