"""The SMPC plane's protocol steps on stacked shares — the hot path.

Counterpart of :mod:`pygrid_tpu.smpc.kernels`. Shares are ring tensors
(int64, :mod:`pygrid_tpu_torch.smpc.ring`) with all parties stacked on one
axis, ``dim``: 0 for one instance ``[P, ...]`` (the class API), 1 for a
batch of instances ``[B, P, ...]`` (:func:`batched_beaver`). "Opening" a
masked value is a sum over that axis.

Where the reference maps a ring op over the party axis (``jax.vmap``), the
port broadcasts instead: the opened ``d`` or ``e`` is expanded over the
party axis (stride 0, never copied) and every party's product is one
batched launch of the ring-matmul kernel. A Beaver matmul round is
therefore three launches (d∘b_i, a_i∘e, d∘e) whatever the number of
parties, and :func:`batched_beaver` adds one for the dealt triple's
c = a∘b: four per round, each over the whole batch.
"""

from __future__ import annotations

import torch

from pygrid_tpu_torch.smpc import ring as R

#: mask-and-open truncation offset magnitude: the secret product z must
#: satisfy |z| < scale * 2^OFFSET_BITS, i.e. |x·y| < 2^OFFSET_BITS / scale
OFFSET_BITS = 30


def share_kernel(
    generator: torch.Generator, value: torch.Tensor, n_parties: int, dim: int = 0
) -> torch.Tensor:
    """Split a ring tensor into ``n_parties`` additive shares, stacked on
    axis ``dim``: P−1 uniform draws from ``generator`` (on the value's
    device) and ``value`` minus their sum."""
    shares = [R.ring_random(generator, value.shape) for _ in range(n_parties - 1)]
    last = value
    for r in shares:
        last = R.ring_sub(last, r)
    return torch.stack(shares + [last], dim=dim)


def reconstruct_kernel(shares: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum over the party axis ``dim`` (the 'open'), party by party."""
    total = shares.select(dim, 0).clone()
    for i in range(1, shares.shape[dim]):
        total += shares.select(dim, i)
    return total


def _expand_parties(t: torch.Tensor, like: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` (no party axis) broadcast over ``like``'s party axis as a
    stride-0 view."""
    return t.unsqueeze(dim).expand(like.shape[: dim + 1] + t.shape[dim:])


def _right_align(t: torch.Tensor, at: int, rank: int) -> torch.Tensor:
    """``t`` with unit axes inserted at axis ``at`` until the axes from
    ``at`` on number ``rank``: numpy's right alignment of a per-party shape
    made explicit, so that broadcasting never pairs it with a leading axis."""
    return t.reshape(t.shape[:at] + (1,) * (rank - (t.dim() - at)) + t.shape[at:])


def beaver_combine(
    x_sh: torch.Tensor,
    y_sh: torch.Tensor,
    a_sh: torch.Tensor,
    b_sh: torch.Tensor,
    c_sh: torch.Tensor,
    op: str,
    dim: int = 0,
) -> torch.Tensor:
    """One full Beaver round on stacked shares -> product shares.

    z_i = c_i + d∘b_i + a_i∘e + [i=0] d∘e,  d = open(x−a), e = open(y−b).
    Per party this is the reference's: ``op="mul"`` broadcasts the two
    per-party shapes as numpy does (right-aligned), any other op is
    :func:`~pygrid_tpu_torch.smpc.ring.ring_matmul`'s contraction."""
    if op == "mul":
        rank = max(x_sh.dim(), y_sh.dim()) - dim - 1
        x_sh, y_sh, a_sh, b_sh = (_right_align(t, dim + 1, rank)
                                  for t in (x_sh, y_sh, a_sh, b_sh))
    d = reconstruct_kernel(R.ring_sub(x_sh, a_sh), dim)
    e = reconstruct_kernel(R.ring_sub(y_sh, b_sh), dim)
    if op == "mul":
        db = R.ring_mul(d.unsqueeze(dim), b_sh)
        ae = R.ring_mul(a_sh, e.unsqueeze(dim))
        de = R.ring_mul(d, e)
    else:
        db = R.lead_matmul(_expand_parties(d, b_sh, dim), b_sh, dim + 1)
        ae = R.lead_matmul(a_sh, _expand_parties(e, a_sh, dim), dim + 1)
        de = R.lead_matmul(d, e, dim)
    z = R.ring_add(c_sh, R.ring_add(db, ae))
    z.select(dim, 0).add_(de)  # z is a fresh tensor: party 0 takes d∘e
    return z


def masked_truncate(
    z_sh: torch.Tensor, r_sh: torch.Tensor, rp_sh: torch.Tensor, scale: int
) -> torch.Tensor:
    """Rescale product shares ``[P, ...]`` by ``scale`` without anyone
    seeing the secret.

    Mask-and-open truncation with a dealer-provided pair
    (``r`` uniform < 2^62, ``r' = floor(r/scale)``):

    1. open ``m = z + OFFSET + r``  (OFFSET = scale·2^30 keeps the sum
       positive; m < 2^63 so the ring sum is the exact integer sum);
    2. publicly compute ``q = floor(m / scale)``;
    3. output shares: party 0 holds ``q − 2^30 − r'_0``, party i>0 holds
       ``−r'_i``  →  the shares sum to ``floor(z/scale) + ε``, ε ∈ {0, 1}.

    Nobody learns z: parties only see their own shares, and the opened
    ``m`` is statistically masked by r. The dealer-sees-all alternative is
    :meth:`~pygrid_tpu_torch.smpc.provider.CryptoProvider.reshare_truncated`,
    kept behind ``trusted_dealer=True``.
    """
    m_sh = R.ring_add(z_sh, r_sh)
    m_sh[0] += scale << OFFSET_BITS
    m = reconstruct_kernel(m_sh)  # public masked value, < 2^63
    q = R.ring_div_const(m, scale)
    out = R.ring_neg(rp_sh)  # party i: −r'_i
    out[0] += q - (1 << OFFSET_BITS)
    return out


def batched_beaver(
    generator: torch.Generator,
    x_sh: torch.Tensor,
    y_sh: torch.Tensor,
    op: str = "matmul",
    n_parties: int = 3,
) -> torch.Tensor:
    """B independent Beaver rounds with the triples dealt on the device.

    ``x_sh``/``y_sh``: shares ``[B, P, ...]``; ``generator`` lives on their
    device and draws the triples (trusted-dealer simulation). The triple's
    c = a∘b and the three products of the round are each one launch over
    the whole batch."""
    if x_sh.shape[1] != n_parties or y_sh.shape[1] != n_parties:
        raise ValueError(
            f"shares {tuple(x_sh.shape)}, {tuple(y_sh.shape)} do not hold "
            f"{n_parties} parties on axis 1"
        )
    B = x_sh.shape[0]
    a = R.ring_random(generator, (B,) + tuple(x_sh.shape[2:]))
    b = R.ring_random(generator, (B,) + tuple(y_sh.shape[2:]))
    if op == "mul":  # per instance, numpy's right-aligned broadcasting
        rank = max(a.dim(), b.dim()) - 1
        a, b = _right_align(a, 1, rank), _right_align(b, 1, rank)
        c = R.ring_mul(a, b)
    else:
        c = R.lead_matmul(a, b, 1)
    a_sh, b_sh, c_sh = (share_kernel(generator, v, n_parties, dim=1) for v in (a, b, c))
    return beaver_combine(x_sh, y_sh, a_sh, b_sh, c_sh, op, dim=1)
