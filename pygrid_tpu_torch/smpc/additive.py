"""AdditiveSharingTensor — additive secret shares over Z_2^64, party-stacked.

Counterpart of :mod:`pygrid_tpu.smpc.additive` (syft-0.2.9's
``AdditiveSharingTensor`` as the reference grid uses it:
``x.fix_prec().share(alice, bob, charlie, crypto_provider=james)``, add,
sub, Beaver mul and matmul, ``.get()``). One tensor holds all parties'
shares as one int64 ring tensor whose leading axis is the party axis, on
one device; every protocol step is a few tensor ops (and ring-matmul
launches) over that stacked tensor.

The class is registered with the port's serde as
``pygrid.AdditiveSharingTensor``, as the reference's is, and
``_bufferize``/``_unbufferize`` keep the reference's numpy dict (shares as
``Ring64``'s uint32 ``lo``/``hi``): a shared tensor serialized by either
package decodes in the other (here onto the ``device`` that
:func:`pygrid_tpu_torch.serde.deserialize` is given).
"""

from __future__ import annotations

import secrets
from typing import Sequence

import numpy as np
import torch

from pygrid_tpu_torch.convert import ring_from_numpy, ring_to_numpy
from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.serde import register_serde
from pygrid_tpu_torch.smpc import ring as R
from pygrid_tpu_torch.smpc.fixed import FixedPointEncoder
from pygrid_tpu_torch.smpc.kernels import (
    beaver_combine,
    masked_truncate,
    reconstruct_kernel,
    share_kernel,
)
from pygrid_tpu_torch.smpc.provider import CryptoProvider


@register_serde(name="pygrid.AdditiveSharingTensor")
class AdditiveSharingTensor:
    """Stacked additive shares: ``shares`` is int64 ``[n_parties, *shape]``."""

    def __init__(
        self,
        shares: torch.Tensor,
        owners: Sequence[str],
        encoder: FixedPointEncoder | None = None,
        crypto_provider: CryptoProvider | None = None,
    ) -> None:
        self.shares = shares
        self.owners = tuple(owners)
        self.encoder = encoder
        self.crypto_provider = crypto_provider
        #: survives serde even when the live provider object doesn't
        self.crypto_provider_id: str | None = (
            crypto_provider.id if crypto_provider is not None else None
        )

    # --- construction -------------------------------------------------------

    @classmethod
    def share(
        cls,
        x,
        owners: Sequence[str],
        crypto_provider: CryptoProvider | None = None,
        encoder: FixedPointEncoder | None = None,
        generator: torch.Generator | None = None,
        device: str | torch.device = "cuda",
    ) -> "AdditiveSharingTensor":
        """Encode (if an encoder is given) and split into len(owners) shares
        on ``device``, drawn from ``generator`` (on that device). Without a
        generator one is seeded from ``secrets.randbits``: share secrecy
        rests on it."""
        n = len(owners)
        if n < 2:
            raise ValueError("need at least 2 parties")
        dev = resolve(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(secrets.randbits(63))
        elif generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, shares on {dev}")
        value = encoder.encode(x, dev) if encoder else R.to_ring(x, dev)
        return cls(share_kernel(generator, value, n), owners, encoder, crypto_provider)

    @property
    def n_parties(self) -> int:
        return len(self.owners)

    @property
    def shape(self) -> tuple:
        return tuple(self.shares.shape[1:])

    # --- reconstruction -----------------------------------------------------

    def reconstruct_ring(self) -> torch.Tensor:
        return reconstruct_kernel(self.shares)

    def get(self) -> np.ndarray:
        """Open the secret (syft ``.get()`` then ``.float_prec()``)."""
        total = self.reconstruct_ring()
        if self.encoder:
            return self.encoder.decode(total)
        return R.from_ring_signed(total)

    # --- linear ops (share-local, no communication) -------------------------

    def _like(self, shares: torch.Tensor) -> "AdditiveSharingTensor":
        return AdditiveSharingTensor(shares, self.owners, self.encoder, self.crypto_provider)

    def _check_compat(self, other: "AdditiveSharingTensor") -> None:
        if self.owners != other.owners:
            raise ValueError("shares live on different parties")
        if (self.encoder is None) != (other.encoder is None) or (
            self.encoder and other.encoder and self.encoder.scale != other.encoder.scale
        ):
            raise ValueError("mismatched fixed-point encoders")

    def __add__(self, other):
        if isinstance(other, AdditiveSharingTensor):
            self._check_compat(other)
            return self._like(R.ring_add(self.shares, other.shares))
        return self._add_public(other)

    def __sub__(self, other):
        if isinstance(other, AdditiveSharingTensor):
            self._check_compat(other)
            return self._like(R.ring_sub(self.shares, other.shares))
        return self._add_public(-np.asarray(other))

    def _add_public(self, c) -> "AdditiveSharingTensor":
        """Add a public constant: only party 0's share moves."""
        dev = self.shares.device
        enc = self.encoder.encode(c, dev) if self.encoder else R.to_ring(c, dev)
        first = R.ring_add(self.shares[0], enc)
        shares = self.shares.clone()
        shares[0] = first
        return self._like(shares)

    # --- multiplicative ops (Beaver triples) --------------------------------

    def _provider(self) -> CryptoProvider:
        if self.crypto_provider is None:
            raise ValueError("this operation requires a crypto_provider")
        return self.crypto_provider

    def _beaver(self, other: "AdditiveSharingTensor", op: str):
        """One Beaver round, then (fixed point) one rescale by the scale."""
        self._check_compat(other)
        provider = self._provider()
        n = self.n_parties
        a_sh, b_sh, c_sh = provider.triple(op, self.shape, other.shape, n)
        z = beaver_combine(self.shares, other.shares, a_sh, b_sh, c_sh, op)
        if self.encoder:  # product carries scale^2 — rescale once
            if provider.trusted_dealer:
                z = provider.reshare_truncated(z, self.encoder.scale, n)
            else:
                r_sh, rp_sh = provider.trunc_pair(tuple(z.shape[1:]), self.encoder.scale, n)
                z = masked_truncate(z, r_sh, rp_sh, self.encoder.scale)
        return self._like(z)

    def __mul__(self, other):
        if isinstance(other, AdditiveSharingTensor):
            return self._beaver(other, "mul")
        return self._mul_public(other)

    def __matmul__(self, other):
        if isinstance(other, AdditiveSharingTensor):
            return self._beaver(other, "matmul")
        raise TypeError("matmul with public operands: share the public side")

    def _mul_public(self, c) -> "AdditiveSharingTensor":
        """Multiply by a public integer scalar or array (share-local)."""
        c_arr = np.asarray(c)
        if not np.all(np.equal(np.mod(c_arr, 1), 0)):
            raise TypeError(
                "public multiplier must be integer-valued (fixed-point "
                "floats must be shared or encoded first)"
            )
        ring_c = R.to_ring(c_arr.astype(np.int64), self.shares.device)
        return self._like(R.ring_mul(self.shares, ring_c))  # broadcasts over parties

    # --- serde (the reference's payload) -------------------------------------

    def _bufferize(self) -> dict:
        lo, hi = ring_to_numpy(self.shares)
        return {
            "lo": lo,
            "hi": hi,
            "owners": list(self.owners),
            "base": self.encoder.base if self.encoder else None,
            "precision": self.encoder.precision_fractional if self.encoder else None,
            "crypto_provider_id": self.crypto_provider_id,
        }

    @classmethod
    def _unbufferize(
        cls, data: dict, device: str | torch.device = "cuda"
    ) -> "AdditiveSharingTensor":
        encoder = None
        if data["base"] is not None:
            encoder = FixedPointEncoder(data["base"], data["precision"])
        out = cls(ring_from_numpy((data["lo"], data["hi"]), device), data["owners"], encoder)
        out.crypto_provider_id = data.get("crypto_provider_id")
        return out

    def __repr__(self) -> str:
        return (
            f"AdditiveSharingTensor(shape={self.shape}, "
            f"owners={self.owners}, encoder={self.encoder})"
        )


# --- syft-style fluent entry points ----------------------------------------


class FixedPrecisionTensor:
    """``fix_prec(x)`` wrapper so user code reads like the reference examples:
    ``fix_prec(x).share("alice", "bob", crypto_provider=cp)``."""

    def __init__(self, x, base: int = 10, precision_fractional: int = 3):
        self.value = np.asarray(x)
        self.encoder = FixedPointEncoder(base, precision_fractional)

    def share(
        self,
        *owners: str,
        crypto_provider: CryptoProvider | None = None,
        generator: torch.Generator | None = None,
        device: str | torch.device = "cuda",
    ) -> AdditiveSharingTensor:
        return AdditiveSharingTensor.share(
            self.value, owners, crypto_provider, self.encoder, generator, device
        )

    def float_prec(self) -> np.ndarray:
        return self.value


def fix_prec(x, base: int = 10, precision_fractional: int = 3) -> FixedPrecisionTensor:
    return FixedPrecisionTensor(x, base, precision_fractional)
