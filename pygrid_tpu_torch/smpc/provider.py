"""Crypto provider — Beaver triple dealing and the primitive store.

Counterpart of :mod:`pygrid_tpu.smpc.provider` (syft's ``crypto_provider``
worker and its crypto-store refill protocol: a dry store raises
``EmptyCryptoPrimitiveStoreError`` carrying what to deal, the caller calls
:meth:`CryptoProvider.provide` and retries). Triples are dealt on the
provider's device, stacked over the party axis; a matmul triple's
c = a·b is one launch of the ring-matmul kernel.
"""

from __future__ import annotations

import secrets

import torch

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.smpc import ring as R
from pygrid_tpu_torch.smpc.kernels import reconstruct_kernel, share_kernel
from pygrid_tpu_torch.utils.exceptions import EmptyCryptoPrimitiveStoreError

#: clears the top 2 bits of a truncation mask: r < 2^62
_R_MASK = (1 << 62) - 1


class CryptoStore:
    """FIFO store of precomputed primitives keyed by (op, shapes, n_parties)."""

    def __init__(self) -> None:
        self._store: dict[tuple, list] = {}

    @staticmethod
    def key(op: str, shape_x: tuple, shape_y: tuple, n_parties: int) -> tuple:
        return (op, tuple(shape_x), tuple(shape_y), n_parties)

    def put(self, key: tuple, item) -> None:
        self._store.setdefault(key, []).append(item)

    def pop(self, key: tuple):
        bucket = self._store.get(key)
        if not bucket:
            raise EmptyCryptoPrimitiveStoreError(
                {
                    "op": key[0],
                    "shapes": [list(key[1]), list(key[2])],
                    "n_instances": 1,
                    "n_parties": key[3],
                }
            )
        return bucket.pop(0)

    def count(self, key: tuple) -> int:
        return len(self._store.get(key, []))


class CryptoProvider:
    """Trusted-dealer triple service on ``device`` (default ``"cuda"``).

    ``strict_store=True`` reproduces the reference stack's refill
    behaviour: requests only draw from the store and raise
    ``EmptyCryptoPrimitiveStoreError`` when it is dry. By default missing
    primitives are dealt on demand. ``trusted_dealer=True`` opts into the
    dealer-sees-all exact truncation (:meth:`reshare_truncated`); the
    default rescale is mask-and-open with :meth:`trunc_pair`.

    Without a ``seed`` the generator is seeded from ``secrets.randbits``:
    triple secrecy rests on it, and a fixed default would make every
    dealer's a/b stream reproducible (the open d = x − a would reveal x).
    The generator is made on the first dealt primitive, on ``device``, so a
    provider that only exists touches no GPU.
    """

    def __init__(
        self,
        id: str = "crypto_provider",
        seed: int | None = None,
        strict_store: bool = False,
        trusted_dealer: bool = False,
        device: str | torch.device = "cuda",
    ) -> None:
        self.id = id
        self.store = CryptoStore()
        self.strict_store = strict_store
        self.trusted_dealer = trusted_dealer
        self.device = device
        self._seed = secrets.randbits(63) if seed is None else seed
        self._gen: torch.Generator | None = None

    def _generator(self) -> torch.Generator:
        if self._gen is None:
            self._gen = torch.Generator(device=resolve(self.device)).manual_seed(self._seed)
        return self._gen

    # --- dealing ------------------------------------------------------------

    def _make_triple(
        self, op: str, shape_x: tuple, shape_y: tuple, n_parties: int
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if op not in ("mul", "matmul"):
            raise ValueError(f"unknown triple op {op!r}")
        g = self._generator()
        a = R.ring_random(g, tuple(shape_x))
        b = R.ring_random(g, tuple(shape_y))
        c = R.ring_mul(a, b) if op == "mul" else R.ring_matmul(a, b)
        return tuple(share_kernel(g, v, n_parties) for v in (a, b, c))

    def _make_trunc_pair(
        self, shape: tuple, scale: int, n_parties: int
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Shares of ``r`` uniform in [0, 2^62) and of ``r' = floor(r /
        scale)`` — the preprocessed randomness for mask-and-open truncation
        (:func:`pygrid_tpu_torch.smpc.kernels.masked_truncate`). r < 2^62
        keeps the masked open z + OFFSET + r from wrapping mod 2^64."""
        g = self._generator()
        r = R.ring_random(g, tuple(shape)) & _R_MASK
        r_prime = R.ring_div_const(r, scale)
        return share_kernel(g, r, n_parties), share_kernel(g, r_prime, n_parties)

    def provide(
        self, op: str, shape_x: tuple, shape_y: tuple, n_parties: int,
        n_instances: int = 1,
    ) -> None:
        """Refill the store (the response to an empty-store error).

        ``op="trunc"`` refills truncation pairs: ``shape_x`` is the value
        shape and ``shape_y`` carries ``(scale,)``.
        """
        key = CryptoStore.key(op, shape_x, shape_y, n_parties)
        for _ in range(n_instances):
            if op == "trunc":
                item = self._make_trunc_pair(tuple(shape_x), int(shape_y[0]), n_parties)
            else:
                item = self._make_triple(op, shape_x, shape_y, n_parties)
            self.store.put(key, item)

    def _draw(self, key: tuple, make):
        if self.store.count(key) or self.strict_store:
            return self.store.pop(key)  # raises EmptyCryptoPrimitiveStoreError when dry
        return make()

    def triple(
        self, op: str, shape_x: tuple, shape_y: tuple, n_parties: int
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        key = CryptoStore.key(op, shape_x, shape_y, n_parties)
        return self._draw(key, lambda: self._make_triple(op, shape_x, shape_y, n_parties))

    def trunc_pair(
        self, shape: tuple, scale: int, n_parties: int
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Draw (or deal) one truncation pair for ``shape``/``scale``."""
        key = CryptoStore.key("trunc", tuple(shape), (int(scale),), n_parties)
        return self._draw(
            key, lambda: self._make_trunc_pair(tuple(shape), int(scale), n_parties)
        )

    # --- provider-assisted exact truncation ---------------------------------

    def reshare_truncated(
        self, shares: torch.Tensor, scale: int, n_parties: int
    ) -> torch.Tensor:
        """Open → truncate exactly → re-share (the dealer sees the value):
        exact and deterministic, for ``trusted_dealer=True``."""
        truncated = R.ring_div_const_signed(reconstruct_kernel(shares), scale)
        return share_kernel(self._generator(), truncated, n_parties)
