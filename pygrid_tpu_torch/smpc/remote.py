"""Distributed SMPC: shares living on grid workers — the port's counterpart
of :mod:`pygrid_tpu.smpc.remote`.

Parity surface: the reference's cross-node sharing flow
(``x.fix_prec().share(alice, bob, charlie, dan)`` sends one share per Node
over the WS binary path — SURVEY.md §3.4; host selection in chunks of 4,
``apps/network/src/app/routes/network.py:16,98-131``) and its flagship
cross-node Beaver matmul with a crypto-provider worker (reference
``tests/data_centric/test_basic_syft_operations.py:383-491``, refill error
path ``events/data_centric/syft_events.py:34-45``).

This module is the *protocol* plane: one additive share per party worker,
the share-local algebra as remote pointer ops, only masked values opened
(Beaver's d/e, the truncation mask m), and secrets reconstructed by opening
every share. Shares travel and rest as int64 ring tensors
(:mod:`pygrid_tpu_torch.smpc.ring`), the message sequence is the
reference's, message for message. The client opens d and e onto its own
``device`` and forms the public d∘e there with the ring ops: on the card a
matmul round's d·e is one launch of the ring-matmul kernel, as is every
party's d·[b]ᵢ and [a]ᵢ·e on a party worker on the card.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.plans.placeholder import fresh_id
from pygrid_tpu_torch.runtime import messages as M
from pygrid_tpu_torch.runtime.pointers import PointerTensor, _raise_if_error
from pygrid_tpu_torch.smpc import ring as R
from pygrid_tpu_torch.smpc.additive import AdditiveSharingTensor
from pygrid_tpu_torch.smpc.fixed import FixedPointEncoder
from pygrid_tpu_torch.smpc.kernels import OFFSET_BITS
from pygrid_tpu_torch.utils.exceptions import EmptyCryptoPrimitiveStoreError


def _raw_cmd(location, op: str, args: list) -> PointerTensor:
    """Issue one remote op with explicit (possibly public-first) args."""
    resp = _raise_if_error(
        location.recv_obj_msg(
            M.TensorCommandMessage(op=op, args=args, return_id=fresh_id())
        )
    )
    return PointerTensor(
        location=location, id_at_location=resp.id_at_location, shape=resp.shape
    )


class RemoteCryptoProvider:
    """Client handle to a crypto-provider worker on the grid.

    ``location`` is anything with ``recv_obj_msg`` — a client dialed at the
    provider node, or an in-process VirtualWorker with an attached
    :class:`~pygrid_tpu_torch.smpc.provider.CryptoProvider`. The provider
    deals per-party share tensors directly to the share-holder workers over
    its own mesh (reference: james in ``x.share(..., crypto_provider=james)``).

    ``auto_refill=True`` reproduces the reference client's transparent
    refill round-trip: an ``EmptyCryptoPrimitiveStoreError`` coming back
    triggers one ``provide`` request built from the error's kwargs, then a
    retry (reference ``syft_events.py:34-45``).
    """

    def __init__(self, location: Any, auto_refill: bool = True) -> None:
        self.location = location
        self.auto_refill = auto_refill

    @property
    def id(self) -> str:
        return getattr(self.location, "id", str(self.location))

    def provide(
        self,
        op: str,
        shape_x: Sequence[int],
        shape_y: Sequence[int],
        n_parties: int,
        n_instances: int = 1,
    ) -> None:
        """The refill request (reference's provide-primitives round)."""
        self.location.recv_obj_msg(
            M.CryptoProvideMessage(
                op=op,
                shape_x=list(shape_x),
                shape_y=list(shape_y),
                n_parties=int(n_parties),
                n_instances=int(n_instances),
            )
        )

    def _request(self, msg: M.CryptoRequestMessage) -> M.CryptoDealResponse:
        try:
            return _raise_if_error(self.location.recv_obj_msg(msg))
        except EmptyCryptoPrimitiveStoreError as err:
            if not self.auto_refill:
                raise
            kw = err.kwargs_
            self.provide(
                kw.get("op", msg.op),
                kw.get("shapes", [msg.shape_x, msg.shape_y])[0],
                kw.get("shapes", [msg.shape_x, msg.shape_y])[1],
                kw.get("n_parties", len(msg.party_ids)),
                kw.get("n_instances", 1),
            )
            return _raise_if_error(self.location.recv_obj_msg(msg))

    def deal(
        self,
        op: str,
        shape_x: Sequence[int],
        shape_y: Sequence[int],
        parties: Sequence[Any],
    ) -> list[list[PointerTensor]]:
        """Deal one primitive; returns per-component pointer lists
        (``[component][party]``) addressed through the caller's own
        connections to the party workers."""
        party_ids = [getattr(p, "id", str(p)) for p in parties]
        resp = self._request(
            M.CryptoRequestMessage(
                op=op,
                shape_x=list(shape_x),
                shape_y=list(shape_y),
                party_ids=party_ids,
            )
        )
        sx, sy = tuple(shape_x), tuple(shape_y)
        if op == "matmul":
            shapes = [sx, sy, sx[:-1] + sy[1:]]
        elif op == "trunc":
            shapes = [sx, sx]  # [r], [r/scale] both carry the value shape
        else:
            shapes = [sx, sy, np.broadcast_shapes(sx, sy)]
        n_components = len(resp.ids[0])
        return [
            [
                PointerTensor(
                    location=parties[i],
                    id_at_location=resp.ids[i][k],
                    shape=shapes[k],
                )
                for i in range(len(parties))
            ]
            for k in range(n_components)
        ]


class RemoteSharedTensor:
    """Handle to a secret whose additive shares live on remote workers.

    ``pointers[i]`` points at owner i's int64 share. Linear ops are
    share-local (one remote op per worker, no cross-worker traffic);
    multiplicative ops run the Beaver round over the grid with a
    :class:`RemoteCryptoProvider`; ``get()`` opens the secret by fetching
    and summing all shares. Opened values (``get``, Beaver's d and e, the
    truncation mask) land on ``device`` (default ``"cuda"``), the client's.
    """

    def __init__(
        self,
        pointers: list,
        encoder: FixedPointEncoder | None,
        provider: RemoteCryptoProvider | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.pointers = list(pointers)
        self.encoder = encoder
        self.provider = provider
        self.device = resolve(device)

    @property
    def n_parties(self) -> int:
        return len(self.pointers)

    @property
    def locations(self) -> list:
        return [p.location for p in self.pointers]

    @property
    def shape(self) -> tuple:
        return tuple(self.pointers[0].shape or ())

    def _like(self, pointers: list, provider=None) -> "RemoteSharedTensor":
        return RemoteSharedTensor(pointers, self.encoder, provider or self.provider, self.device)

    # --- open ---------------------------------------------------------------

    def get(self, delete: bool = True) -> np.ndarray:
        """Fetch every share, sum in the ring, decode."""
        total = _ring_sum([p.get(delete=delete) for p in self.pointers], self.device)
        if self.encoder:
            return self.encoder.decode(total)
        return R.from_ring_signed(total)

    # --- share-local linear algebra (additive homomorphism) ----------------

    def _party_ids(self) -> list:
        return [getattr(p.location, "id", id(p.location)) for p in self.pointers]

    def _zip_op(self, other: "RemoteSharedTensor", op: str):
        if self._party_ids() != other._party_ids():
            raise ValueError(
                "operands are shared over different parties: "
                f"{self._party_ids()} vs {other._party_ids()}"
            )
        mine, theirs = self.encoder, other.encoder
        if (mine is None) != (theirs is None) or (
            mine is not None and mine.scale != theirs.scale
        ):
            raise ValueError("mismatched fixed-point encoders")
        ptrs = [
            getattr(a, op)(b)
            for a, b in zip(self.pointers, other.pointers)
        ]
        return self._like(ptrs, self.provider or other.provider)

    def __add__(self, other: "RemoteSharedTensor") -> "RemoteSharedTensor":
        return self._zip_op(other, "__add__")

    def __sub__(self, other: "RemoteSharedTensor") -> "RemoteSharedTensor":
        return self._zip_op(other, "__sub__")

    def mul_public(self, c: int) -> "RemoteSharedTensor":
        """Multiply by a public integer (share-local; no rescale, so for
        fixed-point secrets ``c`` must be an integer scalar)."""
        if not float(c).is_integer():
            raise ValueError("public factor must be an integer")
        return self._like([p * np.int64(int(c)) for p in self.pointers])

    # --- multiplicative ops: Beaver over the grid protocol ------------------

    def __mul__(self, other) -> "RemoteSharedTensor":
        if isinstance(other, RemoteSharedTensor):
            return self._beaver_remote(other, "mul")
        return self.mul_public(other)

    def __matmul__(self, other) -> "RemoteSharedTensor":
        if not isinstance(other, RemoteSharedTensor):
            raise TypeError("matmul with public operands: share the public side")
        return self._beaver_remote(other, "matmul")

    def _beaver_remote(
        self, other: "RemoteSharedTensor", op: str
    ) -> "RemoteSharedTensor":
        """One Beaver round across workers.

        The provider deals triple shares [a],[b],[c] directly to each
        share-holder; the masked differences d = x−a, e = y−b are opened
        (they are uniform — opening them is the protocol, not a leak); each
        worker combines share-locally; only party 0 folds in the public d∘e.
        Fixed-point products then rescale via mask-and-open truncation —
        at no point does any single worker (provider included) hold the
        secret. Mirrors reference test_basic_syft_operations.py:455-491.
        """
        if self._party_ids() != other._party_ids():
            raise ValueError(
                "operands are shared over different parties: "
                f"{self._party_ids()} vs {other._party_ids()}"
            )
        if (self.encoder is None) != (other.encoder is None) or (
            self.encoder is not None
            and self.encoder.scale != other.encoder.scale
        ):
            raise ValueError("mismatched fixed-point encoders")
        provider = self.provider or other.provider
        if provider is None:
            raise ValueError("this operation requires a crypto_provider")
        # the public d∘e, on the client's device: d·e is a kernel launch there
        combine = R.ring_mul if op == "mul" else R.ring_matmul_np

        a_ptrs, b_ptrs, c_ptrs = provider.deal(
            op, self.shape, other.shape, self.locations
        )
        # share-local masking, then open the (uniform) masked differences
        d = _open_pointers([x - a for x, a in zip(self.pointers, a_ptrs)], self.device)
        e = _open_pointers([y - b for y, b in zip(other.pointers, b_ptrs)], self.device)
        de = combine(d, e)
        z_ptrs = []
        for i, (a, b, c) in enumerate(zip(a_ptrs, b_ptrs, c_ptrs)):
            loc = c.location
            if op == "mul":
                db = b * d  # share-local: public d ∘ [b]_i
                ae = a * e
            else:
                db = _raw_cmd(loc, "__matmul__", [d, M.ref(b.id_at_location)])
                ae = a @ e
            t = c + db
            z = t + ae
            if i == 0:
                zd = z + de
                z.delete()
                z = zd
            for tmp in (a, b, c, db, ae, t):
                tmp.delete()
            z_ptrs.append(z)
        if self.encoder is not None:
            z_ptrs = self._truncate_remote(z_ptrs, provider)
        return self._like(z_ptrs, provider)

    def _truncate_remote(
        self, z_ptrs: list, provider: RemoteCryptoProvider
    ) -> list:
        """Mask-and-open rescale of product shares by the encoder scale —
        the wire twin of :func:`pygrid_tpu_torch.smpc.kernels.masked_truncate`
        (same pair, same offset, ε ∈ {0,1} ULP error; no worker sees the
        product, the client sees only the masked open)."""
        scale = self.encoder.scale
        shape = tuple(z_ptrs[0].shape or ())
        locations = [p.location for p in z_ptrs]
        r_ptrs, rp_ptrs = provider.deal("trunc", shape, [scale], locations)
        offset = int(scale) << OFFSET_BITS
        m_ptrs = []
        for i, (z, r) in enumerate(zip(z_ptrs, r_ptrs)):
            m = z + r
            if i == 0:
                mo = m + np.int64(offset)
                m.delete()
                m = mo
            z.delete()
            r.delete()
            m_ptrs.append(m)
        m = _open_pointers(m_ptrs, self.device)  # masked: z + scale·2^30 + r, < 2^63
        # the public floor(m / scale) - 2^30, as the unsigned division numpy's
        # uint64 // is, on the client's device
        q_minus = R.ring_div_const(m, int(scale)) - (1 << OFFSET_BITS)
        out = []
        for i, rp in enumerate(rp_ptrs):
            if i == 0:
                out.append(
                    _raw_cmd(
                        rp.location, "__sub__", [q_minus, M.ref(rp.id_at_location)]
                    )
                )
                rp.delete()
            else:
                out.append(-rp)
                rp.delete()
        return out

    def __repr__(self) -> str:
        locs = [getattr(loc, "id", loc) for loc in self.locations]
        return f"RemoteSharedTensor(parties={locs})"


def _as_ring(v: Any, device: torch.device) -> torch.Tensor:
    """A fetched share as an int64 ring tensor on ``device``: a tensor (in
    process, on its worker's device) is moved explicitly, a wire ndarray
    copied in."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.array(v, dtype=np.int64)).to(device)


def _ring_sum(values: Sequence[Any], device: torch.device) -> torch.Tensor:
    """Ring sum of fetched shares on ``device`` (int64 wraps: the mod-2^64
    semantics the shares need)."""
    total = _as_ring(values[0], device)
    for v in values[1:]:
        total = total + _as_ring(v, device)
    return total


def _open_pointers(ptrs: Sequence[PointerTensor], device: torch.device) -> torch.Tensor:
    """Fetch and ring-sum a set of share pointers (consumes the objects)."""
    return _ring_sum([p.get() for p in ptrs], device)


def share_to_nodes(
    x,
    clients: Sequence[Any],
    encoder: FixedPointEncoder | None = None,
    tags: Sequence[str] = (),
    crypto_provider: RemoteCryptoProvider | Any | None = None,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> RemoteSharedTensor:
    """Split ``x`` into len(clients) additive shares, one per worker.

    The shares are drawn on ``device`` (default ``"cuda"``) from
    ``generator`` (a fresh secret seed without one) and sent as tensors.
    ``clients``: locations pointers can ``send`` through.
    ``crypto_provider``: a :class:`RemoteCryptoProvider` (or a bare
    provider location, which is wrapped) enabling Beaver mul/matmul.
    Mirrors the reference's ``x.fix_prec().share(*nodes, crypto_provider=james)``."""
    owners = [getattr(c, "id", str(i)) for i, c in enumerate(clients)]
    ast = AdditiveSharingTensor.share(
        np.asarray(x), owners, encoder=encoder, generator=generator, device=device
    )
    from pygrid_tpu_torch.runtime.pointers import send as _send

    pointers = []
    for i, client in enumerate(clients):
        pointers.append(_send(ast.shares[i], client, tags=set(tags)))
    if crypto_provider is not None and not isinstance(
        crypto_provider, RemoteCryptoProvider
    ):
        crypto_provider = RemoteCryptoProvider(crypto_provider)
    return RemoteSharedTensor(pointers, encoder, crypto_provider, device)


def fix_prec_share_to_nodes(
    x,
    clients: Sequence[Any],
    base: int = 10,
    precision_fractional: int = 3,
    tags: Sequence[str] = (),
    crypto_provider: RemoteCryptoProvider | Any | None = None,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> RemoteSharedTensor:
    """``x.fix_prec().share(alice, bob, …, crypto_provider=james)`` over
    grid workers."""
    encoder = FixedPointEncoder(base, precision_fractional)
    return share_to_nodes(
        x, clients, encoder=encoder, tags=tags, crypto_provider=crypto_provider,
        generator=generator, device=device,
    )
