"""Secure aggregation (SecAgg) — Bonawitz et al., "Practical Secure
Aggregation for Privacy-Preserving Machine Learning" (CCS '17), the
double-masking protocol: the server learns ONLY the sum of the clients'
diffs, never an individual contribution, and tolerates client dropouts
between rounds.

No reference analog: the reference's report path ships raw diffs
(fl_events.py:237-271) and its only aggregation privacy is SMPC on the
data-centric plane. SecAgg completes this framework's privacy triad —
SMPC (cross-node shares, `smpc/`), DP (calibrated noise, `privacy.py`),
and SecAgg (mask-and-cancel on the model-centric report path).

The math rides exact mod-2^32 arithmetic:

- diffs quantize to fixed-point uint32 (scale chosen so K clients can
  never overflow the centered lift — :func:`choose_scale`);
- client *i* adds a **self-mask** ``PRG(b_i)`` plus signed **pairwise
  masks** ``±PRG(s_ij)`` for every peer *j* (sign by id order), where
  ``s_ij`` comes from a finite-field Diffie–Hellman agreement
  (RFC 3526 group 14) so the server never sees it;
- full participation: pairwise masks cancel in the sum *identically*
  (uint32 wraparound is the group operation — no float error, property
  tested);
- dropouts: survivors hold Shamir shares (t-of-n over GF(2^521-1)) of
  every client's self-mask seed AND Diffie–Hellman secret; the server
  reconstructs exactly the terms that failed to cancel — ``b_i`` for
  survivors, ``s_jk`` for dropped *j* — and removes them.

Mask expansion uses numpy's Philox counter PRG keyed by SHA-256 of the
seed: spec-pinned, platform-stable, and both the masking client and the
unmasking server derive the identical stream.

The port's copy of :mod:`pygrid_tpu.federated.secagg`, with the port's imports.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import secrets
from dataclasses import dataclass
from typing import Iterable, Mapping, Sequence

import numpy as np

from pygrid_tpu_torch.utils.exceptions import PyGridError

# ── finite-field Diffie–Hellman (RFC 3526 group 14, 2048-bit MODP) ───────────
# Python-native bignum pow(); key agreement is once per (client, peer) per
# cycle, far off the hot path. The generator 2 and modulus are the RFC 3526
# constants — safe-prime group, standard for classic DH.

DH_PRIME = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16,
)
DH_GENERATOR = 2
#: exponent entropy — 256 bits against a 2048-bit safe-prime group is the
#: standard short-exponent setting (≥ the group's ~112-bit security level)
_DH_EXPONENT_BITS = 256


@dataclass(frozen=True)
class DHKeyPair:
    secret: int
    public: int

    @staticmethod
    def generate() -> "DHKeyPair":
        secret = secrets.randbits(_DH_EXPONENT_BITS) | (
            1 << (_DH_EXPONENT_BITS - 1)
        )
        return DHKeyPair(secret, pow(DH_GENERATOR, secret, DH_PRIME))


def dh_shared_secret(secret: int, peer_public: int) -> bytes:
    """32-byte shared key: SHA-256 of the DH group element. Both ends of a
    pair derive the identical value (pow is commutative in the exponent)."""
    if not 1 < peer_public < DH_PRIME - 1:
        raise PyGridError("invalid DH public key")
    shared = pow(peer_public, secret, DH_PRIME)
    return hashlib.sha256(
        shared.to_bytes((DH_PRIME.bit_length() + 7) // 8, "big")
    ).digest()


# ── Shamir t-of-n secret sharing over GF(p), p = 2^521 − 1 ───────────────────
# The Mersenne prime 2^521−1 comfortably holds 256-bit secrets (DH exponents
# and 16-byte seeds) in a single field element.

SHAMIR_PRIME = (1 << 521) - 1


def shamir_share(
    secret: int, n: int, t: int, *, rng: secrets.SystemRandom | None = None
) -> list[tuple[int, int]]:
    """Split ``secret`` into ``n`` points of a random degree-(t−1)
    polynomial; any ``t`` recover it, fewer reveal nothing."""
    if not 0 <= secret < SHAMIR_PRIME:
        raise PyGridError("shamir secret out of field range")
    if not 1 <= t <= n:
        raise PyGridError(f"invalid shamir threshold t={t} n={n}")
    rng = rng or secrets.SystemRandom()
    coeffs = [secret] + [rng.randrange(SHAMIR_PRIME) for _ in range(t - 1)]
    shares = []
    for x in range(1, n + 1):
        y = 0
        for c in reversed(coeffs):  # Horner
            y = (y * x + c) % SHAMIR_PRIME
        shares.append((x, y))
    return shares


def shamir_recover(shares: Sequence[tuple[int, int]]) -> int:
    """Lagrange interpolation at 0. Callers pass ≥t shares; passing fewer
    yields an unrelated field element, not an error (information-theoretic
    hiding means the math cannot tell)."""
    if not shares:
        raise PyGridError("no shamir shares")
    xs = [x for x, _ in shares]
    if len(set(xs)) != len(xs):
        raise PyGridError("duplicate shamir share indices")
    total = 0
    for i, (xi, yi) in enumerate(shares):
        num, den = 1, 1
        for j, (xj, _) in enumerate(shares):
            if i == j:
                continue
            num = (num * (-xj)) % SHAMIR_PRIME
            den = (den * (xi - xj)) % SHAMIR_PRIME
        total = (
            total + yi * num * pow(den, SHAMIR_PRIME - 2, SHAMIR_PRIME)
        ) % SHAMIR_PRIME
    return total


# ── authenticated stream encryption from stdlib primitives ───────────────────
# Share bundles transit the (untrusted) server encrypted peer-to-peer under
# the DH pair key. Keystream = SHA-256(key ‖ nonce ‖ counter) blocks;
# integrity = HMAC-SHA256 (encrypt-then-MAC). pyca/cryptography is not in
# the image; these stdlib constructions are standard and sufficient here
# (unique random nonce per seal, key per (pair, purpose) via :func:`kdf`).


def kdf(key: bytes, purpose: str) -> bytes:
    return hmac_mod.new(key, purpose.encode(), hashlib.sha256).digest()


def _keystream(key: bytes, nonce: bytes, length: int) -> bytes:
    out = bytearray()
    counter = 0
    while len(out) < length:
        out += hashlib.sha256(
            key + nonce + counter.to_bytes(8, "big")
        ).digest()
        counter += 1
    return bytes(out[:length])


def seal(key: bytes, plaintext: bytes) -> bytes:
    nonce = secrets.token_bytes(16)
    enc_key, mac_key = kdf(key, "enc"), kdf(key, "mac")
    ct = bytes(
        a ^ b for a, b in zip(plaintext, _keystream(enc_key, nonce, len(plaintext)))
    )
    tag = hmac_mod.new(mac_key, nonce + ct, hashlib.sha256).digest()
    return nonce + ct + tag


def open_sealed(key: bytes, blob: bytes) -> bytes:
    if len(blob) < 48:
        raise PyGridError("sealed blob too short")
    nonce, ct, tag = blob[:16], blob[16:-32], blob[-32:]
    enc_key, mac_key = kdf(key, "enc"), kdf(key, "mac")
    expect = hmac_mod.new(mac_key, nonce + ct, hashlib.sha256).digest()
    if not hmac_mod.compare_digest(tag, expect):
        raise PyGridError("sealed blob failed authentication")
    return bytes(
        a ^ b for a, b in zip(ct, _keystream(enc_key, nonce, len(ct)))
    )


# ── mask PRG (Philox counter RNG keyed by SHA-256 of the seed) ───────────────


def expand_mask(
    seed: bytes, shapes: Sequence[tuple[int, ...]]
) -> list[np.ndarray]:
    """Deterministic uint32 mask arrays for ``shapes`` from a byte seed.
    Philox is a spec-pinned counter PRG — the masking client and the
    unmasking server regenerate the identical stream from the seed."""
    key = int.from_bytes(hashlib.sha256(b"secagg-mask" + seed).digest()[:16], "big")
    gen = np.random.Generator(np.random.Philox(key=key))
    return [
        gen.integers(0, 1 << 32, size=shape, dtype=np.uint32)
        for shape in shapes
    ]


# ── fixed-point quantization over Z_{2^32} ───────────────────────────────────


def choose_scale(clip_range: float, n_clients: int) -> float:
    """Largest scale such that the sum of ``n_clients`` values bounded by
    ``clip_range`` stays inside the centered lift (±2^31)."""
    if clip_range <= 0 or n_clients <= 0:
        raise PyGridError("clip_range and n_clients must be positive")
    return float((1 << 31) - 1) / (clip_range * n_clients * 1.001)


def quantize(
    diffs: Sequence[np.ndarray], clip_range: float, n_clients: int
) -> list[np.ndarray]:
    """f32 → uint32 fixed point. Values clamp to ±clip_range first (the
    client-side analog of DP ingest clipping — masked coordinates cannot
    be range-checked server-side, so the bound is enforced here)."""
    scale = choose_scale(clip_range, n_clients)
    out = []
    for d in diffs:
        x = np.clip(np.asarray(d, dtype=np.float64), -clip_range, clip_range)
        q = np.rint(x * scale).astype(np.int64)
        out.append((q % (1 << 32)).astype(np.uint32))
    return out


def dequantize_sum(
    sums: Sequence[np.ndarray], clip_range: float, n_clients: int, count: int
) -> list[np.ndarray]:
    """Centered lift of a mod-2^32 sum of ``count`` quantized diffs, back
    to the f32 mean. ``n_clients`` must match the quantizers' value (it
    fixes the scale)."""
    scale = choose_scale(clip_range, n_clients)
    if count <= 0:
        raise PyGridError("dequantize count must be positive")
    out = []
    for s in sums:
        lifted = np.asarray(s, dtype=np.int64)
        lifted = np.where(lifted >= (1 << 31), lifted - (1 << 32), lifted)
        out.append((lifted / (scale * count)).astype(np.float32))
    return out


# ── masking / unmasking ──────────────────────────────────────────────────────


def _pair_seed(shared: bytes) -> bytes:
    return kdf(shared, "pairwise-mask")


def mask_quantized(
    quantized: Sequence[np.ndarray],
    my_id: str,
    self_seed: bytes,
    pair_secrets: Mapping[str, bytes],
) -> list[np.ndarray]:
    """y_i = q_i + PRG(b_i) + Σ_{j>i} PRG(s_ij) − Σ_{j<i} PRG(s_ij)
    (mod 2^32; ids ordered as strings so both ends agree on the sign)."""
    shapes = [np.shape(q) for q in quantized]
    masked = [np.array(q, dtype=np.uint32, copy=True) for q in quantized]
    for m, s in zip(masked, expand_mask(self_seed, shapes)):
        np.add(m, s, out=m)  # uint32 wraps — the group op
    for peer_id, shared in pair_secrets.items():
        if peer_id == my_id:
            continue
        mask = expand_mask(_pair_seed(shared), shapes)
        if my_id < peer_id:
            for m, s in zip(masked, mask):
                np.add(m, s, out=m)
        else:
            for m, s in zip(masked, mask):
                np.subtract(m, s, out=m)
    return masked


def remove_self_masks(
    sums: Sequence[np.ndarray],
    self_seeds: Iterable[bytes],
    shapes: Sequence[tuple[int, ...]],
) -> list[np.ndarray]:
    """Subtract Σ PRG(b_i) for the recovered survivor self-mask seeds."""
    out = [np.array(s, dtype=np.uint32, copy=True) for s in sums]
    for seed in self_seeds:
        for o, m in zip(out, expand_mask(seed, shapes)):
            np.subtract(o, m, out=o)
    return out


def remove_dangling_pairwise(
    sums: Sequence[np.ndarray],
    dropped_id: str,
    dropped_secret: int,
    survivor_publics: Mapping[str, int],
    shapes: Sequence[tuple[int, ...]],
) -> list[np.ndarray]:
    """Remove the pairwise masks survivors applied *toward a dropped
    client*: survivor k's sum contribution carries sign(k, j)·PRG(s_kj)
    with no cancelling term from j. The server, holding j's reconstructed
    DH secret, recomputes every s_kj and subtracts those terms."""
    out = [np.array(s, dtype=np.uint32, copy=True) for s in sums]
    for peer_id, peer_public in survivor_publics.items():
        if peer_id == dropped_id:
            continue
        shared = dh_shared_secret(dropped_secret, peer_public)
        mask = expand_mask(_pair_seed(shared), shapes)
        if peer_id < dropped_id:  # survivor added +PRG → subtract
            for o, m in zip(out, mask):
                np.subtract(o, m, out=o)
        else:  # survivor subtracted PRG → add back
            for o, m in zip(out, mask):
                np.add(o, m, out=o)
    return out


# ── wire envelope for masked diffs ───────────────────────────────────────────

_MAGIC = "__pygrid_secagg_masked__"


def encode_masked_diff(masked: Sequence[np.ndarray]) -> bytes:
    from pygrid_tpu_torch.serde import serialize

    return serialize(
        {_MAGIC: True, "tensors": [np.asarray(m, dtype=np.uint32) for m in masked]}
    )


def is_masked_envelope(obj: object) -> bool:
    return isinstance(obj, dict) and obj.get(_MAGIC) is True


def decode_masked_diff(blob: bytes) -> list[np.ndarray]:
    from pygrid_tpu_torch.serde import deserialize

    try:
        obj = deserialize(blob)
    except Exception as err:  # noqa: BLE001 — worker-supplied bytes
        raise PyGridError(f"undecodable masked diff: {err}") from err
    if not is_masked_envelope(obj):
        raise PyGridError("not a secagg masked diff")
    tensors = obj.get("tensors", [])
    out = []
    for t in tensors:
        arr = np.asarray(t)
        if arr.dtype != np.uint32:
            raise PyGridError("masked diff tensors must be uint32")
        out.append(arr)
    return out


# ── serialization helpers for protocol fields ────────────────────────────────


def int_to_hex(value: int) -> str:
    return format(value, "x")


def hex_to_int(value: str) -> int:
    return int(value, 16)
