"""One password-hashing implementation for both auth planes: the port's
own copy of :mod:`pygrid_tpu.utils.passwords`, so a digest made by either
package verifies in the other.

The reference uses bcrypt (``users/user_ops.py:29-36``) and
werkzeug hashes; neither ships in this image, so both the RBAC plane
(pygrid_tpu.users) and the data-centric session plane
(pygrid_tpu.datacentric.sessions) hash through here — pbkdf2-HMAC-SHA256,
per-user 16-byte salt, constant-time comparison.
"""

from __future__ import annotations

import hashlib
import hmac
import secrets

_ITERATIONS = 100_000


def pbkdf2(password: str, salt: bytes) -> bytes:
    return hashlib.pbkdf2_hmac(
        "sha256", password.encode(), salt, _ITERATIONS
    )


def hash_password(password: str) -> tuple[bytes, bytes]:
    """-> (salt, digest)"""
    salt = secrets.token_bytes(16)
    return salt, pbkdf2(password, salt)


def verify_password(password: str, salt: bytes, digest: bytes) -> bool:
    return hmac.compare_digest(pbkdf2(password, salt), digest)
