"""Per-FL-process worker authentication (JWT).

Parity surface: reference ``model_centric/auth/federated.py:15-79`` —
``verify_token`` accepts HMAC-secret (HS256) and/or RSA public key (RS256)
from the process's ``server_config["authentication"]``, optionally defers to a
third-party verification ``endpoint``, and admits unauthenticated workers when
no auth is configured. No pyjwt in the image: compact JWS encode/verify is
implemented here on hmac / cryptography primitives.

The port's copy of :mod:`pygrid_tpu.federated.auth`, with the port's imports.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Any

from pygrid_tpu_torch.utils.exceptions import AuthorizationError


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    pad = -len(s) % 4
    return base64.urlsafe_b64decode(s + "=" * pad)


def jwt_encode(
    payload: dict,
    secret: str | None = None,
    private_key_pem: str | bytes | None = None,
) -> str:
    """HS256 (secret) or RS256 (RSA private key PEM) compact JWS."""
    alg = "HS256" if secret is not None else "RS256"
    header = {"alg": alg, "typ": "JWT"}
    signing_input = (
        _b64url(json.dumps(header, separators=(",", ":")).encode())
        + "."
        + _b64url(json.dumps(payload, separators=(",", ":")).encode())
    ).encode()
    if alg == "HS256":
        sig = hmac.new(str(secret).encode(), signing_input, hashlib.sha256).digest()
    else:
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import padding

        key = serialization.load_pem_private_key(
            private_key_pem if isinstance(private_key_pem, bytes)
            else str(private_key_pem).encode(),
            password=None,
        )
        sig = key.sign(signing_input, padding.PKCS1v15(), hashes.SHA256())
    return signing_input.decode() + "." + _b64url(sig)


def jwt_verify(
    token: str,
    secret: str | None = None,
    pub_key_pem: str | bytes | None = None,
) -> dict:
    """Verify signature (+ exp when present); returns the payload."""
    try:
        head_b64, payload_b64, sig_b64 = token.split(".")
        signing_input = f"{head_b64}.{payload_b64}".encode()
        header = json.loads(_b64url_decode(head_b64))
        payload = json.loads(_b64url_decode(payload_b64))
        sig = _b64url_decode(sig_b64)
    except Exception as err:
        raise AuthorizationError("The 'auth_token' you sent is invalid.") from err

    alg = header.get("alg")
    if alg == "HS256" and secret is not None:
        expected = hmac.new(
            str(secret).encode(), signing_input, hashlib.sha256
        ).digest()
        if not hmac.compare_digest(sig, expected):
            raise AuthorizationError("The 'auth_token' you sent is invalid.")
    elif alg == "RS256" and pub_key_pem is not None:
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import padding

        key = serialization.load_pem_public_key(
            pub_key_pem if isinstance(pub_key_pem, bytes)
            else str(pub_key_pem).encode()
        )
        try:
            key.verify(sig, signing_input, padding.PKCS1v15(), hashes.SHA256())
        except InvalidSignature as err:
            raise AuthorizationError("The 'auth_token' you sent is invalid.") from err
    else:
        raise AuthorizationError("The 'auth_token' you sent is invalid.")

    exp = payload.get("exp")
    if exp is not None and time.time() > float(exp):
        raise AuthorizationError("The 'auth_token' you sent is invalid.")
    return payload


def verify_token(auth_token: str | None, server_config: dict) -> dict[str, Any]:
    """(reference federated.py:15-79) returns {"status": "success"} plus any
    verified payload, or raises AuthorizationError."""
    auth_config = server_config.get("authentication") or {}
    secret = auth_config.get("secret")
    pub_key = auth_config.get("pub_key")
    endpoint = auth_config.get("endpoint")

    if not (secret or pub_key or endpoint):
        return {"status": "success"}  # unauthenticated process

    if not auth_token:
        raise AuthorizationError(
            "Authentication is required, please pass an 'auth_token'."
        )

    payload: dict = {}
    if secret or pub_key:
        payload = jwt_verify(auth_token, secret=secret, pub_key_pem=pub_key)

    if endpoint:
        import requests

        resp = requests.post(
            endpoint, json={"auth_token": auth_token}, timeout=10
        )
        if resp.status_code != 200:
            raise AuthorizationError("The 'auth_token' you sent is invalid.")

    return {"status": "success", "payload": payload}
