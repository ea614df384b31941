"""Per-user worker sessions for the data-centric plane.

Parity surface: reference ``data_centric/auth/user_session.py`` — a
flask_login ``UserMixin`` owning **one VirtualWorker per user** (``:29-34``)
plus a queue of pending tensor-access requests (``:44-51``), and
``session_repository.py:14-16`` seeding a default ``admin/admin`` account.
Here sessions are framework-agnostic objects a node app keys by an auth
token; the per-user worker is the same
:class:`~pygrid_tpu_torch.runtime.worker.VirtualWorker` the rest of the
runtime uses, on the session's ``device``. The port's counterpart of
:mod:`pygrid_tpu.datacentric.sessions`; a password digest made by either
package verifies in the other.
"""

from __future__ import annotations

import secrets
from typing import Any

import torch

from pygrid_tpu_torch.runtime.worker import VirtualWorker
from pygrid_tpu_torch.utils.exceptions import InvalidCredentialsError
from pygrid_tpu_torch.utils.passwords import hash_password, verify_password


def _hash_password(password: str) -> bytes:
    salt, digest = hash_password(password)
    return salt + digest


def _check_password(password: str, stored: bytes) -> bool:
    return verify_password(password, stored[:16], stored[16:])


class UserSession:
    """One authenticated data-scientist session = one VirtualWorker on
    ``device`` (reference user_session.py:29-34) + a tensor-request queue
    (:44-51)."""

    def __init__(
        self, username: str, password_hash: bytes, device: str | torch.device = "cuda"
    ) -> None:
        self.username = username
        self.device = device
        self._password_hash = password_hash
        self.authenticated = False
        self._worker: VirtualWorker | None = None
        #: requests saved when a .get() hits GetNotPermittedError — the owner
        #: reviews and releases them (reference's tensor_requests list)
        self.tensor_requests: list[dict[str, Any]] = []

    @property
    def worker(self) -> VirtualWorker:
        if self._worker is None:
            self._worker = VirtualWorker(id=self.username, device=self.device)
        return self._worker

    def check_credentials(self, password: str) -> bool:
        return _check_password(password, self._password_hash)

    def save_tensor_request(self, request: dict[str, Any]) -> None:
        self.tensor_requests.append(request)


class SessionsRepository:
    """username → UserSession registry with a default admin/admin account
    (reference session_repository.py:14-16); each session's worker lives on
    ``device`` (default ``"cuda"``)."""

    def __init__(self, device: str | torch.device = "cuda") -> None:
        self.device = device
        self._sessions: dict[str, UserSession] = {}
        #: token → session for WS/HTTP auth continuity
        self._tokens: dict[str, UserSession] = {}
        self.register("admin", "admin")

    def register(self, username: str, password: str) -> UserSession:
        if username in self._sessions:
            raise InvalidCredentialsError(f"user {username} already exists")
        session = UserSession(username, _hash_password(password), self.device)
        self._sessions[username] = session
        return session

    def get_session(self, username: str) -> UserSession | None:
        return self._sessions.get(username)

    def all_sessions(self) -> list[UserSession]:
        return list(self._sessions.values())

    def login(self, username: str, password: str) -> tuple[UserSession, str]:
        session = self._sessions.get(username)
        if session is None or not session.check_credentials(password):
            raise InvalidCredentialsError()
        session.authenticated = True
        token = secrets.token_hex(16)
        self._tokens[token] = session
        return session, token

    def by_token(self, token: str | None) -> UserSession | None:
        if token is None:
            return None
        return self._tokens.get(token)

    def logout(self, token: str) -> None:
        session = self._tokens.pop(token, None)
        if session is not None and session not in self._tokens.values():
            session.authenticated = False
