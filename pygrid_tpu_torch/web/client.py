"""The ``requests`` calls the port's clients make, over ``http.client``.

``get`` and ``post`` (and ``request`` for any other method) take
``params`` (a dict appended to the URL's query), ``json`` (sent as
``application/json``), ``data`` (bytes or str, sent as they are),
``headers`` and ``timeout`` (seconds), and return a :class:`Response` with ``status_code``, ``headers``,
``content``, ``text`` and ``json()``. Each call opens its own connection,
as a call of ``requests`` without a session does.
"""

from __future__ import annotations

import http.client
import json as _json
from typing import Any
from urllib.parse import urlencode, urlsplit


class Response:
    def __init__(self, status_code: int, headers: dict[str, str], content: bytes) -> None:
        self.status_code = status_code
        #: lower-cased header names
        self.headers = headers
        self.content = content

    @property
    def text(self) -> str:
        charset = "utf-8"
        for item in self.headers.get("content-type", "").split(";")[1:]:
            name, _, value = item.strip().partition("=")
            if name.lower() == "charset" and value:
                charset = value.strip('"')
        return self.content.decode(charset, errors="replace")

    def json(self) -> Any:
        return _json.loads(self.content)


def request(method: str, url: str, *, params: dict | None = None, json: Any = None,
            data: bytes | bytearray | str | None = None, headers: dict | None = None,
            timeout: float | None = None) -> Response:
    split = urlsplit(url)
    if split.scheme not in ("http", "https"):
        raise ValueError(f"not an http(s) url: {url}")
    path = split.path or "/"
    query = split.query
    if params:
        extra = urlencode({k: v for k, v in params.items() if v is not None})
        query = f"{query}&{extra}" if query else extra
    if query:
        path = f"{path}?{query}"
    send_headers = dict(headers or {})
    body: bytes | None = None
    if json is not None:
        body = _json.dumps(json).encode()
        send_headers.setdefault("Content-Type", "application/json")
    elif data is not None:
        body = data.encode() if isinstance(data, str) else bytes(data)
    conn_cls = (http.client.HTTPSConnection if split.scheme == "https"
                else http.client.HTTPConnection)
    conn = conn_cls(split.hostname or "localhost", split.port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=send_headers)
        resp = conn.getresponse()
        content = resp.read()
        return Response(resp.status, {k.lower(): v for k, v in resp.getheaders()}, content)
    finally:
        conn.close()


def get(url: str, **kwargs: Any) -> Response:
    return request("GET", url, **kwargs)


def post(url: str, **kwargs: Any) -> Response:
    return request("POST", url, **kwargs)
