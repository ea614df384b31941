"""An async HTTP/1.1 client on ``asyncio`` streams, under aiohttp's names.

The network's outgoing calls (the search fan-outs, the monitor's polls, a
sub-aggregator's registration heartbeat) are written against
``aiohttp.ClientSession``; this module gives them the same surface so the
handlers read the same:

    async with ClientSession(timeout=ClientTimeout(total=5)) as session:
        async with session.get(url, params={"a": 1}) as resp:
            if resp.status == 200:
                payload = await resp.json()

- ``session.get/post/delete/request(url, json=, data=, params=,
  headers=, timeout=)`` are awaitable and ``async with`` context managers,
  and give a :class:`ClientResponse` with ``status``, ``reason``,
  ``headers`` (case-insensitive) and ``await read()/text()/json()``;
- ``ClientTimeout(total=...)`` bounds a whole request — connect, send and
  reading the body — with :func:`asyncio.timeout`; it raises
  :class:`asyncio.TimeoutError`, as aiohttp does;
- a body is read by ``Content-Length``, by ``Transfer-Encoding: chunked``
  (an aiohttp ``StreamResponse`` without a length is chunked) or, with
  neither, up to the close of the connection;
- transport failures raise :class:`ClientConnectorError` (refused, unknown
  host) or :class:`ClientOSError`, both :class:`ClientError`.

Each request opens its own connection and reads its whole body inside the
timeout, so a response holds nothing to release.
"""

from __future__ import annotations

import asyncio
import json as _json
import ssl
from dataclasses import dataclass
from http import HTTPStatus
from typing import Any
from urllib.parse import urlencode, urlsplit

from pygrid_tpu_torch.web.server import MultiDict, _mime_and_params

#: a response head larger than this is a protocol error
MAX_HEAD_BYTES = 64 * 1024


class ClientError(Exception):
    """Base of every client failure except the timeout."""


class ClientConnectionError(ClientError):
    pass


class ClientOSError(ClientConnectionError, OSError):
    pass


class ClientConnectorError(ClientOSError):
    """The connection could not be opened (refused, no route, bad host)."""


class ServerDisconnectedError(ClientConnectionError):
    pass


class ClientPayloadError(ClientError):
    """The response could not be read (bad head, bad chunk framing,
    truncated body)."""


class ContentTypeError(ClientError):
    """``json()`` on a response whose content type is not JSON."""


@dataclass(frozen=True)
class ClientTimeout:
    """``total`` seconds for a whole request (None: no limit)."""

    total: float | None = None


#: aiohttp's default: five minutes for a whole request
DEFAULT_TIMEOUT = ClientTimeout(total=300.0)


class ClientResponse:
    def __init__(self, method: str, url: str, status: int, reason: str,
                 headers: MultiDict, body: bytes) -> None:
        self.method = method
        self.url = url
        self.status = status
        self.reason = reason
        self.headers = headers
        self._body = body

    @property
    def content_type(self) -> str:
        return _mime_and_params(self.headers.get("Content-Type"))[0] or "application/octet-stream"

    @property
    def charset(self) -> str | None:
        return _mime_and_params(self.headers.get("Content-Type"))[1].get("charset")

    async def read(self) -> bytes:
        return self._body

    async def text(self, encoding: str | None = None) -> str:
        return self._body.decode(encoding or self.charset or "utf-8", errors="replace")

    async def json(self, *, content_type: str | None = "application/json") -> Any:
        if content_type is not None and content_type not in self.content_type:
            raise ContentTypeError(
                f"attempt to decode JSON with unexpected mimetype: {self.content_type}"
            )
        if not self._body.strip():
            return None
        return _json.loads(self._body.decode(self.charset or "utf-8"))


class _RequestContext:
    """What ``session.get(...)`` returns: awaitable, and an ``async with``
    context manager giving the response."""

    def __init__(self, coro) -> None:
        self._coro = coro

    def __await__(self):
        return self._coro.__await__()

    async def __aenter__(self) -> ClientResponse:
        return await self._coro

    async def __aexit__(self, *exc: Any) -> None:
        pass


def _target(url: str, params: Any) -> tuple[str, str, int, bool, str]:
    split = urlsplit(url)
    if split.scheme not in ("http", "https"):
        raise ValueError(f"not an http(s) url: {url}")
    tls = split.scheme == "https"
    host = split.hostname or "localhost"
    port = split.port or (443 if tls else 80)
    path = split.path or "/"
    query = split.query
    if params:
        pairs = params.items() if isinstance(params, dict) else params
        extra = urlencode([(k, str(v)) for k, v in pairs])
        query = f"{query}&{extra}" if query else extra
    if query:
        path = f"{path}?{query}"
    host_header = host if split.port is None else f"{host}:{split.port}"
    return host, host_header, port, tls, path


async def _read_head(reader: asyncio.StreamReader) -> tuple[int, str, MultiDict]:
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as err:
        if not err.partial:
            raise ServerDisconnectedError("server closed the connection before answering") \
                from None
        raise ClientPayloadError("response head cut short") from None
    except asyncio.LimitOverrunError:
        raise ClientPayloadError("response head too large") from None
    lines = head[:-4].decode("latin-1").split("\r\n")
    version, _, rest = lines[0].partition(" ")
    code, _, reason = rest.partition(" ")
    if not version.startswith("HTTP/1.") or not code.isdigit():
        raise ClientPayloadError(f"bad status line {lines[0]!r}")
    headers = MultiDict(ci=True)
    for line in lines[1:]:
        name, sep, value = line.partition(":")
        if not sep:
            raise ClientPayloadError(f"bad header line {line!r}")
        headers.add(name.strip(), value.strip())
    return int(code), reason, headers


async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
    body = bytearray()
    while True:
        line = await reader.readuntil(b"\r\n")
        size_text = line[:-2].split(b";", 1)[0].strip()
        try:
            size = int(size_text, 16)
        except ValueError:
            raise ClientPayloadError(f"bad chunk size {size_text!r}") from None
        if size == 0:
            while (await reader.readuntil(b"\r\n")) != b"\r\n":  # trailers
                pass
            return bytes(body)
        body += await reader.readexactly(size)
        if await reader.readexactly(2) != b"\r\n":
            raise ClientPayloadError("chunk not followed by CRLF")


async def _read_body(reader: asyncio.StreamReader, method: str, status: int,
                     headers: MultiDict) -> bytes:
    if method == "HEAD" or status in (204, 304) or 100 <= status < 200:
        return b""
    try:
        if "chunked" in headers.get("Transfer-Encoding", "").lower():
            return await _read_chunked(reader)
        length = headers.get("Content-Length")
        if length is not None:
            if not length.strip().isdigit():
                raise ClientPayloadError(f"bad Content-Length {length!r}")
            return await reader.readexactly(int(length))
        return await reader.read()  # delimited by the close of the connection
    except asyncio.IncompleteReadError:
        raise ClientPayloadError("response body cut short") from None


class ClientSession:
    """A set of requests sharing a default ``timeout``; use it as
    ``async with ClientSession(...) as session``."""

    def __init__(self, *, timeout: ClientTimeout = DEFAULT_TIMEOUT) -> None:
        self.timeout = timeout
        self._closed = False

    @property
    def closed(self) -> bool:
        return self._closed

    async def close(self) -> None:
        self._closed = True

    async def __aenter__(self) -> "ClientSession":
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.close()

    def request(self, method: str, url: str, **kwargs: Any) -> _RequestContext:
        return _RequestContext(self._request(method.upper(), url, **kwargs))

    def get(self, url: str, **kwargs: Any) -> _RequestContext:
        return self.request("GET", url, **kwargs)

    def post(self, url: str, **kwargs: Any) -> _RequestContext:
        return self.request("POST", url, **kwargs)

    def delete(self, url: str, **kwargs: Any) -> _RequestContext:
        return self.request("DELETE", url, **kwargs)

    async def _request(self, method: str, url: str, *, params: Any = None, json: Any = None,
                       data: Any = None, headers: dict | None = None,
                       timeout: ClientTimeout | None = None) -> ClientResponse:
        if self._closed:
            raise RuntimeError("Session is closed")
        if json is not None and data is not None:
            raise ValueError("data and json parameters can not be used at the same time")
        host, host_header, port, tls, path = _target(url, params)
        send = MultiDict(ci=True)
        for k, v in (headers or {}).items():
            send[k] = str(v)
        body = b""
        if json is not None:
            body = _json.dumps(json).encode()
            if "Content-Type" not in send:
                send["Content-Type"] = "application/json"
        elif data is not None:
            body = data.encode() if isinstance(data, str) else bytes(data)
        if "Host" not in send:
            send["Host"] = host_header
        if "Accept" not in send:
            send["Accept"] = "*/*"
        send["Connection"] = "close"
        if body or method in ("POST", "PUT", "PATCH"):
            send["Content-Length"] = str(len(body))
        head = "\r\n".join([f"{method} {path} HTTP/1.1"] + [f"{k}: {v}" for k, v in send.items()])
        total = (timeout or self.timeout).total
        async with asyncio.timeout(total):
            try:
                reader, writer = await asyncio.open_connection(
                    host, port, ssl=ssl.create_default_context() if tls else None,
                    limit=MAX_HEAD_BYTES)
            except OSError as err:
                raise ClientConnectorError(
                    f"cannot connect to host {host}:{port}: {err}") from err
            try:
                writer.write(head.encode("latin-1") + b"\r\n\r\n" + body)
                await writer.drain()
                while True:  # interim 1xx answers come before the real one
                    status, reason, resp_headers = await _read_head(reader)
                    if not 100 <= status < 200:
                        break
                content = await _read_body(reader, method, status, resp_headers)
            except (ConnectionError, OSError) as err:
                raise ClientOSError(f"connection to {host}:{port} failed: {err}") from err
            finally:
                writer.close()
                try:
                    await writer.wait_closed()
                except (ConnectionError, OSError):
                    pass
        if not reason:
            try:
                reason = HTTPStatus(status).phrase
            except ValueError:
                reason = ""
        return ClientResponse(method, url, status, reason, resp_headers, content)
