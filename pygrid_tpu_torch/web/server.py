"""HTTP/1.1 server on ``asyncio.start_server``, under aiohttp's names.

What the port's apps use and no more: an :class:`Application` with a
router (``add_get`` — with HEAD, as aiohttp's — ``add_post``/``add_put``/
``add_delete``/``add_route("*")``, ``{name}`` path parameters in
``match_info``),
aiohttp-style middlewares (``async def mw(request, handler)``),
``on_startup``/``on_cleanup`` hooks run on the server's loop and
``client_max_size`` (a larger body is refused with 413 when the handler
reads it, as aiohttp refuses one of that size too); a :class:`Request`
with ``method``, ``path``, ``query``, case-insensitive ``headers``, ``match_info``, ``app`` and
``read``/``text``/``json``/``multipart``; :class:`Response`,
:func:`json_response` and :class:`StreamResponse` (whose ``write`` awaits
the transport's ``drain``); the :class:`HTTPException` family, raised by
the router for 404 and 405 so a middleware sees the status; and
:class:`AppRunner`/:class:`TCPSite`/:func:`run_app` serving HTTP/1.1 with
keep-alive, ``Connection: close`` and ``Content-Length`` bodies.

:class:`BackgroundServer` runs one app on its own event-loop thread — how
a process hosts several nodes (the tests, ``chip_smoke.py``).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import re
import signal
import threading
from http import HTTPStatus
from typing import Any, Awaitable, Callable, Iterable
from urllib.parse import parse_qsl, unquote, urlsplit

logger = logging.getLogger(__name__)

#: a request line plus headers larger than this is refused with 431
MAX_HEAD_BYTES = 64 * 1024
#: aiohttp's default ``client_max_size``
DEFAULT_MAX_SIZE = 1024 * 1024


class MultiDict:
    """Ordered ``(key, value)`` pairs where ``get`` and ``[]`` return the
    first value of a key (aiohttp's ``request.query`` on repeated keys);
    ``ci=True`` makes key lookups case-insensitive (headers)."""

    def __init__(self, pairs: Iterable[tuple[str, Any]] = (), ci: bool = False):
        self._ci = ci
        self._pairs: list[tuple[str, Any]] = list(pairs)

    def _same(self, a: str, b: str) -> bool:
        return a.lower() == b.lower() if self._ci else a == b

    def getall(self, key: str, default: Any = ...) -> list:
        found = [v for k, v in self._pairs if self._same(k, key)]
        if not found and default is ...:
            raise KeyError(key)
        return found or default

    def get(self, key: str, default: Any = None) -> Any:
        for k, v in self._pairs:
            if self._same(k, key):
                return v
        return default

    def __getitem__(self, key: str) -> Any:
        for k, v in self._pairs:
            if self._same(k, key):
                return v
        raise KeyError(key)

    def __setitem__(self, key: str, value: Any) -> None:
        """Replace every value of ``key`` with one."""
        self._pairs = [(k, v) for k, v in self._pairs if not self._same(k, key)]
        self._pairs.append((key, value))

    def add(self, key: str, value: Any) -> None:
        self._pairs.append((key, value))

    def __contains__(self, key: object) -> bool:
        return isinstance(key, str) and any(self._same(k, key) for k, _ in self._pairs)

    def items(self) -> list[tuple[str, Any]]:
        return list(self._pairs)


def _mime_and_params(value: str | None) -> tuple[str, dict[str, str]]:
    """``"text/plain; charset=utf-8"`` → ``("text/plain", {"charset": "utf-8"})``."""
    if not value:
        return "", {}
    mime, *rest = value.split(";")
    params = {}
    for item in rest:
        name, _, val = item.strip().partition("=")
        params[name.strip().lower()] = val.strip().strip('"')
    return mime.strip().lower(), params


# ── exceptions ────────────────────────────────────────────────────────────


class HTTPException(Exception):
    """A status raised instead of returned; the server answers it as
    ``"<status>: <reason>"`` text, as aiohttp does."""

    status = 500

    def __init__(self, *, text: str | None = None, headers: dict | None = None) -> None:
        if text is None:
            text = f"{self.status}: {HTTPStatus(self.status).phrase}"
        self.text = text
        self.headers = dict(headers or {})
        super().__init__(text)


class HTTPBadRequest(HTTPException):
    status = 400


class HTTPNotFound(HTTPException):
    status = 404


class HTTPMethodNotAllowed(HTTPException):
    status = 405

    def __init__(self, method: str, allowed_methods: Iterable[str], **kw) -> None:
        self.method = method
        self.allowed_methods = set(allowed_methods)
        headers = {"Allow": ",".join(sorted(self.allowed_methods)), **kw.pop("headers", {})}
        super().__init__(headers=headers, **kw)


class HTTPRequestEntityTooLarge(HTTPException):
    status = 413

    def __init__(self, max_size: int, actual_size: int) -> None:
        super().__init__(
            text=f"Maximum request body size {max_size} exceeded, "
            f"actual body size {actual_size}"
        )


class _BadHead(Exception):
    """The request head cannot be parsed: 400 and close."""


# ── responses ─────────────────────────────────────────────────────────────


def _head_bytes(status: int, headers: MultiDict, keep_alive: bool) -> bytes:
    try:
        reason = HTTPStatus(status).phrase
    except ValueError:
        reason = ""
    lines = [f"HTTP/1.1 {status} {reason}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    if "Connection" not in headers:
        lines.append("Connection: " + ("keep-alive" if keep_alive else "close"))
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class StreamResponse:
    """A response written in pieces: ``await prepare(request)`` sends the
    head, each ``await write(data)`` sends data and waits for the
    transport to drain (backpressure), ``await write_eof()`` ends it.
    Without a ``Content-Length`` header the body is chunked."""

    def __init__(self, *, status: int = 200, headers: dict | None = None) -> None:
        self.status = status
        self.headers = MultiDict((headers or {}).items(), ci=True)
        self.prepared = False
        self._writer: asyncio.StreamWriter | None = None
        self._chunked = False
        self._eof = False
        self._head_only = False  # a HEAD request: the head, no body

    async def prepare(self, request: "Request") -> None:
        if self.prepared:
            return
        self._head_only = request.method == "HEAD"
        self._chunked = "Content-Length" not in self.headers and not self._head_only
        if self._chunked:
            self.headers["Transfer-Encoding"] = "chunked"
        self._writer = request._writer
        self._writer.write(_head_bytes(self.status, self.headers, request.keep_alive))
        await self._writer.drain()
        self.prepared = True

    async def write(self, data: bytes | bytearray | memoryview) -> None:
        if not self.prepared:
            raise RuntimeError("write() before prepare()")
        if not data or self._head_only:
            return
        if self._chunked:
            self._writer.write(b"%x\r\n" % len(data))
            self._writer.write(data)
            self._writer.write(b"\r\n")
        else:
            self._writer.write(data)
        await self._writer.drain()

    async def write_eof(self) -> None:
        if self._eof or not self.prepared:
            return
        if self._chunked:
            self._writer.write(b"0\r\n\r\n")
        await self._writer.drain()
        self._eof = True


class Response(StreamResponse):
    """A whole response: ``body`` bytes or ``text`` (``text/plain;
    charset=utf-8`` unless told otherwise)."""

    def __init__(
        self,
        *,
        body: bytes | bytearray | memoryview | None = None,
        status: int = 200,
        text: str | None = None,
        headers: dict | None = None,
        content_type: str | None = None,
        charset: str | None = None,
    ) -> None:
        super().__init__(status=status, headers=headers)
        if body is not None and text is not None:
            raise ValueError("body and text are not allowed together")
        if text is not None:
            charset = charset or "utf-8"
            self.body = text.encode(charset)
            self.headers["Content-Type"] = f"{content_type or 'text/plain'}; charset={charset}"
        else:
            self.body = b"" if body is None else body
            if content_type is not None:
                self.headers["Content-Type"] = content_type + (
                    f"; charset={charset}" if charset else ""
                )
            elif "Content-Type" not in self.headers:
                self.headers["Content-Type"] = "application/octet-stream"


def json_response(
    data: Any = None,
    *,
    status: int = 200,
    headers: dict | None = None,
    content_type: str = "application/json",
    dumps: Callable[[Any], str] = json.dumps,
) -> Response:
    return Response(text=dumps(data), status=status, headers=headers,
                    content_type=content_type)


# ── requests ──────────────────────────────────────────────────────────────


class BodyPart:
    """One part of a ``multipart/form-data`` body."""

    def __init__(self, headers: MultiDict, data: bytes) -> None:
        self.headers = headers
        self._data = data
        _, params = _mime_and_params(headers.get("Content-Disposition"))
        self.name = params.get("name")
        self.filename = params.get("filename")

    async def read(self, decode: bool = False) -> bytearray:
        return bytearray(self._data)

    async def text(self) -> str:
        charset = _mime_and_params(self.headers.get("Content-Type"))[1].get("charset")
        return self._data.decode(charset or "utf-8")


class MultipartReader:
    """``async for part in await request.multipart()``."""

    def __init__(self, parts: list[BodyPart]) -> None:
        self._parts = iter(parts)

    def __aiter__(self) -> "MultipartReader":
        return self

    async def __anext__(self) -> BodyPart:
        try:
            return next(self._parts)
        except StopIteration:
            raise StopAsyncIteration from None


def _parse_multipart(body: bytes, boundary: str) -> list[BodyPart]:
    parts = []
    for section in body.split(b"--" + boundary.encode())[1:]:
        if section.startswith(b"--"):
            break
        head, _, data = section.removeprefix(b"\r\n").partition(b"\r\n\r\n")
        headers = MultiDict(ci=True)
        for line in head.decode("latin-1").split("\r\n"):
            name, sep, value = line.partition(":")
            if sep:
                headers.add(name.strip(), value.strip())
        parts.append(BodyPart(headers, data.removesuffix(b"\r\n")))
    return parts


class _Route:
    def __init__(self, method: str, handler: Callable, resource: "Resource | None"):
        self.method = method
        self.handler = handler
        self.resource = resource


class MatchInfo(dict):
    """The path parameters of the matched route; ``.route.resource`` is
    None when nothing matched (404, 405), as in aiohttp."""

    def __init__(self, params: dict, route: _Route) -> None:
        super().__init__(params)
        self.route = route

    @property
    def handler(self) -> Callable:
        return self.route.handler


class Resource:
    """One path pattern and its handlers by method."""

    def __init__(self, path: str) -> None:
        self.canonical = path
        pieces = re.split(r"\{(\w+)\}", path)
        regex = "".join(
            f"(?P<{p}>[^{{}}/]+)" if i % 2 else re.escape(p) for i, p in enumerate(pieces)
        )
        self._pattern = re.compile(regex)
        self.routes: dict[str, _Route] = {}

    def match(self, path: str) -> dict | None:
        m = self._pattern.fullmatch(path)
        return None if m is None else m.groupdict()


class UrlDispatcher:
    def __init__(self) -> None:
        self._resources: list[Resource] = []

    def add_route(self, method: str, path: str, handler: Callable) -> _Route:
        if not path.startswith("/"):
            raise ValueError(f"path must start with '/': {path!r}")
        resource = next((r for r in self._resources if r.canonical == path), None)
        if resource is None:
            resource = Resource(path)
            self._resources.append(resource)
        method = method.upper()
        if method in resource.routes:
            raise RuntimeError(f"{method} {path} is already registered")
        route = resource.routes[method] = _Route(method, handler, resource)
        return route

    def add_get(self, path: str, handler: Callable, allow_head: bool = True) -> _Route:
        if allow_head:
            self.add_route("HEAD", path, handler)
        return self.add_route("GET", path, handler)

    def add_post(self, path: str, handler: Callable) -> _Route:
        return self.add_route("POST", path, handler)

    def add_put(self, path: str, handler: Callable) -> _Route:
        return self.add_route("PUT", path, handler)

    def add_delete(self, path: str, handler: Callable) -> _Route:
        return self.add_route("DELETE", path, handler)

    def resolve(self, method: str, path: str) -> MatchInfo:
        allowed: set[str] = set()
        for resource in self._resources:
            params = resource.match(path)
            if params is None:
                continue
            route = resource.routes.get(method) or resource.routes.get("*")
            if route is not None:
                return MatchInfo(params, route)
            allowed |= set(resource.routes)
        err: HTTPException = (
            HTTPMethodNotAllowed(method, allowed) if allowed else HTTPNotFound()
        )

        async def _raise(request):
            raise err

        return MatchInfo({}, _Route(method, _raise, None))


class Request:
    """One HTTP request; the body is read from the connection on the first
    ``read()`` (and refused with 413 from ``app.client_max_size`` bytes on)."""

    def __init__(self, app: "Application", method: str, target: str, version: str,
                 headers: MultiDict, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        split = urlsplit(target)
        self.app = app
        self.method = method.upper()
        self.path = unquote(split.path) or "/"
        self.query = MultiDict(parse_qsl(split.query, keep_blank_values=True))
        self.version = version
        self.headers = headers
        self.match_info = MatchInfo({}, _Route(method, None, None))
        self._reader = reader
        self._writer = writer
        self._body: bytes | None = None
        if "chunked" in headers.get("Transfer-Encoding", "").lower():
            raise _BadHead("chunked request bodies are not supported")
        length = headers.get("Content-Length", "0").strip() or "0"
        if not length.isdigit():
            raise _BadHead(f"bad Content-Length {length!r}")
        self.content_length = int(length)
        tokens = {t.strip().lower() for t in headers.get("Connection", "").split(",")}
        self.keep_alive = (
            "close" not in tokens if version == "HTTP/1.1" else "keep-alive" in tokens
        )

    @property
    def content_type(self) -> str:
        return _mime_and_params(self.headers.get("Content-Type"))[0] or "application/octet-stream"

    @property
    def charset(self) -> str | None:
        return _mime_and_params(self.headers.get("Content-Type"))[1].get("charset")

    @property
    def can_read_body(self) -> bool:
        return self._body is None and self.content_length > 0

    async def read(self) -> bytes:
        if self._body is None:
            n = self.content_length
            if n >= self.app.client_max_size:  # aiohttp refuses == too
                self.keep_alive = False  # the unread body is never drained
                raise HTTPRequestEntityTooLarge(self.app.client_max_size, n)
            if n and self.headers.get("Expect", "").lower() == "100-continue":
                self._writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                await self._writer.drain()
            self._body = await self._reader.readexactly(n) if n else b""
        return self._body

    async def text(self) -> str:
        return (await self.read()).decode(self.charset or "utf-8")

    async def json(self) -> Any:
        return json.loads(await self.text())

    async def multipart(self) -> MultipartReader:
        mime, params = _mime_and_params(self.headers.get("Content-Type"))
        if not mime.startswith("multipart/") or not params.get("boundary"):
            raise HTTPBadRequest(text="multipart body without a boundary")
        return MultipartReader(_parse_multipart(await self.read(), params["boundary"]))

    async def _discard_body(self) -> bool:
        """Read an unread body off the connection so the next request
        starts at its head; False when the connection must close."""
        if self._body is not None or not self.content_length:
            return True
        if self.content_length >= self.app.client_max_size:
            return False
        await self._reader.readexactly(self.content_length)
        return True


# ── the application ───────────────────────────────────────────────────────


def middleware(fn: Callable) -> Callable:
    """aiohttp's decorator for ``async def mw(request, handler)``."""
    fn.__middleware_version__ = 1
    return fn


class Application:
    def __init__(self, *, middlewares: Iterable[Callable] = (),
                 client_max_size: int = DEFAULT_MAX_SIZE) -> None:
        self._state: dict[str, Any] = {}
        self.router = UrlDispatcher()
        self.middlewares = list(middlewares)
        self.on_startup: list[Callable[["Application"], Awaitable[None]]] = []
        self.on_cleanup: list[Callable[["Application"], Awaitable[None]]] = []
        self.client_max_size = client_max_size

    def __getitem__(self, key: str) -> Any:
        return self._state[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._state[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self._state.get(key, default)

    async def _handle(self, request: Request) -> StreamResponse:
        request.match_info = self.router.resolve(request.method, request.path)
        handler = request.match_info.handler
        for mw in reversed(self.middlewares):
            handler = _bind(mw, handler)
        return await handler(request)


def _bind(mw: Callable, inner: Callable) -> Callable:
    async def call(request: Request) -> StreamResponse:
        return await mw(request, inner)

    return call


async def _dispatch(app: Application, request: Request) -> StreamResponse:
    try:
        response = await app._handle(request)
        if not isinstance(response, StreamResponse):
            raise TypeError(f"handler returned {type(response).__name__}, not a response")
        return response
    except HTTPException as err:
        return Response(text=err.text, status=err.status, headers=err.headers)
    except asyncio.CancelledError:
        raise
    except Exception:
        logger.exception("error handling %s %s", request.method, request.path)
        return Response(text="500: Internal Server Error", status=500)


def _parse_head(app: Application, head: bytes, reader, writer) -> Request:
    try:
        lines = head[:-4].decode("latin-1").split("\r\n")
        method, target, version = lines[0].split(" ")
    except ValueError as err:
        raise _BadHead(f"bad request line: {err}") from err
    if version not in ("HTTP/1.1", "HTTP/1.0") or not target.startswith("/"):
        raise _BadHead(f"bad request line {lines[0]!r}")
    headers = MultiDict(ci=True)
    for line in lines[1:]:
        name, sep, value = line.partition(":")
        if not sep or not name or name != name.strip():
            raise _BadHead(f"bad header line {line!r}")
        headers.add(name, value.strip())
    return Request(app, method, target, version, headers, reader, writer)


async def _serve_connection(app: Application, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
    """Requests on one connection, one after another, until either side
    closes it or a WebSocket takes it over."""
    from pygrid_tpu_torch.web.websocket import WebSocketResponse

    while True:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, ConnectionError):
            return
        except asyncio.LimitOverrunError:
            response = Response(text="431: Request Header Fields Too Large", status=431)
            writer.write(_head_bytes(431, _with_length(response), False) + response.body)
            await writer.drain()
            return
        try:
            request = _parse_head(app, head, reader, writer)
        except _BadHead as err:
            response = Response(text=f"400: Bad Request ({err})", status=400)
            writer.write(_head_bytes(400, _with_length(response), False) + response.body)
            await writer.drain()
            return
        response = await _dispatch(app, request)
        if isinstance(response, WebSocketResponse) and response.prepared:
            await response.close()
            return
        if not isinstance(response, Response):  # a stream: its head, then its end
            await response.prepare(request)
            await response.write_eof()
        else:
            writer.write(_head_bytes(response.status, _with_length(response),
                                     request.keep_alive))
            if response.body and request.method != "HEAD":
                writer.write(response.body)
            await writer.drain()
        if not request.keep_alive or not await request._discard_body():
            return


def _with_length(response: Response) -> MultiDict:
    headers = MultiDict(response.headers.items(), ci=True)
    headers["Content-Length"] = str(len(response.body))
    return headers


class AppRunner:
    """``await setup()`` runs the app's ``on_startup`` hooks;
    ``await cleanup()`` stops its sites, ends open connections (a
    WebSocket handler sees its iteration end) and runs EVERY
    ``on_cleanup`` hook, re-raising the first failure after the last."""

    def __init__(self, app: Application, *, shutdown_timeout: float = 10.0) -> None:
        self.app = app
        self.shutdown_timeout = shutdown_timeout
        self._sites: list["TCPSite"] = []
        self._conns: set[asyncio.Task] = set()

    async def setup(self) -> None:
        for hook in self.app.on_startup:
            await hook(self.app)

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await _serve_connection(self.app, reader, writer)
        except (asyncio.CancelledError, ConnectionError):
            pass
        except Exception:
            logger.exception("connection failed")
        finally:
            self._conns.discard(task)
            writer.close()
            with contextlib.suppress(Exception, asyncio.CancelledError):
                await writer.wait_closed()

    async def cleanup(self) -> None:
        for site in list(self._sites):
            site._server.close()
        for task in list(self._conns):
            task.cancel()
        if self._conns:
            await asyncio.wait(list(self._conns), timeout=self.shutdown_timeout)
        for site in list(self._sites):
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(site._server.wait_closed(), self.shutdown_timeout)
        self._sites.clear()
        errors = []
        for hook in self.app.on_cleanup:
            try:
                await hook(self.app)
            except Exception as err:  # noqa: BLE001 — the later hooks still run
                logger.exception("on_cleanup hook %r failed", hook)
                errors.append(err)
        if errors:
            raise errors[0]


class TCPSite:
    """Listen on ``host:port``; port 0 binds a free port, read back from
    ``site.port`` once started."""

    def __init__(self, runner: AppRunner, host: str = "0.0.0.0", port: int = 8080,
                 *, shutdown_timeout: float | None = None) -> None:
        self.runner = runner
        self.host = host
        self.port = port
        if shutdown_timeout is not None:
            runner.shutdown_timeout = shutdown_timeout
        self._server: asyncio.Server | None = None

    @property
    def name(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self.runner._connection, self.host, self.port,
            limit=MAX_HEAD_BYTES, reuse_address=True,
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self.runner._sites.append(self)


def run_app(app: Application, *, host: str = "0.0.0.0", port: int = 8080,
            print: Callable[..., None] = print) -> None:
    """Serve ``app`` until SIGINT or SIGTERM, then clean it up."""

    async def _main() -> None:
        runner = AppRunner(app)
        await runner.setup()
        try:
            site = TCPSite(runner, host, port)
            await site.start()
            print(f"======== Running on {site.name} ========")
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                with contextlib.suppress(NotImplementedError, RuntimeError):
                    loop.add_signal_handler(sig, stop.set)
            await stop.wait()
        finally:
            await runner.cleanup()

    asyncio.run(_main())


class BackgroundServer:
    """One :class:`Application` on its own daemon event-loop thread bound
    to ``host:port`` (port 0: a free one, read back as ``.port``).
    ``stop()`` runs the app's cleanup on that loop, shuts its default
    executor down and joins the thread, so nothing of it stays behind."""

    def __init__(self, app: Application, host: str = "127.0.0.1", port: int = 0,
                 shutdown_timeout: float = 1.0) -> None:
        self.app = app
        self.host = host
        self.port = port
        self.loop = asyncio.new_event_loop()
        self._runner = AppRunner(app, shutdown_timeout=shutdown_timeout)
        self._started = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"pygrid-web-{id(self):x}")

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def alive(self) -> bool:
        """Whether the loop thread still runs: started and not stopped."""
        return self._thread.is_alive()

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)

        async def _start() -> None:
            await self._runner.setup()
            site = TCPSite(self._runner, self.host, self.port)
            await site.start()
            self.port = site.port

        try:
            self.loop.run_until_complete(_start())
        except BaseException as err:  # noqa: BLE001 — handed to start()
            self._error = err
        self._started.set()
        if self._error is None:
            self.loop.run_forever()
        self.loop.run_until_complete(self.loop.shutdown_default_executor())
        self.loop.close()

    def start(self, timeout: float = 30.0) -> "BackgroundServer":
        self._thread.start()
        if not self._started.wait(timeout):
            raise RuntimeError("server did not start")
        if self._error is not None:
            self._thread.join(timeout)
            raise self._error
        return self

    def stop(self, timeout: float = 30.0) -> None:
        fut = asyncio.run_coroutine_threadsafe(self._runner.cleanup(), self.loop)
        try:
            fut.result(timeout)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout)
