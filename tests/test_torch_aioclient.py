"""The port's async HTTP client (pygrid_tpu_torch.web.aioclient) against
aiohttp's server and the port's own: JSON bodies and ``params``, bodies
delimited by ``Content-Length``, by chunked transfer coding and by the
close of the connection, the total timeout against a server that never
answers, and a refused connection — each answered as aiohttp's
``ClientSession`` answers it."""

import asyncio
import socket
import threading
import time

import aiohttp
import pytest
from aiohttp import web as aioweb

from pygrid_tpu_torch import web
from test_torch_web import AioServer


def _handlers(w):
    """The same four routes on aiohttp's ``web`` (``w = aioweb``) and the
    port's (``w = web``)."""

    async def echo(request):
        body = await request.json() if request.can_read_body else None
        return w.json_response({"method": request.method, "json": body,
                                "a": request.query.getall("a", []), "b": request.query.get("b"),
                                "hdr": request.headers.get("X-Probe")})

    async def sized(request):
        n = int(request.query["n"])
        return w.Response(body=bytes(range(256)) * (n // 256) + bytes(n % 256),
                          content_type="application/octet-stream")

    async def chunked(request):
        n = int(request.query["n"])
        resp = w.StreamResponse(headers={"Content-Type": "application/json"})
        await resp.prepare(request)
        payload = ("[" + ",".join(str(i) for i in range(n)) + "]").encode()
        for i in range(0, len(payload), 7):  # many small chunks
            await resp.write(payload[i:i + 7])
        await resp.write_eof()
        return resp

    async def status(request):
        return w.json_response({"error": "nope"}, status=int(request.match_info["code"]))

    return {"/echo": echo, "/sized": sized, "/chunked": chunked, "/status/{code}": status}


def _app(w):
    app = w.Application()
    for path, handler in _handlers(w).items():
        if path == "/echo":
            app.router.add_get(path, handler)
            app.router.add_post(path, handler)
            app.router.add_delete(path, handler)
        else:
            app.router.add_get(path, handler)
    return app


@pytest.fixture(scope="module", params=["aiohttp", "port"])
def base(request):
    if request.param == "aiohttp":
        with AioServer(_app(aioweb)) as url:
            yield url
    else:
        server = web.BackgroundServer(_app(web)).start()
        yield server.url
        server.stop()


def _run(coro):
    return asyncio.run(coro)


def test_json_and_params(base):
    async def go():
        async with web.ClientSession(timeout=web.ClientTimeout(total=10)) as session:
            async with session.get(base + "/echo?a=0", params={"a": 1, "b": "x y"},
                                   headers={"X-Probe": "s"}) as r:
                got_get = (r.status, r.reason, await r.json())
            async with session.post(base + "/echo", json={"k": [1, 2.5, None]},
                                    headers={"X-Probe": "r"}) as r:
                got_post = await r.json()
            r = await session.delete(base + "/echo")
            got_del = await r.json()
        return got_get, got_post, got_del

    (status, reason, got), posted, deleted = _run(go())
    assert status == 200 and reason == "OK"
    assert got == {"method": "GET", "json": None, "a": ["0", "1"], "b": "x y", "hdr": "s"}
    assert posted == {"method": "POST", "json": {"k": [1, 2.5, None]}, "a": [], "b": None,
                      "hdr": "r"}
    assert deleted["method"] == "DELETE"


@pytest.mark.parametrize("n", [0, 1, 300, 1 << 20])
def test_content_length_body(base, n):
    async def go():
        async with web.ClientSession() as session:
            async with session.get(base + "/sized", params={"n": n}) as r:
                return r.headers.get("content-length"), await r.read()

    length, body = _run(go())
    assert int(length) == n == len(body)
    assert body == bytes(range(256)) * (n // 256) + bytes(n % 256)


def test_chunked_body(base):
    async def go():
        async with web.ClientSession() as session:
            async with session.get(base + "/chunked", params={"n": 500}) as r:
                return r.headers.get("Transfer-Encoding"), await r.json()

    coding, got = _run(go())
    assert coding == "chunked"
    assert got == list(range(500))


def test_error_status_and_content_type(base):
    async def go():
        async with web.ClientSession() as session:
            async with session.get(base + "/status/409") as r:
                body = await r.json()
                status = r.status
            async with session.get(base + "/sized", params={"n": 3}) as r:
                with pytest.raises(web.ClientError, match="unexpected mimetype"):
                    await r.json()
                loose = await r.text()
            return status, body, loose

    assert _run(go()) == (409, {"error": "nope"}, "\x00\x00\x00")


def test_same_answers_as_aiohttp_client(base):
    """The port's client and aiohttp's on the same requests: same status,
    same body bytes, same JSON."""

    async def fetch(session_cls, timeout_cls):
        async with session_cls(timeout=timeout_cls(total=10)) as session:
            out = []
            for path, params in (("/echo", {"a": 3}), ("/chunked", {"n": 40}),
                                 ("/sized", {"n": 1000}), ("/status/404", None)):
                async with session.get(base + path, params=params) as r:
                    out.append((r.status, await r.read()))
            return out

    ours = _run(fetch(web.ClientSession, web.ClientTimeout))
    theirs = _run(fetch(aiohttp.ClientSession, aiohttp.ClientTimeout))
    assert ours == theirs


class _RawServer:
    """A TCP server answering every connection with ``reply`` (then closing)
    or, with ``reply=None``, reading the request and never answering."""

    def __init__(self, reply: bytes | None):
        self.reply = reply
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self.conns = []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        self.sock.settimeout(0.05)
        while not self.stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except OSError:
                continue
            self.conns.append(conn)
            conn.recv(65536)
            if self.reply is not None:
                conn.sendall(self.reply)
                conn.close()

    def close(self):
        self.stop.set()
        self.thread.join(5)
        for c in self.conns:
            c.close()
        self.sock.close()


def test_close_delimited_body():
    """No Content-Length and no chunking: the body runs to the close of the
    connection (an HTTP/1.0-style answer)."""
    body = b'{"closed": true, "pad": "' + b"z" * 70000 + b'"}'
    raw = _RawServer(b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                     b"Connection: close\r\n\r\n" + body)
    try:
        async def go():
            async with web.ClientSession() as session:
                async with session.get(f"http://127.0.0.1:{raw.port}/x") as r:
                    return r.status, await r.read(), await r.json()

        status, got, parsed = _run(go())
    finally:
        raw.close()
    assert status == 200 and got == body and parsed["closed"] is True


def test_total_timeout_fires_against_a_silent_server():
    raw = _RawServer(None)
    try:
        async def go():
            async with web.ClientSession(timeout=web.ClientTimeout(total=0.3)) as session:
                t0 = time.monotonic()
                with pytest.raises(asyncio.TimeoutError):
                    async with session.get(f"http://127.0.0.1:{raw.port}/never"):
                        pass
                return time.monotonic() - t0

        elapsed = _run(go())
    finally:
        raw.close()
    assert 0.25 <= elapsed < 5.0


def test_per_request_timeout_overrides_the_session():
    raw = _RawServer(None)
    try:
        async def go():
            async with web.ClientSession(timeout=web.ClientTimeout(total=60)) as session:
                with pytest.raises(asyncio.TimeoutError):
                    await session.get(f"http://127.0.0.1:{raw.port}/",
                                      timeout=web.ClientTimeout(total=0.2))

        _run(go())
    finally:
        raw.close()


def test_connection_refused():
    with socket.socket() as s:  # a port nobody listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    async def go():
        async with web.ClientSession(timeout=web.ClientTimeout(total=5)) as session:
            with pytest.raises(web.ClientConnectorError) as err:
                await session.get(f"http://127.0.0.1:{port}/")
            return err.value

    err = _run(go())
    assert isinstance(err, web.ClientError) and isinstance(err, OSError)


def test_closed_session_and_bad_urls():
    async def go():
        session = web.ClientSession()
        await session.close()
        with pytest.raises(RuntimeError, match="closed"):
            await session.get("http://127.0.0.1:1/")
        async with web.ClientSession() as s2:
            with pytest.raises(ValueError):
                await s2.get("ftp://example/")
            with pytest.raises(ValueError):
                await s2.post("http://127.0.0.1:1/", json={}, data=b"x")

    _run(go())


def test_truncated_body_is_a_payload_error():
    raw = _RawServer(b"HTTP/1.1 200 OK\r\nContent-Length: 100\r\n\r\nshort")
    try:
        async def go():
            async with web.ClientSession() as session:
                with pytest.raises(web.ClientError):
                    await session.get(f"http://127.0.0.1:{raw.port}/")

        _run(go())
    finally:
        raw.close()
