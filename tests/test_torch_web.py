"""The port's HTTP/1.1 and WebSocket layer (pygrid_tpu_torch.web) against
independent peers: aiohttp's client and server, ``requests``, and the JAX
package's ``RawWSClient``/``KeepAliveHTTP``. Status codes, headers, bodies
and frames must be what those peers expect of aiohttp itself."""

import asyncio
import base64
import os
import socket
import struct
import threading

import aiohttp
import numpy as np
import pytest
import requests
from aiohttp import web as aioweb
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from pygrid_tpu.client.ws_transport import KeepAliveHTTP, RawWSClient
from pygrid_tpu_torch import web
from pygrid_tpu_torch.web import client as http
from pygrid_tpu_torch.web.websocket import accept_key

MAX_BODY = 1 << 20


async def _hello(request):
    return web.json_response({
        "a": request.query.get("a"), "all_a": request.query.getall("a", []),
        "id": request.match_info.get("id"), "x_hdr": request.headers.get("x-custom"),
        "peer_port": request._writer.get_extra_info("peername")[1],
    })


async def _echo(request):
    body = await request.read()
    return web.Response(body=body, content_type="application/octet-stream",
                        headers={"X-Len": str(len(body))})


async def _json_echo(request):
    return web.json_response({"got": await request.json(), "method": request.method})


async def _stream(request):
    size = int(request.query["size"])
    headers = {"Content-Type": "application/octet-stream"}
    if request.query.get("chunked") is None:
        headers["Content-Length"] = str(size)
    response = web.StreamResponse(headers=headers)
    await response.prepare(request)
    chunk = b"x" * min(max(size, 1), 1 << 20)
    sent = 0
    while sent < size:
        n = min(size - sent, len(chunk))
        await response.write(chunk[:n])
        sent += n
    await response.write_eof()
    return response


async def _multipart(request):
    fields = {}
    async for part in await request.multipart():
        fields[part.name] = (bytes(await part.read(decode=False)) if part.name == "blob"
                             else await part.text())
    return web.json_response({"blob": base64.b64encode(fields["blob"]).decode(),
                              "name": fields["name"]})


#: (the connection's ``tag`` query parameter, its close code) per finished
#: handler — a test reads only its own connections' codes, since another
#: test's connection on the module's server may finish later
CLOSED = []


async def _ws(request):
    ws = web.WebSocketResponse(protocols=("proto.b", "proto.a"), max_msg_size=1 << 22)
    await ws.prepare(request)
    async for msg in ws:
        if msg.type == web.WSMsgType.TEXT:
            if msg.data == "close-me":
                await ws.close(code=4000, message=b"bye")
                break
            await ws.send_str(msg.data)
        elif msg.type == web.WSMsgType.BINARY:
            await ws.send_bytes(msg.data)
    CLOSED.append((request.query.get("tag"), ws.close_code))
    return ws


def _port_app():
    app = web.Application(client_max_size=MAX_BODY)
    app.router.add_get("/hello/{id}", _hello)
    app.router.add_post("/echo", _echo)
    app.router.add_route("*", "/json", _json_echo)
    app.router.add_get("/stream", _stream)
    app.router.add_post("/multipart", _multipart)
    app.router.add_get("/ws", _ws)
    return app


@pytest.fixture(scope="module")
def server():
    srv = web.BackgroundServer(_port_app()).start()
    yield srv
    srv.stop()


class AioServer:
    """An aiohttp app on its own loop thread (the peer the port's client
    talks to)."""

    def __init__(self, app):
        self.app, self.loop = app, asyncio.new_event_loop()
        self.ready = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        asyncio.set_event_loop(self.loop)

        async def start():
            self.runner = aioweb.AppRunner(self.app, shutdown_timeout=1.0)
            await self.runner.setup()
            site = aioweb.TCPSite(self.runner, "127.0.0.1", 0)
            await site.start()
            self.port = site._server.sockets[0].getsockname()[1]

        self.loop.run_until_complete(start())
        self.ready.set()
        self.loop.run_forever()

    def __enter__(self):
        self.thread.start()
        assert self.ready.wait(15)
        return f"http://127.0.0.1:{self.port}"

    def __exit__(self, *exc):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


# --------------------------------------------------------------------------
# HTTP: the port's server against requests, aiohttp's client, KeepAliveHTTP
# --------------------------------------------------------------------------


def test_json_response_query_path_params_and_headers(server):
    r = requests.get(server.url + "/hello/7?a=1&a=2", headers={"X-CUSTOM": "v"})
    assert r.status_code == 200
    assert r.headers["Content-Type"] == "application/json; charset=utf-8"
    body = r.json()
    assert (body["a"], body["all_a"], body["id"], body["x_hdr"]) == ("1", ["1", "2"], "7", "v")


def test_router_404_405_and_413_as_aiohttp_answers_them(server):
    async def statuses(base):
        async with aiohttp.ClientSession() as s:
            out = []
            for method, path, data in (("GET", "/nope", None), ("POST", "/hello/1", None),
                                       ("GET", "/echo", None),
                                       ("POST", "/echo", b"a" * MAX_BODY),
                                       ("POST", "/echo", b"a" * (MAX_BODY - 1))):
                async with s.request(method, base + path, data=data) as r:
                    out.append((r.status, r.headers.get("Allow"), await r.read()))
            return out

    port = asyncio.run(statuses(server.url))
    aio_app = aioweb.Application(client_max_size=MAX_BODY)

    async def aio_echo(request):
        return aioweb.Response(body=await request.read())

    async def aio_hello(request):
        return aioweb.Response()

    aio_app.router.add_get("/hello/{id}", aio_hello)
    aio_app.router.add_post("/echo", aio_echo)
    with AioServer(aio_app) as base:
        ref = asyncio.run(statuses(base))
    assert [s for s, _, _ in port] == [s for s, _, _ in ref] == [404, 405, 405, 413, 200]
    assert port[1][1] == ref[1][1] == "GET,HEAD"
    assert port[0][2] == ref[0][2] == b"404: Not Found"
    assert len(port[4][2]) == MAX_BODY - 1


def test_keep_alive_across_100_requests(server):
    ka = KeepAliveHTTP(server.url)
    ports = set()
    for i in range(100):
        status, body = ka.get(f"/hello/{i}")
        assert status == 200
        ports.add(requests.models.complexjson.loads(body)["peer_port"])
    ka.close()
    assert len(ports) == 1
    # Connection: close ends it; the next request opens a new connection
    r1 = requests.get(server.url + "/hello/1", headers={"Connection": "close"})
    assert r1.headers["Connection"] == "close"
    head = requests.head(server.url + "/hello/1")
    assert head.status_code == 200 and head.content == b""
    assert int(head.headers["Content-Length"]) == len(r1.content)


@pytest.mark.parametrize("size", [0, 1, 65535, 1 << 20, 3 * 1024 * 1024 + 7])
@pytest.mark.parametrize("chunked", [False, True])
def test_stream_response_byte_counts(server, size, chunked):
    params = {"size": str(size), **({"chunked": "1"} if chunked else {})}
    r = requests.get(server.url + "/stream", params=params, stream=True)
    assert r.status_code == 200
    assert sum(len(c) for c in r.iter_content(1 << 16)) == size

    async def aio():
        async with aiohttp.ClientSession() as s:
            async with s.get(server.url + "/stream", params=params) as resp:
                return len(await resp.read())

    assert asyncio.run(aio()) == size


def test_request_bodies_json_and_multipart(server):
    r = requests.put(server.url + "/json", json={"k": [1, 2]})
    assert r.json() == {"got": {"k": [1, 2]}, "method": "PUT"}
    blob = os.urandom(5000) + b"\r\n--"
    r = requests.post(server.url + "/multipart", files={"blob": ("b.bin", blob)},
                      data={"name": "m1"})
    assert r.status_code == 200
    assert base64.b64decode(r.json()["blob"]) == blob and r.json()["name"] == "m1"
    r = requests.post(server.url + "/echo", data=b"q" * 70000)
    assert r.content == b"q" * 70000 and r.headers["X-Len"] == "70000"


def test_bad_request_line_answers_400_and_closes(server):
    with socket.create_connection(("127.0.0.1", server.port)) as s:
        s.sendall(b"NONSENSE\r\n\r\n")
        assert s.recv(100).startswith(b"HTTP/1.1 400")


# --------------------------------------------------------------------------
# the port's client against an aiohttp server
# --------------------------------------------------------------------------


def test_port_client_against_aiohttp_server():
    app = aioweb.Application()

    async def handler(request):
        body = await request.read()
        return aioweb.json_response({
            "method": request.method, "q": dict(request.query), "tok": request.headers.get("token"),
            "ctype": request.content_type, "body": body.decode("latin-1"),
        }, status=201 if request.method == "POST" else 200)

    app.router.add_route("*", "/r", handler)
    with AioServer(app) as base:
        r = http.get(base + "/r?x=1", params={"y": "2", "z": None}, headers={"token": "t"},
                     timeout=10)
        assert r.status_code == 200
        assert r.json() == {"method": "GET", "q": {"x": "1", "y": "2"}, "tok": "t",
                            "ctype": "application/octet-stream", "body": ""}
        r = http.post(base + "/r", json={"a": 1}, timeout=10)
        assert r.status_code == 201 and r.json()["ctype"] == "application/json"
        assert r.json()["body"] == '{"a": 1}'
        r = http.post(base + "/r", data=b"\x00\xff", timeout=10)
        assert r.json()["body"] == "\x00\xff"
        assert http.request("DELETE", base + "/r", timeout=10).json()["method"] == "DELETE"
        r = http.request("PUT", base + "/nope", timeout=10)
        assert r.status_code == 404 and "404" in r.text
        assert r.headers["content-type"].startswith("text/plain")


# --------------------------------------------------------------------------
# WebSocket
# --------------------------------------------------------------------------


def _ws_url(server):
    return server.url.replace("http", "ws") + "/ws"


def test_handshake_accept_and_subprotocol_choice(server):
    assert accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="  # RFC 6455 §1.3
    for offers, chosen in ((["proto.a", "proto.b"], "proto.a"), (["x", "proto.b"], "proto.b"),
                           (["x"], None), ([], None)):
        c = RawWSClient(_ws_url(server), subprotocols=offers)
        assert c.subprotocol == chosen
        c.send("hi")
        assert c.recv(timeout=5) == "hi"
        c.close()

    async def aio():
        async with aiohttp.ClientSession() as s:
            async with s.ws_connect(_ws_url(server), protocols=("proto.b", "proto.a")) as w:
                return w.protocol

    assert asyncio.run(aio()) == "proto.b"
    r = requests.get(_ws_url(server).replace("ws", "http", 1),
                     headers={"Upgrade": "websocket", "Connection": "Upgrade"})
    assert r.status_code == 400  # no key, no version


def _frame(opcode, payload, fin=True, mask=True):
    n = len(payload)
    b0 = (0x80 if fin else 0) | opcode
    mbit = 0x80 if mask else 0
    if n < 126:
        head = struct.pack("!BB", b0, mbit | n)
    elif n < 1 << 16:
        head = struct.pack("!BBH", b0, mbit | 126, n)
    else:
        head = struct.pack("!BBQ", b0, mbit | 127, n)
    if not mask:
        return head + payload
    key = os.urandom(4)
    arr = np.frombuffer(payload, np.uint8) ^ np.resize(np.frombuffer(key, np.uint8), n)
    return head + key + arr.tobytes()


def _read_frame(sock_file):
    b0, b1 = sock_file.read(2)
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack("!H", sock_file.read(2))
    elif n == 127:
        (n,) = struct.unpack("!Q", sock_file.read(8))
    return b0 & 0x0F, sock_file.read(n)


BOUNDARY = st.sampled_from([0, 1, 124, 125, 126, 127, 65534, 65535, 65536, 65537])


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(sizes=st.lists(BOUNDARY | st.integers(0, 70000), min_size=1, max_size=3),
       binary=st.booleans(), ping_between=st.booleans())
def test_payload_lengths_and_fragmentation_roundtrip(server, sizes, binary, ping_between):
    """A message of fragments whose lengths sit on the 7/16/64-bit length
    boundaries comes back whole (the echo itself crosses the same
    boundaries in the server's frames); a ping between fragments is
    answered in between."""
    rng = np.random.default_rng(sum(sizes))
    parts = [rng.integers(97, 123, n, dtype=np.uint8).tobytes() for n in sizes]
    c = RawWSClient(_ws_url(server))
    try:
        opcode = 0x2 if binary else 0x1
        for i, part in enumerate(parts):
            c._sock.sendall(_frame(opcode if i == 0 else 0x0, part, fin=i == len(parts) - 1))
            if ping_between and i == 0:
                c._sock.sendall(_frame(0x9, b"pp"))
        got = c.recv(timeout=10)
        want = b"".join(parts)
        assert got == (want if binary else want.decode())
    finally:
        c.close()


def test_ping_pong_and_close_handshake(server):
    url = _ws_url(server) + "?tag=ping-pong"

    async def aio():
        async with aiohttp.ClientSession() as s:
            w = await s.ws_connect(url, autoping=False)
            await w.ping(b"abc")
            pong = await w.receive()
            await w.send_bytes(b"z" * 70000)
            echo = await w.receive()
            ok = await w.close()
            return pong, echo, ok, w.close_code

    CLOSED.clear()
    pong, echo, ok, code = asyncio.run(aio())
    assert pong.type == aiohttp.WSMsgType.PONG and pong.data == b"abc"
    assert echo.data == b"z" * 70000
    assert ok and code == 1000
    # a server-initiated close carries its code to the client
    c = RawWSClient(url)
    c.send("close-me")
    with pytest.raises(ConnectionError, match="close"):
        c.recv(timeout=5)
    c.close()
    deadline = threading.Event()
    for _ in range(50):
        if len([t for t, _ in CLOSED if t == "ping-pong"]) >= 2:
            break
        deadline.wait(0.05)
    assert [code for t, code in CLOSED if t == "ping-pong"] == [1000, 4000]


@pytest.mark.parametrize("bad, code", [
    (lambda: _frame(0x1, b"unmasked", mask=False), 1002),
    # a length past max_msg_size is refused from the header alone
    (lambda: struct.pack("!BBQ", 0x82, 0x80 | 127, (1 << 22) + 1) + os.urandom(4), 1009),
    (lambda: _frame(0x0, b"cont-without-start"), 1002),
    (lambda: _frame(0x1, b"\xff\xfe"), 1007),
])
def test_protocol_errors_close_with_their_code(server, bad, code):
    c = RawWSClient(_ws_url(server))
    f = c._sock.makefile("rb")
    c._sock.sendall(bad())
    opcode, payload = _read_frame(f)
    assert opcode == 0x8 and struct.unpack("!H", payload[:2])[0] == code
    f.close()
    c.close()
