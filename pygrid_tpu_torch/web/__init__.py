"""The port's own HTTP/1.1 and WebSocket layer, on ``asyncio`` and the
standard library.

The JAX package's apps are aiohttp servers and its clients call
``requests``; neither is installed beside the card. This package covers
exactly the surface the port's apps use, under aiohttp's names so the
handlers read the same:

- :mod:`.server` — ``Application`` (``app[key]``, a router with ``{name}``
  path parameters, middlewares, ``on_startup``/``on_cleanup``,
  ``client_max_size``), ``Request``, ``Response``/``json_response``/
  ``StreamResponse``, the ``HTTPException`` family, and ``AppRunner``/
  ``TCPSite``/``run_app`` (HTTP/1.1 keep-alive, ``Content-Length``
  bodies), plus :class:`~.server.BackgroundServer` for one app on its own
  loop thread;
- :mod:`.websocket` — the RFC 6455 server side (``WebSocketResponse``,
  ``WSMsgType``);
- :mod:`.client` — the ``requests`` calls the clients make
  (``get``/``post``/``put``/``delete``) over ``http.client``;
- :mod:`.aioclient` — the ``aiohttp.ClientSession`` calls the network and
  the sub-aggregator make from their event loops (``ClientSession``,
  ``ClientTimeout``, ``ClientError``), on ``asyncio`` streams.
"""

from pygrid_tpu_torch.web.aioclient import (  # noqa: F401
    ClientConnectorError,
    ClientError,
    ClientResponse,
    ClientSession,
    ClientTimeout,
)
from pygrid_tpu_torch.web.server import (  # noqa: F401
    AppRunner,
    Application,
    BackgroundServer,
    HTTPBadRequest,
    HTTPException,
    HTTPMethodNotAllowed,
    HTTPNotFound,
    HTTPRequestEntityTooLarge,
    Request,
    Response,
    StreamResponse,
    TCPSite,
    json_response,
    middleware,
    run_app,
)
from pygrid_tpu_torch.web.websocket import (  # noqa: F401
    WebSocketResponse,
    WSMessage,
    WSMsgType,
)
