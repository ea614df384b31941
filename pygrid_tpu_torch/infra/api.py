"""Deploy API — HTTP front of the provider builders; the port's counterpart
of :mod:`pygrid_tpu.infra.api`, on the port's own web layer.

Parity: reference ``apps/infrastructure/api/__main__.py:11-40`` (Flask POST
``/`` parses the CLI's config JSON, dispatches to a provider, returns
``{"message": "Deployment successful"}``). Same contract, asyncio, served
by :mod:`pygrid_tpu_torch.web` (no aiohttp beside the card)."""

from __future__ import annotations

import json


def create_app():
    from pygrid_tpu_torch import web
    from pygrid_tpu_torch.infra import handle_deploy

    async def index(request: web.Request) -> web.Response:
        try:
            data = await request.json()
            # the reference CLI double-encodes (requests.post(json=str));
            # accept both
            if isinstance(data, str):
                data = json.loads(data)
            result = handle_deploy(data)
            return web.json_response(result)
        except (ValueError, TypeError, KeyError, NotImplementedError) as err:
            return web.json_response({"error": str(err)}, status=400)

    app = web.Application()
    app.router.add_post("/", index)
    return app


def main(argv=None) -> None:
    import argparse

    from pygrid_tpu_torch import web

    parser = argparse.ArgumentParser(description="pygrid-tpu deploy API (PyTorch port)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5005)
    args = parser.parse_args(argv)
    web.run_app(create_app(), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
