"""User/role/group WS event handlers — shared by Node and Network.

Parity surface: the reference implements these twice with the same pattern
(``apps/node/src/app/main/events/{user,role,group}_related.py`` and
``apps/network/src/app/events/*``); here one table serves both apps. A
handler takes any context exposing ``.users`` (a
:class:`pygrid_tpu_torch.users.UserManager`) plus the raw message dict.

The port's copy of :mod:`pygrid_tpu.users.events`. :func:`http_twin` is
the HTTP door the Network serves these handlers through (the node serves
them through its own routes, ``node/routes.py``), on the port's
:mod:`pygrid_tpu_torch.web`."""

from __future__ import annotations

from dataclasses import asdict
from typing import Any, Callable

from pygrid_tpu_torch.utils import exceptions as E
from pygrid_tpu_torch.utils.codes import (
    CYCLE,
    GROUP_EVENTS,
    MSG_FIELD,
    ROLE_EVENTS,
    USER_EVENTS,
)

SUCCESS = "success"
ERROR = "error"


def serializable(obj: Any) -> Any:
    """Dataclass → dict with secret fields stripped."""
    if hasattr(obj, "__dataclass_fields__"):
        d = asdict(obj)
        d.pop("hashed_password", None)
        d.pop("salt", None)
        d.pop("private_key", None)
        return d
    return obj


def _user_op(fn: Callable) -> Callable:
    """Wrap a UserManager call: resolve the token, format the response."""

    def wrapper(ctx: Any, message: dict, conn: Any = None) -> dict:
        data = message.get(MSG_FIELD.DATA) or message
        try:
            current = ctx.users.resolve_token(data.get("token"))
            result = fn(ctx, current, data)
            if isinstance(result, list):
                result = [serializable(r) for r in result]
            else:
                result = serializable(result)
            return {CYCLE.STATUS: SUCCESS, MSG_FIELD.DATA: result}
        except E.PyGridError as err:
            return {ERROR: str(err)}

    return wrapper


def signup_user(ctx: Any, message: dict, conn: Any = None) -> dict:
    data = message.get(MSG_FIELD.DATA) or message
    try:
        user = ctx.users.signup(
            data.get("email"),
            data.get("password"),
            role=data.get("role"),
            private_key=data.get("private-key"),
        )
        return {CYCLE.STATUS: SUCCESS, "user": serializable(user)}
    except E.PyGridError as err:
        return {ERROR: str(err)}


def login_user(ctx: Any, message: dict, conn: Any = None) -> dict:
    data = message.get(MSG_FIELD.DATA) or message
    try:
        token = ctx.users.login(
            data.get("email"),
            data.get("password"),
            private_key=data.get("private-key"),
        )
        return {CYCLE.STATUS: SUCCESS, "token": token}
    except E.PyGridError as err:
        return {ERROR: str(err)}


USER_HANDLERS: dict[str, Callable] = {
    USER_EVENTS.SIGNUP_USER: signup_user,
    USER_EVENTS.LOGIN_USER: login_user,
    USER_EVENTS.GET_ALL_USERS: _user_op(
        lambda ctx, cur, d: ctx.users.get_all_users(cur)
    ),
    USER_EVENTS.GET_SPECIFIC_USER: _user_op(
        lambda ctx, cur, d: ctx.users.get_user(cur, int(d["id"]))
    ),
    USER_EVENTS.SEARCH_USERS: _user_op(
        lambda ctx, cur, d: ctx.users.search_users(
            cur, **{k: v for k, v in d.items() if k in ("email", "role")}
        )
    ),
    USER_EVENTS.PUT_EMAIL: _user_op(
        lambda ctx, cur, d: ctx.users.change_email(cur, int(d["id"]), d["email"])
    ),
    USER_EVENTS.PUT_PASSWORD: _user_op(
        lambda ctx, cur, d: ctx.users.change_password(
            cur, int(d["id"]), d["password"]
        )
    ),
    USER_EVENTS.PUT_ROLE: _user_op(
        lambda ctx, cur, d: ctx.users.change_role(cur, int(d["id"]), d["role"])
    ),
    USER_EVENTS.PUT_GROUPS: _user_op(
        lambda ctx, cur, d: ctx.users.change_groups(
            cur, int(d["id"]), d["groups"]
        )
    ),
    USER_EVENTS.DELETE_USER: _user_op(
        lambda ctx, cur, d: ctx.users.delete_user(cur, int(d["id"]))
    ),
    ROLE_EVENTS.CREATE_ROLE: _user_op(
        lambda ctx, cur, d: ctx.users.create_role(
            cur, **{k: v for k, v in d.items() if k != "token"}
        )
    ),
    ROLE_EVENTS.GET_ROLE: _user_op(
        lambda ctx, cur, d: ctx.users.get_role(cur, int(d["id"]))
    ),
    ROLE_EVENTS.GET_ALL_ROLES: _user_op(
        lambda ctx, cur, d: ctx.users.get_all_roles(cur)
    ),
    ROLE_EVENTS.PUT_ROLE: _user_op(
        lambda ctx, cur, d: ctx.users.put_role(
            cur, int(d["id"]),
            **{k: v for k, v in d.items() if k not in ("token", "id")},
        )
    ),
    ROLE_EVENTS.DELETE_ROLE: _user_op(
        lambda ctx, cur, d: ctx.users.delete_role(cur, int(d["id"]))
    ),
    GROUP_EVENTS.CREATE_GROUP: _user_op(
        lambda ctx, cur, d: ctx.users.create_group(cur, d["name"])
    ),
    GROUP_EVENTS.GET_GROUP: _user_op(
        lambda ctx, cur, d: ctx.users.get_group(cur, int(d["id"]))
    ),
    GROUP_EVENTS.GET_ALL_GROUPS: _user_op(
        lambda ctx, cur, d: ctx.users.get_all_groups(cur)
    ),
    GROUP_EVENTS.PUT_GROUP: _user_op(
        lambda ctx, cur, d: ctx.users.put_group(
            cur, int(d["id"]),
            **{k: v for k, v in d.items() if k not in ("token", "id")},
        )
    ),
    GROUP_EVENTS.DELETE_GROUP: _user_op(
        lambda ctx, cur, d: ctx.users.delete_group(cur, int(d["id"]))
    ),
}



def http_twin(event_type: str, ctx_key: str):
    """HTTP twin of a user/role/group WS event, shared by Node
    (``app["node"]``) and Network (``app["network"]``).

    Path parameters take precedence over JSON body keys (the URL names the
    resource; a body ``id`` must not silently retarget it), and malformed
    input maps to 400, not 500."""
    import json

    from pygrid_tpu_torch import web

    async def handler(request):
        ctx = request.app[ctx_key]
        try:
            body = (
                json.loads(await request.text())
                if request.can_read_body
                else {}
            )
            if not isinstance(body, dict):
                # typed, like every protocol-boundary defect: a bare
                # ValueError here would be indistinguishable from an
                # internal bug to middleware and tests
                raise E.PyGridError("JSON object body required")
        except (
            json.JSONDecodeError,
            UnicodeDecodeError,  # request.text() on undecodable bytes
            E.PyGridError,
        ) as err:
            return web.json_response({ERROR: str(err)}, status=400)
        token = request.headers.get("token")
        if token and "token" not in body:
            body["token"] = token
        body.update(request.match_info)
        try:
            response = USER_HANDLERS[event_type](ctx, {MSG_FIELD.DATA: body})
        except (ValueError, KeyError, TypeError, AttributeError) as err:
            return web.json_response({ERROR: str(err)}, status=400)
        status = 200 if ERROR not in response else 400
        return web.json_response(response, status=status)

    return handler
