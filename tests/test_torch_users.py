"""The port's users/ (RBAC: roles, signup/login, JWT tokens, gated CRUD)
against the JAX package's: every case of ``tests/unit/test_users.py`` on the
port's ``UserManager``, both packages' WS handlers on the same operations
giving the same responses, and tokens, password digests and rows made by
either package valid in the other."""

import pytest

from pygrid_tpu.storage.warehouse import Database as JDatabase
from pygrid_tpu.users import UserManager as JUserManager
from pygrid_tpu.users.events import USER_HANDLERS as J_HANDLERS
from pygrid_tpu.utils.exceptions import InvalidCredentialsError as JInvalidCredentialsError
from pygrid_tpu_torch.storage.warehouse import Database
from pygrid_tpu_torch.users import UserManager
from pygrid_tpu_torch.users.events import USER_HANDLERS
from pygrid_tpu_torch.utils.codes import GROUP_EVENTS, ROLE_EVENTS, USER_EVENTS
from pygrid_tpu_torch.utils.exceptions import (
    AuthorizationError,
    GroupNotFoundError,
    InvalidCredentialsError,
    RoleNotFoundError,
    UserNotFoundError,
)

SECRET = "test-secret"


@pytest.fixture
def um():
    return UserManager(Database(":memory:"), secret_key=SECRET)


@pytest.fixture
def owner(um):
    return um.signup("owner@node.org", "pw-owner")


def test_seed_roles(um):
    names = [r.name for r in um.roles.query()]
    assert names == ["User", "Compliance Officer", "Administrator", "Owner"]
    owner_role = um.roles.first(name="Owner")
    assert owner_role.can_edit_roles and owner_role.can_manage_nodes
    user_role = um.roles.first(name="User")
    assert not any(
        getattr(user_role, f)
        for f in vars(user_role)
        if f.startswith("can_")
    )


def test_first_user_is_owner(um, owner):
    assert um.role_of(owner).name == "Owner"


def test_second_user_defaults_to_user_role(um, owner):
    u = um.signup("ds@node.org", "pw")
    assert um.role_of(u).name == "User"


def test_creator_can_assign_role(um, owner):
    admin_role = um.roles.first(name="Administrator")
    u = um.signup(
        "admin@node.org", "pw", role=admin_role.id,
        private_key=owner.private_key,
    )
    assert um.role_of(u).name == "Administrator"


def test_unprivileged_cannot_assign_role(um, owner):
    u = um.signup("pleb@node.org", "pw")
    admin_role = um.roles.first(name="Administrator")
    u2 = um.signup(
        "sneaky@node.org", "pw", role=admin_role.id, private_key=u.private_key
    )
    assert um.role_of(u2).name == "User"  # silently demoted, per reference


def test_login_and_token_roundtrip(um, owner):
    token = um.login("owner@node.org", "pw-owner")
    assert um.resolve_token(token).id == owner.id
    with pytest.raises(InvalidCredentialsError):
        um.login("owner@node.org", "wrong")
    with pytest.raises(InvalidCredentialsError):
        um.resolve_token("not.a.token")


def test_read_gates(um, owner):
    pleb = um.signup("pleb@node.org", "pw")
    assert len(um.get_all_users(owner)) == 2
    with pytest.raises(AuthorizationError):
        um.get_all_users(pleb)
    with pytest.raises(AuthorizationError):
        um.get_user(pleb, owner.id)
    assert um.get_user(owner, pleb.id).email == "pleb@node.org"


def test_self_edit_allowed_other_edit_gated(um, owner):
    pleb = um.signup("pleb@node.org", "pw")
    um.change_email(pleb, pleb.id, "new@node.org")
    assert um.users.first(id=pleb.id).email == "new@node.org"
    other = um.signup("other@node.org", "pw")
    with pytest.raises(AuthorizationError):
        um.change_email(pleb, other.id, "hax@node.org")
    um.change_email(owner, other.id, "fixed@node.org")


def test_password_change_relogin(um, owner):
    um.change_password(owner, owner.id, "pw2")
    with pytest.raises(InvalidCredentialsError):
        um.login("owner@node.org", "pw-owner")
    assert um.login("owner@node.org", "pw2")


def test_owner_role_protections(um, owner):
    pleb = um.signup("pleb@node.org", "pw")
    admin = um.signup(
        "adm@node.org", "pw",
        role=um.roles.first(name="Administrator").id,
        private_key=owner.private_key,
    )
    # user id 1 (Owner account) immutable
    with pytest.raises(AuthorizationError):
        um.change_role(owner, owner.id, um.roles.first(name="User").id)
    # only Owners mint Owners
    with pytest.raises(AuthorizationError):
        um.change_role(admin, pleb.id, um.roles.first(name="Owner").id)
    um.change_role(owner, pleb.id, um.roles.first(name="Owner").id)
    assert um.role_of(um.users.first(id=pleb.id)).name == "Owner"


def test_role_crud_gates(um, owner):
    pleb = um.signup("pleb@node.org", "pw")
    with pytest.raises(AuthorizationError):
        um.create_role(pleb, name="Evil")
    role = um.create_role(owner, name="Auditor", can_triage_requests=True)
    assert um.get_role(owner, role.id).name == "Auditor"
    um.put_role(owner, role.id, name="Auditor2")
    assert um.roles.first(id=role.id).name == "Auditor2"
    um.delete_role(owner, role.id)
    with pytest.raises(RoleNotFoundError):
        um.get_role(owner, role.id)


def test_group_crud_and_membership(um, owner):
    g1 = um.create_group(owner, "hospital-a")
    g2 = um.create_group(owner, "hospital-b")
    pleb = um.signup("pleb@node.org", "pw")
    um.change_groups(owner, pleb.id, [g1.id, g2.id])
    assert {g.name for g in um.user_groups(pleb.id)} == {
        "hospital-a", "hospital-b"
    }
    um.change_groups(owner, pleb.id, [g2.id])
    assert [g.name for g in um.user_groups(pleb.id)] == ["hospital-b"]
    with pytest.raises(GroupNotFoundError):
        um.change_groups(owner, pleb.id, [999])
    um.delete_group(owner, g2.id)
    assert um.user_groups(pleb.id) == []
    with pytest.raises(AuthorizationError):
        um.create_group(pleb, "x")


def test_delete_user(um, owner):
    pleb = um.signup("pleb@node.org", "pw")
    um.delete_user(owner, pleb.id)
    with pytest.raises(UserNotFoundError):
        um.get_user(owner, pleb.id)


# --------------------------------------------------------------------------
# across the two packages
# --------------------------------------------------------------------------


class _Ctx:
    def __init__(self, users):
        self.users = users


def _script():
    """(event, data) pairs a node's users/ routes would dispatch; ``{tok}``
    is the owner's token, ``{pleb}`` the second user's."""
    return [
        (USER_EVENTS.SIGNUP_USER, {"email": "o@n.org", "password": "pw"}),
        (USER_EVENTS.SIGNUP_USER, {"email": "p@n.org", "password": "pw2"}),
        (USER_EVENTS.LOGIN_USER, {"email": "o@n.org", "password": "bad"}),
        (USER_EVENTS.GET_ALL_USERS, {"token": "{tok}"}),
        (USER_EVENTS.GET_ALL_USERS, {"token": "{pleb}"}),
        (USER_EVENTS.GET_SPECIFIC_USER, {"token": "{tok}", "id": "2"}),
        (USER_EVENTS.GET_SPECIFIC_USER, {"token": "{tok}", "id": "9"}),
        (USER_EVENTS.SEARCH_USERS, {"token": "{tok}", "email": "p@n.org"}),
        (USER_EVENTS.PUT_EMAIL, {"token": "{pleb}", "id": "2", "email": "q@n.org"}),
        (USER_EVENTS.PUT_EMAIL, {"token": "{pleb}", "id": "1", "email": "x@n.org"}),
        (USER_EVENTS.PUT_ROLE, {"token": "{tok}", "id": "1", "role": 1}),
        (USER_EVENTS.PUT_ROLE, {"token": "{tok}", "id": "2", "role": 3}),
        (ROLE_EVENTS.CREATE_ROLE, {"token": "{tok}", "name": "Auditor",
                                   "can_triage_requests": True}),
        (ROLE_EVENTS.CREATE_ROLE, {"token": "{pleb}", "name": "Evil"}),
        (ROLE_EVENTS.GET_ALL_ROLES, {"token": "{tok}"}),
        (ROLE_EVENTS.PUT_ROLE, {"token": "{tok}", "id": "5", "name": "Auditor2"}),
        (ROLE_EVENTS.GET_ROLE, {"token": "{tok}", "id": "5"}),
        (ROLE_EVENTS.DELETE_ROLE, {"token": "{tok}", "id": "5"}),
        (ROLE_EVENTS.GET_ROLE, {"token": "{tok}", "id": "5"}),
        (GROUP_EVENTS.CREATE_GROUP, {"token": "{tok}", "name": "hospital-a"}),
        (GROUP_EVENTS.GET_ALL_GROUPS, {"token": "{tok}"}),
        (GROUP_EVENTS.PUT_GROUP, {"token": "{tok}", "id": "1", "name": "hospital-b"}),
        (USER_EVENTS.PUT_GROUPS, {"token": "{tok}", "id": "2", "groups": [1]}),
        (USER_EVENTS.PUT_GROUPS, {"token": "{tok}", "id": "2", "groups": [7]}),
        (GROUP_EVENTS.DELETE_GROUP, {"token": "{tok}", "id": "1"}),
        (USER_EVENTS.DELETE_USER, {"token": "{tok}", "id": "2"}),
        (USER_EVENTS.GET_ALL_USERS, {"token": "garbage"}),
        (USER_EVENTS.GET_ALL_USERS, {}),
    ]


def _run(handlers, ctx):
    out, tokens = [], {}
    for event, data in _script():
        data = {k: (v.format(**tokens) if isinstance(v, str) and "{" in v else v)
                for k, v in data.items()}
        out.append(handlers[event](ctx, {"data": data}))
        if event == USER_EVENTS.SIGNUP_USER:
            email, pw = data["email"], data["password"]
            key = "tok" if "tok" not in tokens else "pleb"
            tokens[key] = ctx.users.login(email, pw)
    return out


def _masked(response):
    """A response with the random fields (private keys) blanked."""
    if isinstance(response, dict):
        return {k: ("*" if k == "private_key" else _masked(v)) for k, v in response.items()}
    if isinstance(response, list):
        return [_masked(v) for v in response]
    return response


def test_both_packages_answer_the_same_operations_alike():
    jax_out = _run(J_HANDLERS, _Ctx(JUserManager(JDatabase(":memory:"), secret_key=SECRET)))
    port_out = _run(USER_HANDLERS, _Ctx(UserManager(Database(":memory:"), secret_key=SECRET)))
    assert len(port_out) == len(jax_out) == len(_script())
    for i, (j, p) in enumerate(zip(jax_out, port_out)):
        assert _masked(p) == _masked(j), (i, _script()[i][0])
    assert sum("error" in r for r in port_out) >= 8  # the gates were exercised


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_tokens_and_rows_valid_in_the_other_package(tmp_path, direction):
    """One sqlite file: users signed up by one package log in through the
    other (same salt and pbkdf2 digest), and a token minted by either
    resolves in the other under the same secret."""
    path = str(tmp_path / "users.db")
    make, read = ((JUserManager, JDatabase), (UserManager, Database))
    if direction == "port_to_jax":
        make, read = read, make
    writer = make[0](make[1](path), secret_key=SECRET)
    owner = writer.signup("owner@node.org", "pw-owner")
    writer.signup("ds@node.org", "pw-ds")
    token = writer.login("ds@node.org", "pw-ds")
    reader = read[0](read[1](path), secret_key=SECRET)
    assert [r.name for r in reader.roles.query()] == [
        "User", "Compliance Officer", "Administrator", "Owner"]
    assert reader.resolve_token(token).email == "ds@node.org"
    back = reader.login("owner@node.org", "pw-owner")
    assert writer.resolve_token(back).id == owner.id
    assert reader.role_of(reader.users.first(id=owner.id)).name == "Owner"
    refused = (InvalidCredentialsError, JInvalidCredentialsError)
    with pytest.raises(refused):
        reader.login("ds@node.org", "wrong")
    other = read[0](read[1](":memory:"), secret_key="another-secret")
    with pytest.raises(refused):
        other.resolve_token(token)
