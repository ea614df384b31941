"""User/role/group operations with role-boolean permission gates.

Parity surface: reference ``apps/node/src/app/main/users/{user_ops,role_ops,
group_ops}.py`` — the same gate per operation (reads gated on
``can_triage_requests``; user mutations on ``can_create_users`` unless
self-editing; role mutations on ``can_edit_roles``; group mutations on
``can_create_groups``), first-user-auto-Owner signup
(``user_ops.py:69-81``), Owner-protection rules in ``change_user_role``
(user id 1 immutable, only Owners mint Owners), and HS256 login tokens
(``user_ops.py:120-135``). Passwords: pbkdf2-HMAC-SHA256 with per-user salt
(the image has no bcrypt; same salt+hash storage shape).
"""

from __future__ import annotations

import hmac
import secrets

from pygrid_tpu_torch.federated.auth import jwt_encode, jwt_verify
from pygrid_tpu_torch.utils.passwords import hash_password, pbkdf2
from pygrid_tpu_torch.storage.warehouse import Database, Warehouse
from pygrid_tpu_torch.users.schemas import Group, Role, User, UserGroup
from pygrid_tpu_torch.utils.exceptions import (
    AuthorizationError,
    GroupNotFoundError,
    InvalidCredentialsError,
    MissingRequestKeyError,
    RoleNotFoundError,
    UserNotFoundError,
)

#: the four seeded roles (reference app/__init__.py:79-129)
_SEED_ROLES = [
    dict(name="User"),
    dict(name="Compliance Officer", can_triage_requests=True),
    dict(
        name="Administrator",
        can_triage_requests=True,
        can_edit_settings=True,
        can_create_users=True,
        can_create_groups=True,
        can_upload_data=True,
    ),
    dict(
        name="Owner",
        can_triage_requests=True,
        can_edit_settings=True,
        can_create_users=True,
        can_create_groups=True,
        can_edit_roles=True,
        can_manage_infrastructure=True,
        can_upload_data=True,
        can_manage_nodes=True,
    ),
]


def salt_and_hash_password(password: str, salt: str | None = None):
    """Hex (salt, digest) over the shared pbkdf2 helper — the User schema
    stores both as TEXT columns (reference user.py salt/hashed_password)."""
    if salt is None:
        salt_bytes, digest = hash_password(password)
        return salt_bytes.hex(), digest.hex()
    return salt, pbkdf2(password, bytes.fromhex(salt)).hex()


def seed_roles(db: Database) -> None:
    roles = Warehouse(Role, db)
    if roles.count() == 0:
        for spec in _SEED_ROLES:
            roles.register(**spec)


class UserManager:
    """All RBAC operations for one app (node or network)."""

    def __init__(self, db: Database, secret_key: str | None = None) -> None:
        self.users = Warehouse(User, db)
        self.roles = Warehouse(Role, db)
        self.groups = Warehouse(Group, db)
        self.usergroups = Warehouse(UserGroup, db)
        self.secret_key = secret_key or secrets.token_hex(16)
        seed_roles(db)

    # ── internals ─────────────────────────────────────────────────────────

    def role_of(self, user: User) -> Role:
        role = self.roles.first(id=user.role)
        if role is None:
            raise RoleNotFoundError()
        return role

    def _require(self, user: User, permission: str) -> Role:
        role = self.role_of(user)
        if not getattr(role, permission):
            raise AuthorizationError()
        return role

    def identify_user(self, private_key: str | None) -> tuple[User, Role]:
        if private_key is None:
            raise MissingRequestKeyError()
        user = self.users.first(private_key=private_key)
        if user is None:
            raise UserNotFoundError()
        return user, self.role_of(user)

    # ── signup / login / token resolution ────────────────────────────────

    def signup(
        self,
        email: str,
        password: str,
        role: int | None = None,
        private_key: str | None = None,
    ) -> User:
        """First user becomes Owner; an authenticated can_create_users caller
        may pick the new user's role; everyone else lands on 'User'
        (reference user_ops.py:54-107)."""
        creator = creator_role = None
        if private_key is not None:
            creator, creator_role = self.identify_user(private_key)

        new_key = secrets.token_hex(32)
        salt, hashed = salt_and_hash_password(password)

        if self.users.count() == 0:
            assigned = self._role_id_by_name("Owner")
        elif (
            role is not None
            and creator_role is not None
            and creator_role.can_create_users
        ):
            if self.roles.first(id=role) is None:
                raise RoleNotFoundError()
            assigned = int(role)
        else:
            assigned = self._role_id_by_name("User")

        return self.users.register(
            email=email,
            hashed_password=hashed,
            salt=salt,
            private_key=new_key,
            role=assigned,
        )

    def _role_id_by_name(self, name: str) -> int:
        role = self.roles.first(name=name)
        if role is None:
            raise RoleNotFoundError()
        return role.id

    def login(
        self, email: str, password: str, private_key: str | None = None
    ) -> str:
        filters = {"email": email}
        if private_key is not None:
            filters["private_key"] = private_key
        user = self.users.first(**filters)
        if user is None:
            raise InvalidCredentialsError()
        _, hashed = salt_and_hash_password(password, user.salt)
        if not hmac.compare_digest(hashed, user.hashed_password):
            raise InvalidCredentialsError()
        return jwt_encode({"id": user.id}, secret=self.secret_key)

    def resolve_token(self, token: str | None) -> User:
        """JWT → User (reference auth.py token_required_factory:22-52)."""
        if token is None:
            raise MissingRequestKeyError()
        try:
            data = jwt_verify(token, secret=self.secret_key)
        except Exception as err:
            raise InvalidCredentialsError() from err
        user = self.users.first(id=data.get("id"))
        if user is None:
            raise UserNotFoundError()
        return user

    # ── user CRUD (gated) ─────────────────────────────────────────────────

    def get_all_users(self, current: User) -> list[User]:
        self._require(current, "can_triage_requests")
        return self.users.query()

    def get_user(self, current: User, user_id: int) -> User:
        self._require(current, "can_triage_requests")
        user = self.users.first(id=user_id)
        if user is None:
            raise UserNotFoundError()
        return user

    def search_users(self, current: User, **filters) -> list[User]:
        self._require(current, "can_triage_requests")
        return self.users.query(**filters)

    def _editable(self, current: User, user_id: int) -> User:
        if user_id != current.id:
            self._require(current, "can_create_users")
        user = self.users.first(id=user_id)
        if user is None:
            raise UserNotFoundError()
        return user

    def change_email(self, current: User, user_id: int, email: str) -> User:
        self._editable(current, user_id)
        self.users.modify({"id": user_id}, {"email": email})
        return self.users.first(id=user_id)

    def change_password(
        self, current: User, user_id: int, password: str
    ) -> User:
        self._editable(current, user_id)
        salt, hashed = salt_and_hash_password(password)
        self.users.modify(
            {"id": user_id}, {"salt": salt, "hashed_password": hashed}
        )
        return self.users.first(id=user_id)

    def change_role(self, current: User, user_id: int, role: int) -> User:
        if user_id == 1:  # the Owner account's role is immutable
            raise AuthorizationError()
        self._editable(current, user_id)
        owner_role_id = self._role_id_by_name("Owner")
        current_role = self.role_of(current)
        # only Owners may mint Owners (reference user_ops.py:184-186)
        if int(role) == owner_role_id and current_role.name != "Owner":
            raise AuthorizationError()
        if self.roles.first(id=role) is None:
            raise RoleNotFoundError()
        self.users.modify({"id": user_id}, {"role": int(role)})
        return self.users.first(id=user_id)

    def change_groups(
        self, current: User, user_id: int, groups: list[int]
    ) -> None:
        self._editable(current, user_id)
        for g in groups:
            if self.groups.first(id=g) is None:
                raise GroupNotFoundError()
        self.usergroups.delete(user=user_id)
        for g in groups:
            self.usergroups.register(user=user_id, group=int(g))

    def user_groups(self, user_id: int) -> list[Group]:
        links = self.usergroups.query(user=user_id)
        return [self.groups.first(id=link.group) for link in links]

    def delete_user(self, current: User, user_id: int) -> None:
        if user_id != current.id:
            self._require(current, "can_create_users")
        if self.users.first(id=user_id) is None:
            raise UserNotFoundError()
        self.usergroups.delete(user=user_id)
        self.users.delete(id=user_id)

    # ── role CRUD (gated) ─────────────────────────────────────────────────

    def create_role(self, current: User, **fields) -> Role:
        self._require(current, "can_edit_roles")
        return self.roles.register(**fields)

    def get_role(self, current: User, role_id: int) -> Role:
        self._require(current, "can_triage_requests")
        role = self.roles.first(id=role_id)
        if role is None:
            raise RoleNotFoundError()
        return role

    def get_all_roles(self, current: User) -> list[Role]:
        self._require(current, "can_triage_requests")
        return self.roles.query()

    def put_role(self, current: User, role_id: int, **fields) -> Role:
        self._require(current, "can_edit_roles")
        if self.roles.first(id=role_id) is None:
            raise RoleNotFoundError()
        self.roles.modify({"id": role_id}, fields)
        return self.roles.first(id=role_id)

    def delete_role(self, current: User, role_id: int) -> None:
        self._require(current, "can_edit_roles")
        if self.roles.first(id=role_id) is None:
            raise RoleNotFoundError()
        self.roles.delete(id=role_id)

    # ── group CRUD (gated) ────────────────────────────────────────────────

    def create_group(self, current: User, name: str) -> Group:
        self._require(current, "can_create_groups")
        return self.groups.register(name=name)

    def get_group(self, current: User, group_id: int) -> Group:
        self._require(current, "can_triage_requests")
        group = self.groups.first(id=group_id)
        if group is None:
            raise GroupNotFoundError()
        return group

    def get_all_groups(self, current: User) -> list[Group]:
        self._require(current, "can_triage_requests")
        return self.groups.query()

    def put_group(self, current: User, group_id: int, **fields) -> Group:
        self._require(current, "can_create_groups")
        if self.groups.first(id=group_id) is None:
            raise GroupNotFoundError()
        self.groups.modify({"id": group_id}, fields)
        return self.groups.first(id=group_id)

    def delete_group(self, current: User, group_id: int) -> None:
        self._require(current, "can_create_groups")
        if self.groups.first(id=group_id) is None:
            raise GroupNotFoundError()
        self.usergroups.delete(group=group_id)
        self.groups.delete(id=group_id)
