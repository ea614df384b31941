"""RBAC schemas.

Parity surface: reference ``apps/node/src/app/main/database/{role,user,group,
usergroup}.py`` — same tables, same columns (Role's seven permission
booleans; User's email/hashed_password/salt/private_key/role; Group;
UserGroup join table). The Network app adds ``can_manage_nodes`` to its Role
(reference ``apps/network/src/app/database/role.py``) — carried here as an
optional eighth boolean so one schema serves both apps.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Role:
    id: int | None = None
    name: str = ""
    can_triage_requests: bool = False
    can_edit_settings: bool = False
    can_create_users: bool = False
    can_create_groups: bool = False
    can_edit_roles: bool = False
    can_manage_infrastructure: bool = False
    can_upload_data: bool = False
    can_manage_nodes: bool = False  # network-app extension


@dataclass
class User:
    id: int | None = None
    email: str = ""
    hashed_password: str = ""
    salt: str = ""
    private_key: str = ""
    role: int = 0


@dataclass
class Group:
    id: int | None = None
    name: str = ""


@dataclass
class UserGroup:
    id: int | None = None
    user: int = 0
    group: int = 0
