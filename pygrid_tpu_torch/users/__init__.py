"""RBAC / user management, shared by the Node and Network apps.

Parity surface: reference ``apps/node/src/app/main/{users,database,auth}.py``
(~1200 LoC) and the Network twin (``apps/network/src/app/users/``): bcrypt-
salted signup/login (pbkdf2 here — no bcrypt in the image), first user
auto-Owner, JWT HS256 session tokens, role-boolean permission gates, group
membership, and a transport-agnostic ``token_required`` resolver used by
both the HTTP routes and their WS event twins.

The port's copy of :mod:`pygrid_tpu.users`, over the port's
``storage.warehouse``, ``federated.auth`` and ``utils.passwords``: a digest,
a row and a token made by either package are valid in the other.
"""

from pygrid_tpu_torch.users.ops import UserManager, seed_roles
from pygrid_tpu_torch.users.schemas import Group, Role, User, UserGroup

__all__ = ["UserManager", "seed_roles", "Group", "Role", "User", "UserGroup"]
