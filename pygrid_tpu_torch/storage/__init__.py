"""Storage: the port's own ``Warehouse`` and ``Database`` (sqlite, or
postgres over :mod:`pygrid_tpu_torch.storage.pgwire`)."""

from pygrid_tpu_torch.storage.warehouse import Database, Warehouse  # noqa: F401
