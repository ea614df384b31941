"""Plans: the port's own ``PlaceHolder`` and ``State`` (the wire names
``pygrid.PlaceHolder`` and ``pygrid.State``). ``Plan`` and the translators
are not ported yet."""

from pygrid_tpu_torch.plans.placeholder import PlaceHolder  # noqa: F401
from pygrid_tpu_torch.plans.state import State  # noqa: F401
