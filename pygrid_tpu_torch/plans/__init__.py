"""Plans: the port's ``PlaceHolder``, ``State`` and ``Plan`` (the wire
names ``pygrid.PlaceHolder``, ``pygrid.State`` and ``pygrid.Plan``) and the
op-list dialect's translators."""

from pygrid_tpu_torch.plans.placeholder import PlaceHolder  # noqa: F401
from pygrid_tpu_torch.plans.state import State  # noqa: F401
from pygrid_tpu_torch.plans.plan import Plan, func2plan  # noqa: F401
from pygrid_tpu_torch.plans.translators import (  # noqa: F401
    PLAN_VARIANTS,
    PlanTranslatorDefault,
    PlanTranslatorPortable,
    PlanTranslatorXla,
    fx_to_oplist,
    run_oplist,
    translate_plan,
)
