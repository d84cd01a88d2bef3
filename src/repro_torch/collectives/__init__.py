"""Collectives (port of ``repro.collectives``): MRD schedules, the identity
transform, the sim executor and the plan state machine."""

from repro_torch.collectives.plans import CollectivePlan, allreduce_plan  # noqa: F401
from repro_torch.collectives.schedules import (  # noqa: F401
    SCHEDULES,
    Stage,
    allreduce_schedule,
    get_schedule,
    pivot,
)
