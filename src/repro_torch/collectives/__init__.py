"""Collectives (port of ``repro.collectives``): the MRD allreduce,
reduce-scatter and all-gather schedules, the identity and int8 wire
formats, the sim executor (its int8 combine is the ``mrd_combine`` kernel
on the card), the plan interpreter and the gradient bucketizer."""

from repro_torch.collectives.plans import (  # noqa: F401
    CollectivePlan,
    allgather_plan,
    allreduce_plan,
    reduce_scatter_plan,
)
from repro_torch.collectives.schedules import (  # noqa: F401
    SCHEDULES,
    Stage,
    allreduce_schedule,
    get_schedule,
    pivot,
)
