"""Collectives (port of ``repro.collectives``), in four layers, each a
registry:

1. **schedules**  — pure-data stage lists + the ``SCHEDULES`` registry
   (``mrd`` | ``rabenseifner`` | ``hierarchical``), the paper's counts and
   an alpha-beta cost model;
2. **executors**  — the ``Backend`` protocol + ``EXECUTORS`` registry
   (``device`` | ``device_fused`` over ``torch.distributed`` | ``sim``);
   the int8 combine of 256-blocks is the ``mrd_combine`` kernel on the card
   (``device_fused`` and ``sim``);
3. **transforms** — wire formats + the ``TRANSFORMS`` registry
   (``identity`` | ``int8``);
4. **plans**      — :class:`CollectivePlan` binds one of each to mesh axes
   or to a stacked rank count ``p`` and exposes the blocking ``run()``,
   the bucketed pipelined ``run_bucketed()``/``run_buffers()``/
   ``pipeline()`` engine (packing by ``repro_torch.collectives.buckets``),
   and the paper's non-blocking ``init()``/``step()`` state machine.
"""

from repro_torch.collectives.buckets import (  # noqa: F401
    Bucket,
    BucketLayout,
    LeafSlot,
    build_layout,
    pack,
    unpack,
)
from repro_torch.collectives.executors import (  # noqa: F401
    EXECUTORS,
    OPS,
    Backend,
    DeviceBackend,
    FusedDeviceBackend,
    SimBackend,
    make_backend,
    register_executor,
    resolve_op,
)
from repro_torch.collectives.plans import (  # noqa: F401
    BucketPipeline,
    CollectivePlan,
    allgather_plan,
    allreduce_plan,
    exec_stage,
    reduce_scatter_plan,
    tree_allreduce,
)
from repro_torch.collectives.schedules import (  # noqa: F401
    SCHEDULES,
    Phase,
    ScheduleFamily,
    Stage,
    allreduce_schedule,
    get_schedule,
    pivot,
    register_schedule,
)
from repro_torch.collectives.transforms import (  # noqa: F401
    TRANSFORMS,
    IdentityTransform,
    Int8BlockwiseTransform,
    register_transform,
    resolve_transform,
)
