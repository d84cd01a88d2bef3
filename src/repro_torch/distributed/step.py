"""Step wiring (port of ``repro.distributed.step``): the train step, a thin
facade over the grad-sync registry, and the serving steps of
``distributed.serve``.

The strategies live in ``repro_torch.distributed.gradsync`` (one module
per mode), composing the shared monitor, optimizer and microbatching
pieces of ``gradsync.common`` with their own gradient-crossing plan; every
collective the MRD modes issue runs through a
:class:`repro_torch.collectives.plans.CollectivePlan`, and ``gspmd``
places its params and collectives by ``repro_torch.distributed.sharding``.
"""

from __future__ import annotations

from repro_torch.distributed.gradsync import (  # noqa: F401
    GRAD_SYNC,
    GRAD_SYNC_RESIZE,
    available as available_grad_sync,
    make_step_factory,
    make_train_step,
    migrate_state,
)
from repro_torch.distributed.gradsync.common import (  # noqa: F401
    DATA,
    REMAT_POLICIES,
    TrainConfig,
    build_monitor,
    microbatched_grads,
    resolve_executor,
    world_rank,
)
from repro_torch.distributed.gradsync.gspmd import GspmdStep  # noqa: F401
from repro_torch.distributed.gradsync.mrd_zero1 import (  # noqa: F401
    zero1_layout,
    zero1_masters_from_params,
    zero1_owner_segments,
)
from repro_torch.distributed.serve import (  # noqa: F401
    make_cached_prefill_step,
    make_paged_pool_decode_step,
    make_paged_slot_prefill_step,
    make_pool_decode_step,
    make_prefill_step,
    make_serve_step,
    make_slot_prefill_step,
)
