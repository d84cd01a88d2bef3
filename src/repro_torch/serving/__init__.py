"""Continuous-batching serving (port of ``repro.serving``).

| layer | module | registry |
|---|---|---|
| contiguous pool | ``serving/pool.py`` | (decode pool, fixed-point pool) |
| paged cache | ``serving/paged.py`` | (block allocator + paged pool) |
| schedulers | ``serving/schedulers.py`` | ``SCHEDULERS`` |
| termination | ``serving/termination.py`` | ``TERMINATION`` |
| workloads | ``serving/workloads.py`` | ``WORKLOADS`` |
| engine | ``serving/engine.py`` | composes the four |
| tenants | ``serving/tenants.py`` | ``ARRIVALS`` (the traffic model) |

Deciding when each in-flight request is done without a global barrier is
the paper's convergence-detection problem: per-request termination runs
the non-blocking MRD reduction of ``repro_torch.collectives.plans``, so at
``dp > 1`` every replica retires the same slots on the same tick, at any
(non-power-of-two) replica count.  Fixed-point requests
(``fixedpoint_solve``) retire when ``residual_interval`` or
``residual_inexact`` certifies their agreed update magnitude below their
eps.

Elastic serving: :meth:`ServeEngine.resize` changes the agreement extent
under live traffic (the termination state migrates; joiners receive the
serving state through the MRD sum-broadcast), driven by
:class:`repro_torch.runtime.ElasticServeController`.
"""

from repro_torch.serving.engine import (  # noqa: F401
    Request,
    RequestResult,
    ServeConfig,
    ServeEngine,
)
from repro_torch.serving.paged import BlockAllocator, PagedDecodePool  # noqa: F401
from repro_torch.serving.pool import DecodePool, FixedPointPool  # noqa: F401
from repro_torch.serving.schedulers import (  # noqa: F401
    SCHEDULERS,
    get_scheduler,
    register_scheduler,
)
from repro_torch.serving.tenants import (  # noqa: F401
    ARRIVALS,
    TenantScenario,
    TenantSpec,
    build_requests,
    make_arrival_ticks,
    parse_tenant_specs,
    quotas_of,
    register_arrival,
)
from repro_torch.serving.termination import (  # noqa: F401
    TERMINATION,
    TerminationConfig,
    get_termination,
    make_signals,
    register_termination,
)
from repro_torch.serving.workloads import (  # noqa: F401
    WORKLOADS,
    FixedPointWorkload,
    LLMDecodeWorkload,
    PagedLLMWorkload,
    get_workload,
    make_workload,
    register_workload,
)
