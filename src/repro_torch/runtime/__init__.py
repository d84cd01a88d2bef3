"""The elastic runtime (port of ``repro.runtime``): failure detection,
resize policies and the elastic serving controller.  ``ELASTIC_POLICIES``
resolves by name, extended with ``@register_policy``.  The elastic
trainer's half (``ElasticTrainer``, ``mrd_broadcast`` over a device mesh,
``shrink_mesh``/``grow_mesh``/``recover``) is not ported yet."""

from repro_torch.runtime.elastic import (  # noqa: F401
    ElasticConfig,
    ElasticServeController,
    ResizeEvent,
    flat_keep_for_grow,
    flat_keep_for_shrink,
)
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    FailureDetector,
    HeartbeatConfig,
    ReplicaSet,
    StepClock,
)
from repro_torch.runtime.policies import (  # noqa: F401
    ELASTIC_POLICIES,
    LoadSnapshot,
    ResizeDecision,
    SlaAutoscalePolicy,
    available,
    clamp_min_extent,
    get_policy,
    register_policy,
)
