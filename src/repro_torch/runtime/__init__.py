"""The elastic runtime (port of ``repro.runtime``): failure detection,
resize policies, the elastic trainer and the elastic serving controller;
chaos scripts and the oracle replay are in ``runtime.chaos``.
``ELASTIC_POLICIES`` resolves by name, extended with
``@register_policy``."""

from repro_torch.runtime.elastic import (  # noqa: F401
    ElasticConfig,
    ElasticServeController,
    ElasticTrainer,
    ResizeEvent,
    flat_keep_for_grow,
    flat_keep_for_shrink,
    mrd_broadcast,
)
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    FailureDetector,
    HeartbeatConfig,
    ReplicaSet,
    RestartReport,
    StepClock,
    grow_mesh,
    mesh_ids,
    recover,
    shrink_mesh,
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
