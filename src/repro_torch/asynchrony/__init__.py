"""The asynchronous-iterations runtime (port of ``repro.asynchrony``):
four layers, each a registry, and one engine composing them.

| layer | module | registry |
|---|---|---|
| solvers | ``asynchrony/solvers.py`` | ``SOLVERS`` |
| delay models | ``asynchrony/delay_models.py`` | ``DELAY_MODELS`` |
| detection protocols | ``asynchrony/protocols.py`` | ``DETECTION_PROTOCOLS`` |
| engine | ``asynchrony/engine.py`` | composes the three: ``run``, ``sweep`` |

The draws of the delay models and the snapshot come from
``asynchrony/draws.py``.  ``protocols.py`` also holds the training loop's
:class:`ConvergenceMonitor`.
"""

from repro_torch.asynchrony.delay_models import (  # noqa: F401
    DELAY_MODELS,
    apply_fairness,
    get_delay_model,
    record_trace,
    register_delay_model,
)
from repro_torch.asynchrony.engine import (  # noqa: F401
    AsyncConfig,
    AsyncResult,
    SweepResult,
    record_detection_delay,
    resolve_delay_params,
    run,
    sweep,
)
from repro_torch.asynchrony.protocols import (  # noqa: F401
    DETECTION_PROTOCOLS,
    RES_INIT,
    ConvergenceMonitor,
    get_protocol,
    register_protocol,
)
from repro_torch.asynchrony.solvers import (  # noqa: F401
    SOLVERS,
    FixedPoint,
    get_solver,
    make_solver,
    register_solver,
)
