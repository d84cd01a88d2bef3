"""Asynchrony (port of ``repro.asynchrony``): so far the training loop's
:class:`ConvergenceMonitor` and its detection policies."""

from repro_torch.asynchrony.protocols import (  # noqa: F401
    DETECTION_PROTOCOLS,
    RES_INIT,
    ConvergenceMonitor,
)
