"""PyTorch/CUDA port of the ``repro`` package, module for module.

Each subpackage mirrors its counterpart under ``repro`` (which stays the
reference the port is tested against).  The port imports ``torch`` and
numpy only.  Its entry points take an explicit ``device`` defaulting to
``"cuda"``: without a card they raise instead of running on the CPU, and
tests pass ``device="cpu"``.
"""

from repro_torch.device import resolve_device  # noqa: F401
