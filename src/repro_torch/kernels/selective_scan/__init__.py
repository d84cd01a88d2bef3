"""Selective scan (mamba1 recurrence): CUDA kernel (``csrc/``), its
wrappers (``ops``) and its plain PyTorch versions (``ref``)."""

from repro_torch.kernels.selective_scan.ops import (  # noqa: F401
    selective_scan,
    selective_scan_fused,
)
from repro_torch.kernels.selective_scan.ref import (  # noqa: F401
    selective_scan_fused_ref,
    selective_scan_ref,
)
