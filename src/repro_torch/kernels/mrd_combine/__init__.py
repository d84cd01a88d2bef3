"""Fused dequant-accumulate of the int8 MRD wire format: CUDA kernel
(``csrc/``), its wrapper (``ops``) and its plain PyTorch version
(``ref``)."""

from repro_torch.kernels.mrd_combine.ops import mrd_combine  # noqa: F401
from repro_torch.kernels.mrd_combine.ref import mrd_combine_ref  # noqa: F401
