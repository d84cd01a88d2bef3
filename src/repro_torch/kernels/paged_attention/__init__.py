"""Paged decode attention: CUDA kernel (``csrc/``), its wrapper (``ops``)
and its plain PyTorch version (``ref``)."""

from repro_torch.kernels.paged_attention.ops import paged_attention  # noqa: F401
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: F401
