"""Flash attention (forward): CUDA kernel (``csrc/``), its wrapper
(``ops``) and its plain PyTorch version (``ref``)."""

from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: F401
