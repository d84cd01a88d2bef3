"""Hand-written CUDA kernels of the port, one package each: the kernel
(``csrc/``), its wrapper (``ops``) and its plain PyTorch version (``ref``)."""

import torch


def needs_grad(*tensors) -> bool:
    """Would autograd differentiate through these inputs?  The port's
    kernels have no backward, so such inputs take the plain version."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
