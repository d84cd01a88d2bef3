"""Plain PyTorch version of the rmsnorm kernel (port of the reference's
``kernels/rmsnorm/ref.py``).  The CPU path, the tests and autograd use it,
and ``chip_smoke.py`` holds the CUDA kernel against it on the card."""

from __future__ import annotations

import torch


def rmsnorm_ref(x, w, eps: float = 1e-5):
    """x: [..., d]; w: [d], stored under the (1 + w) convention.  Row
    statistics in fp32; output in x's type."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)
