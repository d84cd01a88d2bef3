"""Plain PyTorch version of the ``mrd_combine`` kernel (the fused
dequant-accumulate of the int8 wire format).

Written as the reference's ``mrd_combine/ref.py`` oracle is: dequantize
in fp32 (one product, rounded), add in fp32 (one sum, rounded), cast to
``x``'s type.  The CPU path and the tests use it, and ``chip_smoke.py``
holds the CUDA kernel against it on the card.
"""

from __future__ import annotations

import torch

QBLOCK = 256


def mrd_combine_ref(x, q, scales, block: int = QBLOCK):
    """x: [n] float; q: [n] int8; scales: [n/block] f32 -> x + dequant(q,
    scales) in x's type (f32 accumulate)."""
    n = x.shape[0]
    deq = (q.float().reshape(n // block, block) * scales[:, None]).reshape(n)
    return (x.float() + deq).to(x.dtype)
