"""Grad-sync strategy ``compressed``: mrd_zero1 with int8 wire payloads
on the reduce-scatter (port of ``repro.distributed.gradsync.compressed``).

Every reducing stage (the backward shift and each halving) sends int8
values with one fp32 scale per 256 (wire bytes / 4 against fp32), and the
receiver folds them in with ``keep + dequant(q, scales)``: the
``mrd_combine`` CUDA kernel on the card, its plain version on the CPU.
Buckets are padded to whole 256-blocks per segment, so the quantizer
never straddles a bucket boundary.  With ``tcfg.error_feedback`` (the
default) each rank carries the EF-SGD residual of what it sent and folds
it into the next step's gradient, so coordinates persistently below the
quantization step are delayed rather than dropped.
"""

from __future__ import annotations

from repro_torch.distributed.gradsync import register
from repro_torch.distributed.gradsync.mrd_zero1 import make_zero1


@register("compressed")
def make(cfg, tcfg, *, dp: int, device="cuda", mesh=None):
    return make_zero1(cfg, tcfg, dp=dp, device=device, mesh=mesh, transform="int8")
