"""Grad-sync strategy ``mrd_paper``: the paper-faithful collective (port
of ``repro.distributed.gradsync.mrd_paper``).

The paper's modified-recursive-doubling Allreduce (S2) of the full fp32
gradient over the ranks, in size-capped buckets run stage-major, and a
replicated optimizer: no reduce-scatter, no all-gather, every rank holds
every optimizer row.  The beyond-paper modes (``mrd_zero1``,
``compressed``) are measured against it.
"""

from __future__ import annotations

from repro_torch.distributed.gradsync import register
from repro_torch.distributed.gradsync.mrd_zero1 import make_zero1


@register("mrd_paper")
def make(cfg, tcfg, *, dp: int, device="cuda", mesh=None):
    return make_zero1(cfg, tcfg, dp=dp, device=device, mesh=mesh, paper_mode=True)
