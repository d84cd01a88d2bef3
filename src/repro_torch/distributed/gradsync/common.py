"""Shared building blocks of the grad-sync strategies (port of
``repro.distributed.gradsync.common``).

Every strategy composes the same pieces: microbatched gradients, the
remat policy, the paper's ConvergenceMonitor (advanced one MRD stage per
train step, never blocking) and the optimizer.  Strategies differ only in
how the gradient crosses the data-parallel ranks and where the optimizer
state lives.

The data-parallel ranks are the rows of stacked ``[dp, ...]`` tensors on
one device (the reference's sim layout): each rank computes its own
gradient on its own batch shard, one rank after the other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.asynchrony import ConvergenceMonitor
from repro_torch.collectives.buckets import tree_flatten, tree_unflatten
from repro_torch.models import transformer
from repro_torch.optim.optimizer import OptimizerConfig

REMAT_POLICIES = transformer.REMAT


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: str = "full"  # 'none' | 'full'
    grad_sync: str = "mrd_zero1"  # any name in repro_torch.distributed.gradsync.GRAD_SYNC
    monitor: bool = True
    # any DETECTION_PROTOCOLS entry: 'inexact' (Alg. 1) | 'exact' (Alg. 2)
    # | 'interval' (windowed)
    monitor_mode: str = "inexact"
    monitor_threshold: float = 1e-3
    # EF-SGD error feedback for quantized grad sync ('compressed'): carry the
    # quantization residual and fold it into the next step's gradient.
    # Ignored by identity-transform modes.
    error_feedback: bool = True
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    # cap on each dtype-homogeneous gradient bucket; None = one bucket
    bucket_bytes: Optional[int] = 32 * 2**20


def resolve_executor(tcfg: TrainConfig, *, compressed: bool = False) -> str:
    """The executor of the gradient plans: ``sim``, the ranks as rows of
    one device's tensors, whose int8 combine on a CUDA tensor is the
    ``mrd_combine`` kernel (the reference reaches it through
    ``device_fused`` on a TPU).  The training loop runs its ranks in one
    process; the ``device``/``device_fused`` executors over
    ``torch.distributed`` need one process a rank."""
    return "sim"


def microbatched_grads(params, batch, cfg, remat: str, microbatches: int):
    """Gradients of the mean loss over ``microbatches`` equal slices of
    ``batch``.  Returns (grads, mean loss, metrics of the last
    microbatch): grads in the params' types for one microbatch (the
    gradient sync casts them to fp32 as it packs them), accumulated in
    fp32 over several."""
    leaves, treedef = tree_flatten(params)
    req = [t.detach().requires_grad_() for t in leaves]
    p_req = tree_unflatten(treedef, req)

    def one(mb):
        with torch.enable_grad():
            loss, metrics = transformer.forward_train(p_req, mb, cfg, remat)
            grads = torch.autograd.grad(loss, req)
        return grads, loss.detach(), {k: v.detach() for k, v in metrics.items()}

    if microbatches == 1:
        grads, loss, metrics = one(batch)
        return tree_unflatten(treedef, grads), loss, metrics
    B = batch["tokens"].shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
    mb = B // microbatches
    acc, loss_sum = None, 0.0
    for i in range(microbatches):
        grads, loss, metrics = one({k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
        if acc is None:
            acc = [g.float() for g in grads]
        else:
            for a, g in zip(acc, grads):
                a.add_(g.float())
        loss_sum = loss_sum + loss
    div = acc[0].new_full((), float(microbatches))  # true division on the card too
    acc = [a / div for a in acc]
    return tree_unflatten(treedef, acc), loss_sum / div, metrics


# ---------------------------------------------------------------------------
# Monitor wiring (identical across strategies)
# ---------------------------------------------------------------------------


def build_monitor(tcfg: TrainConfig, dp: int) -> Optional[ConvergenceMonitor]:
    """The paper's staged detector over the ``dp`` ranks, or None."""
    if not tcfg.monitor:
        return None
    return ConvergenceMonitor(p=dp, threshold=tcfg.monitor_threshold, mode=tcfg.monitor_mode)


def monitor_rows_init(monitor: Optional[ConvergenceMonitor], *, device):
    """The monitor's state, one row per rank (None without a monitor)."""
    return None if monitor is None else monitor.init(device=device)


def local_monitor_tick(monitor, mon_state, metric, step: int):
    """Advance every rank's monitor row by one stage with its ``metric``
    [dp].  Returns (new rows, done [dp], value [dp]); zeros without a
    monitor."""
    if monitor is None:
        zeros = torch.zeros_like(metric)
        return mon_state, zeros.bool(), zeros.float()
    return monitor.step(mon_state, metric, step)
