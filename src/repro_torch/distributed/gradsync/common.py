"""Shared building blocks of the grad-sync strategies (port of
``repro.distributed.gradsync.common``).

Every strategy composes the same pieces: microbatched gradients, the
remat policy (``"none"``, ``"full"`` or ``"dots"``, see
``transformer.remat_call``), the paper's ConvergenceMonitor (advanced one MRD stage per
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
from repro_torch.collectives.buckets import pack_bucket, tree_flatten, tree_unflatten
from repro_torch.models import convert, transformer
from repro_torch.optim.optimizer import OptimizerConfig

REMAT_POLICIES = transformer.REMAT


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: str = "full"  # 'none' | 'full' | 'dots'
    grad_sync: str = "mrd_zero1"  # any name in repro_torch.distributed.gradsync.GRAD_SYNC
    local_sync_every: int = 8  # local_sgd: the replicas' average period (staleness bound)
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
    fp32 over several.  A parameter the loss does not read (the audio
    encoder's ``embed``) gets a zero gradient, as under ``jax.grad``."""
    leaves, treedef = tree_flatten(params)
    req = [t.detach().requires_grad_() for t in leaves]
    p_req = tree_unflatten(treedef, req)

    def one(mb):
        with torch.enable_grad():
            loss, metrics = transformer.forward_train(p_req, mb, cfg, remat)
            grads = torch.autograd.grad(loss, req, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, req)]
        return grads, loss.detach(), {k: v.detach() for k, v in metrics.items()}

    if microbatches == 1:
        grads, loss, metrics = one(batch)
        return tree_unflatten(treedef, grads), loss, metrics
    B = batch_size(batch)
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


def batch_size(batch) -> int:
    """Sequences in a train batch (the audio encoder's has no tokens)."""
    return batch["labels"].shape[0]


def rank_shards(batch, dp: int) -> list:
    """The batch split over ``dp`` ranks, a contiguous slice a rank, as the
    reference's batch specs shard it."""
    B = batch_size(batch)
    if B % dp:
        raise ValueError(f"batch {B} does not split over dp={dp} ranks")
    per = B // dp
    return [{k: v[r * per:(r + 1) * per] for k, v in batch.items()} for r in range(dp)]


def clip_by_global_norm_(leaves: list, max_norm: float) -> torch.Tensor:
    """The reference's ``clip_by_global_norm`` in place on a list of leaves
    (in the reference's flatten order: the norm's squares are summed leaf
    by leaf in that order): with ``max_norm`` > 0, every leaf is scaled by
    ``min(1, max_norm / max(norm, 1e-12))``.  Returns the fp32 norm (0
    when ``max_norm`` <= 0, as the reference's)."""
    if max_norm <= 0:
        return leaves[0].new_zeros((), dtype=torch.float32)
    sq = None
    for g in leaves:
        s = g.float().square().sum()
        sq = s if sq is None else sq + s
    gnorm = torch.sqrt(sq)
    clip = torch.full_like(gnorm, max_norm)  # true division on the card too
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    for g in leaves:
        g.copy_((g * scale).to(g.dtype))
    return gnorm


def like(tree, ref):
    """``tree`` with each leaf cast to the type of ``ref``'s leaf at its
    place (nested dicts of the same keys)."""
    return {k: like(v, ref[k]) if isinstance(v, dict) else v.to(ref[k].dtype)
            for k, v in tree.items()}


def reference_leaves(tree) -> list:
    """The leaves of a port param tree in the reference's flatten order."""
    return tree_flatten(convert.reference_tree(tree))[0]


def stacked_grad_buckets(params, batch, cfg, tcfg: TrainConfig, dp: int, layout, aux=None):
    """Every rank's gradient of its batch shard, packed into fp32 ``[dp,
    len]`` rows of ``layout``'s buckets (built over the reference's nesting
    of ``params``); returns (buffers, losses [dp], monitor metrics [dp]).
    The ranks' gradients are kept in the params' type until all are
    computed, and each bucket's leaves are released as soon as that bucket
    is packed: the fp32 rows (14.8 GB at llama3.2-1b's full width, dp 3)
    never coexist with a backward pass.  The moe family's aux loss, the
    ranks' mean, goes into ``aux`` (a dict) as ``aux_loss``."""
    rank_leaves, losses, metric, auxes = [], [], [], []
    for local in rank_shards(batch, dp):
        grads, loss, metrics = microbatched_grads(params, local, cfg, tcfg.remat,
                                                  tcfg.microbatches)
        rank_leaves.append(reference_leaves(grads))
        del grads
        losses.append(loss)
        metric.append(metrics["per_example"].mean())
        if "aux_loss" in metrics:
            auxes.append(metrics["aux_loss"])
    if aux is not None and auxes:
        aux["aux_loss"] = torch.stack(auxes).mean()
    device = losses[0].device
    bufs = []
    for i, b in enumerate(layout.buckets):
        buf = torch.zeros((dp, b.length), dtype=torch.float32, device=device)
        for r, leaves in enumerate(rank_leaves):
            pack_bucket(leaves, layout, i, out=buf[r])
            for s in b.slots:
                leaves[s.index] = None
        bufs.append(buf)
    return bufs, torch.stack(losses), torch.stack(metric)


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
