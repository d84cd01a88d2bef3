"""Grad-sync strategy ``mrd_zero1``: the paper's butterfly as a ZeRO-1
distributed optimizer (port of ``repro.distributed.gradsync.mrd_zero1``).

The data-parallel ranks are the rows of stacked ``[dp, ...]`` tensors on
one device.  Each rank computes the gradient of its batch shard; the fp32
gradients are packed into size-capped buckets (``collectives.buckets``,
in the reference's leaf order) and each bucket is reduce-scattered over
the ranks with the recursive-halving schedule, stage-major across buckets
(:meth:`CollectivePlan.run_buffers`).  Each pivot rank runs AdamW on the
segments it owns, and the updated params are all-gathered back per
bucket.  Non-power-of-two rank counts (the paper's headline case) work
natively: at dp 3 the backward shift folds rank 2 onto rank 0, rank 2
owns no segment, and the all-gather's forward shift hands it the params.

``mrd_paper`` and ``compressed`` reuse this builder with another binding:
the full-bucket butterfly allreduce with replicated optimizer rows, and
int8 wire payloads with the EF-SGD residual carry.

Memory: the fp32 optimizer rows (``master``/``mu``/``nu`` [dp, m], and
``ef`` [dp, n] under the compressed sync) are updated in place; a
functional update would hold a second copy of them (22 GB at full width,
dp 3).  The params are held once: the all-gather's copy stages move raw
bytes, so every rank's row of the gathered buffers is the same, and the
step keeps row 0.

In a world (``mesh``: one process a rank, ``gradsync.common``) a rank
holds its own ``master``/``mu``/``nu`` row [m] and ``ef`` row [n], its
buckets are 1-D and the plans run over the mesh.  A rank that owns no
segment (rank 2 at dp 3) runs no optimizer update, its rows stay as they
were, and it still takes part in every stage of the scalar allreduce and
the all-gather, whose forward shift hands it the params; the sim, as the
reference, runs the update on that row's stale values, which nothing
reads.  Each rank keeps its own gathered buffers.

At ``tp`` > 1 (a ``("data", "model")`` mesh, ``common.ModelRanks``) a
rank holds its TP blocks of every leaf (``make_rules(fsdp=False)``, the
reference's ``make_zero1``), runs the model in the rules' manual region,
and packs its *local* gradients into buckets: 1/tp of the bytes a rank
moves.  Its plans run over its ``"data"`` column, and its rows are its
owned segments of its local layout: 1/(p0 tp) of the whole.  The leaves
replicated over ``"model"`` (norms, biases, unsharded heads) get buckets
of their own (``zero1_layout``'s ``groups``), so no int8 block mixes them
with a sharded leaf: every model column quantizes them alike, and they
stay bit-equal across the model ranks.  The grad norm counts each global
element once (a replicated bucket on model rank 0 only), summed over the
column by the plan, then over the model ranks in rank order.
:meth:`Zero1Step.rank_state` maps the reference's rows over the flat
layout of the whole params onto a coordinate's (:func:`global_leaves`).

With ``tcfg.overlap`` the backward runs in segments and each bucket
enters the gradient plan's pipeline as its segment completes
(``gradsync.overlap``): the same buffers bit for bit.

Elastic resize (:func:`resize_zero1`, the hook of all three modes): the
master/moment rows are owner segments over the old pivot count, so the
whole buckets are gathered from the old owners, re-padded to the new
extent's quantum (the padding holds exact zeros throughout training, so
this is bit-exact) and scattered onto the new owners, one bucket at a
time.  The EF residual is a worker's own: it follows its worker,
re-padded, and a joiner starts from zeros.  In a world every old owner
writes its segment into zeros and an MRD sum over the union of the old
and new ranks gathers the bucket (exact: one term a slot is nonzero).  A
rank the resize removes still hands over its segments, as the
reference's simulated kill leaves a removed device's shard readable: its
process lives through the resize, then idles.  A real crash loses that
segment, and only a checkpoint restore recovers from it.  At ``tp`` > 1
each model rank's ``"data"`` column re-lays-out its own rows over its
local layout (the plans run over the column; the keep map is per
``"data"`` coordinate).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.collectives import buckets, plans
from repro_torch.collectives import transforms as tf_lib
from repro_torch.collectives.schedules import pivot
from repro_torch.device import resolve_device
from repro_torch.distributed.gradsync import common, register, register_resize
from repro_torch.distributed.gradsync import overlap as overlap_lib
from repro_torch.distributed.gradsync.common import TrainConfig
from repro_torch.distributed.gradsync.snapshot import Snapshot
from repro_torch.models import convert, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.optim import optimizer as opt_lib

BLOCK = tf_lib.BLOCK


def zero1_prod_p0(dp: int) -> int:
    """Pivot rank count: the live reduce-scatter segment count."""
    return pivot(dp)[0]


def zero1_layout(params, dp: int, *, bucket_bytes: Optional[int] = buckets.DEFAULT_BUCKET_BYTES,
                 block: int = BLOCK, groups=None) -> tuple[buckets.BucketLayout, int]:
    """(bucket layout, prod_p0) of the bucketed reduce-scatter over ``dp``
    ranks: the fp32 view of ``params`` in the reference's leaf order, every
    bucket padded to ``prod_p0 * block`` so the halving divides evenly and
    int8 blocks stay aligned.  Master/moment rows concatenate each
    bucket's owned segment: shard length ``layout.total_padded /
    prod_p0``.  ``groups`` (a label a leaf: at ``tp`` > 1 whether it is
    replicated over ``"model"``) keeps leaves of different labels in
    different buckets (``buckets.build_layout``)."""
    prod_p0 = zero1_prod_p0(dp)
    layout = buckets.build_layout(convert.reference_tree(params), bucket_bytes=bucket_bytes,
                                  quantum=prod_p0 * block, dtype=torch.float32, groups=groups)
    return layout, prod_p0


def zero1_owner_segments(dp: int) -> list:
    """For each rank, the segment it owns after the reduce-scatter, or
    None (a non-pivot rank of a non-power-of-two extent)."""
    p0 = zero1_prod_p0(dp)
    return [r if r < p0 else None for r in range(dp)]


def zero1_master_row(params, dp: int, rank: int, *,
                     bucket_bytes: Optional[int] = buckets.DEFAULT_BUCKET_BYTES,
                     paper_mode: bool = False, groups=None) -> torch.Tensor:
    """Row ``rank`` of :func:`zero1_masters_from_params`, without the other
    rows (``paper_mode``: the whole padded vector; ``groups``: see
    :func:`zero1_layout`)."""
    layout, prod_p0 = zero1_layout(params, dp, bucket_bytes=bucket_bytes, groups=groups)
    bufs = buckets.pack(convert.reference_tree(params), layout)
    if paper_mode:
        return torch.cat(bufs)
    own = zero1_owner_segments(dp)[rank]
    if own is None:
        return bufs[0].new_zeros((layout.total_padded // prod_p0,))
    return torch.cat([b.reshape(prod_p0, -1)[own] for b in bufs])


def zero1_masters_from_params(params, dp: int, *,
                              bucket_bytes: Optional[int] = buckets.DEFAULT_BUCKET_BYTES,
                              paper_mode: bool = False) -> torch.Tensor:
    """``[dp, m]`` fp32 master rows in :func:`make_zero1`'s shard layout
    (``paper_mode``: every row the full padded vector)."""
    layout, prod_p0 = zero1_layout(params, dp, bucket_bytes=bucket_bytes)
    bufs = buckets.pack(convert.reference_tree(params), layout)
    if paper_mode:
        return torch.cat(bufs).repeat(dp, 1)
    seg_bufs = [b.reshape(prod_p0, -1) for b in bufs]
    m = layout.total_padded // prod_p0
    rows = [torch.cat([sb[o] for sb in seg_bufs]) if o is not None
            else bufs[0].new_zeros((m,)) for o in zero1_owner_segments(dp)]
    return torch.stack(rows)


def zero1_gather_buckets(rows: torch.Tensor, layout: buckets.BucketLayout, dp: int) -> list:
    """The whole per-bucket buffers of owner-sharded ``[dp, m]`` rows (a
    pivot rank's row concatenates its segment of every bucket): the
    inverse of the scatter in :func:`zero1_masters_from_params`, the
    reference's ``zero1_gather_buckets``."""
    prod_p0 = zero1_prod_p0(dp)
    rank_of = {seg: r for r, seg in enumerate(zero1_owner_segments(dp)) if seg is not None}
    bufs, off = [], 0
    for blen in layout.bucket_lengths:
        seg = blen // prod_p0
        bufs.append(torch.cat([rows[rank_of[s], off:off + seg] for s in range(prod_p0)]))
        off += seg
    return bufs


def global_leaves(cfg: ModelConfig, vec: torch.Tensor, dp: int, *,
                  bucket_bytes: Optional[int] = buckets.DEFAULT_BUCKET_BYTES,
                  full: bool = False) -> dict:
    """The fp32 leaves (the port's tree of the whole params' shapes) that
    the reference's rows over its flat layout of the whole params hold:
    ``[dp, m]`` owner rows, or with ``full`` one whole padded vector
    ``[n]`` (an ``mrd_paper`` row, a rank's EF residual)."""
    layout, _ = zero1_layout(transformer.param_shapes(cfg), dp, bucket_bytes=bucket_bytes)
    if full:
        bufs = list(torch.split(vec, layout.bucket_lengths))
    else:
        bufs = zero1_gather_buckets(vec, layout, dp)
    return convert.port_tree(buckets.unpack(bufs, layout))


@dataclasses.dataclass
class Zero1Step(Snapshot):
    """``(state, batch) -> (state, metrics)`` of one ZeRO-1 train step
    over ``dp`` ranks, and :meth:`init_state`.  Without a ``mesh`` the
    ranks are stacked rows and ``batch`` is the global batch; in a world
    ``batch`` is this rank's shard."""

    cfg: ModelConfig
    tcfg: TrainConfig
    dp: int
    device: torch.device
    transform: str = "identity"
    paper_mode: bool = False
    mesh: Any = None

    def __post_init__(self):
        self.rank = common.check_world(self.dp, self.mesh)
        self.tp = common.model_ranks(self.cfg, self.mesh)
        self.groups = None if self.tp is None else self.tp.replicated
        self.monitor = common.build_monitor(self.tcfg, self.dp, self.mesh)
        self.use_ef = self.tcfg.error_feedback and self.transform != "identity"
        executor = common.resolve_executor(self.tcfg, compressed=self.transform != "identity",
                                           mesh=self.mesh, device=self.device)
        bind = common.plan_binding(self.dp, self.mesh)
        if self.paper_mode:
            self.grad_plan = plans.allreduce_plan(schedule="mrd", op="sum",
                                                  transform=self.transform, executor=executor,
                                                  **bind)
        else:
            self.grad_plan = plans.reduce_scatter_plan(op="sum", transform=self.transform,
                                                       executor=executor, **bind)
            self.ag_plan = plans.allgather_plan(executor=executor, **bind)
        # the grad norm's squares (ZeRO-1) and, in a world, the logged
        # loss: scalars over the paper's MRD allreduce
        self.scalar_ar = plans.allreduce_plan(schedule="mrd", op="sum",
                                              executor=common.resolve_executor(
                                                  self.tcfg, mesh=self.mesh, device=self.device),
                                              **bind)
        # the rows this process holds (every rank's in the sim, a world
        # rank's own), whether each owns a segment, and whether each is
        # updated: every row in the sim (a non-pivot's from stale values, as
        # the reference), a world rank's only if it owns one (every rank
        # holds the full vector under mrd_paper)
        local = range(self.dp) if self.rank is None else [self.rank]
        owners = [self.paper_mode or zero1_owner_segments(self.dp)[r] is not None for r in local]
        self.owns = torch.tensor(owners, device=self.device)
        self.updates = [self.rank is None or o for o in owners]

    def _layout(self, params):
        return zero1_layout(params, self.dp, bucket_bytes=self.tcfg.bucket_bytes,
                            groups=self.groups)

    def init_state(self, generator: torch.Generator):
        """Random params from ``generator`` (on the step's device; at ``tp``
        > 1 this coordinate's blocks), master rows from them, zero moments
        and EF residuals, a fresh monitor."""
        params = common.init_params(self.cfg, generator, self.device, self.tp)
        state = {"params": params, "opt": self.opt_from_params(params), "step": 0}
        if self.monitor is not None:
            state["monitor"] = common.monitor_rows_init(self.monitor, device=self.device)
        return state

    def opt_from_params(self, params) -> dict:
        """A fresh optimizer for ``params``: master rows from them in the
        step's shard layout (a world rank's own row), zero moments and zero
        EF residuals."""
        layout, _ = self._layout(params)
        kw = dict(bucket_bytes=self.tcfg.bucket_bytes, paper_mode=self.paper_mode)
        if self.rank is None:
            masters = zero1_masters_from_params(params, self.dp, **kw)
        else:
            masters = zero1_master_row(params, self.dp, self.rank, groups=self.groups, **kw)
        opt = {"master": masters, "mu": torch.zeros_like(masters), "nu": torch.zeros_like(masters)}
        if self.use_ef:
            rows = () if self.rank is not None else (self.dp,)
            opt["ef"] = torch.zeros(rows + (layout.total_padded,), dtype=torch.float32,
                                    device=self.device)
        return opt

    def __call__(self, state, batch):
        params, opt, step = state["params"], state["opt"], state["step"]
        layout, _ = self._layout(params)
        aux = {}
        wire = None
        if self.use_ef:
            # EF-SGD: send the grid round trip of (grad + residual) and
            # carry what the quantizer dropped into the next step
            efs = torch.split(opt["ef"], layout.bucket_lengths, dim=-1)

            def wire(i, buf):
                return tf_lib.ef_roundtrip_(buf, efs[i])
        with common.model_region(self.tp):
            if self.tcfg.overlap:
                # the segmented backward feeding each ready bucket into the
                # plan's stage pipeline: the same buffers bit for bit
                red, loss, metric = overlap_lib.reduced_buckets(
                    params, batch, self.cfg, self.tcfg, self.dp, layout, self.rank,
                    self.grad_plan, aux, wire)
            else:
                bufs, loss, metric = common.grad_buckets(params, batch, self.cfg, self.tcfg,
                                                         self.dp, layout, self.rank, aux)
                if wire is not None:  # each bucket's fp32 input freed as it goes
                    for i in range(len(bufs)):
                        bufs[i] = wire(i, bufs[i])
                # the paper's full-bucket butterfly allreduce (mrd_paper) or
                # the recursive-halving reduce-scatter: one stage-major pass
                # over all buckets (run_buffers consumes the list, freeing
                # each bucket early)
                red = self.grad_plan.run_buffers(bufs)
        seg_lens = [r.shape[-1] for r in red]
        # a tensor divisor: CUDA's division by a Python number multiplies
        # by its reciprocal (not bit-equal to the reference's division)
        gshard = torch.cat(red, dim=-1).div_(torch.tensor(float(self.dp), device=self.device))
        del red
        g_rows = common.rows(gshard, self.rank)
        if self.tp is None:
            sq = torch.stack([torch.dot(g, g) for g in g_rows])
        else:
            sq = self._squares(gshard, layout, seg_lens)
        if self.paper_mode:
            gnorm = torch.sqrt(sq if self.tp is None else self.tp.sum(sq).reshape(1))
        else:
            # global grad norm via the paper's MRD allreduce of the owners'
            # squared norms (a non-pivot rank holds no segment), then, at
            # tp > 1, over the model ranks
            sq = self.scalar_ar.run(torch.where(self.owns, sq, 0.0))
            gnorm = torch.sqrt(sq if self.tp is None else self.tp.sum(sq).reshape(1))
        ocfg = self.tcfg.optimizer
        if ocfg.grad_clip > 0:
            clip = torch.full_like(gnorm, ocfg.grad_clip)  # true division, as above
            scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            g_rows.mul_(scale[:, None])
        # the shard-local optimizer, row by row and bucket segment by
        # segment (the update is elementwise), written back into the
        # optimizer rows
        starts = [sum(seg_lens[:i]) for i in range(len(seg_lens))]
        opt_rows = {k: common.rows(opt[k], self.rank) for k in ("master", "mu", "nu")}
        for i, g_row in enumerate(g_rows):
            if not self.updates[i]:
                continue
            for a, n in zip(starts, seg_lens):
                part = {k: v[i, a:a + n] for k, v in opt_rows.items()}
                _, new = opt_lib.apply_update_vector(g_row[a:a + n], part, ocfg, step)
                for k, v in part.items():
                    if new[k] is not v:  # a moment the optimizer leaves as it is
                        v.copy_(new[k])
        del gshard, g_rows, g_row
        pdt = dtype_of(self.cfg.param_dtype)
        master = opt["master"].to(pdt)
        if self.paper_mode:
            out = list(torch.split(master, layout.bucket_lengths, dim=-1))
        else:
            # recursive-doubling all-gather of the updated params, per bucket
            out = self.ag_plan.run_buffers(list(torch.split(master, seg_lens, dim=-1)))
        del master
        # every leaf rounded to the param type, then back to its own type
        # (the fp32 leaves, router, A_log, D, dt_bias, stay fp32), as the
        # reference's astype(b.dtype); every row of the gathered buffers is
        # the same, and the first is kept
        new_params = common.like(convert.port_tree(buckets.unpack(
            [common.rows(b, self.rank)[0] for b in out], layout, dtype=pdt)), params)
        del out
        mon, done, val = common.local_monitor_tick(self.monitor, state.get("monitor"), metric,
                                                   step)
        new_state = {"params": new_params, "opt": opt, "step": step + 1}
        if self.monitor is not None:
            new_state["monitor"] = mon
        return new_state, common.step_metrics(
            self.scalar_ar, self.rank, self.dp, {"loss": loss, **aux},
            {"grad_norm": gnorm, "converged": done, "monitor_value": val})

    def _squares(self, g: torch.Tensor, layout, seg_lens: list) -> torch.Tensor:
        """[1]: this coordinate's sum of squares of its segment ``g`` that
        counts each global element once: a bucket of leaves replicated over
        ``"model"`` (at ``tp`` > 1 every bucket holds one kind) on model
        rank 0 only."""
        sq, a = g.new_zeros(()), 0
        for b, n in zip(layout.buckets, seg_lens):
            if self.tp.weight(self.groups[b.slots[0].index]):
                sq = sq + torch.dot(g[a:a + n], g[a:a + n])
            a += n
        return sq.reshape(1)

    def rank_state(self, state) -> dict:
        """A coordinate's state from a stacked-layout one whose rows lie over
        the flat layout of the whole params (the reference's at a ``("data",
        "model")`` mesh, through ``convert.train_state_from_reference``):
        its blocks of the params, its rows of the optimizer over its local
        layout (:func:`global_leaves`, then its blocks' owned segments:
        zeros where it owns no segment) and its row of the monitor."""
        kw = dict(bucket_bytes=self.tcfg.bucket_bytes)
        opt = {}
        for k, v in state["opt"].items():
            full = self.paper_mode or k == "ef"
            tree = global_leaves(self.cfg, v[self.rank] if full else v, self.dp, full=full, **kw)
            # the coordinate's blocks of the whole leaves, in its local layout
            opt[k] = zero1_master_row(self.tp.blocks(tree), self.dp, self.rank, paper_mode=full,
                                      groups=self.groups, **kw)
        out = {"params": self.tp.blocks(state["params"]), "opt": opt, "step": state["step"]}
        if "monitor" in state:
            out["monitor"] = common.monitor_row(state["monitor"], self.rank)
        return out


def make_zero1(cfg: ModelConfig, tcfg: TrainConfig, *, dp: int, device="cuda", mesh=None,
               transform: str = "identity", paper_mode: bool = False) -> Zero1Step:
    """Shared builder of the bucketed MRD strategies: the step object,
    callable as ``train_step(state, batch)``, with ``init_state``."""
    return Zero1Step(cfg, tcfg, dp, resolve_device(device), transform, paper_mode, mesh)


@register("mrd_zero1")
def make(cfg: ModelConfig, tcfg: TrainConfig, *, dp: int, device="cuda", mesh=None):
    return make_zero1(cfg, tcfg, dp=dp, device=device, mesh=mesh)


# ---------------------------------------------------------------------------
# Elastic resize: the ZeRO-1 rows re-laid-out in place
# ---------------------------------------------------------------------------


def _used(bucket: buckets.Bucket) -> int:
    """Elements of a bucket that hold leaves (the rest is padding)."""
    return sum(s.size for s in bucket.slots)


def _bucket_pairs(layout_o: buckets.BucketLayout, layout_n: buckets.BucketLayout):
    """(old bucket, new bucket) pairs of two extents' layouts.  Bucket
    membership depends on the leaves and the byte cap, not on the padding
    quantum, so only the lengths differ."""
    for bo, bn in zip(layout_o.buckets, layout_n.buckets, strict=True):
        if [s.index for s in bo.slots] != [s.index for s in bn.slots]:
            raise ValueError("the two extents' bucket layouts hold different leaves")
        yield bo, bn


def _segments(dp: int, paper_mode: bool) -> tuple[int, list]:
    """(segments a bucket, the segment each rank owns or None): under
    ``paper_mode`` every rank holds the whole bucket."""
    if paper_mode:
        return 1, [0] * dp
    return zero1_prod_p0(dp), zero1_owner_segments(dp)


def relayout_rows(rows: torch.Tensor, layout_o, layout_n, dp_o: int, dp_n: int, *,
                  paper_mode: bool = False) -> torch.Tensor:
    """Stacked ``[dp_o, m_o]`` optimizer rows over the old extent's owner
    segments -> ``[dp_n, m_n]`` rows over the new one's, one bucket at a
    time: the whole bucket from the old owners' segments (``paper_mode``:
    row 0, as the reference re-buckets one replica's copy), its leaves
    re-padded to the new quantum, each new owner's segment of it (a rank
    that owns none gets zeros).  The reference's ``zero1_gather_buckets``,
    ``zero1_regrid`` and ``zero1_scatter_buckets``."""
    p0_o, own_o = _segments(dp_o, paper_mode)
    p0_n, own_n = _segments(dp_n, paper_mode)
    rank_of: dict = {}
    for r, seg in enumerate(own_o):  # under paper_mode every rank holds seg 0: row 0's
        if seg is not None:
            rank_of.setdefault(seg, r)
    out = rows.new_zeros((dp_n, layout_n.total_padded // p0_n))
    off_o = off_n = 0
    for bo, bn in _bucket_pairs(layout_o, layout_n):
        seg_o, seg_n = bo.length // p0_o, bn.length // p0_n
        whole = torch.cat([rows[rank_of[s], off_o:off_o + seg_o] for s in range(p0_o)])
        new = whole.new_zeros((bn.length,))
        new[:_used(bo)] = whole[:_used(bo)]
        for r, s in enumerate(own_n):
            if s is not None:
                out[r, off_n:off_n + seg_n] = new[s * seg_n:(s + 1) * seg_n]
        off_o, off_n = off_o + seg_o, off_n + seg_n
    return out


def regrid_row(row: torch.Tensor, layout_o, layout_n, out=None) -> torch.Tensor:
    """A whole padded vector (a rank's EF residual) of the old layout
    re-padded to the new one (into ``out``, zeros of the new length, when
    given)."""
    out = row.new_zeros((layout_n.total_padded,)) if out is None else out
    off_o = off_n = 0
    for bo, bn in _bucket_pairs(layout_o, layout_n):
        out[off_n:off_n + _used(bo)] = row[off_o:off_o + _used(bo)]
        off_o, off_n = off_o + bo.length, off_n + bn.length
    return out


def relayout_rank_row(row: Optional[torch.Tensor], layout_o, layout_n, dp_o: int, dp_n: int,
                      rank_o: Optional[int], rank_n: Optional[int], plan, device, *,
                      paper_mode: bool = False) -> Optional[torch.Tensor]:
    """:func:`relayout_rows` for a world process of the union of the old
    and new ranks: ``row`` is its old row (None for a joiner), ``rank_o`` /
    ``rank_n`` its old and new ranks (None outside that extent), ``plan``
    an MRD sum over the union.  Bucket by bucket each old owner writes its
    segment into zeros (``paper_mode``: old rank 0 its whole bucket, the
    row the reference re-buckets), the sum gathers the bucket on every
    process (one nonzero term a slot: exact), and each new owner keeps its
    segment.  Returns the new row, or None for a rank the resize removed."""
    p0_o, own_o = _segments(dp_o, paper_mode)
    p0_n, own_n = _segments(dp_n, paper_mode)
    s_o = None if rank_o is None or (paper_mode and rank_o) else own_o[rank_o]
    s_n = None if rank_n is None else own_n[rank_n]
    out = (None if rank_n is None else
           torch.zeros((layout_n.total_padded // p0_n,), dtype=torch.float32, device=device))
    off_o = off_n = 0
    for bo, bn in _bucket_pairs(layout_o, layout_n):
        seg_o, seg_n = bo.length // p0_o, bn.length // p0_n
        buf = torch.zeros((bo.length,), dtype=torch.float32, device=device)
        if s_o is not None:
            buf[s_o * seg_o:(s_o + 1) * seg_o] = row[off_o:off_o + seg_o]
        whole = plan.run(buf)
        if s_n is not None:
            new = whole.new_zeros((bn.length,))
            new[:_used(bo)] = whole[:_used(bo)]
            out[off_n:off_n + seg_n] = new[s_n * seg_n:(s_n + 1) * seg_n]
        off_o, off_n = off_o + seg_o, off_n + seg_n
    return out


def resize_zero1(cfg: ModelConfig, tcfg: TrainConfig, old_mesh, new_mesh, state, keep, *,
                 paper_mode: bool = False):
    """The ``mrd_zero1`` / ``mrd_paper`` / ``compressed`` state after a
    resize, with no checkpoint (the reference's ``resize_zero1``).  The
    params are replicated and pass through (the elastic trainer sends them
    to the joiners); the master/moment rows are re-laid-out
    (:func:`relayout_rows`; in a world :func:`relayout_rank_row` over the
    union of the old and new ranks); the EF residual follows its worker
    (:func:`regrid_row`; a joiner's is zeros); the monitor rows migrate
    through the detection layer."""
    dp_o, dp_n = common.mesh_dp(old_mesh), common.mesh_dp(new_mesh)
    # at tp > 1 the buckets keep the leaves replicated over "model" apart
    kw = dict(bucket_bytes=tcfg.bucket_bytes, groups=common.replicated_groups(cfg, old_mesh))
    layout_o, _ = zero1_layout(state["params"], dp_o, **kw)
    layout_n, _ = zero1_layout(state["params"], dp_n, **kw)
    opt = state["opt"]
    if not common.is_world(new_mesh):
        new_opt = {name: relayout_rows(opt[name], layout_o, layout_n, dp_o, dp_n,
                                       paper_mode=paper_mode) for name in ("master", "mu", "nu")}
        if "ef" in opt:  # written row by row into the new rows: one copy of them
            new_opt["ef"] = opt["ef"].new_zeros((dp_n, layout_n.total_padded))
            for i, k in enumerate(keep):
                if k is not None:
                    regrid_row(opt["ef"][k], layout_o, layout_n, out=new_opt["ef"][i])
        out = {**state, "opt": new_opt}
        if "monitor" in state:
            out["monitor"] = common.monitor_rows_migrate(tcfg, dp_n, state["monitor"], keep)
        return out
    # a world: this process is a rank of the union (the old mesh for a
    # shrink, the new one for a grow); a joiner's state is a fresh one
    rank_o, rank_n = common.mesh_rank(old_mesh), common.mesh_rank(new_mesh)
    union = new_mesh if any(k is None for k in keep) else old_mesh
    device = opt["master"].device
    plan = plans.allreduce_plan(schedule="mrd", op="sum", executor="device",
                                **common.plan_binding(common.mesh_dp(union), union))
    joiner = rank_n is not None and keep[rank_n] is None
    new_opt = {name: relayout_rank_row(None if joiner else opt[name], layout_o, layout_n,
                                       dp_o, dp_n, None if joiner else rank_o, rank_n, plan,
                                       device, paper_mode=paper_mode)
               for name in ("master", "mu", "nu")}
    if rank_n is None:
        return None
    if "ef" in opt:
        new_opt["ef"] = (opt["ef"].new_zeros((layout_n.total_padded,)) if joiner else
                         regrid_row(opt["ef"], layout_o, layout_n))
    out = {**state, "opt": new_opt}
    if "monitor" in state:
        out["monitor"] = common.monitor_rows_migrate(tcfg, dp_n, state["monitor"], keep,
                                                     new_mesh)
    return out


@register_resize("mrd_zero1")
def _resize(cfg, tcfg, old_mesh, new_mesh, state, keep):
    return resize_zero1(cfg, tcfg, old_mesh, new_mesh, state, keep)


@register_resize("mrd_paper")
def _resize_paper(cfg, tcfg, old_mesh, new_mesh, state, keep):
    return resize_zero1(cfg, tcfg, old_mesh, new_mesh, state, keep, paper_mode=True)


@register_resize("compressed")
def _resize_compressed(cfg, tcfg, old_mesh, new_mesh, state, keep):
    return resize_zero1(cfg, tcfg, old_mesh, new_mesh, state, keep)
