"""Grad-sync strategy ``local_sgd``: bounded-staleness local SGD (port of
``repro.distributed.gradsync.local_sgd``).

Each rank trains its own replica on its own batch shard: its gradient
never crosses the ranks, it is clipped by its own global norm and applied
by a local AdamW (fp32 tree-shaped ``master``/``mu``/``nu``).  The params
and optimizer trees are stacked ``[dp, ...]``, a row a replica, and updated
in place.  On every step where ``(step + 1) % local_sync_every == 0`` the
replicas are averaged by the paper's collectives: an fp32 allreduce under
the ``rabenseifner`` schedule (recursive-halving reduce-scatter, then the
all-gather, whose copies move raw bytes, so every replica ends equal bit
for bit), divided by dp and cast back to the params' type.  The average
runs through :func:`plans.tree_allreduce` one piece of at most
``bucket_bytes`` a rank at a time (a leaf, or a slice of a larger one), so
the fp32 copies in flight are one piece's, not the replicas' whole tree
(the reference's one call over the tree sums every element in the same
order: the schedule's reduction order depends on the ranks, not on an
element's place in its bucket).  There is no monitor:
``converged`` is False and ``monitor_value`` 0, as in the reference.

In a world (one process a rank over a mesh) each rank holds its own
replica, its params and optimizer trees unstacked; the average runs the
same ``rabenseifner`` allreduce over the mesh in the same pieces, and the
logged loss and grad norm, the replicas' means, are gathered by the
paper's MRD allreduce.  At ``tp`` > 1 (a ``("data", "model")`` mesh) a
replica is sharded over its model column (``common.ModelRanks``): each
coordinate holds its blocks, its replica's grad norm counts each global
element once, and the average runs over its ``"data"`` column.
``tcfg.overlap`` is a no-op here, as in the reference: no gradient
crosses the ranks.

Elastic resize (:func:`resize`): the replicas follow their workers, and
a joiner takes the first survivor's replica (its params and optimizer
trees): it has no history of its own, and the next average folds it in.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.collectives import plans
from repro_torch.device import resolve_device
from repro_torch.distributed.gradsync import common, register, register_resize
from repro_torch.distributed.gradsync.common import TrainConfig
from repro_torch.distributed.gradsync.snapshot import Snapshot
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.optim import optimizer as opt_lib


PIECE_BYTES = 32 << 20  # a piece of the average without a bucket cap (fp32, a rank)


def _replica(tree, i: int, rank):
    """The ``i``-th replica this process holds of a nested dict (views):
    row ``i`` of the sim's ``[dp, ...]`` leaves, a world rank's own."""
    return {k: _replica(v, i, rank) if isinstance(v, dict) else common.rows(v, rank)[i]
            for k, v in tree.items()}


@dataclasses.dataclass
class LocalSGDStep(Snapshot):
    """``(state, batch) -> (state, metrics)`` of one ``local_sgd`` step over
    ``dp`` replicas, and :meth:`init_state`."""

    cfg: ModelConfig
    tcfg: TrainConfig
    dp: int
    device: torch.device
    mesh: Any = None

    def __post_init__(self):
        self.every = max(self.tcfg.local_sync_every, 1)
        self.rank = common.check_world(self.dp, self.mesh)
        self.tp = common.model_ranks(self.cfg, self.mesh)
        self.executor = common.resolve_executor(self.tcfg, mesh=self.mesh, device=self.device)
        bind = common.plan_binding(self.dp, self.mesh)
        self.avg_plan = plans.allreduce_plan(schedule="rabenseifner", executor=self.executor,
                                             **bind)
        self.scalar_ar = plans.allreduce_plan(schedule="mrd", executor=self.executor, **bind)

    def init_state(self, generator: torch.Generator):
        """One random init from ``generator``, replicated to every row (a
        world rank: its replica), and the optimizer trees of the
        replicas."""
        if self.rank is not None:
            params = common.init_params(self.cfg, generator, self.device, self.tp)
            return {"params": params, "opt": opt_lib.init_opt_state(params), "step": 0}

        def rep(tree):
            return {k: rep(v) if isinstance(v, dict)
                    else v[None].expand((self.dp,) + v.shape).clone() for k, v in tree.items()}

        params = rep(transformer.init_params(self.cfg, generator, self.device))
        return {"params": params, "opt": opt_lib.init_opt_state(params), "step": 0}

    def opt_from_params(self, params) -> dict:
        """A fresh optimizer of the replicas ``params``: fp32 masters of
        them and zero moments."""
        return opt_lib.init_opt_state(params)

    def average_(self, params) -> None:
        """Replace every replica by the replicas' mean, in place."""
        dp = torch.tensor(float(self.dp), device=self.device)  # true division on the card
        piece = max(1, (self.tcfg.bucket_bytes or PIECE_BYTES) // 4)  # fp32 elements a rank
        for leaf in common.reference_leaves(params):
            rows = common.rows(leaf, self.rank)
            rows = rows.view(rows.shape[0], -1)
            for a in range(0, rows.shape[1], piece):
                part = rows[:, a:a + piece]
                avg = self.avg_plan.run_bucketed({"x": part.float()})["x"]
                part.copy_((avg / dp).to(part.dtype))

    def __call__(self, state, batch):
        params, opt, step = state["params"], state["opt"], state["step"]
        pdt = dtype_of(self.cfg.param_dtype)
        losses, gnorms, auxes = [], [], []
        for i, local in enumerate(common.local_shards(batch, self.dp, self.rank)):
            p_i = _replica(params, i, self.rank)
            with common.model_region(self.tp):
                grads, loss, met = common.microbatched_grads(p_i, local, self.cfg,
                                                             self.tcfg.remat,
                                                             self.tcfg.microbatches)
            if "aux_loss" in met:
                auxes.append(met["aux_loss"])
            g = [t.float() for t in common.reference_leaves(grads)]
            del grads
            gnorms.append(common.clip_by_global_norm_(
                g, self.tcfg.optimizer.grad_clip,
                sum_squares=None if self.tp is None else self.tp.sum_squares))
            leaves = {k: common.reference_leaves(_replica(v, i, self.rank))
                      for k, v in opt.items()}
            new = opt_lib.apply_update_tree_(g, leaves, self.tcfg.optimizer, step, pdt)
            del g
            for dst, src in zip(common.reference_leaves(p_i), new):
                dst.copy_(src)
            losses.append(loss)
        if (step + 1) % self.every == 0:
            self.average_(params)
        zero = torch.zeros((), device=self.device)
        # every replica's loss, grad norm and aux loss, averaged
        means = {"loss": losses, "grad_norm": gnorms, **({"aux_loss": auxes} if auxes else {})}
        metrics = common.step_metrics(self.scalar_ar, self.rank, self.dp,
                                      {k: torch.stack(v) for k, v in means.items()},
                                      {"converged": zero.bool(), "monitor_value": zero})
        return {"params": params, "opt": opt, "step": step + 1}, metrics


    def rank_state(self, state) -> dict:
        """A coordinate's state from a stacked-layout one (``[dp, ...]``
        replica rows of whole leaves): its blocks of its data rank's
        replica."""
        return {k: self.tp.blocks(_replica(v, self.rank, None)) if k == "params" else
                {n: self.tp.blocks(_replica(t, self.rank, None)) for n, t in v.items()}
                if k == "opt" else v for k, v in state.items()}


@register_resize("local_sgd")
def resize(cfg, tcfg, old_mesh, new_mesh, state, keep):
    """The replicas after a resize: the stacked ``[dp, ...]`` rows of
    params and optimizer trees follow their workers, and a joiner's row is
    a copy of the first survivor's.  In a world a rank keeps its own
    replica and a joiner's (its fresh state) is filled by the elastic
    trainer's broadcast from the first survivor, new rank 0."""
    if common.is_world(new_mesh):
        return state if common.mesh_rank(new_mesh) is not None else None
    src = next(k for k in keep if k is not None)

    def sel(node):
        if isinstance(node, dict):
            return {k: sel(v) for k, v in node.items()}
        return torch.stack([node[src if k is None else k] for k in keep])

    return {**state, "params": sel(state["params"]), "opt": sel(state["opt"])}


@register("local_sgd")
def make(cfg: ModelConfig, tcfg: TrainConfig, *, dp: int, device="cuda", mesh=None):
    return LocalSGDStep(cfg, tcfg, dp, resolve_device(device), mesh)
