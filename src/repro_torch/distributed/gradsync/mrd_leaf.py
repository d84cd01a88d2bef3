"""Grad-sync strategy ``mrd_leaf``: the MRD butterfly allreduce of the
bucketed gradient tree and a replicated tree-shaped optimizer (port of
``repro.distributed.gradsync.mrd_leaf``).

Each rank's gradient (fp32, in the reference's leaf order) is packed into
size-capped buckets and allreduced by the ``mrd`` schedule with the
``identity`` transform, stage-major across the buckets
(:meth:`CollectivePlan.run_buffers`, the reference's ``run_bucketed``).
Every rank then holds the same sum, so the step divides one row by dp,
clips it by its global norm and runs AdamW on fp32 ``master``/``mu``/
``nu`` trees shaped like the params (``optim.apply_update_tree_``): the
reference's replicated optimizer, held once (16 B a parameter).  The new
params are the masters rounded to the param type, each leaf then kept in
its own type (fp32 leaves such as the moe router stay fp32, as the ZeRO-1
modes of both packages keep them; the reference's tree update leaves them
in the param type: a divergence kept on purpose, ROADMAP queue 3).  The
monitor rows advance as in ``mrd_zero1``.  In a world (one process a
rank over a mesh) each rank keeps its own reduced buckets and runs the
replicated optimizer on them; at ``tp`` > 1 (a ``("data", "model")``
mesh) a rank holds its blocks of the params and optimizer trees
(``common.ModelRanks``), buckets its local gradients, runs the butterfly
over its ``"data"`` column, and its grad norm counts each global element
once.  With ``tcfg.overlap`` each bucket enters the butterfly as its
backward segment completes (``gradsync.overlap``), the same buffers bit
for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.collectives import buckets, plans
from repro_torch.device import resolve_device
from repro_torch.distributed.gradsync import common, register, register_resize
from repro_torch.distributed.gradsync import overlap as overlap_lib
from repro_torch.distributed.gradsync.common import TrainConfig
from repro_torch.distributed.gradsync.snapshot import Snapshot
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.optim import optimizer as opt_lib


@dataclasses.dataclass
class LeafStep(Snapshot):
    """``(state, batch) -> (state, metrics)`` of one ``mrd_leaf`` step over
    ``dp`` ranks, and :meth:`init_state`.  The optimizer trees are updated
    in place."""

    cfg: ModelConfig
    tcfg: TrainConfig
    dp: int
    device: torch.device
    mesh: Any = None

    def __post_init__(self):
        self.rank = common.check_world(self.dp, self.mesh)
        self.tp = common.model_ranks(self.cfg, self.mesh)
        self.monitor = common.build_monitor(self.tcfg, self.dp, self.mesh)
        self.grad_ar = plans.allreduce_plan(
            schedule="mrd", op="sum", **common.plan_binding(self.dp, self.mesh),
            executor=common.resolve_executor(self.tcfg, mesh=self.mesh, device=self.device))

    def init_state(self, generator: torch.Generator):
        params = common.init_params(self.cfg, generator, self.device, self.tp)
        state = {"params": params, "opt": self.opt_from_params(params), "step": 0}
        if self.monitor is not None:
            state["monitor"] = common.monitor_rows_init(self.monitor, device=self.device)
        return state

    def opt_from_params(self, params) -> dict:
        """A fresh optimizer for ``params``: fp32 masters and zero moments."""
        return opt_lib.init_opt_state(params)

    def __call__(self, state, batch):
        params, opt, step = state["params"], state["opt"], state["step"]
        layout = buckets.build_layout(convert.reference_tree(params),
                                      bucket_bytes=self.tcfg.bucket_bytes,
                                      quantum=self.grad_ar.pad_quantum(), dtype=torch.float32)
        aux = {}
        with common.model_region(self.tp):
            if self.tcfg.overlap:
                red, loss, metric = overlap_lib.reduced_buckets(
                    params, batch, self.cfg, self.tcfg, self.dp, layout, self.rank,
                    self.grad_ar, aux)
            else:
                bufs, loss, metric = common.grad_buckets(params, batch, self.cfg, self.tcfg,
                                                         self.dp, layout, self.rank, aux)
                # the paper's butterfly over every bucket, stage-major
                red = self.grad_ar.run_buffers(bufs)
        # every row then holds the sum, so the first is kept
        red = [common.rows(b, self.rank)[0] for b in red]
        grads = buckets.tree_flatten(buckets.unpack(red, layout))[0]
        del red
        dp = torch.tensor(float(self.dp), device=self.device)  # true division on the card
        for g in grads:
            g.div_(dp)
        gnorm = common.clip_by_global_norm_(
            grads, self.tcfg.optimizer.grad_clip,
            sum_squares=None if self.tp is None else self.tp.sum_squares)
        leaves = {k: common.reference_leaves(v) for k, v in opt.items()}
        new = opt_lib.apply_update_tree_(grads, leaves, self.tcfg.optimizer, step,
                                         dtype_of(self.cfg.param_dtype))
        del grads
        new_params = common.like(convert.port_tree(buckets.tree_unflatten(layout.treedef, new)),
                                 params)
        mon, done, val = common.local_monitor_tick(self.monitor, state.get("monitor"), metric,
                                                   step)
        new_state = {"params": new_params, "opt": opt, "step": step + 1}
        if self.monitor is not None:
            new_state["monitor"] = mon
        return new_state, common.step_metrics(
            self.grad_ar, self.rank, self.dp, {"loss": loss, **aux},
            {"grad_norm": gnorm, "converged": done, "monitor_value": val})


    def rank_state(self, state) -> dict:
        """A coordinate's state from a stacked-layout one (whole leaves):
        its blocks of the params and the optimizer trees, its row of the
        monitor."""
        out = {"params": self.tp.blocks(state["params"]),
               "opt": {k: self.tp.blocks(v) for k, v in state["opt"].items()},
               "step": state["step"]}
        if "monitor" in state:
            out["monitor"] = common.monitor_row(state["monitor"], self.rank)
        return out


def monitor_only_resize(cfg, tcfg, old_mesh, new_mesh, state, keep):
    """A resize that moves only the monitor rows (the rest of the state is
    replicated): ``mrd_leaf``'s, and ``gspmd``'s on stacked rows.  In a
    world a removed rank gets None."""
    world = common.is_world(new_mesh)
    if world and common.mesh_rank(new_mesh) is None:
        return None
    out = dict(state)
    if "monitor" in state:
        out["monitor"] = common.monitor_rows_migrate(tcfg, common.mesh_dp(new_mesh),
                                                     state["monitor"], keep,
                                                     new_mesh if world else None)
    return out


register_resize("mrd_leaf")(monitor_only_resize)


@register("mrd_leaf")
def make(cfg: ModelConfig, tcfg: TrainConfig, *, dp: int, device="cuda", mesh=None):
    return LeafStep(cfg, tcfg, dp, resolve_device(device), mesh)
