"""Grad-sync strategy ``gspmd``: the reference's pjit baseline (port of
``repro.distributed.gradsync.gspmd``), the one every MRD mode is measured
against.

Params and the optimizer's ``master``/``mu``/``nu`` trees are placed by
``sharding.param_specs``: FSDP over ``"data"`` (always: no caller of the
reference sets its ``TrainConfig.fsdp`` False), TP over ``"model"``.
The ConvergenceMonitor still advances the paper's staged MRD detection
over the ``"data"`` ranks, fed each DP shard's mean
per-example loss of the last microbatch (every rank the global mean when
that microbatch does not split over the ranks, the reference's
replicated fallback).

The ranks run in one of two layouts:

- *stacked* (no mesh): the step is the unsharded full-batch step on one
  device, and ``dp`` only splits the per-example loss into the monitor's
  rows;
- *world* (a ``DeviceMesh`` with ``("data",)`` or ``("data", "model")``,
  one process a rank): each rank holds its block of every leaf
  (:func:`sharding.local_shard`) and the batch shard of its ``"data"``
  coordinate (every ``"model"`` rank of it the same).  The forward runs
  under a sharding context: each microbatch all-gathers the FSDP leaves
  (``sharding.gather_fsdp``, whose backward reduce-scatters their
  gradients over ``"data"``), and the model's tensor-parallel layers
  place their own collectives.  The gradients of the leaves replicated
  over ``"data"`` are then all-reduced over it (the DP all-reduce and
  reduce-scatter that XLA inserts in the reference), each rank's share
  of the global batch's loss making the sums the global gradient.  Then
  clip (the global norm counts each element once), the update of the
  rank's optimizer blocks, and the monitor.  With microbatches a rank
  trains on the reference's rows: microbatch ``i`` is the ``"data"``
  shard of the global batch's ``i``-th slice, so the ranks all-gather
  the (small) token batch first.

``tcfg.overlap`` is a no-op here, as in the reference: there is no
bucketed gradient path to reorder.  No MRD collective runs in this mode
(``mrd_combine`` launches no kernel).

Elastic resize (:func:`resize`): on stacked rows only the monitor rows
move (the params and optimizer trees do not depend on the extent), as
the reference's hook, whose XLA re-partitions its global arrays.  A world
holds explicit FSDP blocks, so its hook re-shards the params and every
optimizer tree over the new ``"data"`` extent (:func:`reshard_blocks` is
the rule on whole lists of blocks; :func:`reshard_world` runs it as one
MRD sum over the union of the old and the new ranks, where every element
has one nonzero contributor, so the global leaves stay bit for bit) and
moves the monitor rows.  A leaf's spec may change with the extent (a dim
shards over ``"data"`` only where the extent divides it).

A world's checkpoint is global leaves (:func:`save_global`, streamed to
the mesh's root), read back as each rank's blocks (:func:`restore_global`).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.collectives.buckets import tree_flatten, tree_unflatten
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.gradsync import common, register, register_resize
from repro_torch.distributed.gradsync.common import TrainConfig
from repro_torch.distributed.gradsync.snapshot import Snapshot
from repro_torch.models import convert, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.optim import optimizer as opt_lib


def monitor_rows(per_example: torch.Tensor, dp: int) -> torch.Tensor:
    """The stacked monitor's metric rows [dp]: each DP shard's mean of the
    per-example losses, or, when they do not split over ``dp``, every row
    the global mean."""
    if per_example.shape[0] % dp:
        return per_example.mean().expand(dp)
    return per_example.reshape(dp, -1).mean(1)


def expert_parallel_dims(cfg: ModelConfig, rules: shd.ShardingRules, specs) -> dict:
    """The port tree's specs with each EP expert dim (``w1``/``w3``/``w2``
    of the moe family sharded over ``"data"`` by expert) dropped: those
    blocks stay where they are (the tokens travel to them), every other
    ``"data"`` dim is an FSDP dim the forward all-gathers."""
    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif rules.ep and cfg.n_experts and k in ("w1", "w3", "w2") and len(v) >= 3:
                e = len(v) - 3
                out[k] = v[:e] + (None,) + v[e + 1:]
            else:
                out[k] = v
        return out

    return walk(specs)


@dataclasses.dataclass
class GspmdStep(Snapshot):
    """``(state, batch) -> (state, metrics)`` of one ``gspmd`` step and
    :meth:`init_state`.  Without a ``mesh`` ``batch`` is the global batch;
    in a world it is this rank's ``"data"`` shard."""

    cfg: ModelConfig
    tcfg: TrainConfig
    dp: int
    device: torch.device
    mesh: Any = None

    def __post_init__(self):
        self.rank = common.check_world(self.dp, self.mesh)
        where = {shd.DATA: self.dp} if self.mesh is None else self.mesh
        self.rules = shd.make_rules(self.cfg, where)
        self.monitor = common.build_monitor(self.tcfg, self.dp, self.mesh)
        self.sizes = dict(self.rules.sizes)
        self.coords = {} if self.mesh is None else shd.mesh_coords(self.mesh)
        self._specs = None

    # ------------------------------------------------------------ placement
    def specs(self) -> dict:
        """The port tree's param specs (of the global leaves' shapes,
        computed once)."""
        if self._specs is None:
            self._specs = shd.param_specs(self.cfg, self.rules, transformer.param_shapes(self.cfg))
        return self._specs

    def shard(self, tree, specs) -> dict:
        """This rank's blocks of a global tree (contiguous copies)."""
        return {k: self.shard(v, specs[k]) if isinstance(v, dict) else
                shd.local_shard(v, specs[k], self.coords, self.sizes).contiguous().clone()
                for k, v in tree.items()}

    def rank_state(self, state) -> dict:
        """A world rank's state from a stacked-layout one (global leaves,
        the monitor's ``[dp]`` rows): its blocks of the params and the
        optimizer trees, and its row of the monitor."""
        specs = self.specs()
        out = {"params": self.shard(state["params"], specs),
               "opt": {k: self.shard(v, specs) for k, v in state["opt"].items()},
               "step": state["step"]}
        if "monitor" in state:
            out["monitor"] = self.rank_monitor(state["monitor"])
        return out

    def rank_monitor(self, monitor) -> dict:
        """This rank's row of the monitor's ``[dp]`` rows."""
        r = self.coords[shd.DATA]
        return _map_tensors(lambda t: t[r].clone(), monitor)

    def blocks(self) -> dict:
        """{key path: this rank's slices} of every leaf of the params and
        the optimizer trees (``params/...``, ``opt/<name>/...``, the port's
        nesting), for reading the rank's blocks out of global leaves."""
        def walk(spec, shapes, prefix):
            out = {}
            for k, v in spec.items():
                if isinstance(v, dict):
                    out.update(walk(v, shapes[k], f"{prefix}/{k}"))
                else:
                    out[f"{prefix}/{k}"] = shd.local_index(tuple(shapes[k].shape), v,
                                                           self.coords, self.sizes)
            return out

        one = walk(self.specs(), transformer.param_shapes(self.cfg), "")
        return {f"{tree}{k}": v for tree in ("params", "opt/master", "opt/mu", "opt/nu")
                for k, v in one.items()}

    def global_leaves(self, state, device=None):
        """Yield (key path, global leaf) of every leaf of the params and the
        optimizer trees (the port's nesting, ``params/...``,
        ``opt/<name>/...``), each gathered on every rank when it is taken
        and moved to ``device`` (default: where it was) on the mesh's root
        (:func:`sharding.is_mesh_root`); the other ranks get None.  A rank
        holds one gathered leaf at a time beside its own state."""
        keep = shd.is_mesh_root(self.mesh)

        def walk(tree, spec, prefix):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from walk(v, spec[k], f"{prefix}/{k}")
                    continue
                g = shd.gather_global(v, spec[k], self.mesh)
                yield f"{prefix}/{k}", (g.to(device or g.device) if keep else None)
                del g

        specs = self.specs()
        yield from walk(state["params"], specs, "params")
        for name, tree in state["opt"].items():
            yield from walk(tree, specs, f"opt/{name}")

    def global_monitor(self, state, device=None) -> Optional[dict]:
        """The monitor's ``[dp]`` rows of a world, gathered over ``"data"``,
        on the mesh's root (None on the others, and without a monitor)."""
        if "monitor" not in state:
            return None
        keep = shd.is_mesh_root(self.mesh)
        ax = shd.ShardingContext(self.cfg, self.rules, self.mesh).axis(shd.DATA)
        mon = state["monitor"]

        def rows(t):
            g = t[None] if ax is None else shd._all_gather(t.reshape(1, *t.shape), 0, ax)
            return g.to(device or g.device)

        out = {"nb": {k: rows(v) if isinstance(v, torch.Tensor) else v
                      for k, v in mon["nb"].items()},
               "m": {k: rows(v) for k, v in mon.get("m", {}).items()},
               "value": rows(mon["value"]), "done": rows(mon["done"])}
        return out if keep else None

    def global_state(self, state, device=None) -> Optional[dict]:
        """The stacked-layout state of a world (global leaves, the
        monitor's ``[dp]`` rows) on the mesh's root, None on the others: every leaf
        of :meth:`global_leaves` kept (a test's whole small state; a
        checkpoint streams the leaves instead)."""
        leaves = dict(self.global_leaves(state, device))
        mon = self.global_monitor(state, device)
        if not shd.is_mesh_root(self.mesh):
            return None
        out: dict = {"step": state["step"]}
        for key, leaf in leaves.items():
            node = out
            *path, last = key.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[last] = leaf
        if mon is not None:
            out["monitor"] = mon
        return out

    # ------------------------------------------------------------ snapshots
    def bind(self, ck) -> None:
        """One writer: the mesh's root streams a world's global leaves."""
        ck.bind_world(None)

    def save(self, ck, step: int, state, extra: dict, *, block: bool) -> None:
        """:meth:`Snapshot.save`; a world's global leaves
        (:func:`save_global`, blocking)."""
        if self.mesh is None:
            return super().save(ck, step, state, extra, block=block)
        self.bind(ck)
        save_global(ck, state, self, extra)

    def restore(self, ck, state, *, params_only: bool = False) -> tuple:
        """:meth:`Snapshot.restore`; in a world this rank's blocks of the
        global leaves (:func:`global_reads`)."""
        if self.mesh is None:
            return super().restore(ck, state, params_only=params_only)
        from repro_torch.runtime.fault_tolerance import recover

        tree, blocks = global_reads(self, params_only)
        if params_only:
            got, report = recover(ck, tree, self.device, blocks=blocks, new_dp=self.dp,
                                  old_dp=ck.manifest(ck.latest_step())["extra"].get("dp"))
            return convert.port_tree(got["params"]), report
        self.bind(ck)
        state.clear()
        got, report = recover(ck, tree, "cpu", old_dp=self.dp, new_dp=self.dp, blocks=blocks)
        return state_from_global(got, self, self.device), report

    def init_state(self, generator: torch.Generator):
        """Random params from ``generator`` (the same draws on every rank),
        fp32 masters of them, zero moments and a fresh monitor; in a world
        each rank keeps its blocks, each taken as soon as its leaf is
        drawn."""
        place = ({} if self.mesh is None else
                 {"place": shd.Placer(self.cfg, self.rules, self.coords)})
        params = transformer.init_params(self.cfg, generator, self.device, **place)
        state = {"params": params, "opt": self.opt_from_params(params), "step": 0}
        if self.monitor is not None:
            state["monitor"] = common.monitor_rows_init(self.monitor, device=self.device)
        return state

    def opt_from_params(self, params) -> dict:
        """A fresh optimizer for ``params`` (a world rank's blocks): fp32
        masters and zero moments."""
        return opt_lib.init_opt_state(params)

    # ----------------------------------------------------------------- step
    def __call__(self, state, batch):
        params, opt, step = state["params"], state["opt"], state["step"]
        if self.mesh is None:
            grads, loss, metrics = common.microbatched_grads(params, batch, self.cfg,
                                                             self.tcfg.remat,
                                                             self.tcfg.microbatches)
            leaves = [g.float() for g in common.reference_leaves(grads)]
            del grads
            gnorm = common.clip_by_global_norm_(leaves, self.tcfg.optimizer.grad_clip)
            metric = monitor_rows(metrics["per_example"], self.dp)
        else:
            leaves, loss, metrics = self._world_grads(params, self.specs(), batch)
            spec_leaves = common.reference_leaves(self.specs())
            gnorm = common.clip_by_global_norm_(
                leaves, self.tcfg.optimizer.grad_clip,
                sum_squares=lambda sq: self._sum_squares(sq, spec_leaves))
            metric = metrics["per_example"].mean()
        opt_leaves = {k: common.reference_leaves(v) for k, v in opt.items()}
        new = opt_lib.apply_update_tree_(leaves, opt_leaves, self.tcfg.optimizer, step,
                                         dtype_of(self.cfg.param_dtype))
        del leaves
        treedef = tree_flatten(convert.reference_tree(params))[1]
        new_params = common.like(convert.port_tree(tree_unflatten(treedef, new)), params)
        mon, done, val = common.local_monitor_tick(self.monitor, state.get("monitor"), metric,
                                                   step)
        new_state = {"params": new_params, "opt": opt, "step": step + 1}
        if self.monitor is not None:
            new_state["monitor"] = mon
        out = {"loss": loss, "grad_norm": gnorm,
               "converged": done.reshape(-1)[0], "monitor_value": val.reshape(-1)[0]}
        if "aux_loss" in metrics:
            out["aux_loss"] = metrics["aux_loss"]
        return new_state, out

    def _sum_squares(self, squares: list, specs: list) -> torch.Tensor:
        """The global sum of every gradient element's square, each counted
        once: a leaf's local sum is added over the axes its spec shards it
        over (a leaf replicated over an axis holds the same values on every
        rank of it)."""
        groups: dict = {}
        for sq, spec in zip(squares, specs):
            axes = tuple(a for a in (shd.DATA, shd.MODEL)
                         if a in shd.sharded_axes(spec) and self.sizes.get(a, 1) > 1)
            groups[axes] = sq if axes not in groups else groups[axes] + sq
        total = None
        for axes, s in sorted(groups.items()):
            if axes:
                s = s.clone()
                for a in axes:  # axis by axis: a mesh may be short of the world
                    dist.all_reduce(s, group=self.mesh.get_group(a))
            total = s if total is None else total + s
        return total

    def _microbatches(self, batch) -> list:
        """This rank's rows of each microbatch: the ``"data"`` shard of the
        global batch's ``i``-th slice (the token batch all-gathered over
        ``"data"`` first when there are several)."""
        mb = self.tcfg.microbatches
        if mb == 1:
            return [batch]
        B = common.batch_size(batch)
        if (B * self.dp) % (mb * self.dp):
            raise ValueError(f"batch {B * self.dp} does not split into {mb} microbatches")
        per = B * self.dp // mb
        if per % self.dp:
            raise ValueError(f"a microbatch of {per} sequences does not split over dp={self.dp} "
                             f"ranks (a world needs whole rows a rank)")
        full = batch
        ax = shd.ShardingContext(self.cfg, self.rules, self.mesh).axis(shd.DATA)
        if ax is not None:
            full = {k: shd._all_gather(v, 0, ax) for k, v in batch.items()}
        r, q = self.rank, per // self.dp
        return [{k: v[i * per + r * q:i * per + (r + 1) * q] for k, v in full.items()}
                for i in range(mb)]

    def _world_grads(self, params, specs, batch):
        """(fp32 gradient blocks in the reference's leaf order, the global
        loss, the last microbatch's metrics) of a world rank.  The leaves
        outside the layer stacks are all-gathered over ``"data"`` once a
        microbatch; a stack's layers gather theirs as they read them
        (``sharding.layer_leaves``), so under remat a layer's gathered
        weights are made again in the backward pass, not kept."""
        leaves, treedef = tree_flatten(params)
        gather = expert_parallel_dims(self.cfg, self.rules, specs)
        layer_specs = {stack: {k: s[transformer.STACKS[stack]:] for k, s in gather[stack].items()}
                       for stack in transformer.STACKS if stack in gather}
        gather_specs = [() if path[0] in layer_specs else s
                        for path, s in zip(treedef, tree_flatten(gather)[0])]
        req = [t.detach().requires_grad_() for t in leaves]
        acc, loss_sum, metrics = None, None, None
        mbs = self._microbatches(batch)
        with shd.sharding_ctx(self.cfg, self.rules, self.mesh, layer_specs):
            for mb in mbs:
                with torch.enable_grad():
                    tp_params = tree_unflatten(treedef, [shd.gather_fsdp(t, s)
                                                         for t, s in zip(req, gather_specs)])
                    loss, m = transformer.forward_train(tp_params, mb, self.cfg, self.tcfg.remat)
                    grads = torch.autograd.grad(loss, req, allow_unused=True)
                grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, req)]
                total = m["loss"] + 0.01 * m["aux_loss"] if "aux_loss" in m else m["loss"]
                metrics = {k: v.detach() for k, v in m.items()}
                first = acc is None
                acc = acc or [None] * len(grads)
                for j in range(len(grads)):  # each leaf's own-type gradient freed as it goes
                    g, grads[j] = grads[j], None
                    acc[j] = g.float() if first else acc[j].add_(g.float())
                loss_sum = total.detach() if first else loss_sum + total.detach()
        # the DP all-reduce of the leaves no FSDP gather reduced (replicated
        # over "data"; an EP expert block already holds every rank's tokens)
        ax = shd.ShardingContext(self.cfg, self.rules, self.mesh).axis(shd.DATA)
        if ax is not None:
            for a, s in zip(acc, tree_flatten(specs)[0]):
                if shd.DATA not in shd.sharded_axes(s):
                    dist.all_reduce(a, group=ax.group)
        if len(mbs) > 1:
            div = acc[0].new_full((), float(len(mbs)))  # true division on the card too
            acc = [a / div for a in acc]
            loss_sum = loss_sum / div
        grads = common.reference_leaves(tree_unflatten(treedef, acc))
        return grads, loss_sum, metrics


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


# ---------------------------------------------------------------------------
# Checkpoints of a world: global leaves
# ---------------------------------------------------------------------------


def reference_keys(cfg) -> dict:
    """{the port's key path: the reference's} of every leaf of a train
    state's params and optimizer trees (``params/...``, ``opt/<name>/...``;
    ``convert.reference_tree`` moves leaves, it does not change them)."""
    from repro_torch.checkpoint.checkpointer import flatten_with_paths

    def paths(tree, prefix):
        return {k: paths(v, f"{prefix}/{k}") if isinstance(v, dict) else f"{prefix}/{k}"
                for k, v in tree.items()}

    shapes = transformer.param_shapes(cfg)
    out = {}
    for prefix in ("params", "opt/master", "opt/mu", "opt/nu"):
        nested = convert.reference_tree(paths(shapes, prefix))
        out.update({port: f"{prefix}/{ref}" for ref, port in flatten_with_paths(nested).items()})
    return out


def global_template(train_step) -> dict:
    """Meta tensors of a ``gspmd`` world's stacked-layout state: the
    global params, fp32 optimizer trees and the monitor's ``[dp]`` rows."""
    def meta(tree, dtype=None):
        return {k: meta(v, dtype) if isinstance(v, dict) else
                torch.empty(v.shape, dtype=dtype or v.dtype, device="meta")
                for k, v in tree.items()}

    params = meta(transformer.param_shapes(train_step.cfg))
    state = {"params": params, "opt": {k: meta(params, torch.float32)
                                       for k in ("master", "mu", "nu")}, "step": 0}
    if train_step.monitor is not None:
        mon = common.build_monitor(train_step.tcfg, train_step.dp)
        state["monitor"] = mon.init(device="cpu")
    return state


def save_global(ck, state, train_step, extra: dict) -> None:
    """A ``gspmd`` world's snapshot, the file a one-process trainer writes
    (global leaves, nested as the reference nests them): every rank
    gathers the leaves one at a time (``GspmdStep.global_leaves``) and
    the mesh's root writes each into the archive as it comes
    (``Checkpointer.save_streamed``), so no rank holds more than one
    global leaf beside its own blocks.  The save is done when it returns."""
    from repro_torch.checkpoint.checkpointer import flatten_with_paths

    leaves = train_step.global_leaves(state, "cpu")
    mon = train_step.global_monitor(state, "cpu")
    if not shd.is_mesh_root(train_step.mesh):
        for _ in leaves:  # the gathers, in step with the root's
            pass
        return
    template = convert.train_state_to_reference(global_template(train_step))
    specs = {k: (tuple(v.shape), v.dtype) for k, v in flatten_with_paths(template).items()}
    keys = reference_keys(train_step.cfg)
    small = {"step": state["step"], "params": {}, "opt": {}}
    if mon is not None:
        small["monitor"] = mon
    rest = flatten_with_paths(convert.train_state_to_reference(small))
    ck.save_streamed(state["step"], specs, itertools.chain(
        ((keys[k], leaf) for k, leaf in leaves), rest.items()), extra=extra)


def global_reads(train_step, params_only: bool = False) -> tuple:
    """(template, blocks) of a world rank's read of a checkpoint of global
    leaves (``Checkpointer.restore_blocks``): the template the saved
    state's (the reference's nesting, meta tensors of the global shapes)
    and each params and optimizer leaf's block (``GspmdStep.blocks``);
    ``params_only`` reads the params and the step alone."""
    template = convert.train_state_to_reference(global_template(train_step))
    if params_only:
        template = {"params": template["params"], "step": template["step"]}
    keys = reference_keys(train_step.cfg)
    blocks = {keys[k]: index for k, index in train_step.blocks().items()
              if not params_only or k.startswith("params/")}
    return template, blocks


def state_from_global(restored, train_step, device) -> dict:
    """A world rank's state from its read of a checkpoint of global leaves
    (:func:`global_reads`) on ``device``: its blocks, the step and its row
    of the monitor (a params-only read: the params and the step)."""
    state = {"params": convert.port_tree(restored["params"]), "step": int(restored["step"])}
    if "opt" in restored:
        state["opt"] = {k: convert.port_tree(v) for k, v in restored["opt"].items()}
    if "monitor" in restored:
        state["monitor"] = train_step.rank_monitor(
            convert.monitor_from_reference(restored["monitor"], "cpu"))
    return _to_device(state, device)


def restore_global(ck, step0: int, train_step, device) -> dict:
    """A ``gspmd`` world rank's state from a checkpoint of global leaves:
    each leaf's block read straight out of the file
    (``Checkpointer.restore_blocks``, through ``np.memmap``), so a rank
    reads its own blocks and no whole leaf of the params or optimizer,
    then placed on ``device``."""
    template, blocks = global_reads(train_step)
    restored = ck.restore_blocks(step0, template, blocks, "cpu", dp=train_step.dp)
    return state_from_global(restored, train_step, device)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


# ---------------------------------------------------------------------------
# Elastic resize: the FSDP blocks re-sharded over the new "data" extent
# ---------------------------------------------------------------------------


def _data_only(spec: tuple) -> tuple:
    return tuple(e if shd.DATA in shd.spec_axes(e) else None for e in spec)


def data_sharded(spec: tuple) -> bool:
    """Does ``spec`` shard a dim over ``"data"``?"""
    return shd.DATA in shd.sharded_axes(spec)


def data_index(shape, spec: tuple, coord: int, dp: int) -> tuple:
    """The slices of ``"data"`` coordinate ``coord``'s block (of ``dp``)
    within a leaf's *model block* of ``shape`` (the leaf cut along its
    ``"model"`` dims alone, what :func:`sharding.gather_fsdp` gives) under
    ``spec``; the whole block where ``spec`` shards no dim over
    ``"data"``."""
    return shd.local_index(tuple(shape), _data_only(spec), {shd.DATA: coord}, {shd.DATA: dp})


def model_block_shape(shape, spec: tuple, sizes) -> tuple:
    """A global leaf's ``shape`` cut along its ``"model"`` dims."""
    out = []
    for n, e in zip(shape, spec):
        for a in shd.spec_axes(e):
            if a != shd.DATA:
                n //= sizes[a]
        out.append(n)
    return tuple(out)


def reshard_blocks(old_blocks: list, specs: tuple, dp_new: int) -> list:
    """One leaf's ``"data"`` blocks of one model coordinate carried to a
    new extent: ``old_blocks`` by old ``"data"`` coordinate under spec
    ``specs[0]`` (each the whole model block where it shards no dim over
    ``"data"``) -> ``dp_new`` contiguous blocks under ``specs[1]``.  A
    copy of every element, so the model block (and the global leaf) is
    the same bit for bit."""
    spec_o, spec_n = specs
    dp_o = len(old_blocks)
    first = old_blocks[0]
    if data_sharded(spec_o):
        shape = tuple(n * dp_o if shd.DATA in shd.spec_axes(e) else n
                      for n, e in zip(first.shape, spec_o))
        whole = first.new_empty(shape)
        for d, b in enumerate(old_blocks):
            whole[data_index(shape, spec_o, d, dp_o)] = b
    else:
        whole = first
    return [whole[data_index(whole.shape, spec_n, d, dp_new)].contiguous().clone()
            for d in range(dp_new)]


def _union_sum_(buf: torch.Tensor, plan) -> torch.Tensor:
    """``buf`` summed over ``plan``'s ranks in place, a piece of
    ``distributed.serve.BROADCAST_CHUNK`` elements at a time (bools as
    uint8)."""
    from repro_torch.distributed.serve import BROADCAST_CHUNK

    flat = buf.view(-1)
    if flat.dtype == torch.bool:
        flat = flat.view(torch.uint8)
    for i in range(0, flat.numel(), BROADCAST_CHUNK):
        piece = flat[i:i + BROADCAST_CHUNK]
        piece.copy_(plan.run(piece.clone()))
    return buf


def reshard_world(cfg: ModelConfig, tcfg: TrainConfig, old_mesh, new_mesh, state, keep):
    """:func:`reshard_blocks` in a world, run by every process of the union
    of the old and the new ranks: leaf by leaf, of the params and of every
    optimizer tree, an old member writes its block into zeros of the
    leaf's model block (a leaf that shards no dim over ``"data"``: old
    ``"data"`` rank 0 only), an MRD sum over the union's ``"data"``
    column adds them (one nonzero term an element: exact), and a member
    of the new mesh keeps its new block.  A joiner's ``state`` (a fresh
    one) contributes nothing; the monitor rows migrate as on stacked rows.
    Returns the new state, or None on a rank the resize removed."""
    from repro_torch.collectives import plans

    d_o, d_n = common.mesh_rank(old_mesh), common.mesh_rank(new_mesh)
    dp_o, dp_n = common.mesh_dp(old_mesh), common.mesh_dp(new_mesh)
    joiner = d_n is not None and keep[d_n] is None
    src = None if joiner else d_o
    union = new_mesh if any(k is None for k in keep) else old_mesh
    plan = plans.allreduce_plan(schedule="mrd", op="sum", executor="device",
                                **common.plan_binding(common.mesh_dp(union), union))
    shapes = transformer.param_shapes(cfg)
    rules_o, rules_n = shd.make_rules(cfg, old_mesh), shd.make_rules(cfg, new_mesh)
    specs_o = shd.param_specs(cfg, rules_o, shapes)
    specs_n = shd.param_specs(cfg, rules_n, shapes)
    sizes = dict(rules_n.sizes)

    def leaf(block, shape, spec_o, spec_n):
        whole = model_block_shape(shape, spec_o, sizes)
        buf = torch.zeros(whole, dtype=block.dtype, device=block.device)
        if src is not None and (data_sharded(spec_o) or src == 0):
            buf[data_index(whole, spec_o, src, dp_o)] = block
        _union_sum_(buf, plan)
        if d_n is None:
            return None
        return buf[data_index(whole, spec_n, d_n, dp_n)].contiguous().clone()

    def walk(tree, shp, so, sn):
        return {k: walk(v, shp[k], so[k], sn[k]) if isinstance(v, dict) else
                leaf(v, tuple(shp[k].shape), so[k], sn[k]) for k, v in tree.items()}

    params = walk(state["params"], shapes, specs_o, specs_n)
    opt = {name: walk(tree, shapes, specs_o, specs_n) for name, tree in state["opt"].items()}
    if d_n is None:
        return None
    out = {**state, "params": params, "opt": opt}
    if "monitor" in state:
        out["monitor"] = common.monitor_rows_migrate(tcfg, dp_n, state["monitor"], keep, new_mesh)
    return out


@register_resize("gspmd")
def resize(cfg, tcfg, old_mesh, new_mesh, state, keep):
    """Stacked rows: only the monitor's ``[dp]`` rows move.  A world:
    :func:`reshard_world`."""
    from repro_torch.distributed.gradsync.mrd_leaf import monitor_only_resize

    if common.is_world(new_mesh):
        return reshard_world(cfg, tcfg, old_mesh, new_mesh, state, keep)
    return monitor_only_resize(cfg, tcfg, old_mesh, new_mesh, state, keep)


@register("gspmd")
def make(cfg: ModelConfig, tcfg: TrainConfig, *, dp: int, device="cuda", mesh=None):
    return GspmdStep(cfg, tcfg, dp, resolve_device(device), mesh)
