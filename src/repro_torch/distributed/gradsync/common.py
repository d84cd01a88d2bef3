"""Shared building blocks of the grad-sync strategies (port of
``repro.distributed.gradsync.common``).

Every strategy composes the same pieces: microbatched gradients, the
remat policy (``"none"``, ``"full"`` or ``"dots"``, see
``transformer.remat_call``), the paper's ConvergenceMonitor (advanced one MRD stage per
train step, never blocking) and the optimizer.  Strategies differ only in
how the gradient crosses the data-parallel ranks and where the optimizer
state lives.

The data-parallel ranks run in one of two layouts:

- *sim* (no mesh): the ranks are the rows of stacked ``[dp, ...]``
  tensors on one device; each rank computes its own gradient on its own
  batch shard, one rank after the other, and the plans run on the
  ``sim`` executor;
- *world* (a ``torch.distributed`` :class:`DeviceMesh` with the dimension
  ``"data"``): one process a rank, each holding only its own state and
  batch shard; the plans run on the ``device``/``device_fused``
  executors, and every value that crosses the ranks (the gradient
  buckets, the grad norm, the logged loss, the monitor) goes through
  them, as the reference's ``shard_map`` bodies use only the plans.

A world rank computes what the sim computes for its row, with the same
operations on the same values, so each rank's state equals the sim's row
of it bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch

from repro_torch.asynchrony import ConvergenceMonitor
from repro_torch.collectives.buckets import pack_bucket, tree_flatten, tree_unflatten
from repro_torch.collectives.executors import axis_ranks
from repro_torch.models import convert, transformer
from repro_torch.optim.optimizer import OptimizerConfig

REMAT_POLICIES = transformer.REMAT


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: str = "full"  # 'none' | 'full' | 'dots'
    grad_sync: str = "gspmd"  # any name in repro_torch.distributed.gradsync.GRAD_SYNC
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
    # collectives executor of the gradient plans: None = auto
    # (resolve_executor); 'device_fused' routes the int8 combine through
    # the mrd_combine kernel
    collective_executor: Optional[str] = None
    # cap on each dtype-homogeneous gradient bucket; None = one bucket
    bucket_bytes: Optional[int] = 32 * 2**20
    # ready-bucket overlap (gradsync.overlap): issue each gradient bucket's
    # MRD stages as its backward segment completes instead of after the
    # whole backward; the same buffers bit for bit.  Honored by the
    # gradient-scale modes (mrd_paper, mrd_zero1, compressed, mrd_leaf);
    # gspmd and local_sgd have no bucketed gradient path and ignore it.
    overlap: bool = False


DATA = "data"  # the mesh dimension of the data-parallel ranks


@dataclasses.dataclass
class ModelRanks:
    """The ``"model"`` side of an MRD world at ``tp`` > 1 (a ``("data",
    "model")`` mesh, one process a coordinate): every process holds its
    TP-local block of every leaf, the blocks a ``gspmd`` step's
    :class:`~repro_torch.distributed.sharding.Placer` gives it under
    ``make_rules(cfg, mesh, fsdp=False)`` (the reference's
    ``make_zero1``: no FSDP, experts replicated over ``"data"``), runs
    the model under the rules' :meth:`manual_region` (TP live, every
    batch statistic its own) and its gradient plans over its ``"data"``
    column.  A leaf replicated over ``"model"`` has the same values and
    the same gradient on every model rank; a sharded one a block a
    rank."""

    cfg: Any
    mesh: Any

    def __post_init__(self):
        from repro_torch.distributed import sharding as shd

        self.rules = shd.make_rules(self.cfg, self.mesh, fsdp=False)
        self.coords = shd.mesh_coords(self.mesh)
        self.sizes = dict(self.rules.sizes)
        self.axis = shd.ShardingContext(self.cfg, self.rules, self.mesh).axis(shd.MODEL)
        self.rank = self.axis.rank
        self.specs = shd.param_specs(self.cfg, self.rules, transformer.param_shapes(self.cfg))
        self.replicated = replicated_leaves(self.specs)

    def region(self):
        """The model's sharding context of a step: TP over ``"model"``,
        no DP axes."""
        from repro_torch.distributed import sharding as shd

        return shd.sharding_ctx(self.cfg, self.rules.manual_region(), self.mesh)

    def placer(self):
        """``init_params``'s ``place``: this coordinate's blocks."""
        from repro_torch.distributed import sharding as shd

        return shd.Placer(self.cfg, self.rules, self.coords)

    def blocks(self, tree: dict) -> dict:
        """This coordinate's blocks (contiguous copies) of a tree of whole
        leaves in the params' nesting."""
        from repro_torch.distributed import sharding as shd

        def walk(node, spec):
            return {k: walk(v, spec[k]) if isinstance(v, dict) else
                    shd.local_shard(v, spec[k], self.coords, self.sizes).contiguous().clone()
                    for k, v in node.items()}

        return walk(tree, self.specs)

    def weight(self, replicated: bool) -> bool:
        """Does this rank count a leaf's elements in a global sum (a
        replicated leaf's on model rank 0 only)?"""
        return not replicated or self.rank == 0

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The model ranks' sum of the 0-d fp32 ``x``, the same bits on
        every rank: the values are all-gathered and added in rank order."""
        from repro_torch.distributed import sharding as shd

        out = shd._all_gather(x.reshape(1), 0, self.axis)
        total = out[0]
        for i in range(1, self.axis.size):
            total = total + out[i]
        return total

    def sum_squares(self, squares: list) -> torch.Tensor:
        """``clip_by_global_norm_``'s ``sum_squares`` over this rank's
        leaves (the reference's flatten order): each global element's
        square counted once, in the leaves' order, then over the model
        ranks."""
        sq = squares[0].new_zeros(())
        for s, rep in zip(squares, self.replicated):
            if self.weight(rep):
                sq = sq + s
        return self.sum(sq)


def replicated_leaves(specs: dict) -> list:
    """For each leaf of a param spec tree (the port's nesting), in the
    reference's flatten order: is it replicated over ``"model"``?"""
    from repro_torch.distributed.sharding import MODEL, sharded_axes

    return [MODEL not in sharded_axes(s) for s in reference_leaves(specs)]


def replicated_groups(cfg, mesh) -> Optional[list]:
    """:attr:`ModelRanks.replicated` of a world's ``mesh`` (the labels
    ``zero1_layout`` keeps apart at ``tp`` > 1), or None without a
    ``"model"`` dimension of more than one rank; read from the mesh's
    sizes alone, so a process outside ``mesh`` gets them too."""
    from repro_torch.distributed import sharding as shd

    if not is_world(mesh) or shd.MODEL not in mesh.mesh_dim_names:
        return None
    if mesh.size(mesh.mesh_dim_names.index(shd.MODEL)) == 1:
        return None
    rules = shd.make_rules(cfg, mesh, fsdp=False)
    return replicated_leaves(shd.param_specs(cfg, rules, transformer.param_shapes(cfg)))


def model_ranks(cfg, mesh) -> Optional[ModelRanks]:
    """:class:`ModelRanks` of a world whose mesh has a ``"model"``
    dimension of more than one rank, else None (stacked rows, a
    ``("data",)`` world)."""
    from repro_torch.distributed.sharding import MODEL

    if mesh is None or MODEL not in (mesh.mesh_dim_names or ()):
        return None
    if mesh.size(mesh.mesh_dim_names.index(MODEL)) == 1:
        return None
    return ModelRanks(cfg, mesh)


def monitor_row(monitor, rank: int):
    """Row ``rank`` of a stacked monitor state's ``[dp]`` rows (a world
    rank's own state)."""
    if isinstance(monitor, dict):
        return {k: monitor_row(v, rank) for k, v in monitor.items()}
    return monitor[rank].clone() if isinstance(monitor, torch.Tensor) else monitor


def model_region(tp: Optional[ModelRanks]):
    """The model's sharding context of a step (:meth:`ModelRanks.region`),
    or none without TP."""
    return contextlib.nullcontext() if tp is None else tp.region()


def init_params(cfg, generator, device, tp: Optional[ModelRanks]):
    """Random params from ``generator``: whole, or at ``tp`` > 1 this
    coordinate's blocks (the same numbers as the whole init's)."""
    place = {} if tp is None else {"place": tp.placer()}
    return transformer.init_params(cfg, generator, device, **place)


def resolve_executor(tcfg: TrainConfig, *, compressed: bool = False, mesh=None,
                     device=None) -> str:
    """The executor of the gradient plans, the reference's rule with CUDA
    in the TPU's place: an explicit ``tcfg.collective_executor`` wins; in
    a world (``mesh``) the int8 sync on a CUDA device gets
    ``device_fused`` (the ``mrd_combine`` kernel combines each received
    payload) and anything else ``device``; without a world the ranks are
    rows and the executor is ``sim`` (whose int8 combine on a CUDA tensor
    is the kernel too)."""
    if tcfg.collective_executor is not None:
        return tcfg.collective_executor
    if mesh is None:
        return "sim"
    if compressed and torch.device(device).type == "cuda":
        return "device_fused"
    return "device"


def is_world(mesh) -> bool:
    """Is ``mesh`` a world's :class:`DeviceMesh` (not a stacked-rows extent:
    ``None``, or the elastic trainer's tuple of replica ids)?"""
    return mesh is not None and hasattr(mesh, "mesh_dim_names")


def mesh_dp(mesh) -> int:
    """The data-parallel extent of a world's mesh (its ``"data"``
    dimension) or of a stacked-rows tuple of replica ids."""
    if is_world(mesh):
        return mesh.size(mesh.mesh_dim_names.index(DATA))
    return len(mesh)


def mesh_rank(mesh) -> Optional[int]:
    """This process's ``"data"`` rank in a world's mesh, or None when the
    process lies outside it (a spare, or a worker the elastic trainer
    removed)."""
    if mesh.get_coordinate() is None:
        return None
    return axis_ranks(mesh, DATA)[0]


def world_rank(mesh) -> tuple[int, int]:
    """(this process's rank, the rank count) along ``mesh``'s ``"data"``
    dimension (its coordinate: the elastic trainer's meshes list their
    ranks out of order)."""
    return axis_ranks(mesh, DATA)[0], mesh.size(mesh.mesh_dim_names.index(DATA))


def plan_binding(dp: int, mesh) -> dict:
    """The keyword arguments that bind a plan to the ranks: the sim's rank
    count, or the world's ``"data"`` dimension."""
    return {"p": dp} if mesh is None else {"axes": (DATA,), "mesh": mesh}


def check_world(dp: int, mesh) -> Optional[int]:
    """This process's rank in the world of ``mesh`` (None without one);
    raises unless the world has ``dp`` ranks."""
    if mesh is None:
        return None
    rank, size = world_rank(mesh)
    if size != dp:
        raise ValueError(f"dp={dp} but the mesh's {DATA!r} dimension has {size} ranks")
    return rank


def gather_scalars(plan, values: list, rank: int, dp: int) -> torch.Tensor:
    """Every rank's ``values`` (scalars: 0-d, or one element): ``[len(values), dp]`` fp32,
    column r rank r's, on every rank.  Each rank writes its values into
    its own column of zeros and ``plan`` (an MRD sum over the world) adds
    the columns: a sum with one nonzero term a slot is exact, so the rows
    are the values themselves, bit for bit, and a mean over a row is the
    sim's mean over its stacked ranks."""
    x = values[0].new_zeros((len(values), dp), dtype=torch.float32)
    x[:, rank] = torch.stack([v.float().reshape(()) for v in values])
    return plan.run(x.reshape(-1)).reshape(len(values), dp)


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
        return one_microbatch(p_req, req, mb, cfg, remat)

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


def one_microbatch(p_req, req: list, mb, cfg, remat: str):
    """(gradients of ``req`` in its order, loss, metrics) of one
    microbatch ``mb`` on the params ``p_req`` whose leaves ``req`` require
    grad; a leaf the loss does not read gets zeros."""
    with torch.enable_grad():
        loss, metrics = transformer.forward_train(p_req, mb, cfg, remat)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, req)]
    return grads, loss.detach(), {k: v.detach() for k, v in metrics.items()}


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


def local_shards(batch, dp: int, rank: Optional[int]) -> list:
    """The batch shards this process computes: every rank's of the global
    batch (the sim), or a world rank's own ``batch``."""
    return rank_shards(batch, dp) if rank is None else [batch]


def rows(x: torch.Tensor, rank: Optional[int]) -> torch.Tensor:
    """``x`` as rows a rank: the sim's stacked ``[dp, ...]`` as it is, a
    world rank's own ``[...]`` as its one row ``[1, ...]`` (a view)."""
    return x if rank is None else x[None]


def clip_by_global_norm_(leaves: list, max_norm: float, sum_squares=None) -> torch.Tensor:
    """The reference's ``clip_by_global_norm`` in place on a list of leaves
    (in the reference's flatten order: the norm's squares are summed leaf
    by leaf in that order): with ``max_norm`` > 0, every leaf is scaled by
    ``min(1, max_norm / max(norm, 1e-12))``.  Returns the fp32 norm (0
    when ``max_norm`` <= 0, as the reference's).  ``sum_squares``, when
    given, maps the leaves' own sums of squares to the global sum: over
    sharded leaves each element's square must count once (``gspmd``)."""
    if max_norm <= 0:
        return leaves[0].new_zeros((), dtype=torch.float32)
    if sum_squares is not None:
        sq = sum_squares([g.float().square().sum() for g in leaves])
    else:
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


def rank_grad_buckets(params, batch, cfg, tcfg: TrainConfig, layout, aux=None):
    """A world rank's :func:`stacked_grad_buckets`: the gradient of its own
    batch shard ``batch``, packed into fp32 1-D buckets of ``layout``;
    returns (buffers, loss, monitor metric), the loss and the metric 0-d.
    Each bucket's leaves are released as soon as it is packed.  The moe
    family's aux loss of the rank goes into ``aux`` as ``aux_loss``."""
    grads, loss, metrics = microbatched_grads(params, batch, cfg, tcfg.remat,
                                              tcfg.microbatches)
    leaves = reference_leaves(grads)
    del grads
    if aux is not None and "aux_loss" in metrics:
        aux["aux_loss"] = metrics["aux_loss"]
    bufs = []
    for i, b in enumerate(layout.buckets):
        buf = torch.zeros((b.length,), dtype=torch.float32, device=loss.device)
        pack_bucket(leaves, layout, i, out=buf)
        for s in b.slots:
            leaves[s.index] = None
        bufs.append(buf)
    return bufs, loss, metrics["per_example"].mean()


def grad_buckets(params, batch, cfg, tcfg: TrainConfig, dp: int, layout, rank: Optional[int],
                 aux=None):
    """The gradient buckets of :func:`stacked_grad_buckets` (the sim,
    ``rank`` None) or of :func:`rank_grad_buckets` (a world rank)."""
    if rank is None:
        return stacked_grad_buckets(params, batch, cfg, tcfg, dp, layout, aux)
    return rank_grad_buckets(params, batch, cfg, tcfg, layout, aux)


def step_metrics(plan, rank: Optional[int], dp: int, means: dict, firsts: dict) -> dict:
    """A step's metrics in either layout: each of ``means`` the ranks'
    mean (the sim's ``[dp]`` rows, or every world rank's own value
    gathered exactly by ``plan``, :func:`gather_scalars`), each of
    ``firsts`` (values every rank holds equal) its first row."""
    if rank is not None and means:
        means = dict(zip(means, gather_scalars(plan, list(means.values()), rank, dp)))
    return {**{k: v.mean() for k, v in means.items()},
            **{k: v.reshape(-1)[0] for k, v in firsts.items()}}


# ---------------------------------------------------------------------------
# Monitor wiring (identical across strategies)
# ---------------------------------------------------------------------------


def build_monitor(tcfg: TrainConfig, dp: int, mesh=None) -> Optional[ConvergenceMonitor]:
    """The paper's staged detector over the ``dp`` ranks (stacked rows, or
    the ``"data"`` dimension of a world's ``mesh``), or None."""
    if not tcfg.monitor:
        return None
    where: dict[str, Any] = {"p": dp} if mesh is None else {"axis_name": DATA, "mesh": mesh}
    return ConvergenceMonitor(threshold=tcfg.monitor_threshold, mode=tcfg.monitor_mode, **where)


def monitor_rows_migrate(tcfg: TrainConfig, dp: int, rows, keep, mesh=None):
    """The ``state["monitor"]`` rows after a resize to ``dp`` ranks (None
    passes through): the survivors' rows follow their workers, a joiner
    gets a fresh row, and the staged reduction restarts
    (:meth:`ConvergenceMonitor.migrate_rows`).  In a world (``mesh``, the
    new one) ``rows`` is the rank's own old state."""
    monitor = build_monitor(tcfg, dp, mesh if is_world(mesh) else None)
    if monitor is None or rows is None:
        return rows
    return monitor.migrate_rows(rows, keep)


def monitor_rows_init(monitor: Optional[ConvergenceMonitor], *, device):
    """The monitor's state, one row per rank (a world rank's own scalars;
    None without a monitor)."""
    return None if monitor is None else monitor.init(device=device)


def local_monitor_tick(monitor, mon_state, metric, step: int):
    """Advance every rank's monitor row by one stage with its ``metric``
    [dp] (a world rank: its own 0-d metric).  Returns (new rows, done
    [dp], value [dp]); zeros without a monitor."""
    if monitor is None:
        zeros = torch.zeros_like(metric)
        return mon_state, zeros.bool(), zeros.float()
    return monitor.step(mon_state, metric, step)
