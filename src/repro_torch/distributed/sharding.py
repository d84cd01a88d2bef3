"""Divisibility-aware sharding rules, and the explicit tensor and data
parallelism that runs them (port of ``repro.distributed.sharding``).

Mesh axes: ``("data", "model")`` or ``("data",)``.  ``"data"`` is the
DP/FSDP domain, ``"model"`` is TP.  Per-arch decisions are derived, as in
the reference:

- attention activations shard over heads iff ``n_heads % tp == 0`` (else
  the heads stay replicated and TP lives in the flattened QKV projections
  and the MLP);
- the moe expert dim shards over the FSDP axis iff ``n_experts % fsdp ==
  0`` (true EP), else the experts replicate and d_ff shards over TP;
- every weight matmul dim shards only when divisible.

A spec is a plain tuple with one entry a dimension: a mesh-axis name, a
tuple of names (:meth:`ShardingRules.batch_axes`), or None (replicated):
the port's ``PartitionSpec``.  :func:`param_specs` walks the port's param
dict by key name, as the reference's walks its pytree, and gives the
reference's specs.  The rules are built from the mesh's axis names and
sizes (``{"data": 2, "model": 2}``, or a ``DeviceMesh``), so they need no
process group; a :class:`ShardingContext` carries the ``DeviceMesh``
beside them.  This module is the only source of placements in the port:
:func:`local_index` and :func:`local_shard` give a rank's block of a
global tensor under a spec (the params' and optimizer's blocks, a
checkpoint's reads), and the models ask it which of their dimensions
are local (:func:`attn_heads` reads the ``"q"`` and ``"k"`` specs of
:meth:`ShardingContext.spec_for`, :func:`tp_dim` the rules).

How a spec runs.  GSPMD inserts the reference's collectives; PyTorch has
no such compiler, so the port places them itself.  It holds explicit
local shards (each rank the block of every leaf that its spec gives it)
and calls this module's autograd pairs at the reference's constraint
points, Megatron-style, rather than running DTensors: every hand-written
kernel (flash and paged attention, rmsnorm, the selective scan) has to
see a plain tensor anyway, so under DTensor each would sit in a
``local_map`` and every plain constant that meets a sharded tensor
(positions, masks, RoPE tables, token ids, block tables) would need
wrapping; serving shares the model code, and its decode ticks are bound
by the host, where a DTensor's eager dispatch adds time to every op; and
the few collectives of a layer stay visible at their call sites.

The convention over ``"model"``: a tensor is either *replicated* (every
rank holds the same values, and its gradient is the full gradient on
every rank) or *local* (each rank holds its own part).  Four pairs move
between the two:

- :func:`tp_copy` (identity forward, all-reduce backward): a replicated
  tensor entering a computation each rank does on its own part (a
  column-parallel matmul, a scan over local channels);
- :func:`tp_reduce` (all-reduce forward, identity backward): each rank's
  partial sum into a replicated tensor (after a row-parallel matmul, a
  vocabulary-parallel lookup);
- :func:`tp_gather` (all-gather forward, the local chunk backward) and
  :func:`tp_split` (the local chunk forward, all-gather backward).

Over ``"data"`` every rank computes on its own batch shard, so every
gradient is a partial sum: :func:`gather_fsdp` all-gathers an FSDP
leaf's blocks and reduce-scatters its gradient; :func:`data_sum` adds a
statistic of the global batch (the token count, the moe routing shares)
with an identity backward, so that each rank's backward reaches its own
contribution and the ranks' gradients sum to the global batch's.

The reference's ``constrain`` points are the call sites of these pairs
(a tensor of explicit local shards is already laid out as its kind
says).  Outside a context (or with one rank on every axis) every
function here is the identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch.models.config import ModelConfig

DATA, MODEL = "data", "model"


def P(*entries) -> tuple:
    """A spec of ``entries``, a one-axis tuple entry written as its name
    (as ``jax.sharding.PartitionSpec`` normalizes it)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)

# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    sizes: tuple  # ((axis name, size), ...) in the mesh's order
    dp_axes: tuple  # ("data",) or ()
    fsdp_axis: Optional[str]  # weight/opt-state sharding over DP ("data")
    tp_axis: Optional[str]
    attn_heads_sharded: bool
    kv_heads_sharded: bool
    ep: bool  # expert dim over fsdp axis

    def size(self, axis: str) -> int:
        return dict(self.sizes)[axis]

    @property
    def tp(self) -> int:
        return self.size(self.tp_axis) if self.tp_axis else 1

    @property
    def dp(self) -> int:
        out = 1
        for a in self.dp_axes:
            out *= self.size(a)
        return out

    def fsdp_if(self, dim: int):
        if self.fsdp_axis and dim % self.size(self.fsdp_axis) == 0:
            return self.fsdp_axis
        return None

    def tp_if(self, dim: int):
        if self.tp_axis is None:
            return None
        return self.tp_axis if dim % self.tp == 0 else None

    def batch_axes(self, batch_dim: int):
        """DP axes for a batch dim, or None when indivisible (e.g. B=1)."""
        if not self.dp_axes:
            return None
        return self.dp_axes if batch_dim % self.dp == 0 else None

    def manual_region(self) -> "ShardingRules":
        """Rules for code that already runs on its DP shard: batch dims are
        local (no DP constraints); TP stays."""
        return dataclasses.replace(self, dp_axes=(), fsdp_axis=None)

    def full_manual_region(self) -> "ShardingRules":
        """Rules for code that runs on its shard of every axis: nothing is
        sharded, TP clears too."""
        return dataclasses.replace(self, dp_axes=(), fsdp_axis=None, tp_axis=None)


def mesh_sizes(mesh) -> tuple:
    """((axis name, size), ...) of a ``DeviceMesh`` or of a mapping such
    as ``{"data": 2, "model": 2}``."""
    if isinstance(mesh, Mapping):
        return tuple((str(k), int(v)) for k, v in mesh.items())
    return tuple((n, mesh.size(i)) for i, n in enumerate(mesh.mesh_dim_names))


def make_rules(cfg: ModelConfig, mesh, *, fsdp: bool = True,
               tp_axis: str = MODEL) -> ShardingRules:
    """The reference's ``make_rules`` over ``mesh``: a ``DeviceMesh`` or
    ``{axis name: size}``."""
    sizes = mesh_sizes(mesh)
    shape = dict(sizes)
    axes = [n for n, _ in sizes]
    if tp_axis not in axes:
        tp_axis = None  # pure-DP mesh
    dp_axes = tuple(a for a in axes if a != tp_axis)
    fsdp_axis = DATA if (fsdp and DATA in axes) else None
    tp = shape[tp_axis] if tp_axis else 1
    heads_ok = tp_axis is not None and cfg.n_heads > 0 and cfg.n_heads % tp == 0
    kv_ok = tp_axis is not None and cfg.n_kv_heads > 0 and cfg.n_kv_heads % tp == 0
    ep = cfg.n_experts > 0 and fsdp_axis is not None and cfg.n_experts % shape[fsdp_axis] == 0
    return ShardingRules(sizes=sizes, dp_axes=dp_axes, fsdp_axis=fsdp_axis, tp_axis=tp_axis,
                         attn_heads_sharded=heads_ok, kv_heads_sharded=kv_ok, ep=ep)


# ---------------------------------------------------------------------------
# Param specs (by key name; stacked leading dims get None)
# ---------------------------------------------------------------------------


def _leaf_spec(name: str, shape, cfg: ModelConfig, r: ShardingRules) -> tuple:
    """Spec for the logical (unstacked) trailing dims of a param leaf."""
    t, f = r.tp_if, r.fsdp_if

    def pad(spec_tail):
        return (None,) * (len(shape) - len(spec_tail)) + tuple(spec_tail)

    if name == "embed":
        return pad((t(shape[-2]), None))
    if name == "lm_head":
        return pad((None, t(shape[-1])))
    if name in ("patch_proj", "frame_proj", "router"):
        return pad((None, None))
    if name in ("wq", "wk", "wv"):
        return pad((f(shape[-2]), t(shape[-1])))
    if name in ("bq", "bk", "bv"):
        return pad((t(shape[-1]),))
    if name == "wo":
        return pad((t(shape[-2]), f(shape[-1])))
    if name in ("w1", "w3"):
        if len(shape) >= 3 and cfg.n_experts:  # [.., E, d, f]
            if r.ep:
                return pad((r.fsdp_axis, None, t(shape[-1])))
            return pad((None, f(shape[-2]), t(shape[-1])))
        return pad((f(shape[-2]), t(shape[-1])))
    if name == "w2":
        if len(shape) >= 3 and cfg.n_experts:  # [.., E, f, d]
            if r.ep:
                return pad((r.fsdp_axis, t(shape[-2]), None))
            return pad((None, t(shape[-2]), f(shape[-1])))
        return pad((t(shape[-2]), f(shape[-1])))
    # --- ssm ---
    if name in ("in_proj", "in_z", "in_x"):  # mamba1 [d, 2 di]; mamba2 [d, di]
        return pad((f(shape[-2]), t(shape[-1])))
    if name in ("in_bc", "in_dt"):
        return pad((f(shape[-2]), None))
    if name == "x_proj":
        return pad((t(shape[-2]), None))
    if name == "dt_proj":
        return pad((None, t(shape[-1])))
    if name == "out_proj":
        return pad((t(shape[-2]), f(shape[-1])))
    if name == "A_log":
        if len(shape) >= 2 and shape[-1] == cfg.ssm_state:  # mamba1 [di, st]
            return pad((t(shape[-2]), None))
        return pad((None,))  # mamba2 [nh]
    if name == "D" and len(shape) >= 1 and shape[-1] == cfg.d_inner:  # mamba1 [di]
        return pad((t(shape[-1]),))
    # conv weights, small vectors, norms and everything else: replicated
    return (None,) * len(shape)


def param_specs(cfg: ModelConfig, rules: ShardingRules, params: Mapping[str, Any]) -> dict:
    """A spec for every leaf of ``params`` (nested dicts of anything with a
    ``.shape``), by the leaf's own key, in the same nesting."""
    return {k: param_specs(cfg, rules, v) if isinstance(v, Mapping)
            else _leaf_spec(k, tuple(v.shape), cfg, rules) for k, v in params.items()}


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sharded_axes(spec: tuple) -> tuple:
    """Every mesh axis a spec shards over."""
    return tuple(a for e in spec for a in spec_axes(e))


def local_index(shape, spec: tuple, coords: Mapping[str, int],
                sizes: Mapping[str, int]) -> tuple:
    """The slices of the block of a global tensor of ``shape`` that the
    rank at mesh coordinates ``coords`` holds under ``spec`` (a dim over
    several axes is split over them major to minor)."""
    out = []
    for dim, entry in enumerate(spec):
        start, length = 0, shape[dim]
        for a in spec_axes(entry):
            n = sizes[a]
            if length % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not split over {a}={n}")
            length //= n
            start += coords[a] * length
        out.append(slice(start, start + length))
    return tuple(out)


def local_shard(x: torch.Tensor, spec: tuple, coords: Mapping[str, int],
                sizes: Mapping[str, int]) -> torch.Tensor:
    """The block of the global tensor ``x`` that the rank at mesh
    coordinates ``coords`` holds under ``spec`` (a view)."""
    return x[local_index(x.shape, spec, coords, sizes)]


class Placer:
    """The ``place`` of ``transformer.init_params`` for the rank at mesh
    ``coords``: each leaf's block under its spec.  ``place(name, leaf)``
    cuts a made leaf (a copy, so the whole is freed); ``place.dense`` draws
    a random matrix stack a matrix at a time, from the same stream as the
    whole leaf, and keeps only the rank's block of each matrix, so the
    whole stack never exists (llama4-scout's w1, 64 GB in bf16)."""

    def __init__(self, cfg: ModelConfig, rules: ShardingRules, coords: Mapping[str, int]):
        self.cfg, self.rules, self.coords = cfg, rules, coords
        self.sizes = dict(rules.sizes)

    def _spec(self, name: str, shape) -> Optional[tuple]:
        spec = _leaf_spec(name, tuple(shape), self.cfg, self.rules)
        return spec if any(self.sizes[a] > 1 for a in sharded_axes(spec)) else None

    def __call__(self, name: str, leaf: torch.Tensor) -> torch.Tensor:
        spec = self._spec(name, leaf.shape)
        if spec is None:
            return leaf
        return local_shard(leaf, spec, self.coords, self.sizes).clone(
            memory_format=torch.contiguous_format)

    def dense(self, name: str, gen, shape, dtype, *, fan_in: Optional[int] = None):
        from repro_torch.models.layers import dense_init

        spec = self._spec(name, shape)
        if spec is None:
            return dense_init(gen, shape, dtype, fan_in=fan_in)
        n_lead = max(len(shape) - 2, 0)
        lead_spec, tail_spec = spec[:n_lead], spec[n_lead:]

        def ranges(dims, sp):
            out = []
            for d, e in zip(dims, sp):
                n = 1
                for a in spec_axes(e):
                    n *= self.sizes[a]
                per = d // n
                c = 0
                for a in spec_axes(e):  # major to minor, as local_shard splits
                    c = c * self.sizes[a] + self.coords[a]
                out.append(range(c * per, (c + 1) * per))
            return out

        coords, sizes = self.coords, self.sizes

        class Block:
            lead = ranges(shape[:n_lead], lead_spec)

            def __call__(self, x):
                return local_shard(x, tail_spec, coords, sizes)

        return dense_init(gen, shape, dtype, fan_in=fan_in, block=Block())


def mesh_coords(mesh) -> dict:
    """{axis name: this process's coordinate} of a ``DeviceMesh`` (its
    place in the mesh, not its rank in the axis's process group: a grown
    mesh lists its ranks out of order, a process group sorts them)."""
    return dict(zip(mesh.mesh_dim_names, (int(c) for c in mesh.get_coordinate())))


def mesh_axis(mesh, name: str) -> "Axis":
    """This process's :class:`Axis` ``name`` of ``mesh``, numbered by
    coordinate (``executors.axis_ranks``'s rule): its ``order`` maps the
    process group's ranks (sorted global ranks) to coordinates when the
    two differ, and the collectives below put every rank's part at its
    coordinate."""
    d = mesh.mesh_dim_names.index(name)
    coord = [int(c) for c in mesh.get_coordinate()]
    where = tuple(coord[:d]) + (slice(None),) + tuple(coord[d + 1:])
    ranks = [int(r) for r in mesh.mesh[where].tolist()]
    order = tuple(ranks.index(r) for r in sorted(ranks))
    return Axis(name, mesh.get_group(name), coord[d], len(ranks),
                None if order == tuple(range(len(ranks))) else order)


def is_mesh_root(mesh) -> bool:
    """Is this process at coordinate 0 of every axis of ``mesh`` (the rank
    that writes what the mesh gathers)?"""
    coord = mesh.get_coordinate()
    return coord is not None and not any(coord)


# ---------------------------------------------------------------------------
# The active context
# ---------------------------------------------------------------------------

_ACTIVE: list["ShardingContext"] = []


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this process sees it: its group, the rank's
    coordinate along it and its size; ``order[g]`` is the coordinate of
    the group's rank ``g`` where they differ (None: the same)."""

    name: str
    group: Any
    rank: int
    size: int
    order: Optional[tuple] = None


@dataclasses.dataclass
class ShardingContext:
    cfg: ModelConfig
    rules: ShardingRules
    mesh: Any = None  # the DeviceMesh of a world (None: specs only)
    # {stacked tree: {leaf: the spec of one layer's block}} of the leaves a
    # layer all-gathers over "data" when it reads them (FSDP a layer at a
    # time, ``layer_leaves``); None: the caller gathered every leaf
    layer_specs: Optional[dict] = None
    _axes: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def spec_for(self, kind: str, x) -> Optional[tuple]:
        r = self.rules
        if kind == "tokens":  # [B, S, d]
            return P(r.batch_axes(x.shape[0]), None, None)
        if kind == "mb_batch":  # [mb, B_mb, ...]: shard the per-microbatch batch
            return P(None, r.batch_axes(x.shape[1]), *(None,) * (x.ndim - 2))
        if kind == "q":  # [B, S, H, hd]
            h = r.tp_axis if r.attn_heads_sharded else None
            return P(r.batch_axes(x.shape[0]), None, h, None)
        if kind in ("k", "v"):  # [B, S, KV(_eff), hd]: divisibility on the
            # actual (possibly kv-repeated) head count
            h = r.tp_if(x.shape[2]) if r.attn_heads_sharded else None
            return P(r.batch_axes(x.shape[0]), None, h, None)
        if kind in ("cache_k", "cache_v"):  # [B, W, KV, hd]
            if r.kv_heads_sharded:
                return P(r.batch_axes(x.shape[0]), None, r.tp_axis, None)
            return P(r.batch_axes(x.shape[0]), r.tp_axis, None, None)
        if kind == "ffn":  # [B, S, f]
            return P(r.batch_axes(x.shape[0]), None, r.tp_if(x.shape[-1]))
        if kind == "expert_buf":  # [G, E, C, d]: groups over DP
            return P(r.batch_axes(x.shape[0]), None, None, None)
        if kind == "expert_buf_ep":  # [G, E, C, d]: experts over the EP axis
            if r.ep and x.shape[1] % r.size(r.fsdp_axis) == 0:
                return P(None, r.fsdp_axis, None, None)
            return P(r.batch_axes(x.shape[0]), None, None, None)
        if kind == "ssm_inner":  # [B, S, di] or [B, di, ...]
            return P(r.batch_axes(x.shape[0]), None,
                     r.tp_if(x.shape[2]) if x.ndim > 2 else None)
        if kind == "logits":  # [B, S, V]
            return P(r.batch_axes(x.shape[0]), None, r.tp_if(x.shape[-1]))
        return None

    def axis(self, name: Optional[str]) -> Optional[Axis]:
        """``name``'s :class:`Axis` in the world, or None (no world, no such
        axis, or one rank along it); looked up in the mesh once (a layer
        asks many times a step)."""
        if name not in self._axes:
            self._axes[name] = self._lookup(name)
        return self._axes[name]

    def _lookup(self, name: Optional[str]) -> Optional[Axis]:
        if self.mesh is None or name is None or name not in self.mesh.mesh_dim_names:
            return None
        if self.mesh.size(self.mesh.mesh_dim_names.index(name)) == 1:
            return None
        return mesh_axis(self.mesh, name)


@contextlib.contextmanager
def use(ctx: ShardingContext):
    """Make ``ctx`` the active context while the block runs."""
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.pop()


def sharding_ctx(cfg: ModelConfig, rules: ShardingRules, mesh=None, layer_specs=None):
    """A new :class:`ShardingContext`, active while the block runs."""
    return use(ShardingContext(cfg, rules, mesh, layer_specs))


def active() -> Optional[ShardingContext]:
    return _ACTIVE[-1] if _ACTIVE else None


def tp_axis() -> Optional[Axis]:
    """The ``"model"`` axis of the active world, or None (no TP)."""
    ctx = active()
    return None if ctx is None else ctx.axis(ctx.rules.tp_axis)


def data_axis() -> Optional[Axis]:
    """The ``"data"`` axis of the active world, or None: also None where
    the rules have no DP axes (:meth:`ShardingRules.manual_region`, the
    MRD grad-sync modes' model region), whose code runs on its own data
    shard, so the token count and the moe routing shares are the rank's
    own statistics and no tokens cross the data ranks."""
    ctx = active()
    return None if ctx is None or not ctx.rules.dp_axes else ctx.axis(DATA)


def tp_dim(dim: int) -> bool:
    """Does a weight dim of size ``dim`` shard over the active TP axis
    (:meth:`ShardingRules.tp_if`, in a world with more than one model
    rank)?"""
    return tp_axis() is not None and active().rules.tp_if(dim) is not None


def kv_repeat_factor(H: int, KV: int) -> int:
    """Smallest factor r such that KV*r divides the TP axis cleanly (and r
    divides H/KV), so GQA's heads shard when KV < tp."""
    if not _ACTIVE:
        return 1
    r = _ACTIVE[-1].rules
    if r.tp_axis is None or H == 0 or H % r.tp:
        return 1
    if KV % r.tp == 0:
        return 1
    rep = H // KV
    for f in range(2, rep + 1):
        if rep % f == 0 and (KV * f) % r.tp == 0:
            return f
    return 1


def attn_heads(cfg: ModelConfig) -> tuple[int, int, int]:
    """(query heads, K/V heads, kv repeat factor) of this rank's attention:
    where the ``"q"`` and ``"k"`` specs (:meth:`ShardingContext.spec_for`)
    shard the heads over ``"model"``, its ``H / tp`` query heads and the
    ``KV * f / tp`` K/V heads they read (each K/V head repeated ``f`` =
    :func:`kv_repeat_factor` times first); otherwise every head.  Its K/V
    caches hold these heads."""
    ax = tp_axis()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if ax is None:
        return H, KV, 1
    ctx, f = active(), kv_repeat_factor(H, KV)

    def sharded(kind, heads):
        return ctx.spec_for(kind, torch.empty((1, 1, heads, cfg.head_dim), device="meta"))[2]

    return (H // ax.size if sharded("q", H) else H,
            KV * f // ax.size if sharded("k", KV * f) else KV * f, f)


class _GatheredLayer(dict):
    """One layer's leaves (the rank's FSDP blocks) that all-gather over
    ``"data"`` when read: inside a recomputed layer the gathered weights
    are made again in the backward pass instead of kept, as FSDP frees
    them between uses."""

    def __init__(self, leaves: dict, specs: dict):
        super().__init__(leaves)
        self._specs = specs

    def __getitem__(self, name):
        return gather_fsdp(super().__getitem__(name), self._specs[name])

    def get(self, name, default=None):
        return self[name] if name in self else default


def layer_leaves(stack: str, leaves: dict) -> dict:
    """One layer's leaves of stacked tree ``stack`` as the model reads
    them: gathered over ``"data"`` on each read where the active context
    has that tree's layer specs (FSDP a layer at a time), else as they
    are."""
    ctx = active()
    if ctx is None or not ctx.layer_specs or stack not in ctx.layer_specs:
        return leaves
    return _GatheredLayer(leaves, ctx.layer_specs[stack])


# ---------------------------------------------------------------------------
# Collectives and their autograd pairs
# ---------------------------------------------------------------------------

_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _by_group(parts: list, ax: Axis) -> list:
    """Parts in coordinate order -> in the order of ``ax``'s process group."""
    return parts if ax.order is None else [parts[c] for c in ax.order]


def _by_coordinate(parts: list, ax: Axis) -> list:
    """Parts in the order of ``ax``'s process group -> in coordinate order."""
    if ax.order is None:
        return parts
    out = [None] * len(parts)
    for g, c in enumerate(ax.order):
        out[c] = parts[g]
    return out


def _all_gather(x, dim: int, ax: Axis):
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((ax.size * x.shape[0],) + x.shape[1:])
    _all_gather_into(out, x, group=ax.group)
    if ax.order is not None:
        out = torch.cat(_by_coordinate(list(out.chunk(ax.size)), ax))
    return out.movedim(0, dim).contiguous()


def _chunk(x, dim: int, ax: Axis):
    return x.chunk(ax.size, dim)[ax.rank].contiguous()


_WIDEN = (torch.bfloat16, torch.float16)  # sums of these are added in fp32


def _all_reduce(x, ax: Axis, op=dist.ReduceOp.SUM):
    """``x`` reduced over ``ax`` into a new tensor (``x`` may be saved for
    the backward); a bf16 or fp16 sum is added in fp32 and rounded once,
    as one card's matmul accumulates the same partial sums."""
    widen = op == dist.ReduceOp.SUM and x.dtype in _WIDEN
    y = x.to(torch.float32 if widen else x.dtype, memory_format=torch.contiguous_format,
             copy=True)
    dist.all_reduce(y, op=op, group=ax.group)
    return y.to(x.dtype) if widen else y


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.ax), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _chunk(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.ax), None, None


class _GatherScatter(torch.autograd.Function):
    """All-gather forward, reduce-scatter (sum) backward: an FSDP leaf."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        dtype = g.dtype
        g = g.movedim(ctx.dim, 0).contiguous()
        if dtype in _WIDEN:  # added in fp32, as _all_reduce
            g = g.float()
        if ctx.ax.order is not None:
            g = torch.cat(_by_group(list(g.chunk(ctx.ax.size)), ctx.ax))
        out = g.new_empty((g.shape[0] // ctx.ax.size,) + g.shape[1:])
        _reduce_scatter(out, g, group=ctx.ax.group)
        return out.movedim(0, ctx.dim).to(dtype).contiguous(), None, None


def _all_to_all(x, split_dim: int, cat_dim: int, ax: Axis):
    parts = _by_group([p.contiguous() for p in x.chunk(ax.size, split_dim)], ax)
    out = [torch.empty_like(p) for p in parts]
    dist.all_to_all(out, parts, group=ax.group)
    return torch.cat(_by_coordinate(out, ax), cat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, ax):
        ctx.dims, ctx.ax = (split_dim, cat_dim), ax
        return _all_to_all(x, split_dim, cat_dim, ax)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return _all_to_all(g, cat_dim, split_dim, ctx.ax), None, None, None


def tp_copy(x):
    """Replicated ``x`` into a computation each model rank does on its own
    part: identity forward, all-reduce backward."""
    ax = tp_axis()
    return x if ax is None else _Copy.apply(x, ax)


def tp_reduce(x):
    """Each model rank's partial sum ``x`` -> their sum, replicated:
    all-reduce forward, identity backward."""
    ax = tp_axis()
    return x if ax is None else _Reduce.apply(x, ax)


def tp_gather(x, dim: int):
    """Each model rank's chunk along ``dim`` -> the whole, replicated."""
    ax = tp_axis()
    return x if ax is None else _Gather.apply(x, dim, ax)


def tp_split(x, dim: int):
    """Replicated ``x`` -> this model rank's chunk along ``dim``."""
    ax = tp_axis()
    return x if ax is None else _Split.apply(x, dim, ax)


def tp_max(x):
    """The model ranks' elementwise maximum of ``x`` (no gradient)."""
    ax = tp_axis()
    return x if ax is None else _all_reduce(x.detach(), ax, dist.ReduceOp.MAX)


def data_sum(x):
    """The data ranks' sum of a statistic of their batch shards: all-reduce
    forward, identity backward (each rank's backward reaches its own
    contribution)."""
    ax = data_axis()
    return x if ax is None else _Reduce.apply(x, ax)


def data_all_to_all(x, split_dim: int, cat_dim: int):
    """The data ranks' all-to-all: chunk r of ``x`` along ``split_dim`` goes
    to data rank r, the received chunks are concatenated along
    ``cat_dim``; its backward is the inverse exchange."""
    ax = data_axis()
    return x if ax is None else _AllToAll.apply(x, split_dim, cat_dim, ax)


def gather_fsdp(x, spec: tuple):
    """An FSDP leaf's local block -> its block over ``"model"`` alone: the
    all-gather along every dim the spec shards over ``"data"``, whose
    backward reduce-scatters (sums) the gradient over the data ranks."""
    ax = data_axis()
    if ax is None:
        return x
    for dim, entry in enumerate(spec):
        if DATA in spec_axes(entry):
            x = _GatherScatter.apply(x, dim, ax)
    return x


def gather_global(x, spec: tuple, mesh):
    """A rank's block of a leaf -> the global leaf (no gradient): the
    all-gather along every sharded dim, over the axes the spec names."""
    names = mesh.mesh_dim_names
    for dim, entry in reversed(list(enumerate(spec))):
        for a in reversed(spec_axes(entry)):
            if mesh.size(names.index(a)) > 1:
                x = _all_gather(x, dim, mesh_axis(mesh, a))
    return x
