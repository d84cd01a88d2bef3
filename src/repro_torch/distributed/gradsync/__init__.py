"""Grad-sync strategy registry (port of ``repro.distributed.gradsync``).

Each strategy is one module registering a builder ``make(cfg, tcfg, *,
dp, device, mesh=None) -> train_step`` under its mode name; ``train_step(state,
batch) -> (state, metrics)`` and ``train_step.init_state(generator)``.

- ``gspmd``: the reference's default and the baseline every MRD mode is
  measured against: params and optimizer state placed by
  ``distributed.sharding`` (FSDP over ``"data"``, TP over ``"model"``),
  the model's tensor-parallel collectives and the DP reductions of the
  gradients placed by hand where XLA's GSPMD inserts them in the reference.
- ``mrd_paper``: the paper's recursive-doubling Allreduce of the full
  bucketed fp32 gradient (paper S2) and replicated optimizer rows.
- ``mrd_zero1``: the butterfly as a ZeRO-1 distributed optimizer:
  recursive-halving reduce-scatter, shard-local AdamW, recursive-doubling
  all-gather of the params.  Non-power-of-two rank counts work natively.
- ``compressed``: mrd_zero1 with int8 wire payloads, combined on receive
  by the ``mrd_combine`` kernel on the card, and the EF-SGD residual carry.
- ``local_sgd``: bounded-staleness local SGD; the replicas are averaged by
  the paper's collectives every ``local_sync_every`` steps.
- ``mrd_leaf``: the butterfly allreduce of the bucketed gradient tree and
  a replicated tree-shaped optimizer.

Every family trains under every mode, in either layout of the ranks
(``gradsync.common``): stacked rows on one device (``mesh=None``, the
``sim`` executor), or a world of one process a rank over a
``torch.distributed`` :class:`DeviceMesh` (the ``device`` and
``device_fused`` executors): ``("data",)``, or ``("data", "model")``
with tensor parallelism, where an MRD mode's rank holds its TP blocks,
buckets its local gradients and runs its plans over its ``"data"``
column (``common.ModelRanks``).  ``tcfg.overlap`` sends each gradient
bucket through its plan as its backward segment completes
(``gradsync.overlap``).

Elastic resize: each strategy registers a hook in ``GRAD_SYNC_RESIZE``
that carries a live train state to a new data-parallel extent in place,
without a checkpoint (:func:`migrate_state`).  In a world the hooks run
on every process of the union of the old and the new ranks; at ``tp`` >
1 each model rank's ``"data"`` column re-lays-out what it holds, and a
``gspmd`` world re-shards its FSDP blocks over the new ``"data"``
extent (``gspmd.reshard_blocks``).  Each step's ``save``/``restore``
(:mod:`.snapshot`) is its checkpoint layout: the reference's nesting on
stacked rows, a rank's rows in an MRD world, global leaves in a
``gspmd`` world.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

GRAD_SYNC: Dict[str, Callable] = {}

# Elastic resize hooks: ``hook(cfg, tcfg, old_mesh, new_mesh, state, keep)
# -> new_state``, where a mesh is a stacked-rows tuple of replica ids or a
# world's ``("data",)`` or ``("data", "model")`` DeviceMesh, and ``keep[i]``
# is the old ``"data"`` coordinate now at new coordinate ``i`` (None: a
# joiner).  Each hook re-lays-out what its strategy holds a rank (the
# ZeRO-1 master/moment segments, the EF residuals, the monitor rows, local
# SGD's replicas, gspmd's FSDP blocks) and leaves replicated leaves as they
# are: the elastic trainer sends the params (and a replicated optimizer) to
# the joiners itself.  In a world ``state`` is the process's own (a joiner's
# is a fresh one of the new extent) and a removed rank gets None back.
GRAD_SYNC_RESIZE: Dict[str, Callable] = {}


def register(name: str):
    """Decorator: register a strategy builder under ``name``."""

    def deco(fn: Callable) -> Callable:
        GRAD_SYNC[name] = fn
        return fn

    return deco


def register_resize(name: str):
    """Decorator: register a strategy's elastic resize hook under ``name``."""

    def deco(fn: Callable) -> Callable:
        GRAD_SYNC_RESIZE[name] = fn
        return fn

    return deco


def get(name: str) -> Callable:
    try:
        return GRAD_SYNC[name]
    except KeyError:
        raise ValueError(f"unknown grad_sync {name!r}; registered: {sorted(GRAD_SYNC)}") from None


def available() -> list[str]:
    return sorted(GRAD_SYNC)


def make_train_step(cfg, tcfg, *, dp: int, device="cuda", mesh=None):
    """The train step of ``tcfg.grad_sync`` over ``dp`` ranks: stacked rows
    on ``device``, or with ``mesh`` this process's rank of a world of
    ``dp`` (its step takes the rank's batch shard)."""
    return get(tcfg.grad_sync)(cfg, tcfg, dp=dp, device=device, mesh=mesh)


def make_step_factory(cfg, tcfg, *, device="cuda") -> Callable:
    """``mesh -> train step``, what the elastic trainer rebuilds at every
    resize: ``mesh`` a stacked-rows tuple of replica ids (the step over
    that many rows on ``device``) or a world's DeviceMesh (this process's
    rank of it)."""
    from repro_torch.distributed.gradsync import common

    def factory(mesh):
        world = common.is_world(mesh)
        return make_train_step(cfg, tcfg, dp=common.mesh_dp(mesh), device=device,
                               mesh=mesh if world else None)

    return factory


def migrate_state(cfg, tcfg, old_mesh, new_mesh, state, keep: Sequence[Optional[int]]):
    """Carry a live train state across a resize in place, with no
    checkpoint, through ``tcfg.grad_sync``'s registered hook (see
    :data:`GRAD_SYNC_RESIZE`).  ``keep`` maps new ranks to old ones (None:
    a joiner)."""
    name = tcfg.grad_sync
    if name not in GRAD_SYNC_RESIZE:
        raise ValueError(f"grad_sync {name!r} has no registered resize hook; "
                         f"registered: {sorted(GRAD_SYNC_RESIZE)}")
    return GRAD_SYNC_RESIZE[name](cfg, tcfg, old_mesh, new_mesh, state, tuple(keep))


# populate the registry (import order = doc order)
from repro_torch.distributed.gradsync import (  # noqa: E402,F401
    compressed,
    gspmd,
    local_sgd,
    mrd_leaf,
    mrd_paper,
    mrd_zero1,
)
