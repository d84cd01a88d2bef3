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
(``gradsync.overlap``).  The elastic resize hooks are not ported yet
(ROADMAP queue 1, item 7b).
"""

from __future__ import annotations

from typing import Callable, Dict

GRAD_SYNC: Dict[str, Callable] = {}


def register(name: str):
    """Decorator: register a strategy builder under ``name``."""

    def deco(fn: Callable) -> Callable:
        GRAD_SYNC[name] = fn
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


# populate the registry (import order = doc order)
from repro_torch.distributed.gradsync import (  # noqa: E402,F401
    compressed,
    gspmd,
    local_sgd,
    mrd_leaf,
    mrd_paper,
    mrd_zero1,
)
