"""Distributed snapshot (Chandy-Lamport) for the exact detector (port of
``repro.core.snapshot``).

The paper simplifies to an "all-to-all" pattern: dependent neighbors ==
all other workers, so after the snapshot every worker holds the full
consistent vector ``x̄ = (x_1^{k_1}, ..., x_p^{k_p})``.

In the bounded-delay simulator a snapshot started at tick ``t0`` latches
worker ``j``'s block when its marker arrives (tick ``t0 + d_j``), and the
assembled x̄ is available to everyone once every latch plus the data
replies have propagated (``complete_tick``).  Exactness of Algorithm 2
comes from evaluating ``f`` on the frozen x̄.

Every function takes state with any leading batch dimensions (the
engine's lanes).  :func:`start` takes the marker delays ``d [..., p]``
and the reply delay ``reply [...]`` as inputs: the engine draws them from
its source (the reference draws them inside ``start``).
"""

from __future__ import annotations

from typing import Any

import torch


def init(p: int, m: int, lanes=(), device="cpu", dtype=torch.float32) -> dict[str, Any]:
    lanes = tuple(lanes)
    return {
        "xbar": torch.zeros(lanes + (p, m), dtype=dtype, device=device),  # latched blocks
        "latched": torch.zeros(lanes + (p,), dtype=torch.bool, device=device),
        "latch_tick": torch.zeros(lanes + (p,), dtype=torch.int32, device=device),
        "complete_tick": torch.zeros(lanes, dtype=torch.int32, device=device),
        "in_progress": torch.zeros(lanes, dtype=torch.bool, device=device),
    }


def start(state, tick, d, reply):
    """Begin a snapshot at ``tick``: worker j's marker arrives ``d[..., j]``
    ticks later, the data replies ``reply`` ticks after the last one."""
    latch = tick[..., None] + d
    return {
        **state,
        "latched": torch.zeros_like(state["latched"]),
        "latch_tick": latch,
        "complete_tick": latch.amax(dim=-1) + reply,
        "in_progress": torch.ones_like(state["in_progress"]),
    }


def tick(state, x_blocks, now):
    """Advance one tick: latch any block whose marker arrives now (or
    earlier, for the tick the snapshot starts on)."""
    due = (state["in_progress"][..., None] & ~state["latched"]
           & (state["latch_tick"] <= now[..., None]))
    xbar = torch.where(due[..., None], x_blocks, state["xbar"])
    return {**state, "xbar": xbar, "latched": state["latched"] | due}


def done(state, now):
    return state["in_progress"] & state["latched"].all(dim=-1) & (now >= state["complete_tick"])


def assembled(state):
    """Full consistent vector x̄ (valid once :func:`done` is True)."""
    return state["xbar"].flatten(-2)
