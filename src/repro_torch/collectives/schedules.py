"""Communication schedules (port of ``repro.collectives.schedules``: the
``mrd`` allreduce and the reduce-scatter/all-gather primitives).

The paper's modified recursive doubling Allreduce for any rank count
``p``: with ``p0 = 2^floor(log2 p)``, a backward shift folds the ``p - p0``
extra ranks onto the first ones, ``log2(p0)`` XOR-butterfly stages reduce
over the ``p0`` pivot ranks, and a forward shift hands the result back to
the extra ranks.  Schedules are pure data (rank pairs and stage kinds);
plans (``repro_torch.collectives.plans``) interpret them.

The same shifts frame the recursive-halving reduce-scatter and the
recursive-doubling all-gather that the ZeRO-1 gradient sync runs.  The
paper's message and step counts close the module.  The reference's
``rabenseifner``/``hierarchical`` families and its alpha-beta cost model
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Literal

StageKind = Literal["bshift", "butterfly", "fshift", "rs", "ag"]


@dataclasses.dataclass(frozen=True)
class Stage:
    """One communication stage: a static list of (src, dst) rank pairs.

    ``kind`` controls the combine rule applied by the plan:
      - ``bshift``:    dst (< extra) does ``x = op(x, recv)``
      - ``butterfly``: ranks < p0 do ``x = op(x, recv)`` (full-buffer exchange)
      - ``fshift``:    dst (>= p0) does ``x = recv``
      - ``rs``:        reduce-scatter half-exchange; keep one half, reduce it
      - ``ag``:        all-gather doubling; concat own + received halves
    """

    kind: StageKind
    pairs: tuple[tuple[int, int], ...]
    distance: int = 0  # butterfly / rs / ag partner distance, 0 for shifts
    payload_fraction: float = 1.0  # fraction of the full buffer sent per pair


def pivot(p: int) -> tuple[int, int, int]:
    """Return (p0, mu0, extra) with p0 = 2^mu0 <= p < 2^(mu0+1)."""
    if p < 1:
        raise ValueError(f"need p >= 1, got {p}")
    mu0 = p.bit_length() - 1
    p0 = 1 << mu0
    return p0, mu0, p - p0


def backward_shift_stage(p: int) -> Stage:
    p0, _, _ = pivot(p)
    return Stage("bshift", tuple((r, r - p0) for r in range(p0, p)))


def forward_shift_stage(p: int) -> Stage:
    p0, _, extra = pivot(p)
    return Stage("fshift", tuple((r, r + p0) for r in range(extra)))


def allreduce_schedule(p: int) -> list[Stage]:
    """backward shift (if p != p0) -> mu0 XOR-butterfly stages -> forward
    shift: ``log2(p0) + 2`` stages, or ``log2(p0)`` when p is a power of two."""
    p0, mu0, extra = pivot(p)
    stages: list[Stage] = []
    if extra:
        stages.append(backward_shift_stage(p))
    for s in range(mu0):
        d = 1 << s
        stages.append(
            Stage("butterfly", tuple((i, i ^ d) for i in range(p0)), distance=d)
        )
    if extra:
        stages.append(forward_shift_stage(p))
    return stages


def reduce_scatter_schedule(p: int) -> list[Stage]:
    """Recursive-halving reduce-scatter over the p0 pivot ranks.

    After the backward shift, stage s exchanges buffer halves with the
    partner at distance ``p0 >> (s+1)`` (large -> small).  Rank r (< p0)
    ends holding segment r (natural order) of the reduced vector; extra
    ranks carry buffers the stages mask out.
    """
    p0, mu0, extra = pivot(p)
    stages: list[Stage] = []
    if extra:
        stages.append(backward_shift_stage(p))
    for s in range(mu0):
        d = p0 >> (s + 1)
        stages.append(Stage("rs", tuple((i, i ^ d) for i in range(p0)), distance=d,
                            payload_fraction=0.5 ** (s + 1)))
    return stages


def allgather_schedule(p: int) -> list[Stage]:
    """Recursive-doubling all-gather (inverse of
    :func:`reduce_scatter_schedule`): stage s exchanges the current buffer
    with the partner at distance ``p0 >> (mu0 - s)`` (small -> large), and
    a forward shift delivers the full vector to the extra ranks."""
    p0, mu0, extra = pivot(p)
    stages: list[Stage] = []
    for s in range(mu0):
        d = 1 << s
        stages.append(Stage("ag", tuple((i, i ^ d) for i in range(p0)), distance=d,
                            payload_fraction=0.5 ** (mu0 - s)))
    if extra:
        stages.append(forward_shift_stage(p))
    return stages


# ---------------------------------------------------------------------------
# Schedule registry: name -> phase decomposition over the plan's axes.
# ---------------------------------------------------------------------------

Collective = Literal["allreduce", "reduce_scatter", "allgather"]

PRIMITIVES: dict[str, Callable[[int], list[Stage]]] = {
    "allreduce": allreduce_schedule,
    "reduce_scatter": reduce_scatter_schedule,
    "allgather": allgather_schedule,
}


@dataclasses.dataclass(frozen=True)
class Phase:
    """One primitive collective applied over one of a plan's axes."""

    collective: Collective
    axis_index: int

    def stages(self, p: int) -> list[Stage]:
        return PRIMITIVES[self.collective](p)


@dataclasses.dataclass(frozen=True)
class ScheduleFamily:
    """A named allreduce realization: how to phase it over ``n_axes`` axes."""

    name: str
    phases_fn: Callable[[int], list[Phase]]

    def phases(self, n_axes: int) -> list[Phase]:
        return self.phases_fn(n_axes)


SCHEDULES: dict[str, ScheduleFamily] = {}


def register_schedule(name: str, phases_fn: Callable[[int], list[Phase]]):
    fam = ScheduleFamily(name, phases_fn)
    SCHEDULES[name] = fam
    return fam


def get_schedule(name: str) -> ScheduleFamily:
    try:
        return SCHEDULES[name]
    except KeyError:
        raise ValueError(
            f"unknown schedule {name!r}; registered: {sorted(SCHEDULES)}"
        ) from None


register_schedule("mrd", lambda n: [Phase("allreduce", i) for i in range(n)])


# ---------------------------------------------------------------------------
# Cost accounting (the paper's S2 counts; the engine bills messages by them).
# ---------------------------------------------------------------------------


def schedule_steps(stages) -> int:
    return len(stages)


def schedule_messages(stages) -> int:
    """Point-to-point messages in one cycle (paper: p0*log2(p0) + 2(p-p0)
    for the MRD allreduce)."""
    return sum(len(st.pairs) for st in stages)


def paper_message_count(p: int) -> int:
    """Closed form from the paper, S2: p0*log2(p0) + 2*(p - p0)."""
    p0, mu0, extra = pivot(p)
    return p0 * mu0 + 2 * extra


def paper_step_count(p: int) -> int:
    """Closed form from the paper, S2: log2(p0) + 2 (shifts skipped if p=2^k)."""
    _, mu0, extra = pivot(p)
    return mu0 + (2 if extra else 0)


def stage_message_table(p: int) -> list[int]:
    """Messages sent at stage s of the MRD allreduce cycle (``[0]`` at
    p = 1, which has no stage)."""
    return [len(st.pairs) for st in allreduce_schedule(p)] or [0]
