"""Communication schedules (port of ``repro.collectives.schedules``).

The paper's modified recursive doubling Allreduce for any rank count
``p``: with ``p0 = 2^floor(log2 p)``, a backward shift folds the ``p - p0``
extra ranks onto the first ones, ``log2(p0)`` XOR-butterfly stages reduce
over the ``p0`` pivot ranks, and a forward shift hands the result back to
the extra ranks.  Schedules are pure data (rank pairs and stage kinds);
plans (``repro_torch.collectives.plans``) interpret them.

The same shifts frame the recursive-halving reduce-scatter and the
recursive-doubling all-gather that the ZeRO-1 gradient sync runs.

The :data:`SCHEDULES` registry maps allreduce-schedule names to *phase*
decompositions over one or more mesh axes:

- ``mrd``:           one MRD allreduce per axis (latency-optimal,
                     ``log2(p0)+2`` stages, full payload each stage);
- ``rabenseifner``:  chained reduce-scatter then all-gather (bandwidth-
                     optimal, ~2n per rank; paper ref. [20]);
- ``hierarchical``:  reduce-scatter on the inner (fast) axes, MRD
                     allreduce across the outermost axis on the shard,
                     all-gather back on the inner axes.

The paper's message and step counts, the volume a cycle moves and an
alpha-beta cost model (with link constants of an H100 node) close the
module.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Literal, Sequence

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


def is_power_of_two(p: int) -> bool:
    return p >= 1 and (p & (p - 1)) == 0


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


def rabenseifner_schedule(p: int) -> list[Stage]:
    """Bandwidth-optimal allreduce = reduce-scatter + all-gather (the
    paper's ref. [20]): each rank sends ~2n(1 - 1/p0) elements instead of
    n log2(p0); the same shifts handle a p that is not a power of two."""
    return reduce_scatter_schedule(p) + allgather_schedule(p)


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
    min_axes: int = 1

    def phases(self, n_axes: int) -> list[Phase]:
        if n_axes < self.min_axes:
            raise ValueError(
                f"schedule {self.name!r} needs >= {self.min_axes} axes, got {n_axes}"
            )
        return self.phases_fn(n_axes)


SCHEDULES: dict[str, ScheduleFamily] = {}


def register_schedule(name: str, phases_fn: Callable[[int], list[Phase]], **kw):
    fam = ScheduleFamily(name, phases_fn, **kw)
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
register_schedule(
    "rabenseifner",
    lambda n: [Phase("reduce_scatter", i) for i in range(n)]
    + [Phase("allgather", i) for i in reversed(range(n))],
)
register_schedule(
    "hierarchical",
    # chained reduce-scatter over the inner (fast-link) axes, allreduce
    # across the outermost (slow-link) axis on the 1/prod(p0_inner) shard,
    # chained all-gather back out.  Axis order: innermost first.
    lambda n: [Phase("reduce_scatter", i) for i in range(n - 1)]
    + [Phase("allreduce", n - 1)]
    + [Phase("allgather", i) for i in reversed(range(n - 1))],
    min_axes=2,
)


# ---------------------------------------------------------------------------
# Cost accounting (the paper's S2 counts; the engine bills messages by them).
# ---------------------------------------------------------------------------


def schedule_steps(stages: Sequence[Stage]) -> int:
    return len(stages)


def schedule_messages(stages: Sequence[Stage]) -> int:
    """Point-to-point messages in one cycle (paper: p0*log2(p0) + 2(p-p0)
    for the MRD allreduce)."""
    return sum(len(st.pairs) for st in stages)


def schedule_volume(stages: Sequence[Stage], n_elements: int) -> float:
    """Total elements moved across the network in one cycle."""
    return sum(len(st.pairs) * st.payload_fraction * n_elements for st in stages)


def per_rank_volume(stages: Sequence[Stage], n_elements: int, rank: int) -> float:
    """Elements *sent* by ``rank`` over the cycle."""
    total = 0.0
    for st in stages:
        for src, _ in st.pairs:
            if src == rank:
                total += st.payload_fraction * n_elements
    return total


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


# ---------------------------------------------------------------------------
# Latency/bandwidth cost model (alpha-beta): compares schedules for a given
# interconnect without running them (``repro_torch.benchmarks.bench_mrd``).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkModel:
    alpha_s: float  # per-message latency (seconds)
    beta_s_per_byte: float  # inverse bandwidth (seconds/byte)

    @classmethod
    def h100_nvlink(cls) -> "LinkModel":
        """Between two H100 SXM cards of one node.  Bandwidth: NVLink 4, 18
        links, 900 GB/s both directions together, so 450 GB/s a direction
        (NVIDIA H100 Tensor Core GPU datasheet).  Latency: an assumed 2 us
        start-up a point-to-point message, not measured."""
        return cls(alpha_s=2e-6, beta_s_per_byte=1.0 / 450e9)

    @classmethod
    def ndr_infiniband(cls) -> "LinkModel":
        """Between two nodes, one NDR InfiniBand port a card: 400 Gb/s = 50
        GB/s a direction (NVIDIA ConnectX-7 datasheet).  Latency: an assumed
        5 us start-up a message, not measured."""
        return cls(alpha_s=5e-6, beta_s_per_byte=1.0 / 50e9)


def schedule_time(stages: Sequence[Stage], n_bytes: int, link: LinkModel) -> float:
    """Alpha-beta time of one cycle: stages are sequential; within a stage all
    pairs proceed in parallel, so a stage costs alpha + fraction*n*beta."""
    t = 0.0
    for st in stages:
        if not st.pairs:
            continue
        t += link.alpha_s + st.payload_fraction * n_bytes * link.beta_s_per_byte
    return t


def ring_allreduce_time(p: int, n_bytes: int, link: LinkModel) -> float:
    """Ring allreduce: 2(p-1) steps of n/p bytes."""
    if p == 1:
        return 0.0
    return 2 * (p - 1) * (link.alpha_s + (n_bytes / p) * link.beta_s_per_byte)


def tree_allreduce_time(p: int, n_bytes: int, link: LinkModel) -> float:
    """Binomial tree reduce + broadcast: 2*ceil(log2 p) full-buffer steps."""
    if p == 1:
        return 0.0
    return 2 * math.ceil(math.log2(p)) * (link.alpha_s + n_bytes * link.beta_s_per_byte)
