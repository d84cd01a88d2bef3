"""Collective plans (port of ``repro.collectives.plans``, sim executor).

A :class:`CollectivePlan` binds a schedule, an executor, a payload
transform and a reduction op to a stacked rank count ``p``.  Every
collective runs through the one stage interpreter below:

- :meth:`CollectivePlan.run` executes all stages (blocking): allreduce
  phases on any stacked ``[p, ...]`` buffer, reduce-scatter and all-gather
  phases on a ``[p, n]`` buffer.
- :meth:`CollectivePlan.run_buffers` executes the stages **stage-major
  across buffers** (the gradient buckets of ``collectives.buckets``):
  every buffer's stage-s send is issued before any buffer's stage-s
  receive is folded in, with the same math per buffer as :meth:`run`.
- :meth:`CollectivePlan.init` / :meth:`CollectivePlan.step` are the
  paper's non-blocking state machine (Fig. 4): each ``step`` advances
  **one** communication stage; a cycle completes after
  :meth:`CollectivePlan.cycle_length` calls, sets ``flag``, publishes the
  reduced value, and the next call latches the caller's current local
  contribution ("each cycle begins with the backward shift").
- :meth:`CollectivePlan.init_lanes` / :meth:`CollectivePlan.step_lanes`
  run that state machine for a batch of independent lanes (the
  asynchronous engine's sweeps), each lane at its own stage.

The single state machine's counters are host integers (the reference
carries them as device scalars for ``lax.switch``); the lane-batched one
carries them as ``[B]`` tensors.
The reference's multi-axis (chained) plans and its late-admission
``BucketPipeline`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.collectives import transforms as T
from repro_torch.collectives.executors import make_backend, resolve_op
from repro_torch.collectives.schedules import Phase, Stage, get_schedule, pivot

# ---------------------------------------------------------------------------
# The one stage interpreter.  Each stage is split into a *start* half
# (encode the outgoing payload and move it) and a *finish* half (fold the
# received payload in); blocking execution composes them back to back and
# run_buffers interleaves them stage-major across buffers.
# ---------------------------------------------------------------------------


def _stage_start(x, st: Stage, be, tf):
    """Issue the stage's communication; returns the in-flight context.
    Reducing stages send ``tf.encode``-ed payloads; copy stages
    (``fshift``/``ag``) move raw buffers."""
    if st.kind in ("bshift", "butterfly"):
        return x, tuple(be.permute(leaf, st.pairs) for leaf in tf.encode(x, be))
    if st.kind in ("fshift", "ag"):
        return x, be.permute(x, st.pairs)
    if st.kind == "rs":
        lower, upper = be.split_half(x)
        my_bit = (be.rank(x.device) & st.distance) != 0
        to_send = be.where(my_bit, lower, upper)
        keep = be.where(my_bit, upper, lower)
        return keep, tuple(be.permute(leaf, st.pairs) for leaf in tf.encode(to_send, be))
    raise ValueError(f"bad stage kind {st.kind}")


def _stage_finish(ctx, st: Stage, be, p: int, op: Callable, tf):
    """Fold the in-flight payload from :func:`_stage_start` back in.  The
    combined (or received, or concatenated) buffer is fresh, so the row
    selection writes into it instead of allocating a third buffer."""
    p0, _, extra = pivot(p)
    x, recv = ctx
    r = be.rank(x.device)
    if st.kind in ("bshift", "butterfly"):
        # butterfly partners combine the canonical (wire) views so that both
        # hold the same value even under a lossy transform
        keep = tf.canonicalize(x, be) if st.kind == "butterfly" else x
        combined = tf.combine(keep, recv, op, be)
        pred = (r < extra) if st.kind == "bshift" else (r < p0)
        return be.where(pred, combined, x, out=combined)
    if st.kind == "fshift":
        return be.where(r >= p0, recv, x, out=recv)
    if st.kind == "rs":
        combined = tf.combine(x, recv, op, be)
        return be.where(r < p0, combined, x, out=combined)
    if st.kind == "ag":
        my_bit = (r & st.distance) != 0
        lo_recv = be.concat(recv, x)
        return be.where(my_bit, lo_recv, be.concat(x, recv), out=lo_recv)
    raise ValueError(f"bad stage kind {st.kind}")


def exec_stage(x, st: Stage, be, p: int, op: Callable, tf=None):
    """Apply one schedule stage to the stacked buffer ``x [p, ...]`` (start
    and finish back to back)."""
    tf = tf or T.IdentityTransform()
    return _stage_finish(_stage_start(x, st, be, tf), st, be, p, op, tf)


def _run_phase(x, collective: str, be, p: int, op: Callable, tf):
    if p == 1:
        return x
    for st in Phase(collective, 0).stages(p):
        x = exec_stage(x, st, be, p, op, tf if collective != "allgather" else None)
    return x


@dataclasses.dataclass(frozen=True)
class CollectivePlan:
    """schedule x executor x transform x op, bound to a sim rank count.

    ``phases`` defaults to the registered decomposition of ``schedule``;
    the primitive plans (:func:`reduce_scatter_plan`,
    :func:`allgather_plan`) pass theirs explicitly."""

    schedule: str = "mrd"
    op: Any = "sum"  # 'sum' | 'max' | 'min' | callable
    transform: Any = "identity"
    executor: str = "sim"
    p: int = 1
    phases: Optional[tuple[Phase, ...]] = None

    def __post_init__(self):
        if self.p < 1:
            raise ValueError(f"need p >= 1, got {self.p}")
        self._transform().validate_op(self.op)

    def _phases(self) -> tuple[Phase, ...]:
        if self.phases is not None:
            return self.phases
        return tuple(get_schedule(self.schedule).phases(1))

    def _transform(self):
        return T.resolve_transform(self.transform)

    @functools.cached_property
    def _backend(self):
        return make_backend(self.executor, p=self.p)

    @functools.cached_property
    def stage_table(self) -> tuple[tuple[Stage, str], ...]:
        """Flat [(stage, collective)] across all phases: the order in which
        :meth:`run_buffers` walks the stages."""
        return tuple((st, ph.collective) for ph in self._phases() for st in ph.stages(self.p))

    @functools.cached_property
    def bound_stages(self) -> tuple[Stage, ...]:
        """The flat stage list of one cycle (allreduce-only plans)."""
        if any(coll != "allreduce" for _, coll in self.stage_table):
            raise ValueError(
                "stage-at-a-time stepping needs an allreduce-only plan "
                f"(schedule {self.schedule!r} has other phases)"
            )
        return tuple(st for st, _ in self.stage_table)

    def cycle_length(self) -> int:
        """Non-blocking calls per completed reduction (>= 1)."""
        return max(len(self.bound_stages), 1)

    def pad_quantum(self) -> int:
        """Required divisor of a buffer's length for this plan."""
        q = self._transform().quantum
        for ph in self._phases():
            if ph.collective == "reduce_scatter":
                q *= pivot(self.p)[0]
        return q

    # -- blocking execution -------------------------------------------------

    def _check_lengths(self, bufs) -> None:
        if any(coll == "reduce_scatter" for _, coll in self.stage_table):
            q = self.pad_quantum()
            for i, b in enumerate(bufs):
                if b.ndim != 2 or b.shape[-1] % q:
                    raise ValueError(
                        f"reduce-scatter phases need [p, n] buffers with n % {q} == 0 "
                        f"(p0 x transform quantum), got {tuple(b.shape)} for buffer {i}"
                    )

    def run(self, x):
        """Execute every phase on the stacked buffer ``x``: an allreduce
        leaves every row holding the reduction of all rows; a
        reduce-scatter leaves pivot rank r holding segment r; an all-gather
        concatenates the segments back."""
        self._check_lengths([x])
        op, tf = resolve_op(self.op), self._transform()
        for ph in self._phases():
            x = _run_phase(x, ph.collective, self._backend, self.p, op, tf)
        return x

    def run_buffers(self, bufs: Sequence) -> list:
        """Execute this plan's stages stage-major across ``bufs``
        (independent ``[p, n]`` buffers, typically gradient buckets): for
        every stage, buffer k's send is issued before buffer k+1's
        previous-stage receive is folded in.  Identical math to :meth:`run`
        per buffer.

        A ``list`` argument is consumed (emptied), so that each input can
        be freed as soon as its first stage has replaced it: at full width
        the gradient buckets are the largest tensors of a train step."""
        work = list(bufs)
        if isinstance(bufs, list):
            bufs.clear()
        if not self.stage_table or not work:
            return work
        self._check_lengths(work)
        op, tf, be = resolve_op(self.op), self._transform(), self._backend
        ctxs: list = [None] * len(work)
        prev = None  # the stage whose sends are in flight
        for st, _ in self.stage_table:
            for k in range(len(work)):
                if prev is not None:
                    work[k], ctxs[k] = _stage_finish(ctxs[k], *prev), None
                ctxs[k], work[k] = _stage_start(work[k], st, be, tf), None
            prev = (st, be, self.p, op, tf)
        return [_stage_finish(c, *prev) for c in ctxs]

    # -- non-blocking state machine (paper Fig. 4) --------------------------

    def init(self, value) -> dict[str, Any]:
        """State of the state machine, latching ``value [p, ...]`` as the
        first cycle's contribution."""
        return {
            "stage": 0,
            "buf": value,
            "result": value.new_zeros(value.shape),
            "flag": False,  # True for exactly the completing call
            "cycles": 0,
        }

    def step(self, state: dict[str, Any], local_value) -> dict[str, Any]:
        """Advance one stage.  ``local_value`` is latched only when a new
        cycle begins (stage 0); ``flag`` is True iff this call completed a
        cycle, and then ``result`` holds that cycle's reduction."""
        nstages = len(self.bound_stages)
        if nstages == 0:  # p == 1: every call is a complete cycle
            return {
                "stage": state["stage"], "buf": local_value, "result": local_value,
                "flag": True, "cycles": state["cycles"] + 1,
            }
        buf = local_value if state["stage"] == 0 else state["buf"]
        st = self.bound_stages[state["stage"]]
        buf = exec_stage(buf, st, self._backend, self.p, resolve_op(self.op),
                         self._transform())
        done = state["stage"] + 1 == nstages
        return {
            "stage": 0 if done else state["stage"] + 1,
            "buf": buf,
            "result": buf if done else state["result"],
            "flag": done,
            "cycles": state["cycles"] + int(done),
        }

    # -- the same state machine over a batch of independent lanes ----------

    def init_lanes(self, value) -> dict[str, Any]:
        """Lane-batched state: ``value [B, p]`` is each lane's first
        contribution, one row a lane.  ``stage``, ``flag`` and ``cycles``
        are ``[B]`` tensors, so every lane sits at its own stage."""
        lanes = value.shape[0]
        zeros = torch.zeros(lanes, dtype=torch.int32, device=value.device)
        return {"stage": zeros, "buf": value, "result": torch.zeros_like(value),
                "flag": torch.zeros(lanes, dtype=torch.bool, device=value.device),
                "cycles": zeros.clone()}

    def step_lanes(self, state: dict[str, Any], local_value) -> dict[str, Any]:
        """:meth:`step` for every lane at once, each at its own stage (the
        reference's ``vmap`` of its ``lax.switch`` step).  Each stage runs
        on every lane's transposed ``[p, B]`` buffer, ranks leading as the
        sim backend permutes them, and each lane keeps the stage it is at."""
        stages = self.bound_stages
        stage = state["stage"]
        if not stages:  # p == 1: every call is a complete cycle
            return {"stage": stage, "buf": local_value, "result": local_value,
                    "flag": torch.ones_like(state["flag"]), "cycles": state["cycles"] + 1}
        buf = torch.where((stage == 0)[:, None], local_value, state["buf"]).t()
        op, tf = resolve_op(self.op), self._transform()
        new = exec_stage(buf, stages[0], self._backend, self.p, op, tf)
        for s, st in enumerate(stages[1:], start=1):
            new = torch.where(stage == s, exec_stage(buf, st, self._backend, self.p, op, tf),
                              new)
        new = new.t()
        nxt = stage + 1
        done = nxt == len(stages)
        return {"stage": torch.where(done, 0, nxt), "buf": new,
                "result": torch.where(done[:, None], new, state["result"]),
                "flag": done, "cycles": state["cycles"] + done.int()}

    def run_blocking(self, value):
        """Drive the state machine through one full cycle."""
        st = self.init(value)
        for _ in range(self.cycle_length()):
            st = self.step(st, value)
        return st["result"]


def allreduce_plan(*, schedule: str = "mrd", op: Any = "sum", transform: Any = "identity",
                   executor: str = "sim", p: int = 1) -> CollectivePlan:
    return CollectivePlan(schedule=schedule, op=op, transform=transform,
                          executor=executor, p=p)


def reduce_scatter_plan(*, op: Any = "sum", transform: Any = "identity",
                        executor: str = "sim", p: int = 1) -> CollectivePlan:
    """Recursive-halving reduce-scatter over the stacked ranks."""
    return CollectivePlan(schedule="reduce_scatter", op=op, transform=transform,
                          executor=executor, p=p, phases=(Phase("reduce_scatter", 0),))


def allgather_plan(*, executor: str = "sim", p: int = 1) -> CollectivePlan:
    """Recursive-doubling all-gather over the stacked ranks (the inverse of
    :func:`reduce_scatter_plan`)."""
    return CollectivePlan(schedule="allgather", executor=executor, p=p,
                          phases=(Phase("allgather", 0),))
