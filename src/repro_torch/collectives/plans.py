"""Collective plans (port of ``repro.collectives.plans``).

A :class:`CollectivePlan` binds a schedule, an executor, a payload
transform and a reduction op to a communication domain: named dimensions
of a ``torch.distributed`` device mesh (the ``device`` and
``device_fused`` executors, one process a rank) or a stacked rank count
``p`` (the ``sim`` executor).  Every collective runs through the one stage
interpreter below:

- :meth:`CollectivePlan.run` executes all stages of all phases
  (blocking): allreduce-only plans take a tree (nested dicts) of buffers,
  plans with reduce-scatter/all-gather phases one buffer (a rank-local
  1-D vector on a device, a stacked ``[p, n]`` in the sim).
- :meth:`CollectivePlan.run_buffers` executes the stages **stage-major
  across buffers** (the gradient buckets of ``collectives.buckets``):
  every buffer's stage-s send is issued before any buffer's stage-s
  receive is folded in, with the same math per buffer as :meth:`run`;
  :meth:`CollectivePlan.run_bucketed` packs a tree into buckets for it,
  and :class:`BucketPipeline` admits buckets while earlier ones are in
  flight.
- :meth:`CollectivePlan.init` / :meth:`CollectivePlan.step` are the
  paper's non-blocking state machine (Fig. 4): each ``step`` advances
  **one** communication stage; a cycle completes after
  :meth:`CollectivePlan.cycle_length` calls, sets ``flag``, publishes the
  reduced value, and the next call latches the caller's current local
  contribution ("each cycle begins with the backward shift").
- :meth:`CollectivePlan.init_lanes` / :meth:`CollectivePlan.step_lanes`
  run that state machine for a batch of independent lanes (the
  asynchronous engine's sweeps), each lane at its own stage (sim only).

Chained (multi-axis) plans concatenate per-axis stage lists, each stage
run by its own axis's backend, which is how ``("pod", "data")`` meshes run
the same code path as a single axis.  The single state machine's counters
are host integers (the reference carries them as device scalars for
``lax.switch``); the lane-batched one carries them as ``[B]`` tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Optional, Sequence

import torch
from torch.profiler import record_function

from repro_torch.collectives import buckets as B
from repro_torch.collectives import transforms as T
from repro_torch.collectives.executors import landed, make_backend, resolve_op
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
    (``fshift``/``ag``) move raw buffers.  A device backend's messages are
    waited on at the stage's finish (:func:`executors.landed`), not here."""
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
    selection writes into it instead of allocating a third buffer.  On a
    device the rank is a host integer: a rank that takes no part in a
    reducing stage keeps its buffer and computes nothing."""
    p0, _, extra = pivot(p)
    x, recv = ctx
    recv = landed(recv)
    r = be.rank(x.device)
    if st.kind in ("bshift", "butterfly", "rs"):
        pred = (r < extra) if st.kind == "bshift" else (r < p0)
        if pred is False:
            return x
        # butterfly partners combine the canonical (wire) views so that both
        # hold the same value even under a lossy transform
        keep = tf.canonicalize(x, be) if st.kind == "butterfly" else x
        combined = tf.combine(keep, recv, op, be)
        return be.where(pred, combined, x, out=combined)
    if st.kind == "fshift":
        return be.where(r >= p0, recv, x, out=recv)
    if st.kind == "ag":
        my_bit = (r & st.distance) != 0
        lo_recv = be.concat(recv, x)
        return be.where(my_bit, lo_recv, be.concat(x, recv), out=lo_recv)
    raise ValueError(f"bad stage kind {st.kind}")


def exec_stage(x, st: Stage, be, p: int, op: Callable, tf=None):
    """Apply one schedule stage to ``x`` (start and finish back to back)."""
    tf = tf or T.IdentityTransform()
    return _stage_finish(_stage_start(x, st, be, tf), st, be, p, op, tf)


def _run_phase(x, collective: str, be, p: int, op: Callable, tf):
    if p == 1:
        return x
    for st in Phase(collective, 0).stages(p):
        x = exec_stage(x, st, be, p, op, tf if collective != "allgather" else None)
    return x


def _tree_map(fn: Callable, tree):
    """``fn`` over every tensor of a tree of nested dicts (or one tensor)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


PROFILE_RANGE = "collective_plan"  # the profiler's name for a blocking plan run


def profiled():
    """A ``PROFILE_RANGE`` range around a blocking plan run while
    ``torch.profiler`` records (its kernels then sum to the plans' device
    time); nothing otherwise."""
    if torch.autograd._profiler_enabled():
        return record_function(PROFILE_RANGE)
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Live plans, which the elastic runtime invalidates at a resize
#
# A plan memoizes what it derives (backends, bound stage tables) per
# instance.  A resize changes the extent under long-lived plans, so the
# elastic runtime calls invalidate_all_plans() at each ResizeEvent and every
# live plan derives again on its next use.  A list of weakrefs (not a
# WeakSet: equal frozen plans would collapse into one) tracks them without
# keeping them alive.
# ---------------------------------------------------------------------------

_LIVE_PLANS: list = []
_PRUNE_THRESHOLD = 256


def _track_plan(plan) -> None:
    global _PRUNE_THRESHOLD
    _LIVE_PLANS.append(weakref.ref(plan))
    # amortized prune: a workload that builds plans without ever resizing
    # must not accumulate dead references without bound
    if len(_LIVE_PLANS) >= _PRUNE_THRESHOLD:
        _LIVE_PLANS[:] = [r for r in _LIVE_PLANS if r() is not None]
        _PRUNE_THRESHOLD = max(256, 2 * len(_LIVE_PLANS))


def live_plans() -> list:
    """The :class:`CollectivePlan` instances alive now (dead references
    are pruned)."""
    alive, kept = [], []
    for ref in _LIVE_PLANS:
        plan = ref()
        if plan is not None:
            alive.append(plan)
            kept.append(ref)
    _LIVE_PLANS[:] = kept
    return alive


def invalidate_all_plans() -> int:
    """Drop every live plan's memoized derivations (the resize hook);
    returns how many plans were invalidated."""
    alive = live_plans()
    for plan in alive:
        plan.invalidate()
    return len(alive)


@dataclasses.dataclass(frozen=True)
class CollectivePlan:
    """schedule x executor x transform x op, bound to the named dimensions
    ``axes`` of a device ``mesh`` (device executors) or to a stacked rank
    count ``p`` (sim).

    ``phases`` defaults to the registered decomposition of ``schedule``
    over the plan's axes; the primitive plans (:func:`reduce_scatter_plan`,
    :func:`allgather_plan`) pass theirs explicitly.  ``transform_kwargs``
    are the transform's options as sorted ``(name, value)`` pairs, e.g.
    ``(("block", 128),)``.  The derived state (phases, transform, backends,
    stage tables) is built once a plan and kept outside the dataclass
    fields, so equal plans stay equal and hashable."""

    schedule: str = "mrd"
    op: Any = "sum"  # 'sum' | 'max' | 'min' | callable
    transform: Any = "identity"  # name | transform instance
    executor: str = "device"  # 'device' | 'device_fused' | 'sim'
    axes: Optional[tuple[str, ...]] = None  # device: mesh dimension names (chained)
    mesh: Any = None  # device: a torch.distributed DeviceMesh naming ``axes``
    p: Optional[int] = None  # sim: stacked rank count
    phases: Optional[tuple[Phase, ...]] = None
    transform_kwargs: tuple = ()

    def __post_init__(self):
        if (self.axes is None) == (self.p is None):
            raise ValueError("bind exactly one of axes= (device) or p= (sim)")
        if self.p is not None:
            if self.p < 1:
                raise ValueError(f"need p >= 1, got {self.p}")
            if self.executor == "device":
                object.__setattr__(self, "executor", "sim")
        else:
            if isinstance(self.axes, str):
                object.__setattr__(self, "axes", (self.axes,))
            names = getattr(self.mesh, "mesh_dim_names", None) or ()
            missing = [a for a in self.axes if a not in names]
            if self.mesh is None or missing:
                raise ValueError(
                    f"a device plan needs mesh= a DeviceMesh whose dimension names hold "
                    f"its axes {self.axes}; missing {missing} in {tuple(names)}"
                )
        self._transform().validate_op(self.op)
        _track_plan(self)

    # -- layer resolution (memoized per instance, outside eq/hash) ----------

    def _memo(self, key, build):
        memo = self.__dict__.setdefault("_memo_cache", {})
        if key not in memo:
            memo[key] = build()
        return memo[key]

    def invalidate(self) -> None:
        """Drop every memoized derivation (backends, bound stage tables),
        so the next use derives them again: the elastic runtime calls
        :func:`invalidate_all_plans` after a resize."""
        self.__dict__.pop("_memo_cache", None)

    def _n_axes(self) -> int:
        return len(self.axes) if self.axes is not None else 1

    def _phases(self) -> tuple[Phase, ...]:
        if self.phases is not None:
            return self.phases
        return self._memo(
            "phases", lambda: tuple(get_schedule(self.schedule).phases(self._n_axes())))

    def _transform(self):
        return self._memo("transform", lambda: T.resolve_transform(
            self.transform, **dict(self.transform_kwargs)))

    def _backend(self, axis_index: int):
        """The backend of one axis, built at its first use (a device
        backend's first act is a barrier of its group)."""
        if self.axes is not None:
            return self._memo(("backend", axis_index), lambda: make_backend(
                self.executor, axis=self.axes[axis_index], mesh=self.mesh))
        return self._memo(("backend", axis_index), lambda: make_backend(self.executor, p=self.p))

    def _size(self, axis_index: int) -> int:
        if self.p is not None:
            return self.p
        return self.mesh.shape[self.mesh.mesh_dim_names.index(self.axes[axis_index])]

    def _sizes(self) -> tuple[int, ...]:
        return tuple(self._size(ph.axis_index) for ph in self._phases())

    # -- introspection ------------------------------------------------------

    def bound_stages(self) -> tuple[tuple[Stage, int, int], ...]:
        """Flat [(stage, axis_index, p)] across phases (allreduce plans)."""

        def build():
            out = []
            for ph in self._phases():
                if ph.collective != "allreduce":
                    raise ValueError(
                        "stage-at-a-time stepping needs an allreduce-only plan "
                        f"(schedule {self.schedule!r} has a {ph.collective} phase)"
                    )
                p = self._size(ph.axis_index)
                out.extend((st, ph.axis_index, p) for st in ph.stages(p))
            return tuple(out)

        return self._memo("bound_stages", build)

    def bound_stage_table(self) -> tuple[tuple[Stage, str, int, int], ...]:
        """Flat [(stage, collective, axis_index, p)] across *all* phases:
        the order in which :meth:`run_buffers` walks the stages."""

        def build():
            out = []
            for ph in self._phases():
                p = self._size(ph.axis_index)
                out.extend((st, ph.collective, ph.axis_index, p) for st in ph.stages(p))
            return tuple(out)

        return self._memo("stage_table", build)

    def cycle_length(self) -> int:
        """Non-blocking calls per completed reduction (>= 1)."""
        return max(len(self.bound_stages()), 1)

    def pad_quantum(self) -> int:
        """Required divisor of a buffer's length for this plan."""
        q = self._transform().quantum
        for ph in self._phases():
            if ph.collective == "reduce_scatter":
                q *= pivot(self._size(ph.axis_index))[0]
        return q

    # -- blocking execution -------------------------------------------------

    def _check_lengths(self, bufs) -> None:
        """Plans with reduce-scatter phases need one buffer a rank (``[p,
        n]`` stacked, 1-D on a device) whose length the plan can halve."""
        if not any(coll == "reduce_scatter" for _, coll, _, _ in self.bound_stage_table()):
            return
        q, ndim = self.pad_quantum(), 2 if self.p is not None else 1
        for i, b in enumerate(bufs):
            if b.ndim != ndim or b.shape[-1] % q:
                layout = "[p, n] stacked" if ndim == 2 else "rank-local 1-D [n]"
                raise ValueError(
                    f"reduce-scatter phases need {layout} buffers with n % {q} == 0 "
                    f"(pad_quantum), got {tuple(b.shape)} for buffer {i}"
                )

    def run(self, x):
        """Execute every phase.  An allreduce leaves every rank holding the
        reduction (a tree of buffers reduces leaf by leaf); a reduce-scatter
        leaves pivot rank r holding segment r; an all-gather concatenates
        the segments back."""
        with profiled():
            return self._run(x)

    def _run(self, x):
        op, tf = resolve_op(self.op), self._transform()
        phases = self._phases()
        if all(ph.collective == "allreduce" for ph in phases):
            for ph in phases:
                p = self._size(ph.axis_index)
                if p > 1:
                    be = self._backend(ph.axis_index)
                    x = _tree_map(lambda leaf: _run_phase(leaf, "allreduce", be, p, op, tf), x)
            return x
        self._check_lengths([x])
        for ph in phases:
            x = _run_phase(x, ph.collective, self._backend(ph.axis_index),
                           self._size(ph.axis_index), op, tf)
        return x

    def run_buffers(self, bufs: Sequence) -> list:
        """Execute this plan's stages stage-major across ``bufs``
        (independent buffers, typically gradient buckets): for every stage,
        buffer k's send is issued before buffer k+1's previous-stage
        receive is folded in.  Identical math to :meth:`run` per buffer.

        A ``list`` argument is consumed (emptied), so that each input can
        be freed as soon as its first stage has replaced it: at full width
        the gradient buckets are the largest tensors of a train step."""
        work = list(bufs)
        if isinstance(bufs, list):
            bufs.clear()
        with profiled():
            return self._run_buffers(work)

    def _run_buffers(self, work: list) -> list:
        table = self.bound_stage_table()
        if not table or not work:
            return work
        self._check_lengths(work)
        op, tf = resolve_op(self.op), self._transform()
        ctxs: list = [None] * len(work)
        prev = None  # the stage whose sends are in flight
        for st, _, ai, p in table:
            be = self._backend(ai)
            for k in range(len(work)):
                if prev is not None:
                    work[k], ctxs[k] = _stage_finish(ctxs[k], *prev, op, tf), None
                ctxs[k], work[k] = _stage_start(work[k], st, be, tf), None
            prev = (st, be, p)
        return [_stage_finish(c, *prev, op, tf) for c in ctxs]

    def run_bucketed(self, tree, *, bucket_bytes: Optional[int] = None,
                     layout: Optional[B.BucketLayout] = None):
        """Allreduce a tree in dtype-homogeneous, size-capped buckets: the
        leaves are packed by :mod:`repro_torch.collectives.buckets` (a bf16
        leaf travels and reduces as bf16), each bucket padded to
        :meth:`pad_quantum`, and every stage runs stage-major across the
        buckets (:meth:`run_buffers`).  ``layout`` reuses a prebuilt
        :class:`~repro_torch.collectives.buckets.BucketLayout`;
        ``bucket_bytes=None`` makes one bucket per dtype.  Primitive
        reduce-scatter/all-gather plans change buffer lengths and are
        refused."""
        if self.phases is not None and not all(
                ph.collective == "allreduce" for ph in self.phases):
            raise ValueError(
                "run_bucketed needs an allreduce-schedule plan (primitive "
                "reduce-scatter/all-gather plans change buffer lengths)"
            )
        if layout is None:
            layout = B.build_layout(tree, bucket_bytes=bucket_bytes,
                                    quantum=self.pad_quantum(), stacked=self.p)
        return B.unpack(self.run_buffers(B.pack(tree, layout)), layout)

    def pipeline(self) -> "BucketPipeline":
        """A :class:`BucketPipeline` over this plan: :meth:`run_buffers`
        with buckets admitted while earlier ones are in flight."""
        return BucketPipeline(self)

    # -- non-blocking state machine (paper Fig. 4) --------------------------

    def init(self, value) -> dict[str, Any]:
        """State of the state machine, latching ``value`` (a rank-local
        buffer on a device, ``[p, ...]`` in the sim) as the first cycle's
        contribution."""
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
        bound = self.bound_stages()
        if not bound:  # every axis of size 1: every call is a complete cycle
            return {
                "stage": state["stage"], "buf": local_value, "result": local_value,
                "flag": True, "cycles": state["cycles"] + 1,
            }
        buf = local_value if state["stage"] == 0 else state["buf"]
        st, ai, p = bound[state["stage"]]
        buf = exec_stage(buf, st, self._backend(ai), p, resolve_op(self.op), self._transform())
        done = state["stage"] + 1 == len(bound)
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
        if self.p is None:
            raise ValueError("lane-batched stepping runs on the sim executor (p=)")
        stages = [st for st, _, _ in self.bound_stages()]
        stage = state["stage"]
        if not stages:  # p == 1: every call is a complete cycle
            return {"stage": stage, "buf": local_value, "result": local_value,
                    "flag": torch.ones_like(state["flag"]), "cycles": state["cycles"] + 1}
        buf = torch.where((stage == 0)[:, None], local_value, state["buf"]).t()
        op, tf, be = resolve_op(self.op), self._transform(), self._backend(0)
        new = exec_stage(buf, stages[0], be, self.p, op, tf)
        for s, st in enumerate(stages[1:], start=1):
            new = torch.where(stage == s, exec_stage(buf, st, be, self.p, op, tf), new)
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


# ---------------------------------------------------------------------------
# BucketPipeline: run_buffers with late admission
# ---------------------------------------------------------------------------


class BucketPipeline:
    """Stage-major pipelined execution with **late bucket admission**.

    :meth:`CollectivePlan.run_buffers` needs every bucket up front; a
    gradient sync that overlaps the backward pass produces buckets while
    earlier buckets are already mid-schedule.  This is the same stage
    interpreter with an explicit in-flight set:

    - :meth:`admit` enters a bucket and issues its first stage;
    - :meth:`advance` moves every in-flight bucket forward one stage
      (finish the received payload, issue the next stage);
      a stage's messages are waited on only at its finish, so on a
      device what runs between two calls (a backward segment) runs while
      they are in flight;
    - :meth:`drain` runs all remaining stages stage-major and returns the
      finished buffers.

    Per bucket the stage sequence is exactly ``run_buffers``'s, and every
    stage's math touches only that bucket's tensors, so the results equal
    ``run_buffers``'s bit for bit for any admission/advance interleaving,
    lossy transforms included (int8 blocks are keyed to offsets within a
    bucket, which this never changes)."""

    def __init__(self, plan: CollectivePlan):
        self.plan = plan
        self.table = plan.bound_stage_table()
        self._op = resolve_op(plan.op)
        self._tf = plan._transform()
        self._inflight: dict = {}  # key -> (stage index started, ctx)
        self._done: dict = {}

    def _start(self, buf, i: int):
        st, _, ai, _ = self.table[i]
        return _stage_start(buf, st, self.plan._backend(ai), self._tf)

    def _finish(self, ctx, i: int):
        st, _, ai, p = self.table[i]
        return _stage_finish(ctx, st, self.plan._backend(ai), p, self._op, self._tf)

    def admit(self, key, buf) -> None:
        """Enter ``buf`` under ``key`` and issue its first stage.  A plan
        with no stages (every axis of size 1) completes it at once."""
        if key in self._inflight or key in self._done:
            raise ValueError(f"bucket {key!r} admitted twice")
        self.plan._check_lengths([buf])
        if not self.table:
            self._done[key] = buf
            return
        self._inflight[key] = (0, self._start(buf, 0))

    def advance(self) -> None:
        """Advance every in-flight bucket by one stage (admission order)."""
        for key in list(self._inflight):
            i, ctx = self._inflight[key]
            # the finished stage's context is released before the next
            # stage starts, as run_buffers releases it
            self._inflight[key] = None
            buf = self._finish(ctx, i)
            del ctx
            if i + 1 < len(self.table):
                self._inflight[key] = (i + 1, self._start(buf, i + 1))
            else:
                del self._inflight[key]
                self._done[key] = buf
            del buf

    def drain(self) -> dict:
        """Run all remaining stages stage-major; returns {key: buffer} and
        resets the pipeline."""
        while self._inflight:
            self.advance()
        out, self._done = self._done, {}
        return out


# ---------------------------------------------------------------------------
# Plan factories
# ---------------------------------------------------------------------------


def _axes(axes) -> Optional[tuple[str, ...]]:
    if axes is None:
        return None
    return (axes,) if isinstance(axes, str) else tuple(axes)


def allreduce_plan(*, schedule: str = "mrd", op: Any = "sum", transform: Any = "identity",
                   executor: str = "device", axes: Optional[Sequence[str]] = None,
                   mesh=None, p: Optional[int] = None, **transform_kwargs) -> CollectivePlan:
    return CollectivePlan(schedule=schedule, op=op, transform=transform, executor=executor,
                          axes=_axes(axes), mesh=mesh, p=p,
                          transform_kwargs=tuple(sorted(transform_kwargs.items())))


def reduce_scatter_plan(*, op: Any = "sum", transform: Any = "identity",
                        executor: str = "device", axes: Optional[Sequence[str]] = None,
                        mesh=None, p: Optional[int] = None,
                        **transform_kwargs) -> CollectivePlan:
    """Chained recursive-halving reduce-scatter over ``axes`` (in order)."""
    axes = _axes(axes)
    n = len(axes) if axes is not None else 1
    return CollectivePlan(schedule="reduce_scatter", op=op, transform=transform,
                          executor=executor, axes=axes, mesh=mesh, p=p,
                          phases=tuple(Phase("reduce_scatter", i) for i in range(n)),
                          transform_kwargs=tuple(sorted(transform_kwargs.items())))


def allgather_plan(*, executor: str = "device", axes: Optional[Sequence[str]] = None,
                   mesh=None, p: Optional[int] = None) -> CollectivePlan:
    """Chained recursive-doubling all-gather (reverse axis order: the
    inverse of :func:`reduce_scatter_plan`)."""
    axes = _axes(axes)
    n = len(axes) if axes is not None else 1
    return CollectivePlan(schedule="allgather", executor=executor, axes=axes, mesh=mesh, p=p,
                          phases=tuple(Phase("allgather", i) for i in reversed(range(n))))


def tree_allreduce(tree, *, schedule: str = "mrd", op: Any = "sum",
                   transform: Any = "identity", executor: str = "device",
                   axes: Sequence[str] = (), mesh=None, p: Optional[int] = None,
                   bucket_bytes: Optional[int] = None, **transform_kwargs):
    """Allreduce a tree in dtype-homogeneous buckets, chained over ``axes``
    of ``mesh`` (device) or over a stacked rank count ``p`` (sim), through
    :meth:`CollectivePlan.run_bucketed`: leaf types are kept end to end and
    ``bucket_bytes`` caps each wire buffer, so stages pipeline across
    buckets instead of materializing one flat gradient.  ``rabenseifner``
    suits bandwidth-bound payloads like gradients, ``mrd`` latency-bound
    ones."""
    if p is not None and axes:
        raise ValueError("bind exactly one of axes= (device) or p= (sim), not both")
    plan = allreduce_plan(schedule=schedule, op=op, transform=transform, executor=executor,
                          axes=axes if p is None else None, mesh=mesh, p=p,
                          **transform_kwargs)
    return plan.run_bucketed(tree, bucket_bytes=bucket_bytes)
