"""Collective plans (port of ``repro.collectives.plans``, sim executor).

A :class:`CollectivePlan` binds a schedule, an executor, a payload
transform and a reduction op to a stacked rank count ``p``.  Every
collective runs through the one stage interpreter below:

- :meth:`CollectivePlan.run` executes all stages (blocking).
- :meth:`CollectivePlan.init` / :meth:`CollectivePlan.step` are the
  paper's non-blocking state machine (Fig. 4): each ``step`` advances
  **one** communication stage; a cycle completes after
  :meth:`CollectivePlan.cycle_length` calls, sets ``flag``, publishes the
  reduced value, and the next call latches the caller's current local
  contribution ("each cycle begins with the backward shift").

The state machine's counters are host integers (the reference carries
them as device scalars for ``lax.switch``); only the buffers are tensors.
Buckets, the device executors and the reduce-scatter/all-gather phases
are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

from repro_torch.collectives import transforms as T
from repro_torch.collectives.executors import make_backend, resolve_op
from repro_torch.collectives.schedules import Phase, Stage, get_schedule, pivot


def exec_stage(x, st: Stage, be, p: int, op: Callable, tf=None):
    """Apply one allreduce stage to the stacked buffer ``x [p, ...]``."""
    tf = tf or T.IdentityTransform()
    p0, _, extra = pivot(p)
    r = be.rank(x.device)
    if st.kind in ("bshift", "butterfly"):
        recv = tuple(be.permute(leaf, st.pairs) for leaf in tf.encode(x, be))
        # butterfly partners combine the canonical (wire) views so that both
        # hold the same value even under a lossy transform
        keep = tf.canonicalize(x, be) if st.kind == "butterfly" else x
        combined = tf.combine(keep, recv, op, be)
        pred = (r < extra) if st.kind == "bshift" else (r < p0)
        return be.where(pred, combined, x)
    if st.kind == "fshift":
        return be.where(r >= p0, be.permute(x, st.pairs), x)
    raise ValueError(f"bad stage kind {st.kind}")


@dataclasses.dataclass(frozen=True)
class CollectivePlan:
    """schedule x executor x transform x op, bound to a sim rank count."""

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
    def bound_stages(self) -> tuple[Stage, ...]:
        """The flat stage list of one cycle (allreduce phases only)."""
        out = []
        for ph in self._phases():
            if ph.collective != "allreduce":
                raise ValueError(f"phase {ph.collective!r} is not ported")
            out.extend(ph.stages(self.p))
        return tuple(out)

    def cycle_length(self) -> int:
        """Non-blocking calls per completed reduction (>= 1)."""
        return max(len(self.bound_stages), 1)

    # -- blocking execution -------------------------------------------------

    def run(self, x):
        """Allreduce the stacked buffer ``x [p, ...]``; every row ends
        holding the reduction of all rows."""
        if self.p == 1:
            return x
        op, tf = resolve_op(self.op), self._transform()
        for st in self.bound_stages:
            x = exec_stage(x, st, self._backend, self.p, op, tf)
        return x

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
