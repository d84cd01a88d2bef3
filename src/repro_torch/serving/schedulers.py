"""Admission schedulers (port of ``repro.serving.schedulers``).

A scheduler is host-side control plane: given the pending queue and the
pool's free slots at a tick, it orders the queue; the engine fills the
lowest-numbered free slots first with the first eligible requests, so
decisions are deterministic given the queue.

Registered:

- ``fcfs``: first come, first served (arrival order; ties by id);
- ``priority``: highest ``Request.priority`` first (ties FCFS);
- ``sla_edf``: earliest deadline first over ``arrival + sla`` (requests
  without an SLA last, FCFS among themselves); a request that has waited
  ``max_wait`` ticks (default 64) goes ahead of every deadline, oldest
  first, so tight-deadline traffic cannot starve the rest.  ``sla_edf:N``
  sets ``max_wait``.

A name may carry a ``:arg`` suffix; the bare name resolves to the
registered default instance.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

SCHEDULERS: Dict[str, Any] = {}


def register_scheduler(name: str):
    def deco(cls):
        SCHEDULERS[name] = cls()
        return cls

    return deco


def get_scheduler(name: str):
    """Resolve ``name`` (optionally ``name:arg``) to a scheduler instance."""
    base, _, arg = name.partition(":")
    try:
        sched = SCHEDULERS[base]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {base!r}; registered: {sorted(SCHEDULERS)}"
        ) from None
    return sched.configure(arg) if arg else sched


class _SchedulerBase:
    """Order the queue; the engine (or :meth:`select`) fills the free slots."""

    def order(self, queue: Sequence, now: int) -> List:
        raise NotImplementedError

    def configure(self, arg: str):
        """A re-parameterized instance from a ``name:arg`` spec."""
        raise ValueError(f"scheduler {type(self).__name__} takes no ':{arg}' parameter")

    def select(self, queue: Sequence, free_slots: Sequence[int], now: int,
               eligible: Optional[Callable[[Any], bool]] = None) -> List[Tuple[Any, int]]:
        """``[(request, slot)]`` admissions for this tick: the first
        ``eligible`` requests in scheduling order take the lowest free
        slots (an ineligible request is passed over)."""
        if not queue or not free_slots:
            return []
        slots = sorted(free_slots)
        picked = []
        for r in self.order(list(queue), now):
            if len(picked) == len(slots):
                break
            if eligible is None or eligible(r):
                picked.append(r)
        return list(zip(picked, slots))


@register_scheduler("fcfs")
class FCFSScheduler(_SchedulerBase):
    name = "fcfs"

    def order(self, queue, now):
        return sorted(queue, key=lambda r: (r.arrival, r.id))


@register_scheduler("priority")
class PriorityScheduler(_SchedulerBase):
    name = "priority"

    def order(self, queue, now):
        return sorted(queue, key=lambda r: (-r.priority, r.arrival, r.id))


@register_scheduler("sla_edf")
class SlaEdfScheduler(_SchedulerBase):
    name = "sla_edf"

    def __init__(self, max_wait: int = 64):
        if max_wait < 1:
            raise ValueError(f"max_wait must be >= 1, got {max_wait}")
        self.max_wait = max_wait

    def configure(self, arg: str):
        return SlaEdfScheduler(max_wait=int(arg))

    def order(self, queue, now):
        def key(r):
            if now - r.arrival >= self.max_wait:
                return (0, r.arrival, 0, r.id)  # promoted: oldest first
            deadline = r.arrival + r.sla if r.sla is not None else float("inf")
            return (1, deadline, r.arrival, r.id)

        return sorted(queue, key=key)
