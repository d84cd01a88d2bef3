"""Admission schedulers (port of ``repro.serving.schedulers``, ``fcfs``).

A scheduler is host-side control plane: given the pending queue and the
pool's free slots at a tick, it orders the queue; the engine fills the
lowest-numbered free slots first with the first eligible requests, so
decisions are deterministic given the queue.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

SCHEDULERS: Dict[str, Any] = {}


def register_scheduler(name: str):
    def deco(cls):
        SCHEDULERS[name] = cls()
        return cls

    return deco


def get_scheduler(name: str):
    """Resolve ``name`` to a scheduler instance."""
    try:
        return SCHEDULERS[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; registered: {sorted(SCHEDULERS)}"
        ) from None


class _SchedulerBase:
    """Order the queue; the engine fills the free slots."""

    def order(self, queue: Sequence, now: int) -> List:
        raise NotImplementedError


@register_scheduler("fcfs")
class FCFSScheduler(_SchedulerBase):
    name = "fcfs"

    def order(self, queue, now):
        return sorted(queue, key=lambda r: (r.arrival, r.id))
