"""The event-script harness of the elastic serving tests (the serving half
of ``tests/chaos.py``), without JAX, so card tests can use it too.

A seeded script of :class:`Kill` / :class:`Join` / :class:`Stall` /
:class:`Unstall` events composed into a :class:`ChaosScript`, applied to
an :class:`repro_torch.runtime.ElasticServeController` through
``apply_due`` on the engine's tick clock.  Detection runs on the
controller's injected clock, so a script decides the whole resize
trajectory: a silent kill is detected exactly when the virtual heartbeat
timeout elapses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Kill:
    """Replica ``device`` dies at ``step``; ``silent`` models a partition:
    detection waits for the heartbeat timeout instead of a crash report."""

    step: int
    device: int
    silent: bool = False

    def fire(self, target):
        target.kill(self.device, silent=self.silent)


@dataclasses.dataclass(frozen=True)
class Join:
    """Replicas ``devices`` ask to join at ``step``."""

    step: int
    devices: tuple

    def fire(self, target):
        target.join(tuple(self.devices))


@dataclasses.dataclass(frozen=True)
class Stall:
    """Replica ``device`` slows to ``factor`` x the healthy step time."""

    step: int
    device: int
    factor: float = 10.0

    def fire(self, target):
        target.stall(self.device, self.factor)


@dataclasses.dataclass(frozen=True)
class Unstall:
    step: int
    device: int

    def fire(self, target):
        target.unstall(self.device)


class ChaosScript:
    """An ordered event script."""

    def __init__(self, events: Sequence):
        self.events = sorted(events, key=lambda e: e.step)
        self.fired: list = []

    def apply(self, target, step: int):
        """Fire the events due exactly at ``step``."""
        for ev in self.events:
            if ev.step == step and ev not in self.fired:
                ev.fire(target)
                self.fired.append(ev)

    def apply_due(self, target, step: int):
        """Fire every event not yet fired with ``ev.step <= step``: the
        engine's tick jumps by up to ``steps_per_dispatch`` a step, so an
        event inside a dispatch fires at the next boundary."""
        for ev in self.events:
            if ev.step <= step and ev not in self.fired:
                ev.fire(target)
                self.fired.append(ev)

    @staticmethod
    def random(seed: int, n_steps: int, initial_devices: Sequence[int],
               spare_devices: Sequence[int] = (), min_extent: int = 2, max_events: int = 4,
               event_steps: Optional[Sequence[int]] = None) -> "ChaosScript":
        """A seeded legal kill/join sequence: never below ``min_extent``
        live replicas, and only replicas outside the live set join."""
        rng = np.random.default_rng(seed)
        live = list(initial_devices)
        outside = list(spare_devices)
        steps = (sorted(rng.choice(np.arange(1, n_steps), size=max_events, replace=False))
                 if event_steps is None else list(event_steps))
        events: list = []
        for s in steps[:max_events]:
            can_kill = len(live) > min_extent
            can_join = len(outside) > 0
            if not (can_kill or can_join):
                break
            if can_kill and (not can_join or rng.random() < 0.5):
                victim = live[int(rng.integers(len(live)))]
                events.append(Kill(int(s), victim))
                live.remove(victim)
                outside.append(victim)
            else:
                n = int(rng.integers(1, min(2, len(outside)) + 1))
                joiners = [outside.pop(int(rng.integers(len(outside)))) for _ in range(n)]
                events.append(Join(int(s), tuple(sorted(joiners))))
                live.extend(joiners)
        return ChaosScript(events)


def poisson_arrivals(rng, n, mean_gap=3.0):
    """Arrival ticks with exponential gaps (a Poisson process)."""
    return np.floor(np.cumsum(rng.exponential(mean_gap, size=n))).astype(int)


def llm_requests(cls, vocab, n=8, seed=3):
    """The reference chaos suite's LLM traffic (``tests/test_chaos_serving.py``)."""
    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(rng, n)
    lens = rng.integers(3, 9, size=n)
    max_new = rng.integers(4, 8, size=n)
    return [cls(id=i, arrival=int(arrivals[i]), prompt=rng.integers(0, vocab, size=int(lens[i])),
                max_new=int(max_new[i])) for i in range(n)]


def script():
    """The reference chaos suite's script: 4 -> 3 (a fail-stop kill) -> 5
    (two joiners) -> 4 (a second kill), a stall and unstall riding along
    (grow_on_join drains no straggler: the stall only exercises the
    heartbeats)."""
    return ChaosScript([
        Kill(step=4, device=2),
        Stall(step=8, device=1, factor=10.0),
        Join(step=14, devices=(4, 5)),
        Unstall(step=20, device=1),
        Kill(step=24, device=0),
    ])


TRAJECTORY = [("shrink", 4, 3), ("grow", 3, 5), ("shrink", 5, 4)]


def trajectory(resizes) -> list:
    return [(e.kind, e.old_dp, e.new_dp) for e in resizes]
