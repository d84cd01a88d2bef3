"""Chaos scripts for the elastic runtime, and the oracle replay of a
recorded resize trajectory.

A :class:`ChaosScript` is an ordered list of :class:`Kill` / :class:`Join`
/ :class:`Stall` / :class:`Unstall` events.  Each event calls the method
of its name on a target: an :class:`~repro_torch.runtime.ElasticTrainer`
(through :meth:`ChaosScript.apply`, before the train step it names) or an
:class:`~repro_torch.runtime.ElasticServeController` (through
:meth:`ChaosScript.apply_due` on the engine's tick clock).  Detection runs
on the target's injected clock, so a script decides the whole resize
trajectory.  :func:`parse_chaos` reads the CLIs' ``--kill/--join/--stall/
--unstall`` specs into a script.

:func:`oracle_replay` replays what an elastic training run recorded
with the plain train step and none of the elastic machinery; a run that
survives its script equals its replay bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Kill:
    """Replica ``device`` dies at ``step``; ``silent`` models a partition:
    detection waits for the heartbeat timeout instead of a crash report."""

    step: int
    device: int
    silent: bool = False

    def call(self) -> tuple:
        return "kill", (self.device,), {"silent": self.silent}


@dataclasses.dataclass(frozen=True)
class Join:
    """Replicas ``devices`` ask to join at ``step``."""

    step: int
    devices: tuple

    def call(self) -> tuple:
        return "join", (tuple(self.devices),), {}


@dataclasses.dataclass(frozen=True)
class Stall:
    """Replica ``device`` slows to ``factor`` x the healthy step time."""

    step: int
    device: int
    factor: float = 10.0

    def call(self) -> tuple:
        return "stall", (self.device, self.factor), {}


@dataclasses.dataclass(frozen=True)
class Unstall:
    step: int
    device: int

    def call(self) -> tuple:
        return "unstall", (self.device,), {}


class ChaosScript:
    """An ordered event script; each event fires once.  ``log``, when
    given, receives a ``# chaos @tick T: name(args)`` line for each event
    fired (the serving CLI prints them)."""

    def __init__(self, events: Sequence, log: Optional[Callable[[str], None]] = None):
        self.events = sorted(events, key=lambda e: e.step)
        self.fired: list = []
        self.log = log
        self._done: set = set()

    def _fire(self, i: int, target, step: int):
        name, args, kw = self.events[i].call()
        if self.log is not None:
            self.log(f"# chaos @tick {step}: {name}{args}")
        getattr(target, name)(*args, **kw)
        self._done.add(i)
        self.fired.append(self.events[i])

    def apply(self, target, step: int):
        """Fire the events due exactly at ``step``."""
        for i, ev in enumerate(self.events):
            if ev.step == step and i not in self._done:
                self._fire(i, target, step)

    def apply_due(self, target, step: int):
        """Fire every event not yet fired with ``ev.step <= step``: the
        engine's tick jumps by up to ``steps_per_dispatch`` a step, so an
        event inside a dispatch fires at the next boundary."""
        for i, ev in enumerate(self.events):
            if ev.step <= step and i not in self._done:
                self._fire(i, target, step)

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


def parse_chaos(kill=(), join=(), stall=(), unstall=(), *,
                log: Optional[Callable[[str], None]] = None) -> Optional[ChaosScript]:
    """A script from CLI specs: ``kill`` ``STEP:ID[:silent]``, ``join``
    ``STEP:ID[,ID...]``, ``stall`` ``STEP:ID[:FACTOR]``, ``unstall``
    ``STEP:ID`` (each a list; events of one step fire in that order of the
    kinds).  None when there is no event."""
    events: list = []
    for spec in kill or ():
        parts = spec.split(":")
        events.append(Kill(int(parts[0]), int(parts[1]),
                           silent=len(parts) > 2 and parts[2] == "silent"))
    for spec in join or ():
        at, _, ids = spec.partition(":")
        events.append(Join(int(at), tuple(int(i) for i in ids.split(","))))
    for spec in stall or ():
        parts = spec.split(":")
        events.append(Stall(int(parts[0]), int(parts[1]),
                            float(parts[2]) if len(parts) > 2 else 10.0))
    for spec in unstall or ():
        at, _, rid = spec.partition(":")
        events.append(Unstall(int(at), int(rid)))
    return ChaosScript(events, log=log) if events else None


def scripted_extents(script: ChaosScript, initial_ids: Sequence[int],
                     min_extent: int = 1) -> list:
    """(event, extent after it) for each kill and join of ``script`` in its
    order, from the live replicas ``initial_ids``: a kill drops a live id
    (never below ``min_extent``, as ``policies.clamp_min_extent`` spares
    one), a join appends the ids not live.  The extents a policy that acts
    on every report and admits every joiner passes through."""
    live = list(initial_ids)
    out = []
    for ev in script.events:
        if isinstance(ev, Kill):
            if ev.device in live and len(live) > min_extent:
                live.remove(ev.device)
        elif isinstance(ev, Join):
            live += [d for d in ev.devices if d not in live]
        else:
            continue
        out.append((ev, len(live)))
    return out


def kill_join_script() -> ChaosScript:
    """The reference chaos suite's headline training script from replicas
    0-3: 4 -> 3 at step 2, 3 -> 5 at step 4 (the killed worker rejoins
    with a spare), 5 -> 4 at step 7."""
    return ChaosScript([Kill(2, 2), Join(4, (2, 4)), Kill(7, 1)])


KILL_JOIN_TRAJECTORY = [("shrink", 4, 3), ("grow", 3, 5), ("shrink", 5, 4)]


def oracle_replay(cfg, tcfg, dcfg, initial_ids: Sequence[int], resizes: Sequence, n_steps: int,
                  *, seed: int = 0, device="cpu", state=None, batches=None):
    """Replay a recorded resize trajectory with the plain train step and
    none of the elastic machinery (the reference's ``oracle_replay``,
    stacked rows): each segment is an uninterrupted run of
    ``make_train_step`` at its extent, and the segments are joined by the
    same ``gradsync.migrate_state`` calls the recorded
    :class:`~repro_torch.runtime.ResizeEvent` s name.  The initial state is
    ``state`` or ``init_state`` from ``seed``; the batches ``batches[i]``
    or the synthetic pipeline's over ``dcfg``.  Returns ``(state,
    losses)``."""
    import torch

    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.distributed import gradsync
    from repro_torch.distributed import step as step_lib

    by_step: dict = {}
    for ev in resizes:
        by_step.setdefault(int(ev.step), []).append(ev)
    ids = tuple(initial_ids)
    train_step = step_lib.make_train_step(cfg, tcfg, dp=len(ids), device=device)
    if state is None:
        state = train_step.init_state(torch.Generator(device=device).manual_seed(seed))
    pipe = SyntheticPipeline(cfg, dcfg, device) if batches is None else None
    losses = []
    for i in range(n_steps):
        for ev in by_step.get(i, []):
            new_ids = tuple(ev.device_ids)
            state = gradsync.migrate_state(cfg, tcfg, ids, new_ids, state, ev.keep)
            ids = new_ids
            train_step = step_lib.make_train_step(cfg, tcfg, dp=len(ids), device=device)
        batch = pipe.next_batch() if batches is None else batches[i]
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
    return state, losses
