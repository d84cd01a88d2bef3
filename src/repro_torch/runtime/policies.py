"""Elastic resize policies (port of ``repro.runtime.policies``).

A policy turns the host's health picture (heartbeat failures, straggler
percentiles, pending joins, and for serving the load) into one
:class:`ResizeDecision` a step; the controller executes it: ``shrink`` and
``grow`` resize the agreement extent in place, ``abort`` raises, ``none``
serves on.  Policies live in the ``ELASTIC_POLICIES`` registry, resolved
by name (``--elastic-policy``); adding one is a ``@register_policy`` class.

- ``static``: never resize; a confirmed failure aborts.
- ``shrink_on_failure``: drop failed workers and go on at the (usually
  non-power-of-two) smaller extent, which the MRD schedule serves as it
  serves any other.
- ``grow_on_join``: ``shrink_on_failure`` plus admission of pending
  joiners as new trailing ranks (they receive the state through the MRD
  sum-broadcast at the new extent).
- ``drain_straggler``: ``shrink_on_failure`` plus eviction of workers the
  straggler rule flags.
- ``sla_autoscale``: ``shrink_on_failure`` plus load-driven grow and
  shrink for serving: the controller hands it a :class:`LoadSnapshot`
  (queue depth, TTFT-SLA pressure, free capacity) and it trades replicas
  against SLA risk with up/down patience, a cooldown after each resize
  and min/max-extent clamps.  It keeps state, so a controller takes its
  own instance through :meth:`ElasticPolicy.spawn`.

The decisions are pure host logic and equal the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from repro_torch.runtime.fault_tolerance import FailureDetector


@dataclasses.dataclass(frozen=True)
class ResizeDecision:
    """What the policy wants done before the next step."""

    action: str = "none"  # 'none' | 'shrink' | 'grow' | 'abort'
    remove: frozenset = frozenset()  # ids to drop (shrink/abort)
    admit: tuple = ()  # ids to add (grow)
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class LoadSnapshot:
    """The serving load an autoscaling policy sees each step, built by
    ``ServeEngine.load_snapshot``: tick-domain integers, so a replayed
    trace autoscales the same way every run."""

    tick: int  # engine tick the snapshot was taken at
    queue_depth: int = 0  # pending requests (arrived, not admitted)
    sla_near: int = 0  # queued SLA requests past half their deadline
    sla_overdue: int = 0  # queued SLA requests past their deadline
    free_slots: int = 0  # usable slots with no active request
    usable_slots: int = 0  # min(slots, dp * slots_per_replica)
    dp: int = 1  # live replica extent


ELASTIC_POLICIES: Dict[str, "ElasticPolicy"] = {}


def register_policy(name: str):
    def deco(cls):
        ELASTIC_POLICIES[name] = cls()
        return cls

    return deco


def get_policy(name) -> "ElasticPolicy":
    """The registered policy ``name`` (a policy instance passes through)."""
    if isinstance(name, ElasticPolicy):
        return name
    try:
        return ELASTIC_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown elastic policy {name!r}; registered: {sorted(ELASTIC_POLICIES)}"
        ) from None


def available() -> list[str]:
    return sorted(ELASTIC_POLICIES)


def clamp_min_extent(decision: ResizeDecision, live_ids, min_extent: int = 1) -> ResizeDecision:
    """Never shrink below ``min_extent`` replicas: a serving pool keeps
    answering, so the lowest-id victims are spared until ``min_extent``
    survivors remain (the controller presses them back into service; a
    later decision drops them once joiners restore headroom)."""
    if decision.action != "shrink":
        return decision
    survivors = [w for w in live_ids if w not in decision.remove]
    if len(survivors) >= min_extent:
        return decision
    spared = sorted(decision.remove)[: min_extent - len(survivors)]
    remove = frozenset(w for w in decision.remove if w not in spared)
    if not remove:
        return ResizeDecision(reason=f"shrink suppressed: min extent {min_extent}")
    return dataclasses.replace(
        decision, remove=remove,
        reason=f"{decision.reason} (clamped to min extent {min_extent})",
    )


class ElasticPolicy:
    """Base: no failure tolerated, no growth."""

    def decide(self, detector: FailureDetector, now: float, pending_joins: Sequence[int],
               mesh_device_ids: frozenset, load: Optional[LoadSnapshot] = None
               ) -> ResizeDecision:
        raise NotImplementedError

    def spawn(self) -> "ElasticPolicy":
        """A deployment's own instance: stateless policies return the
        registry's, stateful ones a fresh copy."""
        return self

    def _confirmed_failures(self, detector, now, mesh_device_ids):
        return frozenset(w for w in detector.failed(now) if w in mesh_device_ids)


@register_policy("static")
class StaticPolicy(ElasticPolicy):
    def decide(self, detector, now, pending_joins, mesh_device_ids, load=None):
        failed = self._confirmed_failures(detector, now, mesh_device_ids)
        if failed:
            return ResizeDecision("abort", remove=failed,
                                  reason=f"static policy: workers {sorted(failed)} failed")
        return ResizeDecision()


@register_policy("shrink_on_failure")
class ShrinkOnFailurePolicy(ElasticPolicy):
    def decide(self, detector, now, pending_joins, mesh_device_ids, load=None):
        failed = self._confirmed_failures(detector, now, mesh_device_ids)
        if failed:
            return ResizeDecision("shrink", remove=failed,
                                  reason=f"heartbeat failure: {sorted(failed)}")
        return ResizeDecision()


@register_policy("grow_on_join")
class GrowOnJoinPolicy(ShrinkOnFailurePolicy):
    def decide(self, detector, now, pending_joins, mesh_device_ids, load=None):
        d = super().decide(detector, now, pending_joins, mesh_device_ids)
        if d.action != "none":
            return d
        joiners = tuple(w for w in pending_joins if w not in mesh_device_ids)
        if joiners:
            return ResizeDecision("grow", admit=joiners, reason=f"join: {sorted(joiners)}")
        return ResizeDecision()


@register_policy("drain_straggler")
class DrainStragglerPolicy(ShrinkOnFailurePolicy):
    def decide(self, detector, now, pending_joins, mesh_device_ids, load=None):
        d = super().decide(detector, now, pending_joins, mesh_device_ids)
        if d.action != "none":
            return d
        slow = frozenset(w for w in detector.stragglers() if w in mesh_device_ids)
        if slow:
            return ResizeDecision("shrink", remove=slow,
                                  reason=f"straggler drain: {sorted(slow)}")
        return ResizeDecision()


@register_policy("sla_autoscale")
class SlaAutoscalePolicy(ShrinkOnFailurePolicy):
    """SLA-pressure autoscaler for serving.  After the inherited failure
    shrink, which always wins:

    - **pressure** (overdue or near-deadline SLA requests, or a queue
      deeper than the free usable slots plus ``queue_per_replica`` a
      replica) for ``up_patience`` consecutive steps outside the cooldown
      grows by one replica, id ``max(live) + 1``;
    - **idle** (no queue, no SLA risk, a replica's worth of free slots)
      for ``down_patience`` steps shrinks by the highest live id, never
      below ``min_extent``;
    - a resize arms ``cooldown`` ticks in which both counters stay 0.
    """

    def __init__(self, *, min_extent: int = 1, max_extent: int = 8, up_patience: int = 2,
                 down_patience: int = 8, cooldown: int = 8, queue_per_replica: int = 0):
        if min_extent < 1 or max_extent < min_extent:
            raise ValueError(
                f"need 1 <= min_extent <= max_extent, got {min_extent}..{max_extent}")
        self.min_extent = min_extent
        self.max_extent = max_extent
        self.up_patience = up_patience
        self.down_patience = down_patience
        self.cooldown = cooldown
        self.queue_per_replica = queue_per_replica
        self._up = 0
        self._down = 0
        self._cool_until = -1

    def spawn(self):
        return SlaAutoscalePolicy(
            min_extent=self.min_extent, max_extent=self.max_extent,
            up_patience=self.up_patience, down_patience=self.down_patience,
            cooldown=self.cooldown, queue_per_replica=self.queue_per_replica,
        )

    def _pressure(self, load: LoadSnapshot) -> bool:
        slack = self.queue_per_replica * load.dp
        return (load.sla_overdue > 0 or load.sla_near > 0
                or load.queue_depth > load.free_slots + slack)

    def _idle(self, load: LoadSnapshot) -> bool:
        per_replica = max(1, load.usable_slots // max(1, load.dp))
        return (load.queue_depth == 0 and load.sla_near == 0 and load.sla_overdue == 0
                and load.free_slots >= per_replica)

    def decide(self, detector, now, pending_joins, mesh_device_ids, load=None):
        d = super().decide(detector, now, pending_joins, mesh_device_ids)
        if d.action != "none":
            self._up = self._down = 0
            self._cool_until = now + self.cooldown
            return d
        if load is None:  # not a serving controller: behave as the parent
            return d
        if load.tick < self._cool_until:
            self._up = self._down = 0
            return ResizeDecision(reason="autoscale: cooldown")
        live = sorted(mesh_device_ids)
        if self._pressure(load):
            self._down = 0
            self._up += 1
            if self._up >= self.up_patience and len(live) < self.max_extent:
                self._up = 0
                self._cool_until = load.tick + self.cooldown
                joiner = (max(live) + 1) if live else 0
                return ResizeDecision(
                    "grow", admit=(joiner,),
                    reason=(f"autoscale up: queue={load.queue_depth} near={load.sla_near} "
                            f"overdue={load.sla_overdue} at dp={load.dp}"),
                )
        elif self._idle(load):
            self._up = 0
            self._down += 1
            if self._down >= self.down_patience and len(live) > self.min_extent:
                self._down = 0
                self._cool_until = load.tick + self.cooldown
                return ResizeDecision("shrink", remove=frozenset({max(live)}),
                                      reason=f"autoscale down: idle at dp={load.dp}")
        else:
            self._up = self._down = 0
        return ResizeDecision()
