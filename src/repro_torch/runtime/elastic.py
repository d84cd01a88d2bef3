"""The elastic serving runtime (port of the serving half of
``repro.runtime.elastic``).

The paper's modified recursive doubling is correct at any process count,
which is what makes live elasticity cheap: losing or admitting a replica
changes the agreement extent to an arbitrary, usually non-power-of-two,
value and the MRD plans keep working.  :class:`ElasticServeController`
turns that into a runtime for the serving engine:

- a policy of ``ELASTIC_POLICIES`` (``runtime/policies.py``) decides each
  step whether to shrink (heartbeat failure, straggler drain, idle
  autoscale), grow (a pending join, SLA pressure), abort or serve on;
- the decision becomes a :class:`~repro_torch.runtime.fault_tolerance.ReplicaSet`
  keep map and a :meth:`ServeEngine.resize` at the new extent: the
  termination state migrates, and on a grow the joiners receive the
  serving state through the MRD sum-broadcast
  (:func:`repro_torch.distributed.serve.mrd_broadcast_stacked`), bit for
  bit the source's;
- failures are detected on an injected
  :class:`~repro_torch.runtime.fault_tolerance.StepClock`, so every resize
  is a function of the event script (kill, stall, unstall, join).

The training half (``mrd_broadcast`` over a device mesh and
``ElasticTrainer``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.runtime.fault_tolerance import (
    FailureDetector,
    HeartbeatConfig,
    ReplicaSet,
    StepClock,
)
from repro_torch.runtime.policies import LoadSnapshot, clamp_min_extent, get_policy


@dataclasses.dataclass(frozen=True)
class ResizeEvent:
    """One executed topology change: everything needed to replay it."""

    kind: str  # 'shrink' | 'grow'
    step: int  # the tick (serving) or step (training) it took effect at
    old_dp: int
    new_dp: int
    # new flattened-DP rank -> old flattened-DP rank (None = joined worker)
    keep: tuple
    device_ids: tuple  # device ids of the new mesh (row-major; () when simulated)
    reason: str = ""
    restored_from_checkpoint: bool = False


@dataclasses.dataclass
class ElasticConfig:
    ckpt_every: int = 50
    heartbeat: HeartbeatConfig = dataclasses.field(default_factory=HeartbeatConfig)
    max_restarts: int = 8  # resize budget (the reference's name)
    dp_axis: str = "data"
    policy: str = "shrink_on_failure"  # any ELASTIC_POLICIES entry
    step_dt: float = 1.0  # virtual seconds a step (StepClock)
    base_step_time: float = 1.0  # a healthy worker's reported step time


def _axis_sizes(mesh, dp_axes) -> list:
    """Sizes of ``dp_axes`` of ``mesh``: a ``torch.distributed``
    ``DeviceMesh`` (its ``mesh_dim_names``) or a mapping axis -> size."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return [mesh.size(names.index(a)) for a in dp_axes]
    shape = getattr(mesh, "shape", mesh)
    return [int(shape[a]) for a in dp_axes]


def flat_keep_for_shrink(old_mesh, dp_axes, axis: str, kept: Sequence[int]):
    """Flattened-DP keep map after dropping dp-``axis`` slices: new flat
    rank i held old flat rank ``keep[i]``."""
    sizes_o = _axis_sizes(old_mesh, dp_axes)
    ai = list(dp_axes).index(axis)
    sizes_n = list(sizes_o)
    sizes_n[ai] = len(kept)
    keep = []
    for new_flat in range(int(np.prod(sizes_n))):
        idx = list(np.unravel_index(new_flat, sizes_n))
        idx[ai] = kept[idx[ai]]
        keep.append(int(np.ravel_multi_index(idx, sizes_o)))
    return tuple(keep)


def flat_keep_for_grow(old_mesh, dp_axes, axis: str, n_new: int):
    """Flattened-DP keep map after appending ``n_new`` dp-``axis`` slices:
    survivors keep their positions, joiners map to None."""
    sizes_o = _axis_sizes(old_mesh, dp_axes)
    ai = list(dp_axes).index(axis)
    old_extent = sizes_o[ai]
    sizes_n = list(sizes_o)
    sizes_n[ai] = old_extent + n_new
    keep = []
    for new_flat in range(int(np.prod(sizes_n))):
        idx = list(np.unravel_index(new_flat, sizes_n))
        if idx[ai] >= old_extent:
            keep.append(None)
        else:
            keep.append(int(np.ravel_multi_index(idx, sizes_o)))
    return tuple(keep)


class ElasticServeController:
    """Drive a :class:`repro_torch.serving.ServeEngine` across replica
    changes.

    The "workers" are the engine's simulated termination-agreement
    replicas: a resize produces a :class:`ReplicaSet` keep map and calls
    :meth:`ServeEngine.resize`.  Serving never aborts on total failure:
    :func:`clamp_min_extent` pins the pool at ``min_extent`` replicas and
    the spared replicas are pressed back into service.

    One controller step is one policy pass and one engine step (up to
    ``steps_per_dispatch`` ticks); chaos events match the engine's tick
    clock through ``apply_due``, so an event due inside a dispatch fires
    at the next dispatch boundary, the first point a control plane could
    act."""

    def __init__(self, engine, policy="grow_on_join", *,
                 heartbeat: Optional[HeartbeatConfig] = None,
                 clock: Optional[StepClock] = None,
                 replica_ids: Optional[Sequence[int]] = None, min_extent: int = 1,
                 base_step_time: float = 1.0, max_resizes: int = 32):
        self.engine = engine
        ids = list(replica_ids) if replica_ids is not None else list(range(engine.dp))
        if len(ids) != engine.dp:
            raise ValueError(f"{len(ids)} replica ids for a dp={engine.dp} engine")
        self.replicas = ReplicaSet(ids)
        # a stateful policy (sla_autoscale) gets this controller's own copy
        self.policy = get_policy(policy).spawn()
        self.clock = clock or StepClock()
        self.detector = FailureDetector(ids, heartbeat or HeartbeatConfig(), now=self.clock.now())
        self.min_extent = min_extent
        self.base_step_time = base_step_time
        self.max_resizes = max_resizes
        self.health: dict[int, str] = {r: "ok" for r in ids}
        self.stall_factor: dict[int, float] = {}
        self.pending_joins: list[int] = []

    # -- what a chaos script pokes ------------------------------------------

    def kill(self, replica_id: int, *, silent: bool = False):
        self.health[replica_id] = "dead"
        if not silent:
            self.detector.mark_dead(replica_id)

    def stall(self, replica_id: int, factor: float = 10.0):
        self.health[replica_id] = "stalled"
        self.stall_factor[replica_id] = factor

    def unstall(self, replica_id: int):
        if self.health.get(replica_id) == "stalled":
            self.health[replica_id] = "ok"
        self.stall_factor.pop(replica_id, None)

    def join(self, replica_ids: Sequence[int]):
        for r in replica_ids:
            if r not in self.pending_joins and r not in self.replicas.ids:
                self.pending_joins.append(r)
                self.health[r] = "ok"

    def _heartbeat_all(self, now: float):
        for r in self.replicas.ids:
            status = self.health.get(r, "ok")
            if status == "dead":
                continue
            step_time = self.base_step_time * (
                self.stall_factor.get(r, 1.0) if status == "stalled" else 1.0)
            self.detector.heartbeat(r, now=now, step_time=step_time)

    def _load(self) -> LoadSnapshot:
        return self.engine.load_snapshot()

    # -- one controller step ------------------------------------------------

    def step(self, events=None) -> np.ndarray:
        """One policy pass and one engine step; returns the retired mask."""
        now = self.clock.advance()
        if events is not None:
            fire = getattr(events, "apply_due", None) or events.apply
            fire(self, self.engine.tick)
        self._heartbeat_all(now)
        decision = self.policy.decide(self.detector, now, self.pending_joins,
                                      frozenset(self.replicas.ids), load=self._load())
        clamped = clamp_min_extent(decision, self.replicas.ids, self.min_extent)
        if decision.action == "shrink" and clamped is not decision:
            # the spared replicas serve on: clear their failure evidence, or
            # the suppressed shrink fires again every step and blocks joins
            for r in decision.remove - clamped.remove:
                self.health[r] = "ok"
                self.detector.heartbeat(r, now=now)
        decision = clamped
        if decision.action == "abort":
            raise RuntimeError(f"elastic policy abort: {decision.reason}")
        if decision.action == "shrink":
            if len(self.resizes) >= self.max_resizes:
                raise RuntimeError("resize budget exhausted")
            for r in decision.remove:
                self.detector.remove_worker(r)
                self.health[r] = "dead"
            _, keep = self.replicas.remove(decision.remove)
            self.engine.resize(self.replicas.dp, keep, reason=decision.reason)
        elif decision.action == "grow":
            if len(self.resizes) >= self.max_resizes:
                raise RuntimeError("resize budget exhausted")
            joiners = tuple(decision.admit)
            self.pending_joins = [r for r in self.pending_joins if r not in set(joiners)]
            for r in joiners:
                self.detector.add_worker(r, now)
            _, keep = self.replicas.add(joiners)
            self.engine.resize(self.replicas.dp, keep, reason=decision.reason)
        return self.engine.step()

    @property
    def resizes(self) -> list[ResizeEvent]:
        return self.engine.resizes

    def run(self, requests=None, *, events=None, max_steps: Optional[int] = None):
        """Submit ``requests`` and step under the policy until everything
        retires, with chaos ``events`` applied on the engine's tick clock.
        Returns the engine's results."""
        eng = self.engine
        for r in requests or []:
            eng.submit(r)
        budget = max_steps or eng.cfg.max_ticks
        steps = 0
        while eng.queue or eng.pending or any(r is not None for r in eng.slot_req):
            if steps >= budget:
                raise RuntimeError(f"elastic serve loop did not drain within {budget} steps")
            self.step(events)
            steps += 1
        return eng.results
