"""Failure detection and mesh rebuilds for the elastic runtime (port of
``repro.runtime.fault_tolerance``).

The paper's non-power-of-two support is what makes losing a worker cheap:
losing one of four termination-agreement replicas leaves three, and the
MRD schedule keeps every reduction correct at that extent without waiting
for a replacement.

- :class:`FailureDetector` tracks heartbeats on an injected clock (a
  fail-stop crash report marks a worker dead at once; a silent one is
  reported after ``timeout_s``) and applies the straggler rule (a worker
  whose recent step times exceed ``straggler_factor`` x the median for
  ``evict_after_straggler_steps`` consecutive checks).
- :class:`ReplicaSet` is the ordered set of live replica ids of a
  simulated extent, producing the keep maps ``ServeEngine.resize`` takes.
- :class:`StepClock` is the deterministic virtual clock the controller
  advances once a step, so every detection is a function of the event
  script.

- :func:`shrink_mesh` / :func:`grow_mesh` rebuild the elastic trainer's
  mesh without the failed workers or with the joiners appended.  On
  stacked rows a mesh is the ordered tuple of replica ids; in a world it
  is a ``("data",)`` or ``("data", "model")`` :class:`DeviceMesh` over
  the live global ranks, resized a whole data-parallel slice (a TP group)
  at a time.  Every process of the world builds each new mesh
  (``new_group`` is collective over the default group); a rank outside
  it has coordinate None.
- :func:`recover` restores the latest checkpoint onto a template of the
  new extent: the trainer's one restore route (``init_or_restore``, and
  the resize of a step factory it cannot migrate).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class HeartbeatConfig:
    timeout_s: float = 60.0  # hard failure
    straggler_factor: float = 3.0  # x median step time => straggler
    evict_after_straggler_steps: int = 5


class FailureDetector:
    """Per-worker heartbeats on the host, on an injected clock (tests and
    the controller drive it explicitly)."""

    def __init__(self, workers: list[int], cfg: HeartbeatConfig, now: float = 0.0):
        self.cfg = cfg
        self.last: dict[int, float] = {w: now for w in workers}
        self.step_times: dict[int, list[float]] = {w: [] for w in workers}
        self.straggler_strikes: dict[int, int] = {w: 0 for w in workers}

    def heartbeat(self, worker: int, now: float, step_time: Optional[float] = None):
        self.last[worker] = now
        if step_time is not None:
            self.step_times[worker].append(step_time)
            self.step_times[worker] = self.step_times[worker][-32:]

    def mark_dead(self, worker: int):
        """Fail-stop notification: the worker is known dead now (a crash
        report), so :meth:`failed` reports it at once instead of after
        ``timeout_s``."""
        if worker in self.last:
            self.last[worker] = float("-inf")

    def add_worker(self, worker: int, now: float):
        """Start tracking a joining worker (grow)."""
        self.last.setdefault(worker, now)
        self.step_times.setdefault(worker, [])
        self.straggler_strikes.setdefault(worker, 0)

    def remove_worker(self, worker: int):
        """Stop tracking an evicted worker (shrink)."""
        self.last.pop(worker, None)
        self.step_times.pop(worker, None)
        self.straggler_strikes.pop(worker, None)

    def failed(self, now: float) -> list[int]:
        return [w for w, t in self.last.items() if now - t > self.cfg.timeout_s]

    def stragglers(self) -> list[int]:
        med = np.median([np.mean(v) for v in self.step_times.values() if v] or [0.0])
        out = []
        for w, v in self.step_times.items():
            if v and med > 0 and np.mean(v[-5:]) > self.cfg.straggler_factor * med:
                self.straggler_strikes[w] += 1
                if self.straggler_strikes[w] >= self.cfg.evict_after_straggler_steps:
                    out.append(w)
            else:
                self.straggler_strikes[w] = 0
        return out


class ReplicaSet:
    """Ordered live replica ids of a simulated agreement extent.

    The serving engine's termination agreement runs over stacked replicas,
    so a resize needs a keep map and no device grid: ``keep[i]`` is the old
    rank now at new rank ``i`` (None: a joiner), the contract of the
    termination ``migrate`` hooks and ``ServeEngine.resize``."""

    def __init__(self, ids):
        self.ids = list(ids)
        if len(set(self.ids)) != len(self.ids):
            raise ValueError(f"duplicate replica ids: {self.ids}")

    @property
    def dp(self) -> int:
        return len(self.ids)

    def remove(self, dead) -> tuple:
        """Drop ``dead`` ids; survivors keep their order.  Returns
        ``(new_ids, keep)``."""
        dead = set(dead)
        keep = tuple(i for i, r in enumerate(self.ids) if r not in dead)
        if not keep:
            raise RuntimeError("no live replicas left")
        self.ids = [self.ids[i] for i in keep]
        return tuple(self.ids), keep

    def add(self, joiners) -> tuple:
        """Append ``joiners`` (those not already live) as new trailing
        ranks.  Returns ``(new_ids, keep)``, None marking each joiner."""
        joiners = [j for j in joiners if j not in self.ids]
        keep = tuple(range(len(self.ids))) + (None,) * len(joiners)
        self.ids = self.ids + joiners
        return tuple(self.ids), keep


class StepClock:
    """Deterministic virtual clock: ``dt`` seconds a controller step, so
    failure detection is a function of the event script alone."""

    def __init__(self, dt: float = 1.0, t0: float = 0.0):
        self.dt = dt
        self.t = t0

    def now(self) -> float:
        return self.t

    def advance(self) -> float:
        self.t += self.dt
        return self.t


def mesh_ids(mesh) -> tuple:
    """The worker ids of an elastic mesh, in rank order: a stacked-rows
    tuple's replica ids, a world ``DeviceMesh``'s global ranks (row-major
    over its dimensions)."""
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(int(r) for r in mesh.mesh.reshape(-1).tolist())
    return tuple(mesh)


def _slices(mesh, dp_axis: str) -> np.ndarray:
    """The worker ids of ``mesh`` with the ``dp_axis`` dimension first: a
    row a data-parallel slice (one id a row on stacked rows and in a
    ``("data",)`` world; a TP group's ``tp`` ids in a ``("data",
    "model")`` world)."""
    if not hasattr(mesh, "mesh_dim_names"):
        return np.asarray(mesh, dtype=np.int64).reshape(-1, 1)
    grid = np.asarray(mesh.mesh.tolist(), dtype=np.int64)
    grid = np.moveaxis(grid, list(mesh.mesh_dim_names).index(dp_axis), 0)
    return grid.reshape(grid.shape[0], -1)


def _rebuild(mesh, rows: np.ndarray, dp_axis: str):
    """A mesh like ``mesh`` over the slices ``rows`` (as :func:`_slices`
    gives them).  In a world every process must call it: ``new_group`` is
    collective over the default group."""
    if not hasattr(mesh, "mesh_dim_names"):
        return tuple(int(r) for r in rows.reshape(-1))
    from torch.distributed.device_mesh import DeviceMesh

    names = list(mesh.mesh_dim_names)
    d = names.index(dp_axis)
    shape = list(mesh.mesh.shape)
    moved = [shape[d]] + shape[:d] + shape[d + 1:]
    moved[0] = rows.shape[0]
    grid = np.moveaxis(rows.reshape(moved), 0, d)
    return DeviceMesh(mesh.device_type, torch.as_tensor(grid.tolist(), dtype=torch.int64),
                      mesh_dim_names=tuple(names))


def shrink_mesh(mesh, failed_device_ids, dp_axis: str = "data"):
    """The mesh without every data-parallel slice that holds a failed
    worker (a TP group with a dead member is unusable): the surviving
    slices keep their order, and the extent may be any count,
    non-power-of-two included.  Returns ``(new_mesh, kept)``, the old
    ``dp_axis`` coordinates kept."""
    rows = _slices(mesh, dp_axis)
    failed = set(failed_device_ids)
    kept = [i for i, row in enumerate(rows.tolist()) if not failed & set(row)]
    if not kept:
        raise RuntimeError("no healthy DP slices left")
    return _rebuild(mesh, rows[kept], dp_axis), kept


def grow_mesh(mesh, joining_device_ids, dp_axis: str = "data"):
    """The mesh with the joiners appended as new trailing data-parallel
    slices (the inverse of :func:`shrink_mesh`: the survivors keep their
    coordinates), ``tp`` joiners a slice in their given order.  The joiner
    count must be a positive multiple of a slice's worker count.  Returns
    ``(new_mesh, n_new)``, the slices added."""
    rows = _slices(mesh, dp_axis)
    ids = set(rows.reshape(-1).tolist())
    per_slice = rows.shape[1]
    world = None
    if hasattr(mesh, "mesh_dim_names"):
        import torch.distributed as dist

        world = dist.get_world_size()
    joiners = []
    for d in joining_device_ids:
        if d in ids:
            raise ValueError(f"device {d} is already in the mesh")
        if world is not None and not 0 <= d < world:
            raise ValueError(f"no such device id {d}: the world has {world} ranks")
        joiners.append(int(d))
    if not joiners or len(joiners) % per_slice:
        raise ValueError(f"need a positive multiple of {per_slice} joining devices to form "
                         f"whole DP slices, got {len(joiners)}")
    new = np.asarray(joiners, dtype=np.int64).reshape(-1, per_slice)
    return _rebuild(mesh, np.concatenate([rows, new]), dp_axis), new.shape[0]


@dataclasses.dataclass
class RestartReport:
    old_dp: int
    new_dp: int
    restored_step: int
    elapsed_s: float


def recover(checkpointer, template_state, device="cpu", *, old_dp: int, new_dp: int,
            blocks: Optional[dict] = None, rows: Optional[tuple] = None):
    """Restore the latest checkpoint onto ``template_state`` (the leaves to
    read, nested as saved: their structure, shapes and types) on
    ``device``.  ``blocks`` ({leaf key: index}) reads those leaves cut to a
    block of the saved one (``Checkpointer.restore_blocks``; the template
    then has the saved shapes); ``rows`` (top-level parts) reads a world
    rank's rows of them (``Checkpointer.restore_rank``, at ``new_dp``).
    Returns ``(state, RestartReport)``."""
    t0 = time.time()
    step = checkpointer.latest_step()
    if step is None:
        raise RuntimeError("no checkpoint to recover from")
    if rows is not None:
        state = checkpointer.restore_rank(step, template_state, rows, device, dp=new_dp)
    elif blocks is None:
        state = checkpointer.restore(step, template_state, device)
    else:
        state = checkpointer.restore_blocks(step, template_state, blocks, device)
    return state, RestartReport(old_dp, new_dp, step, time.time() - t0)
