"""The elastic runtime (port of ``repro.runtime.elastic``): training and
serving across topology changes.

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

- :class:`ElasticTrainer` does the same for training: a decision
  rebuilds the mesh (:func:`~repro_torch.runtime.fault_tolerance.shrink_mesh`,
  :func:`~repro_torch.runtime.fault_tolerance.grow_mesh`), invalidates
  the live plans, carries the state to the new extent in place through
  the grad-sync strategy's resize hook (``gradsync.migrate_state``: the
  ZeRO-1 segments, the EF residuals, the monitor rows, local SGD's
  replicas) and, on a grow, sends the joiners the params through the MRD
  sum at the new extent (:func:`mrd_broadcast` in a world,
  ``distributed.serve.mrd_broadcast_stacked`` on stacked rows), bit for
  bit the source's.  The checkpointer stays the path for a step factory
  the trainer cannot migrate (``restores`` counts its use) and for cold
  starts, and the trainer saves every ``ckpt_every`` steps and at the end
  of a run, as the reference's.

The trainer runs in either layout of the ranks.  On stacked rows (one
device) the mesh is the tuple of live replica ids.  In a world (one
process a rank) it is a ``DeviceMesh`` over the live global ranks,
``("data",)`` or ``("data", "model")``: the world is launched at the
largest extent the script reaches (the initial ranks and the spares),
every process runs the same controller on the same clock and script and
so reaches the same decisions without communicating, and a process
outside the mesh skips the step.  A resize drops or appends whole
``"data"`` slices (a TP group of ``tp`` workers), the keep map is per
``"data"`` coordinate, and each model rank's ``"data"`` column migrates
its own blocks and rows; a ``gspmd`` world re-shards its FSDP blocks.  A
kill is simulated, as in the reference: the removed rank's process lives
through the resize and hands over its ZeRO-1 segments or FSDP blocks,
then idles; a rank that joins again drops its old state and is sent the
current one.  A world's checkpoint is the file a one-process trainer of
its strategy writes (a ``gspmd`` world's global leaves, streamed to the
mesh's root; an MRD world's rows, each rank writing its own).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import RESIZE_HINT
from repro_torch.runtime.fault_tolerance import (
    FailureDetector,
    HeartbeatConfig,
    ReplicaSet,
    StepClock,
    grow_mesh,
    mesh_ids,
    shrink_mesh,
)
from repro_torch.runtime.policies import (
    LoadSnapshot,
    ResizeDecision,
    clamp_min_extent,
    get_policy,
)


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
    act.

    A resize the workload cannot take (``dp_refusal``: a fixed-point
    pool's residual blocks must split ``n``) is declined: the extent stays,
    the reason goes to ``log`` (once until it changes) and to
    :attr:`declined`, and the policy is asked again at the next step."""

    def __init__(self, engine, policy="grow_on_join", *,
                 heartbeat: Optional[HeartbeatConfig] = None,
                 clock: Optional[StepClock] = None,
                 replica_ids: Optional[Sequence[int]] = None, min_extent: int = 1,
                 base_step_time: float = 1.0, max_resizes: int = 32,
                 log: Optional[Callable[[str], None]] = None):
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
        self.log = log
        self.declined: list[tuple] = []  # (tick, action, new extent, reason)

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

    def _declines(self, action: str, new_dp: int) -> bool:
        """Does the workload refuse the extent ``new_dp``?  Records and logs
        the refusal."""
        refusal = getattr(self.engine.workload, "dp_refusal", None)
        why = None if refusal is None else refusal(new_dp)
        if why is None:
            return False
        entry = (self.engine.tick, action, new_dp, why)
        if self.log is not None and (not self.declined or self.declined[-1][1:] != entry[1:]):
            self.log(f"# resize declined @tick {entry[0]}: {action} to {new_dp} replicas "
                     f"({why}); the extent stays {self.replicas.dp}")
        self.declined.append(entry)
        return True

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
        if decision.action in ("shrink", "grow"):
            ids = set(self.replicas.ids)
            new_dp = len(ids - set(decision.remove) if decision.action == "shrink"
                         else ids | set(decision.admit))
            if self._declines(decision.action, new_dp):
                decision = ResizeDecision()
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


# ---------------------------------------------------------------------------
# The elastic trainer
# ---------------------------------------------------------------------------


def _host_tensor(leaf, device) -> torch.Tensor:
    """A host scalar or numpy array as a tensor on ``device`` (bools as
    uint8, floats as float64, ints as int64)."""
    arr = np.asarray(leaf)
    if arr.dtype == bool:
        arr = arr.astype(np.uint8)
    elif arr.dtype.kind == "f":
        arr = arr.astype(np.float64)
    elif arr.dtype.kind in "iu":
        arr = arr.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def mrd_broadcast(tree, mesh, dp_axes: Sequence[str] = ("data",), src: int = 0,
                  executor: str = "device", *, receive: bool = True):
    """Broadcast ``tree`` (nested dicts of tensors, numpy arrays and host
    scalars) from rank ``src`` of a world's ``mesh`` (its ``dp_axes``,
    flattened) to every rank through the paper's MRD sum-allreduce at the
    mesh's extent, non-power-of-two included: every other rank contributes
    zeros, so every combine adds a zero and the result is the source's
    value bit for bit (``x + 0`` only turns ``-0.0`` into ``+0.0``).  The
    grow's parameter transfer, in place of a checkpoint restore.

    It runs one leaf at a time, in pieces of
    ``distributed.serve.BROADCAST_CHUNK`` elements, and writes each piece
    into the leaf's own storage, so a joiner never holds a second copy of
    the params.  Every rank of the mesh takes part; a rank with ``receive``
    False contributes (zeros, or the source's leaves) and keeps its own
    leaves.  Host leaves come back as new values of their own type."""
    from repro_torch.collectives import plans
    from repro_torch.collectives.executors import axis_ranks
    from repro_torch.distributed.serve import BROADCAST_CHUNK, _map_tree

    names = mesh.mesh_dim_names
    plan = plans.allreduce_plan(schedule="mrd", op="sum", executor=executor,
                                axes=tuple(dp_axes), mesh=mesh)
    rank = 0
    for ax in dp_axes:
        rank = rank * mesh.size(names.index(ax)) + axis_ranks(mesh, ax)[0]
    host_device = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")

    def tensor(leaf: torch.Tensor) -> torch.Tensor:
        if leaf.numel() == 0:
            return leaf
        out = leaf if leaf.is_contiguous() else leaf.contiguous()
        flat = out.view(-1)
        if flat.dtype == torch.bool:  # bools ride as uint8 (a view)
            flat = flat.view(torch.uint8)
        for i in range(0, flat.numel(), BROADCAST_CHUNK):
            piece = flat[i:i + BROADCAST_CHUNK]
            got = plan.run(piece.clone() if rank == src else torch.zeros_like(piece))
            if receive:
                piece.copy_(got)
        return out if receive else leaf

    def leaf_fn(leaf):
        if isinstance(leaf, torch.Tensor):
            return tensor(leaf)
        if isinstance(leaf, (np.ndarray, bool, int, float, np.generic)):
            got = tensor(_host_tensor(leaf, host_device)).cpu().numpy()
            if not receive:
                return leaf
            if isinstance(leaf, np.ndarray):
                return got.astype(leaf.dtype)
            return type(leaf)(got.item())
        return leaf

    return _map_tree(leaf_fn, tree)


def _rows_of(tree, i: int):
    """Row ``i`` (views) of every ``[dp, ...]`` leaf of a nested dict."""
    return {k: _rows_of(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ElasticTrainer:
    """Drive training across topology changes.

    ``step_fn_factory(mesh) -> train step`` (a step object with
    ``init_state``, ``opt_from_params`` and the checkpoint layout's
    ``save``/``restore``, ``gradsync.snapshot``; ``gradsync.make_step_factory``
    builds one), or ``(model_cfg, tcfg)``: then the factory is built from
    the ``GRAD_SYNC`` registry on ``device`` and a resize migrates the
    state in place through the strategy's resize hook.  With an opaque
    factory every resize restores the latest checkpoint instead
    (``restores`` counts them).  ``mesh`` is the tuple of replica ids of
    stacked rows, or a world's ``("data",)`` or ``("data", "model")``
    ``DeviceMesh`` over the initial ranks (a world takes ``(model_cfg,
    tcfg)``).

    ``pipe_factory(mesh)`` builds the data pipeline (in a world, the
    rank's); its state is the step, so the stream goes on where it stopped
    at any extent.  Each resize's wall time and its parts are kept in
    :attr:`resize_times`: ``mesh_s`` (the new mesh and, in a world, its
    communicators), ``build_s`` (the step and pipeline rebuilt, a
    joiner's fresh state), ``migrate_s`` (the hook) and ``broadcast_s``
    (the joiners' transfer)."""

    def __init__(self, mesh, step_fn_factory, pipe_factory: Callable, checkpointer=None,
                 cfg: Optional[ElasticConfig] = None, clock: Optional[StepClock] = None, *,
                 device="cuda"):
        from repro_torch.device import resolve_device
        from repro_torch.distributed import gradsync
        from repro_torch.distributed.gradsync import common

        cfg = cfg or ElasticConfig()
        self.device = resolve_device(device)
        self.world = common.is_world(mesh)
        self.train_cfgs = None
        if isinstance(step_fn_factory, tuple):
            self.train_cfgs = step_fn_factory
            step_fn_factory = gradsync.make_step_factory(*self.train_cfgs, device=self.device)
        if self.world and self.train_cfgs is None:
            raise ValueError("an elastic world migrates in place: pass (model_cfg, tcfg)")
        self.mesh = mesh
        self.step_fn_factory = step_fn_factory
        self.pipe_factory = pipe_factory
        self.ck = checkpointer
        self.cfg = cfg
        self.policy = get_policy(cfg.policy)
        self.clock = clock or StepClock(dt=cfg.step_dt)
        self.resizes: list[ResizeEvent] = []
        self.resize_times: list[dict] = []
        self.restores = 0  # checkpoint restores a resize needed
        self.step = 0  # the global step, kept on every process of a world
        self.health: dict[int, str] = {}  # worker id -> 'ok' | 'dead' | 'stalled'
        self.stall_factor: dict[int, float] = {}
        self.pending_joins: list[int] = []
        self.detector = None
        self._build()

    # -- wiring ---------------------------------------------------------------

    @property
    def restarts(self) -> int:
        """The resize count (the reference's older name)."""
        return len(self.resizes)

    def device_ids(self) -> tuple:
        """The mesh's worker ids, row-major (the reference's order)."""
        return mesh_ids(self.mesh)

    def dp(self) -> int:
        from repro_torch.distributed.gradsync import common

        return common.mesh_dp(self.mesh)

    def member(self) -> bool:
        """Does this process hold a rank of the current mesh (always, on
        stacked rows)?"""
        from repro_torch.distributed.gradsync import common

        return not self.world or common.mesh_rank(self.mesh) is not None

    def tp(self) -> int:
        """The mesh's ``"model"`` extent (1 on stacked rows and in a
        ``("data",)`` world)."""
        from repro_torch.distributed.gradsync.snapshot import mesh_tp

        return mesh_tp(self.mesh)

    def _mode(self) -> Optional[str]:
        return None if self.train_cfgs is None else self.train_cfgs[1].grad_sync

    def _build(self):
        member = self.member()
        self.train_step = self.step_fn_factory(self.mesh) if member else None
        self.pipe = self.pipe_factory(self.mesh) if member else None
        now = self.clock.now()
        ids = set(self.device_ids())
        if self.detector is None:
            self.detector = FailureDetector(list(self.device_ids()), self.cfg.heartbeat, now=now)
        else:
            # heartbeat history survives a resize: a partitioned worker's
            # stale evidence and a straggler's strikes must not restart
            # with every unrelated topology change
            for w in list(self.detector.last):
                if w not in ids:
                    self.detector.remove_worker(w)
            for w in ids:
                self.detector.add_worker(w, now)
        for d in self.device_ids():
            self.health.setdefault(d, "ok")

    def init_or_restore(self, generator: torch.Generator):
        """A fresh state from ``generator``, or with a checkpoint its latest
        step onto the current mesh in the train step's layout
        (``train_step.restore``, ``gradsync.snapshot``): at the saved
        ``"data"`` extent and strategy the whole state (params, optimizer,
        monitor, step) and the data cursor; at another extent the params,
        the step and the data cursor, with the optimizer restarted from the
        restored params: fp32 masters of them, zero moments and EF
        residuals.  (The reference keeps the fresh init's masters there,
        so its ZeRO-1 and tree optimizers write the fresh params back at
        the first step.)  A checkpoint of another ``tp`` is refused.  None
        on a world process outside the mesh."""
        self.step = 0
        if not self.member():
            return None
        state = self.train_step.init_state(generator)
        latest = None if self.ck is None else self.ck.latest_step()
        if latest is None:
            return state
        extra = self.ck.manifest(latest)["extra"]
        saved_tp = extra.get("tp", 1)
        if saved_tp != self.tp():
            raise ValueError(f"checkpoint step {latest} was saved at tp={saved_tp}, this run has "
                             f"tp={self.tp()}: {RESIZE_HINT}")
        if (self.train_cfgs is not None and extra.get("dp") == self.dp()
                and extra.get("grad_sync") == self._mode()):
            state, report = self.train_step.restore(self.ck, state)
        else:
            params, report = self.train_step.restore(self.ck, state, params_only=True)
            state["params"] = params
            state["step"] = report.restored_step
            state["opt"] = self.train_step.opt_from_params(params)
        self.pipe.load_state_dict(extra["data"])
        self.step = report.restored_step
        return state

    # -- what a chaos script pokes --------------------------------------------

    def kill(self, device_id: int, *, silent: bool = False):
        """Mark a worker dead.  ``silent`` models a network partition
        (detected when the heartbeat timeout elapses on the injected clock);
        the default a fail-stop crash report (detected at the next policy
        pass)."""
        self.health[device_id] = "dead"
        if not silent:
            self.detector.mark_dead(device_id)

    def stall(self, device_id: int, factor: float = 10.0):
        """Mark a worker a straggler: it keeps heartbeating with ``factor``
        x the healthy step time."""
        self.health[device_id] = "stalled"
        self.stall_factor[device_id] = factor

    def unstall(self, device_id: int):
        if self.health.get(device_id) == "stalled":
            self.health[device_id] = "ok"
        self.stall_factor.pop(device_id, None)

    def join(self, device_ids: Sequence[int]):
        """Queue workers for admission (a growing policy admits them at its
        next decision)."""
        for d in device_ids:
            if d not in self.pending_joins:
                self.pending_joins.append(d)
                self.health[d] = "ok"

    def _heartbeat_all(self, now: float):
        for d in self.device_ids():
            status = self.health.get(d, "ok")
            if status == "dead":
                continue
            step_time = self.cfg.base_step_time * (
                self.stall_factor.get(d, 1.0) if status == "stalled" else 1.0)
            self.detector.heartbeat(d, now=now, step_time=step_time)

    # -- the ResizeEvent lifecycle --------------------------------------------

    def _clamp_grow(self, decision: ResizeDecision) -> ResizeDecision:
        """Admit only whole DP slices: ``tp`` workers a slice (one on stacked
        rows and in a ``("data",)`` world).  A joiner set short of a slice
        stays pending (admitting it would make ``grow_mesh`` raise); the
        rest is admitted once enough joiners have come."""
        per_slice = len(self.device_ids()) // self.dp()
        n = (len(decision.admit) // per_slice) * per_slice
        if n == 0:
            return ResizeDecision()
        if n < len(decision.admit):
            return dataclasses.replace(decision, admit=decision.admit[:n])
        return decision

    def resize(self, state, decision: ResizeDecision):
        """Execute a policy decision: rebuild the mesh, carry the state over
        in place (or restore a checkpoint where no hook applies), rebuild
        the step and the pipeline, record the :class:`ResizeEvent`."""
        t0 = time.perf_counter()
        times: dict = {"build_s": 0.0, "migrate_s": 0.0, "broadcast_s": 0.0}
        state = self._resize_impl(state, decision, times)
        _sync(self.device)
        ev = self.resizes[-1]
        self.resize_times.append({"step": ev.step, "kind": ev.kind, "old_dp": ev.old_dp,
                                  "new_dp": ev.new_dp, **times,
                                  "wall_s": time.perf_counter() - t0})
        return state

    def _resize_impl(self, state, decision: ResizeDecision, times: dict):
        from repro_torch.collectives import plans

        if len(self.resizes) >= self.cfg.max_restarts:
            raise RuntimeError("resize budget exhausted")
        axis = self.cfg.dp_axis
        old_mesh, old_dp, step = self.mesh, self.dp(), self.step
        t = time.perf_counter()
        if decision.action == "shrink":
            new_mesh, kept = shrink_mesh(old_mesh, set(decision.remove), axis)
            keep = flat_keep_for_shrink({axis: old_dp}, (axis,), axis, kept)
            for d in decision.remove:
                self.detector.remove_worker(d)
                self.health[d] = "dead"
        elif decision.action == "grow":
            new_mesh, n_new = grow_mesh(old_mesh, tuple(decision.admit), axis)
            keep = flat_keep_for_grow({axis: old_dp}, (axis,), axis, n_new)
            self.pending_joins = [d for d in self.pending_joins if d not in set(decision.admit)]
        else:
            raise ValueError(f"resize cannot execute action {decision.action!r}")
        times["mesh_s"] = time.perf_counter() - t
        # the old extent's memoized stage tables and backends go
        plans.invalidate_all_plans()

        restored = False
        if self.train_cfgs is not None:
            state = self._migrate(state, old_mesh, new_mesh, keep, times)
            if decision.action == "grow" and self.member():
                t = time.perf_counter()
                state = self._send_to_joiners(state, keep)
                _sync(self.device)
                times["broadcast_s"] = time.perf_counter() - t
        else:
            # an opaque step factory: the checkpoint round trip
            if self.ck is None:
                raise RuntimeError("cannot resize: no (model_cfg, tcfg) for in-place migration "
                                   "and no checkpointer to restore from")
            self.ck.wait()
            self.mesh = new_mesh
            self._build()
            state = self.init_or_restore(torch.Generator(device=self.device).manual_seed(0))
            self.restores += 1
            restored = True
        self.resizes.append(ResizeEvent(
            kind=decision.action, step=step, old_dp=old_dp, new_dp=self.dp(), keep=tuple(keep),
            device_ids=self.device_ids(), reason=decision.reason,
            restored_from_checkpoint=restored))
        return state

    def _migrate(self, state, old_mesh, new_mesh, keep, times: dict):
        """The state on the new mesh through ``gradsync.migrate_state``, and
        the step and pipeline rebuilt (``times``' ``build_s`` and
        ``migrate_s``, the hook's).  In a world the process of a joiner
        starts from a fresh state of the new extent (a rank that was
        removed before drops what it held), a process of the union of the
        old and new ranks runs the hook, and one outside it holds None."""
        from repro_torch.distributed import gradsync
        from repro_torch.distributed.gradsync import common

        cfg, tcfg = self.train_cfgs
        pipe_state = self.pipe.state_dict() if self.pipe is not None else None
        rank = common.mesh_rank(new_mesh) if self.world else 0
        in_old = not self.world or common.mesh_rank(old_mesh) is not None
        t = time.perf_counter()
        self.mesh = new_mesh
        self._build()
        if self.world and rank is not None and keep[rank] is None:  # a joiner: a fresh state
            state = self.train_step.init_state(torch.Generator(device=self.device).manual_seed(0))
        _sync(self.device)
        times["build_s"] = time.perf_counter() - t
        if not in_old and rank is None:
            return None
        t = time.perf_counter()
        state = gradsync.migrate_state(cfg, tcfg, old_mesh, new_mesh, state, keep)
        _sync(self.device)
        times["migrate_s"] = time.perf_counter() - t
        if rank is not None and keep[rank] is not None:
            self.pipe.load_state_dict(pipe_state)
        return state

    def _send_to_joiners(self, state, keep):
        """The grow's parameter transfer, from new rank 0 at the new extent:
        on stacked rows ``mrd_broadcast_stacked`` into the params (under
        ``local_sgd`` into each joiner's replica row of params and
        optimizer, which the hook filled from the first survivor); in a
        world :func:`mrd_broadcast` over each model rank's ``"data"``
        column (its own TP blocks) of the params (every rank's but under
        ``local_sgd`` only the joiners'; none under ``gspmd``, whose hook
        re-sharded them over the union), of the replicated optimizer trees
        of ``mrd_leaf`` and ``local_sgd`` (the joiners'), and of the step
        and the data cursor.  All in place."""
        from repro_torch.distributed import serve as dserve
        from repro_torch.distributed.gradsync import common

        mode = self.train_cfgs[1].grad_sync
        replica = mode == "local_sgd"
        dp = self.dp()
        if not self.world:
            if replica:
                for j, k in enumerate(keep):
                    if k is None:
                        dserve.mrd_broadcast_stacked({"params": _rows_of(state["params"], j),
                                                      "opt": _rows_of(state["opt"], j)},
                                                     dp, src=0, dst=j)
            else:
                dserve.mrd_broadcast_stacked(state["params"], dp, src=0)
            return state
        joiner = keep[common.mesh_rank(self.mesh)] is None
        if mode != "gspmd":
            mrd_broadcast(state["params"], self.mesh, src=0, receive=joiner or not replica)
        if mode in ("local_sgd", "mrd_leaf"):
            mrd_broadcast(state["opt"], self.mesh, src=0, receive=joiner)
        host = mrd_broadcast({"step": state["step"], "data": self.pipe.state_dict()},
                             self.mesh, src=0, receive=joiner)
        if joiner:
            state["step"] = host["step"]
            self.pipe.load_state_dict(host["data"])
        return state

    # -- the training loop ----------------------------------------------------

    def handle_failure(self, state, failed_device_ids: set):
        """An immediate shrink (the reference's older API): the named
        workers are gone."""
        for d in failed_device_ids:
            self.kill(d)
        return self.resize(state, ResizeDecision("shrink", remove=frozenset(failed_device_ids),
                                                 reason="handle_failure"))

    def _save(self, state, block) -> None:
        """Snapshot the state (a world's members each their part), the data
        cursor and the extent, in the train step's layout
        (``gradsync.snapshot``)."""
        extra = {"data": self.pipe.state_dict(), "dp": self.dp(), "tp": self.tp(),
                 "grad_sync": self._mode()}
        self.train_step.save(self.ck, self.step, state, extra, block=block)

    def run(self, state, n_steps: int, *, fail_at: Optional[dict] = None, events=None):
        """Train ``n_steps`` steps; returns ``(state, losses)``.  Before
        each step, in the reference's order: ``fail_at`` ({step: {ids}})
        kills, the chaos script's ``events.apply(trainer, step)``, the
        heartbeats on the injected clock, the policy's decision, the resize.
        With a checkpointer it saves every ``ckpt_every`` steps and once,
        blocking, at the end.  In a world a process outside the mesh skips
        the step, and its save, and records None for its loss."""
        losses: list = []
        i = self.step
        target = i + n_steps
        while i < target:
            now = self.clock.advance()
            if fail_at and i in fail_at:
                for d in fail_at.pop(i):
                    self.kill(d)
            if events is not None:
                events.apply(self, i)
            self._heartbeat_all(now)
            decision = self.policy.decide(self.detector, now, self.pending_joins,
                                          frozenset(self.device_ids()))
            if decision.action == "abort":
                raise RuntimeError(f"elastic policy abort: {decision.reason}")
            if decision.action == "grow":
                decision = self._clamp_grow(decision)
            if decision.action in ("shrink", "grow"):
                state = self.resize(state, decision)
                i = self.step
                if i >= target:
                    break
            if self.member():
                state, metrics = self.train_step(state, self.pipe.next_batch())
                losses.append(float(metrics["loss"]))
            else:
                losses.append(None)
            i += 1
            self.step = i
            if self.ck is not None and self.member() and i % self.cfg.ckpt_every == 0:
                self._save(state, block=False)
        if self.ck is not None and self.member():
            self._save(state, block=True)
        return state, losses
