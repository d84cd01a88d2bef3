"""Detection protocols (port of ``repro.asynchrony.protocols``,
``DETECTION_PROTOCOLS``): the asynchronous engine's half and the training
loop's :class:`ConvergenceMonitor`.

**The engine's half.**  A protocol is an ``init / tick / finalize`` object
over the non-blocking MRD max-plan, run for ``B`` independent lanes at
once (a sweep's seeds and grid points; a single run is one lane):

- ``init(p, m, cfg, lanes, device)``: the protocol's state, every leaf
  ``[B, ...]``; it always holds ``res_norm`` (the certified value, latched
  at :data:`RES_INIT`) and ``detected``;
- ``tick(state, obs)``: advance one engine tick; returns ``(state,
  coll_msgs [B])``, this tick's collective messages (paper S2);
- ``finalize(state, x)``: the solution the protocol certifies (``x̄`` for
  the snapshot-exact protocol, the live iterate otherwise).

Registered: ``inexact`` (paper Alg. 1), ``exact`` (Alg. 2, Chandy-Lamport
snapshot), ``interval`` (Alg. 1 over a sliding window of update
magnitudes), ``oracle`` (the true residual, physically unrealizable) and
``sync`` (synchronous iteration and a blocking allreduce; the engine reads
``synchronous`` and pins full activity and zero delays).  Where a lane's
stage or phase decides what happens (the reference's ``lax.switch`` and
``lax.cond`` under ``vmap``), every branch is computed for every lane and
each lane keeps its own with :func:`where_lanes`.

**The training loop's half.**  ``inexact``, ``exact`` and ``interval``
also define ``monitor_init(metric0 [p])`` and
``monitor_contribution(mstate, metric [p], step_idx, cycle_length)``:
what each data-parallel rank (a row of a stacked ``[dp]`` tensor)
contributes a step.  The contributions are max-reduced through the same
plan, one stage a step; the run is certified converged once a published
value falls below the threshold.  The policies take any leading
dimensions (``metric [...]``): serving's residual terminations run them
over ``[dp, slots]``.

**Elastic resize.**  Each protocol's ``migrate(state, keep, new_p, m,
cfg)`` carries the engine's state to a new worker count along a keep map
(``keep[i]``: the old worker now at new rank ``i``, None for a joiner):
what was certified (``res_norm``, ``detected``) and the survivors'
per-worker latches and windows follow their workers, a joiner starts at
:data:`RES_INIT`, and the staged reduction restarts at stage 0.
:meth:`ConvergenceMonitor.migrate_rows` does the same for the training
loop's monitor rows.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.collectives import plans
from repro_torch.core import snapshot

# Finite 'infinity' for residual latches.
RES_INIT = 1e30


@dataclasses.dataclass(frozen=True)
class Obs:
    """One engine tick as seen by a protocol, for ``B`` lanes."""

    x: Any  # [B, p, m] current blocks
    update_mag: Any  # [B, p] last local update magnitude per worker
    tick: Any  # [B] int32
    draw: Any  # this tick's draws (repro_torch.asynchrony.draws.Draw): marker delays
    fp: Any  # the FixedPoint being solved
    eps: float
    max_delay: int
    msg_table: Any  # [S] int32: messages sent at MRD stage s
    coll_cycle_msgs: int  # messages of one full blocking cycle


def where_lanes(mask, new, old):
    """Each lane's leaves from ``new`` where ``mask [B]`` holds, else from
    ``old``: dicts of ``[B, ...]`` tensors.  A leaf that is the same tensor
    on both sides is kept as it is."""
    if isinstance(new, dict):
        return {k: where_lanes(mask, new[k], old[k]) for k in new}
    if new is old:
        return new
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


@functools.lru_cache(maxsize=64)
def _sim_plan(p: int) -> plans.CollectivePlan:
    return plans.allreduce_plan(schedule="mrd", p=p, op="max")


def _take_ranks(arr, keep, fill, axis: int = -1):
    """The worker entries of ``arr`` along ``axis`` after a resize:
    ``keep[i]`` is the old rank now at new rank ``i`` (None: a joiner,
    which gets ``fill``).  Any rank axis: ``res_loc [B, p]``, ``win [B,
    W, p]``, stacked monitor rows ``[dp, ...]`` (``axis=0``)."""
    parts = [torch.full_like(arr.select(axis, 0), fill) if k is None else arr.select(axis, int(k))
             for k in keep]
    return torch.stack(parts, dim=axis)


def _stage_msgs(msg_table, stage):
    return msg_table[stage.clamp(max=msg_table.shape[0] - 1).long()]


def _latch(lanes: int, p: int, device) -> torch.Tensor:
    return torch.full((lanes, p), RES_INIT, dtype=torch.float32, device=device)


def _certify(lanes: int, device) -> dict:
    return {"res_norm": torch.full((lanes,), RES_INIT, dtype=torch.float32, device=device),
            "detected": torch.zeros(lanes, dtype=torch.bool, device=device)}


def _reduce_tick(st):
    """One stage of the staged max-reduction of ``st["res_loc"]``: the new
    ``nb``, ``res_norm`` and ``flag`` (True where a cycle completed)."""
    nb = _sim_plan(st["res_loc"].shape[-1]).step_lanes(st["nb"], st["res_loc"])
    flag = nb["flag"]
    res_norm = torch.where(flag, nb["result"].amax(dim=-1), st["res_norm"])
    return nb, res_norm, flag


DETECTION_PROTOCOLS: Dict[str, Any] = {}


def register_protocol(name: str):
    def deco(cls):
        DETECTION_PROTOCOLS[name] = cls()
        return cls

    return deco


def get_protocol(name: str):
    try:
        return DETECTION_PROTOCOLS[name]
    except KeyError:
        raise ValueError(
            f"unknown detection protocol {name!r}; registered: {sorted(DETECTION_PROTOCOLS)}"
        ) from None


class _ProtocolBase:
    """Default surfaces shared by the registered protocols."""

    synchronous = False

    def finalize(self, state, x):
        """Solution to report at termination (default: the live iterate)."""
        return x.flatten(-2)

    def monitor_init(self, metric0):
        raise ValueError(f"protocol {type(self).__name__} has no training-loop policy")

    # -- elastic resize -------------------------------------------------------

    def migrate(self, state, keep, new_p: int, m: int, cfg):
        """The state after the worker set changes (``keep[i]``: the old
        rank now at new rank ``i``, None for a joiner).  The reduction in
        flight is dropped: its stage and partial combines mean nothing at
        the new extent, whose cycle differs.  What was certified
        (``res_norm``, ``detected``) survives; subclasses carry their
        per-worker state."""
        lanes, device = state["res_norm"].shape[0], state["res_norm"].device
        new = self.init(new_p, m, cfg, lanes, device)
        for k in ("res_norm", "detected"):
            if k in new and k in state:
                new[k] = state[k]
        return new


@register_protocol("inexact")
@dataclasses.dataclass(frozen=True)
class InexactProtocol(_ProtocolBase):
    """Paper Algorithm 1: a non-blocking allreduce of the workers' update
    magnitudes; each cycle re-latches the worker's *current* value, so
    contributions mix local iterations (and, in training, step indices)."""

    name: str = "inexact"

    def init(self, p: int, m: int, cfg, lanes: int, device):
        return {"nb": _sim_plan(p).init_lanes(_latch(lanes, p, device)),
                "res_loc": _latch(lanes, p, device), **_certify(lanes, device)}

    def tick(self, st, obs: Obs):
        msgs = _stage_msgs(obs.msg_table, st["nb"]["stage"])
        nb, res_norm, flag = _reduce_tick(st)
        return {
            "nb": nb,
            "res_loc": torch.where(flag[:, None], obs.update_mag, st["res_loc"]),
            "res_norm": res_norm,
            "detected": st["detected"] | (flag & (res_norm < obs.eps)),
        }, msgs

    def migrate(self, state, keep, new_p, m, cfg):
        new = super().migrate(state, keep, new_p, m, cfg)
        # a survivor re-latches its last contribution at the next cycle's
        # start; a joiner starts at the RES_INIT sentinel
        new["res_loc"] = _take_ranks(state["res_loc"], keep, RES_INIT)
        return new

    def monitor_init(self, metric0):
        return {}

    def monitor_contribution(self, mstate, metric, step_idx, cycle_length):
        return mstate, metric


@register_protocol("exact")
@dataclasses.dataclass(frozen=True)
class ExactProtocol(_ProtocolBase):
    """Paper Algorithm 2: Chandy-Lamport snapshot -> residual on the frozen
    x̄ -> non-blocking allreduce.  Certification is exact for the returned
    x̄; a failed certification starts a new snapshot.  In a training loop
    contributions are latched only at steps with ``step_idx % cycle_length
    == 0``, so every rank reduces the same step's metric (a consistent
    cut)."""

    name: str = "exact"

    def init(self, p: int, m: int, cfg, lanes: int, device):
        return {
            "snap": snapshot.init(p, m, (lanes,), device),
            "nb": _sim_plan(p).init_lanes(_latch(lanes, p, device)),
            "res_loc": _latch(lanes, p, device),
            **_certify(lanes, device),
            "mode": torch.zeros(lanes, dtype=torch.int32, device=device),  # 0 snapshot, 1 reduce
            "xbar": torch.zeros((lanes, p * m), dtype=torch.float32, device=device),
        }

    def _snapshot_phase(self, st, obs: Obs):
        p, m = obs.x.shape[-2:]
        snap = st["snap"]
        d, reply = obs.draw.markers(p, obs.max_delay)
        snap = where_lanes(~snap["in_progress"], snapshot.start(snap, obs.tick, d, reply), snap)
        snap = snapshot.tick(snap, obs.x, obs.tick)
        fin = snapshot.done(snap, obs.tick)
        xbar = snapshot.assembled(snap)
        res_blocks = (obs.fp.full_map(xbar) - xbar).abs().reshape(-1, p, m).amax(dim=-1)
        return {
            **st,
            "snap": {**snap, "in_progress": snap["in_progress"] & ~fin},
            "res_loc": torch.where(fin[:, None], res_blocks, st["res_loc"]),
            "xbar": torch.where(fin[:, None], xbar, st["xbar"]),
            "mode": torch.where(fin, 1, st["mode"]),
        }

    def _reduce_phase(self, st, obs: Obs):
        nb, res_norm, flag = _reduce_tick(st)
        det_now = flag & (res_norm < obs.eps)
        return {
            **st,
            "nb": nb,
            "res_norm": res_norm,
            "detected": st["detected"] | det_now,
            "mode": torch.where(flag & ~det_now, 0, st["mode"]),
        }

    def tick(self, st, obs: Obs):
        p = obs.x.shape[-2]
        in_reduce = st["mode"] == 1
        # snapshot markers + data replies (all-to-all) when a snapshot starts
        started = ~in_reduce & ~st["snap"]["in_progress"]
        msgs = (torch.where(in_reduce, _stage_msgs(obs.msg_table, st["nb"]["stage"]), 0)
                + torch.where(started, 2 * p * (p - 1), 0))
        new = where_lanes(in_reduce, self._reduce_phase(st, obs), self._snapshot_phase(st, obs))
        return new, msgs

    def finalize(self, state, x):
        return state["xbar"]

    def migrate(self, state, keep, new_p, m, cfg):
        new = super().migrate(state, keep, new_p, m, cfg)
        # a snapshot in progress is a cut of the old worker set: it is
        # dropped (a new one starts next tick); the last certified x̄ carries
        # over when the global problem size is unchanged
        if state["xbar"].shape == new["xbar"].shape:
            new["xbar"] = state["xbar"]
        return new

    def monitor_init(self, metric0):
        return {"latched": metric0}

    def monitor_contribution(self, mstate, metric, step_idx, cycle_length):
        latched = metric if step_idx % cycle_length == 0 else mstate["latched"]
        return {"latched": latched}, latched


@register_protocol("interval")
@dataclasses.dataclass(frozen=True)
class IntervalProtocol(_ProtocolBase):
    """Windowed Algorithm 1: each worker contributes the max of its update
    magnitudes over the last ``window`` ticks (default ``max_delay + 2``,
    covering the staleness bound), so certification means the updates
    stayed below eps across a whole window.  Same message cost as
    ``inexact``.  In a training loop each rank contributes the max of its
    last 8 metrics."""

    name: str = "interval"

    def _window(self, cfg) -> int:
        w = getattr(cfg, "window", 0)
        return int(w) if w else int(cfg.max_delay) + 2

    def init(self, p: int, m: int, cfg, lanes: int, device):
        win = torch.full((lanes, self._window(cfg), p), RES_INIT, dtype=torch.float32,
                         device=device)
        return {"nb": _sim_plan(p).init_lanes(_latch(lanes, p, device)), "win": win,
                "res_loc": _latch(lanes, p, device), **_certify(lanes, device)}

    def tick(self, st, obs: Obs):
        W = st["win"].shape[1]
        slot = torch.arange(W, device=obs.tick.device) == (obs.tick % W)[:, None]  # [B, W]
        win = torch.where(slot[:, :, None], obs.update_mag[:, None, :], st["win"])
        msgs = _stage_msgs(obs.msg_table, st["nb"]["stage"])
        nb, res_norm, flag = _reduce_tick(st)
        return {
            "nb": nb,
            "win": win,
            "res_loc": torch.where(flag[:, None], win.amax(dim=1), st["res_loc"]),
            "res_norm": res_norm,
            "detected": st["detected"] | (flag & (res_norm < obs.eps)),
        }, msgs

    def migrate(self, state, keep, new_p, m, cfg):
        new = super().migrate(state, keep, new_p, m, cfg)
        new["res_loc"] = _take_ranks(state["res_loc"], keep, RES_INIT)
        # the window columns follow their workers; a joiner's starts
        # saturated, so it cannot certify before filling a whole window
        new["win"] = _take_ranks(state["win"], keep, RES_INIT)
        return new

    def monitor_init(self, metric0, window: int = 8):
        return {"win": metric0[..., None].expand(*metric0.shape, window).float().clone()}

    def monitor_contribution(self, mstate, metric, step_idx, cycle_length):
        win = mstate["win"].clone()
        win[..., step_idx % win.shape[-1]] = metric
        return {"win": win}, win.amax(dim=-1)


@register_protocol("oracle")
@dataclasses.dataclass(frozen=True)
class OracleProtocol(_ProtocolBase):
    """Ground truth (physically unrealizable): the true residual of the
    *current* global iterate, free of charge.  The baseline every
    realizable protocol's detection delay is measured against."""

    name: str = "oracle"

    def init(self, p: int, m: int, cfg, lanes: int, device):
        return _certify(lanes, device)

    def tick(self, st, obs: Obs):
        res = obs.fp.residual_norm(obs.x.flatten(-2))
        return {"res_norm": res, "detected": res < obs.eps}, torch.zeros_like(obs.tick)


@register_protocol("sync")
@dataclasses.dataclass(frozen=True)
class SyncProtocol(_ProtocolBase):
    """Classic synchronous iteration: full activity, zero delays (the
    engine honors ``synchronous``), a blocking allreduce of the update
    magnitudes every iteration: the paper's Fig. 5 comparison arm."""

    name: str = "sync"
    synchronous = True

    def init(self, p: int, m: int, cfg, lanes: int, device):
        return _certify(lanes, device)

    def tick(self, st, obs: Obs):
        res = obs.update_mag.amax(dim=-1)
        return ({"res_norm": res, "detected": res < obs.eps},
                torch.full_like(obs.tick, obs.coll_cycle_msgs))


@functools.lru_cache(maxsize=64)
def _mesh_plan(axes: tuple, mesh) -> plans.CollectivePlan:
    return plans.allreduce_plan(schedule="mrd", axes=axes, mesh=mesh, op="max")


@dataclasses.dataclass(frozen=True, kw_only=True)
class ConvergenceMonitor:
    """The paper's detection over data-parallel ranks, in one of two forms:

    - ``p``: the ranks are the rows of stacked tensors on one device;
      ``metric``, ``done`` and ``value`` are [p];
    - ``axis_name`` over ``mesh``: one process a rank (the device executor
      over ``torch.distributed``); ``axis_name`` is one named dimension of
      the :class:`~torch.distributed.device_mesh.DeviceMesh` or a tuple of
      them (e.g. a multi-pod ``("pod", "data")`` domain), whose plan chains
      the per-axis MRD schedules into one stage list, so detection over a
      product of axes costs one scalar permute a step like one axis does;
      ``metric``, ``done`` and ``value`` are the rank's scalars.

    ``mode`` names a :data:`DETECTION_PROTOCOLS` policy: ``inexact``
    (each cycle latches the current metric; the certified value lags by
    ``cycle_length`` steps), ``exact`` (latches only at cycle starts, so
    all ranks reduce the same step's metric) or ``interval`` (the max over
    each rank's last 8 metrics).

    ``state, done, value = monitor.step(state, metric, step_idx)``; ``done``
    and ``value`` are equal on every rank once a cycle has completed."""

    p: Optional[int] = None
    axis_name: Any = None  # str or tuple of mesh dimension names
    mesh: Any = None
    threshold: float
    mode: str = "inexact"

    def __post_init__(self):
        if (self.p is None) == (self.axis_name is None):
            raise ValueError("bind exactly one of p= (stacked rows) or axis_name= (a mesh)")
        if self.axis_name is not None and self.mesh is None:
            raise ValueError("axis_name= needs mesh= (the DeviceMesh that names it)")

    def _axes(self) -> tuple[str, ...]:
        if isinstance(self.axis_name, str):
            return (self.axis_name,)
        return tuple(self.axis_name)

    def _plan(self) -> plans.CollectivePlan:
        if self.p is not None:
            return _sim_plan(self.p)
        return _mesh_plan(self._axes(), self.mesh)

    def _protocol(self):
        return get_protocol(self.mode)

    def init(self, *, device) -> dict[str, Any]:
        """Monitor state on ``device``: the staged plan's state and the
        policy state, published value and ``done`` latch of each rank (one
        row a rank in the ``p`` form, the rank's own scalars over a
        mesh)."""
        shape = (self.p,) if self.p is not None else ()
        metric0 = torch.full(shape, RES_INIT, dtype=torch.float32, device=device)
        return {
            "nb": self._plan().init(metric0),
            "m": self._protocol().monitor_init(metric0),
            "value": metric0.clone(),
            "done": torch.zeros(shape, dtype=torch.bool, device=device),
        }

    def migrate_rows(self, rows, keep):
        """The monitor state after a resize, this monitor being the one of
        the new extent.  ``keep[i]`` is the old rank now at new rank ``i``
        (None: a joiner, which gets a fresh row).  The per-rank policy state
        (``m``: the exact mode's latch, the interval window), the published
        ``value`` and the ``done`` latch follow their workers; the staged
        reduction restarts at stage 0, since the cycle at the new extent
        differs and a partial combine would mix extents.  Stacked rows:
        ``rows`` holds every old rank's ``[dp_old]`` rows.  Over a mesh: the
        rank's own old state (a joiner's, a fresh one, is not read)."""
        fresh = self.init(device=rows["done"].device)
        if self.p is None:
            from repro_torch.collectives.executors import axis_ranks

            names, r = self.mesh.mesh_dim_names, 0
            for ax in self._axes():  # the rank, flattened over the monitor's axes
                r = r * self.mesh.size(names.index(ax)) + axis_ranks(self.mesh, ax)[0]
            if keep[r] is None:
                return fresh
            return {**fresh, "m": rows["m"], "value": rows["value"], "done": rows["done"]}

        def sel(old, new):
            if isinstance(old, dict):
                return {k: sel(old[k], new[k]) for k in new}
            return torch.stack([new[i] if k is None else old[k] for i, k in enumerate(keep)])

        return {"nb": fresh["nb"], **{k: sel(rows[k], fresh[k]) for k in ("m", "value", "done")}}

    def step(self, state, local_metric, step_idx: int):
        plan = self._plan()
        mstate, contribution = self._protocol().monitor_contribution(
            state["m"], local_metric.float(), step_idx, plan.cycle_length())
        nb = plan.step(state["nb"], contribution)
        value = nb["result"] if nb["flag"] else state["value"]
        done = state["done"] | (nb["flag"] & (value < self.threshold))
        return {"nb": nb, "m": mstate, "value": value, "done": done}, done, value
