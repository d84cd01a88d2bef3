"""The asynchronous-iteration engine (port of ``repro.asynchrony.engine``):
solver x delay model x detection protocol (paper S1 + S3).

``p`` virtual workers each own one block of the iterate.  Per global tick:

1. the delay model emits ``(active, delays)`` under the paper's two
   fairness conditions (``repro_torch.asynchrony.delay_models``);
2. each active worker applies its block map to a *stale view* of the
   global vector, assembled from a ring buffer of the last ``max_delay +
   2`` iterates with per-(i, j) delays bounded by ``max_delay``;
3. the detection protocol advances one tick
   (``repro_torch.asynchrony.protocols``): the non-blocking MRD allreduce
   advances exactly one stage a tick, so communication progresses while
   the workers compute.

Every run is a batch of independent *lanes* (:func:`sweep`'s seeds and
delay-parameter grid; :func:`run` is one lane through the same code).
Every carry leaf is ``[B, ...]``, and a lane freezes once its own
condition clears (detected, or ``max_ticks`` reached): each tick's update
is kept only where the lane still runs.  The host asks whether any lane
runs once every :data:`CHECK_EVERY` ticks (on the card each ask is a
synchronisation); the extra ticks of a frozen lane change nothing, so the
results do not depend on :data:`CHECK_EVERY`.

Randomness is an input: the delay models and the snapshot's marker delays
draw from one source (``repro_torch.asynchrony.draws``), by default the
counter-based one, whose draws are the same on the CPU and the card and
independent of the batch a lane runs in.

Message accounting follows the paper: point-to-point ``Send(x_i)`` to all
dependent neighbors (all-to-all) plus per-stage collective messages from
the schedule, billed by the protocol.  The reference's telemetry spans and
counters are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.asynchrony.delay_models import get_delay_model
from repro_torch.asynchrony.draws import CounterSource, Draw
from repro_torch.asynchrony.protocols import RES_INIT, Obs, get_protocol, where_lanes
from repro_torch.asynchrony.solvers import FixedPoint
from repro_torch.collectives import schedules
from repro_torch.device import resolve_device

CHECK_EVERY = 16  # ticks between the host's checks for a running lane


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    p: int
    max_delay: int = 3
    activity: float = 0.7
    force_every: int = 5
    # any name in repro_torch.asynchrony.DETECTION_PROTOCOLS
    detection: str = "exact"
    # any name in repro_torch.asynchrony.DELAY_MODELS
    delay_model: str = "bernoulli"
    eps: float = 1e-6
    max_ticks: int = 20000
    seed: int = 0
    window: int = 0  # 'interval' protocol: 0 -> max_delay + 2


@dataclasses.dataclass
class AsyncResult:
    detected: bool
    ticks: int  # tick at which the loop stopped (detection or budget)
    res_glb: float  # detector's certified value at detection
    true_res: float  # ground-truth ||f(.)-.||_inf of the returned solution
    kiter: np.ndarray  # per-worker local iteration counts
    messages_p2p: int
    messages_coll: int
    x: np.ndarray  # returned solution (x̄ for 'exact', current x otherwise)

    @property
    def det_tick(self) -> int:
        """Deprecated alias of ``ticks`` (they were always equal)."""
        return self.ticks


@dataclasses.dataclass
class SweepResult:
    """Stacked :class:`AsyncResult` fields: leading axes ``[S]`` (seeds) or
    ``[G, S]`` (delay-parameter grid x seeds)."""

    detected: np.ndarray
    ticks: np.ndarray
    res_glb: np.ndarray
    true_res: np.ndarray
    kiter: np.ndarray
    messages_p2p: np.ndarray
    messages_coll: np.ndarray
    x: np.ndarray


def resolve_delay_params(fp: FixedPoint, cfg: AsyncConfig, delay_params=None):
    """The delay-model parameters a run will use (the model's defaults
    unless given)."""
    if delay_params is None:
        return get_delay_model(cfg.delay_model).default_params(cfg, cfg.p)
    return delay_params


def _tick(c: dict, fp: FixedPoint, cfg: AsyncConfig, model, proto, source, msg_table) -> dict:
    """One engine tick for every lane; a lane that no longer runs keeps its
    carry unchanged."""
    p, tick = cfg.p, c["tick"]
    lanes, _, m = c["x"].shape
    H = c["hist"].shape[1]
    running = ~c["det"]["detected"] & (tick < cfg.max_ticks)

    draw = Draw(source, c["seed"], tick)
    if proto.synchronous:
        active = torch.ones((lanes, p), dtype=torch.bool, device=tick.device)
        delays = torch.zeros((lanes, p, p), dtype=torch.int32, device=tick.device)
        dm = c["dm"]
    else:
        active, delays, dm = model.sample(c["params"], c["dm"], tick, draw, c["last_active"],
                                          p=p, max_delay=cfg.max_delay,
                                          force_every=cfg.force_every)

    # stale views: worker i sees block j from delays[b, i, j] ticks ago (its
    # own block is always current)
    lane = torch.arange(lanes, device=tick.device)
    ranks = torch.arange(p, device=tick.device)
    slot = (tick[:, None, None] - 1 - delays).remainder(H).long()  # [B, p, p]
    views = c["hist"][lane[:, None, None], slot, ranks[None, None, :]]  # [B, p, p, m]
    views[:, ranks, ranks] = c["x"]
    xnew = fp.block_views_update(views.reshape(lanes, p, p * m))

    x = torch.where(active[:, :, None], xnew, c["x"])
    update_mag = torch.where(active, (x - c["x"]).abs().amax(dim=-1), c["update_mag"])
    det, coll_msgs = proto.tick(c["det"], Obs(
        x=x, update_mag=update_mag, tick=tick, draw=draw, fp=fp, eps=cfg.eps,
        max_delay=cfg.max_delay, msg_table=msg_table,
        coll_cycle_msgs=schedules.paper_message_count(p)))
    new = {
        "tick": tick + 1,
        "x": x,
        "update_mag": update_mag,
        "kiter": c["kiter"] + active.int(),
        "last_active": torch.where(active, tick[:, None], c["last_active"]),
        "dm": dm,
        "det": det,
        "messages_p2p": c["messages_p2p"] + active.int().sum(dim=-1, dtype=torch.int32) * (p - 1),
        "messages_coll": c["messages_coll"] + coll_msgs,
    }
    # the ring buffer is written in place, one slot a running lane
    write = tick.long().remainder(H)
    c["hist"][lane, write] = torch.where(running[:, None, None], x, c["hist"][lane, write])
    frozen = {k: c[k] for k in new}
    return {**c, **where_lanes(running, new, frozen)}


def _lane_params(params, grid: int, seeds: int, device) -> dict:
    """Each lane's copy of the delay parameters, ``[G * S, ...]`` (lanes
    grid-major); ``grid == 0`` means the parameters have no grid axis."""
    out = {}
    for k, v in params.items():
        v = torch.as_tensor(v).to(device)
        v = v[None] if grid == 0 else v
        out[k] = v.repeat_interleave(seeds, dim=0)
    return out


def _drive(fp: FixedPoint, cfg: AsyncConfig, seeds, params, grid: int, source, device):
    """Run every lane until none runs; returns the final carry, the
    finalized solutions and their true residuals."""
    p = cfg.p
    if fp.n % p:
        raise ValueError(f"n={fp.n} must be divisible by p={p}")
    m = fp.n // p
    model = get_delay_model(cfg.delay_model)
    proto = get_protocol(cfg.detection)
    fp = fp.to(device)
    seed = torch.as_tensor(np.asarray(seeds, np.int64), device=device).repeat(max(grid, 1))
    lanes = seed.shape[0]
    msg_table = torch.tensor(schedules.stage_message_table(p), dtype=torch.int32, device=device)
    zeros = torch.zeros(lanes, dtype=torch.int32, device=device)
    x0 = torch.zeros((lanes, p, m), dtype=torch.float32, device=device)
    c = {
        "tick": zeros + 1,
        "seed": seed,
        "params": _lane_params(params, grid, len(seeds), device),
        "x": x0,
        "hist": x0[:, None].repeat(1, cfg.max_delay + 2, 1, 1),  # [B, H, p, m]
        "update_mag": torch.full((lanes, p), RES_INIT, dtype=torch.float32, device=device),
        "kiter": torch.zeros((lanes, p), dtype=torch.int32, device=device),
        "last_active": torch.zeros((lanes, p), dtype=torch.int32, device=device),
        "dm": model.init_state(p, lanes, device),
        "det": proto.init(p, m, cfg, lanes, device),
        "messages_p2p": zeros.clone(),
        "messages_coll": zeros.clone(),
    }
    while bool((~c["det"]["detected"] & (c["tick"] < cfg.max_ticks)).any()):
        for _ in range(CHECK_EVERY):
            c = _tick(c, fp, cfg, model, proto, source, msg_table)
    xs = proto.finalize(c["det"], c["x"])
    return c, xs, fp.residual_norm(xs)


def sweep(fp: FixedPoint, cfg: AsyncConfig, seeds, *, delay_params=None, source=None,
          device="cuda") -> SweepResult:
    """A batch of solves, one lane each, stepped together.

    ``seeds``: ``[S]`` ints.  ``delay_params``: optional dict whose tensors
    carry a leading grid axis ``[G, ...]`` (the stacked parameters of
    ``cfg.delay_model``); then the result axes are ``[G, S]``.  Each lane's
    results equal a :func:`run` with its seed and parameters, bit for bit.
    ``source`` is the draw source (default: counter-based)."""
    dev = resolve_device(device)
    seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
    if delay_params is None:
        params, grid = resolve_delay_params(fp, cfg), 0
    else:
        params = delay_params
        grid = int(torch.as_tensor(next(iter(params.values()))).shape[0])
    c, xs, true_res = _drive(fp, cfg, seeds, params, grid, source or CounterSource(), dev)
    shape = (grid, len(seeds)) if grid else (len(seeds),)

    def out(t):
        t = t.cpu().numpy()
        return t.reshape(shape + t.shape[1:])

    return SweepResult(
        detected=out(c["det"]["detected"]),
        ticks=out(c["tick"] - 1),
        res_glb=out(c["det"]["res_norm"]),
        true_res=out(true_res),
        kiter=out(c["kiter"]),
        messages_p2p=out(c["messages_p2p"]),
        messages_coll=out(c["messages_coll"]),
        x=out(xs),
    )


def run(fp: FixedPoint, cfg: AsyncConfig, *, delay_params=None, source=None,
        device="cuda") -> AsyncResult:
    """One asynchronous solve under ``cfg``: :func:`sweep` with one seed
    and a grid of one point."""
    params = resolve_delay_params(fp, cfg, delay_params)
    r = sweep(fp, cfg, [cfg.seed], delay_params={k: torch.as_tensor(v)[None]
                                                 for k, v in params.items()},
              source=source, device=device)
    return AsyncResult(
        detected=bool(r.detected[0, 0]),
        ticks=int(r.ticks[0, 0]),
        res_glb=float(r.res_glb[0, 0]),
        true_res=float(r.true_res[0, 0]),
        kiter=r.kiter[0, 0],
        messages_p2p=int(r.messages_p2p[0, 0]),
        messages_coll=int(r.messages_coll[0, 0]),
        x=r.x[0, 0],
    )


def record_detection_delay(protocol: str, ticks, oracle_ticks) -> float:
    """Mean detection delay against the ``oracle`` on the same scenario
    (the reference feeds it to a telemetry gauge, not ported yet)."""
    return float(np.mean(np.asarray(ticks) - np.asarray(oracle_ticks)))
