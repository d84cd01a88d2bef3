"""The serving engine (port of ``repro.serving.engine``): a thin
composition of workload x scheduler x termination.

Per engine step (one dispatch):

1. **admit** — the scheduler orders the queue and the first eligible
   requests take the free slots (at most ``max_admit_per_tick``); a
   request whose tenant is at its quota, or that the pool has no blocks
   for, stays queued and the slot goes to the next one.  An LLM admission
   prefills the prompt and yields the request's first token (TTFT stops
   here), a fixed-point one sets the slot's payload;
2. **ticks** — up to ``steps_per_dispatch`` workload ticks, each advancing
   every active slot one token (or one iteration) and the termination
   protocol's staged MRD reduction one stage.  The dispatch ends after the
   first tick that retires or forces a slot, and never runs past the next
   pending arrival, so its length changes no scheduling decision;
3. **retire** — slots certified done by the agreed result retire, free
   their blocks, and their outputs are collected.  A slot frozen at cache
   capacity, or (under a residual termination) a fixed-point request
   whose iteration budget ran out before certification, is force-retired
   with ``converged=False``; one frozen at capacity is requeued instead,
   up to ``max_retries`` times.

The reference runs a dispatch's ticks as one device loop; here they are a
host loop, and the control plane (termination state, per-slot counters)
lives on the host: each tick brings the slots' new tokens, or a
fixed-point pool's ``[dp, S]`` residual, to the host once.

Elastic serving: :meth:`ServeEngine.resize` changes the agreement
extent under live traffic (driven by
:class:`repro_torch.runtime.ElasticServeController`).  No request is lost
and no slot prefills again: the termination state migrates along the keep
map, a fixed-point workload re-blocks its residual report, and on a grow
the joiners receive everything the next tick reads through the MRD
sum-broadcast (:func:`repro_torch.distributed.serve.mrd_broadcast_stacked`).
With ``slots_per_replica`` each replica funds that many slots, so a
resize changes how many slots admit (:attr:`ServeEngine.usable_slots`);
:meth:`ServeEngine.load_snapshot` is the load an autoscaling policy sees.

Metrics: TTFT / TPOT (wall seconds, p50/p95/p99 in :meth:`summary`),
token throughput, slot occupancy, converged requests, tick-domain
admission/retirement ticks, SLA goodput, replica-ticks, capacity retries,
resizes and a per-tenant breakdown.  Telemetry is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.asynchrony.protocols import RES_INIT
from repro_torch.runtime.elastic import ResizeEvent
from repro_torch.runtime.policies import LoadSnapshot
from repro_torch.serving.schedulers import get_scheduler
from repro_torch.serving.termination import TerminationConfig, get_termination, make_signals


@dataclasses.dataclass
class Request:
    """One serving request: a token prompt or a solver payload."""

    id: int
    arrival: int = 0  # tick at which the request enters the queue
    prompt: Any = None  # llm_decode: 1-D int token array
    payload: Any = None  # fixedpoint_solve: affine payload [n] (None = default)
    max_new: int = 32  # generation budget / iteration budget
    eos: int = -1  # llm_decode: EOS token id (-1 = never)
    priority: int = 0  # 'priority' scheduler: higher first
    sla: Optional[int] = None  # TTFT SLA in ticks: deadline = arrival + sla
    eps: Optional[float] = None  # residual terminations: per-request threshold
    tenant: str = ""  # the multi-tenant traffic model (serving/tenants.py)


@dataclasses.dataclass
class RequestResult:
    id: int
    output: np.ndarray  # token ids (trimmed at EOS / budget) or solution vector
    arrival: int
    admit_tick: int
    retire_tick: int
    n_tokens: int  # tokens, or a fixed-point request's iterations
    certified: float  # agreed value at retirement (RES_INIT if forced)
    converged: bool  # False when force-retired (budget or cache capacity)
    ttft_s: float
    tpot_s: float  # NaN for n_tokens <= 1 (no inter-token interval)
    retries: int = 0  # capacity-forced requeues this request went through
    tenant: str = ""
    sla: Optional[int] = None
    sla_met: Optional[bool] = None  # TTFT tick deadline met (None = no SLA)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    scheduler: str = "fcfs"
    termination: str = "eos_maxlen"
    dp: int = 1  # termination-agreement replicas (MRD over [dp])
    eps: float = 1e-6  # residual threshold of requests that carry none
    window: int = 0  # residual_interval: 0 -> one agreement cycle + 1
    max_admit_per_tick: int = 0  # 0 = fill every free slot
    max_ticks: int = 100_000  # engine steps before run() gives up
    # requeues of a request forced at cache capacity before it retires
    # converged=False (0: it retires at once)
    max_retries: int = 0
    # ticks a dispatch runs at most: it ends after the first tick that
    # retires a slot and never runs past the next arrival, so a larger value
    # changes no scheduling decision
    steps_per_dispatch: int = 16
    # {tenant: most slots in flight} (0 or absent: unlimited); a tenant at
    # its quota is passed over and the slot goes to the next request
    quotas: Any = None
    # capacity model: each agreement replica funds this many slots, so only
    # min(slots, dp * slots_per_replica) admit and a resize changes serving
    # capacity (what the autoscaler trades against SLA pressure); None:
    # every slot admits at any extent
    slots_per_replica: Optional[int] = None


class ServeEngine:
    """Continuous-batching serving loop over a workload's pool."""

    def __init__(self, workload, cfg: ServeConfig = ServeConfig()):
        if cfg.termination.startswith("residual") and not workload.residual_capable:
            raise ValueError(
                f"termination {cfg.termination!r} needs a residual-reporting "
                f"workload (got {type(workload).__name__}); use 'eos_maxlen'"
            )
        self.workload = workload
        self.cfg = cfg
        self.slots = workload.slots
        self.dp = cfg.dp  # the live replica extent (resize() changes it)
        # a workload that reports over dp blocks (fixed point) and served at
        # another extent is aligned, as resize() aligns it
        if getattr(workload, "dp", cfg.dp) != cfg.dp:
            workload.migrate_dp(cfg.dp)
        self.scheduler = get_scheduler(cfg.scheduler)
        self.term = get_termination(cfg.termination)
        self.certifying = cfg.termination.startswith("residual")
        self.tcfg = TerminationConfig(dp=self.dp, eps=cfg.eps, window=cfg.window)
        # the control plane is a few bytes per tick: it lives on the host
        self.tstate = self.term.init(self.tcfg, self.slots, device="cpu")

        if cfg.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {cfg.steps_per_dispatch}")
        self.tick = 0
        self.decode_ticks = 0  # ticks that ran a decode step
        self.queue: List[Request] = []
        self.pending: List[Request] = []  # submitted, not yet arrived
        self.slot_req: List[Optional[Request]] = [None] * self.slots
        self.results: Dict[int, RequestResult] = {}
        self.resizes: List[ResizeEvent] = []
        self._active = np.zeros((self.slots,), bool)
        self._admit_tick = np.zeros((self.slots,), np.int64)
        self._new_tokens = np.zeros((self.slots,), np.int64)
        self._max_new = np.ones((self.slots,), np.int64)
        self._eos = np.full((self.slots,), -1, np.int64)
        self._eps = np.full((self.slots,), cfg.eps, np.float32)
        self._t_queue = np.zeros((self.slots,), np.float64)
        self._t_first = np.zeros((self.slots,), np.float64)
        self._t_submit: Dict[int, float] = {}
        self._quotas = dict(cfg.quotas or {})
        self._retries: Dict[int, int] = {}  # request id -> capacity requeues
        self._occupancy_ticks = 0
        self._occupancy_sum = 0.0
        self._forced_at_capacity = 0
        self._retried = 0
        self._replica_ticks = 0  # dp for every tick the clock passed
        self._t_start: Optional[float] = None
        self._t_last = 0.0

    # -- request intake -----------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue ``req`` (it becomes schedulable at ``req.arrival``)."""
        if req.arrival <= self.tick:
            req.arrival = self.tick
            self._t_submit[req.id] = time.perf_counter()
            self.queue.append(req)
        else:
            self.pending.append(req)

    @property
    def usable_slots(self) -> int:
        """Slots the replica extent funds (the capacity model): after a
        shrink the defunded tail slots admit nothing, their requests in
        flight drain, and a grow funds them again."""
        spr = self.cfg.slots_per_replica
        return self.slots if not spr else min(self.slots, self.dp * spr)

    def _free_slots(self) -> List[int]:
        return [s for s in range(self.usable_slots) if self.slot_req[s] is None]

    def load_snapshot(self) -> LoadSnapshot:
        """The tick-domain load an autoscaling policy sees: queue depth, SLA
        pressure (near: a queued request past half its deadline; overdue:
        past it) and the free capacity under ``slots_per_replica``."""
        near = overdue = 0
        for r in self.queue:
            if r.sla is None:
                continue
            waited = self.tick - r.arrival
            if waited > r.sla:
                overdue += 1
            elif 2 * waited >= r.sla:
                near += 1
        return LoadSnapshot(tick=self.tick, queue_depth=len(self.queue), sla_near=near,
                            sla_overdue=overdue, free_slots=len(self._free_slots()),
                            usable_slots=self.usable_slots, dp=self.dp)

    # -- elastic resize -----------------------------------------------------

    def resize(self, new_dp: int, keep, *, reason: str = "") -> Optional[ResizeEvent]:
        """Change the agreement extent under live traffic: no request is
        lost and no slot prefills again.

        ``keep[i]`` is the old replica now at new rank ``i`` (None: a
        joiner).  The termination state migrates (certified latches and
        the survivors' windows kept, the staged reduction restarted at the
        new, typically non-power-of-two, extent), a fixed-point workload
        re-blocks its residual report, and on a grow the joiners receive
        the serving state through :meth:`_broadcast_to_joiners`.  Returns
        the recorded :class:`ResizeEvent`, or None for the identity."""
        keep = tuple(keep)
        if new_dp < 1 or len(keep) != new_dp:
            raise ValueError(f"keep map {keep} does not cover dp={new_dp}")
        old_dp = self.dp
        for k in keep:
            if k is not None and not 0 <= k < old_dp:
                raise ValueError(f"keep entry {k} outside old extent {old_dp}")
        if new_dp == old_dp and keep == tuple(range(old_dp)):
            return None
        kind = "grow" if any(k is None for k in keep) else "shrink"
        mig = getattr(self.workload, "migrate_dp", None)
        if mig is not None:
            mig(new_dp)
        self.dp = new_dp
        self.tcfg = TerminationConfig(dp=new_dp, eps=self.cfg.eps, window=self.cfg.window)
        self.tstate = self.term.migrate(self.tstate, keep, self.tcfg, self.slots)
        if kind == "grow":
            self._broadcast_to_joiners()
        ev = ResizeEvent(kind=kind, step=self.tick, old_dp=old_dp, new_dp=new_dp, keep=keep,
                         device_ids=(), reason=reason)
        self.resizes.append(ev)
        return ev

    def _broadcast_to_joiners(self) -> None:
        """Route everything the next tick reads through the MRD
        sum-broadcast at the new extent and install the newest joiner's
        copy: the params, the workload's state, the termination state, the
        per-slot control arrays and (paged pools) the host's block tables,
        allocator and lengths.  The broadcast is exact (the other ranks
        contribute zeros), so the joiner decodes the tokens the source
        would.  It runs a leaf at a time into each leaf's own storage, so
        no second copy of the params is ever alive."""
        from repro_torch.distributed import serve as dserve

        # the pool's one state tree; a paged pool's host side (its
        # ``"host"`` entry) rides beside the device leaves
        wstate = dict(self.workload.wstate)
        host = {"host": wstate.pop("host")} if "host" in wstate else {}
        tree = {
            "params": getattr(self.workload, "params", {}),
            "wstate": wstate,
            "tstate": self.tstate,
            "ctrl": {"active": self._active, "new_tokens": self._new_tokens,
                     "admit_tick": self._admit_tick, "eos": self._eos,
                     "max_new": self._max_new, "eps": self._eps},
            **host,
        }
        tree = dserve.mrd_broadcast_stacked(tree, self.dp, src=0)
        if hasattr(self.workload, "params"):
            self.workload.params = tree["params"]
        self.workload.wstate = {**tree["wstate"],
                                **({"host": tree["host"]} if "host" in tree else {})}
        self.tstate = tree["tstate"]
        ctrl = tree["ctrl"]
        self._active, self._new_tokens = ctrl["active"], ctrl["new_tokens"]
        self._admit_tick, self._eos = ctrl["admit_tick"], ctrl["eos"]
        self._max_new, self._eps = ctrl["max_new"], ctrl["eps"]

    # -- one step -----------------------------------------------------------

    def _admit(self, now: int) -> None:
        """Fill free slots in scheduler order with the first eligible
        requests: one whose tenant is at its quota, or that the pool cannot
        take yet (out of cache blocks), stays queued and the next one gets
        the slot."""
        free = self._free_slots()
        if self.cfg.max_admit_per_tick:
            free = free[: self.cfg.max_admit_per_tick]
        if not (self.queue and free):
            return
        gate = getattr(self.workload, "can_admit", None)
        inflight: Dict[str, int] = {}
        if self._quotas:
            for r in self.slot_req:
                if r is not None:
                    inflight[r.tenant] = inflight.get(r.tenant, 0) + 1
        for req in self.scheduler.order(list(self.queue), now):
            if not free:
                break
            quota = self._quotas.get(req.tenant, 0)
            if quota and inflight.get(req.tenant, 0) >= quota:
                continue
            if gate is not None and not gate(req):
                continue
            slot = free.pop(0)
            self.queue.remove(req)
            inflight[req.tenant] = inflight.get(req.tenant, 0) + 1
            t0 = time.perf_counter()
            self.workload.admit(req, slot, now)
            self.slot_req[slot] = req
            self._active[slot] = True
            self._admit_tick[slot] = now
            self._new_tokens[slot] = self.workload.prefill_tokens
            self._max_new[slot] = self.workload.clamp_max_new(req)
            self._eos[slot] = req.eos
            self._eps[slot] = self.cfg.eps if req.eps is None else req.eps
            self._t_queue[slot] = self._t_submit.get(req.id, t0)
            self._t_first[slot] = time.perf_counter()

    def _tick(self, now: int):
        """One workload tick + termination tick -> (retire, forced, at_cap)
        masks."""
        act = self._active.copy()
        tokens, residual = self.workload.step(act)
        self.decode_ticks += 1
        self._new_tokens[act] += 1
        self.workload.collect_tick(tokens, act)
        self._occupancy_sum += float(act.sum()) / self.slots
        self._occupancy_ticks += 1
        if residual is None:
            residual = np.zeros((self.dp, self.slots), np.float32)
        sig = make_signals(
            tokens=torch.from_numpy(tokens.astype(np.int64)),
            new_tokens=torch.from_numpy(self._new_tokens.copy()),
            eos=torch.from_numpy(self._eos.copy()),
            max_new=torch.from_numpy(self._max_new.copy()),
            eps=torch.from_numpy(self._eps.copy()),
            active=torch.from_numpy(act),
            admit_tick=torch.from_numpy(self._admit_tick.copy()),
            tick=now,
            residual=torch.from_numpy(residual),
        )
        self.tstate, retire = self.term.tick(self.tstate, sig, self.tcfg)
        retire = retire.numpy()
        spent = self._new_tokens >= self._max_new
        # iteration budget spent before the protocol certified
        forced = act & spent & ~retire if self.certifying else np.zeros_like(retire)
        natural = (tokens == self._eos) | spent
        # a slot frozen at cache capacity but not naturally done can produce
        # no further useful token: force-retire it, counted separately
        cap_fn = getattr(self.workload, "capacity_mask", None)
        at_cap = np.zeros_like(retire)
        if cap_fn is not None:
            at_cap = act & cap_fn() & ~natural & ~retire & ~forced
        return retire, forced | at_cap, at_cap

    def _dispatch_len(self, now: int) -> int:
        """Ticks this dispatch may run: ``steps_per_dispatch``, cut at the
        next pending arrival, and 1 while ``max_admit_per_tick`` holds a
        queued request back from a free slot."""
        klim = self.cfg.steps_per_dispatch
        if self.pending:
            nxt = min(r.arrival for r in self.pending)
            klim = max(1, min(klim, nxt - now))
        if self.cfg.max_admit_per_tick and self.queue and self._free_slots():
            klim = 1
        return klim

    def step(self) -> np.ndarray:
        """Advance one dispatch; returns the retired-slot mask ``[S]``."""
        if self._t_start is None:
            self._t_start = time.perf_counter()
        now = self.tick
        still = []
        for r in self.pending:  # arrivals become schedulable (TTFT clock starts)
            if r.arrival <= now:
                self._t_submit[r.id] = time.perf_counter()
                self.queue.append(r)
            else:
                still.append(r)
        self.pending = still

        self._admit(now)
        if not self._active.any():
            # nothing in flight: fast-forward the clock to the next arrival
            self.tick = min(r.arrival for r in self.pending) if self.pending else now + 1
            self._replica_ticks += (self.tick - now) * self.dp
            self._t_last = time.perf_counter()
            return np.zeros((self.slots,), bool)

        # the dispatch's ticks share one active set: it ends at the first
        # tick that retires or forces a slot
        for k in range(self._dispatch_len(now)):
            retire, forced, at_cap = self._tick(now + k)
            out_mask = retire | forced
            if out_mask.any():
                break
        if out_mask.any():
            self._active[out_mask] = False
            certified = self.tstate["certified"].numpy()
            t_done = time.perf_counter()
            for slot in np.nonzero(out_mask)[0]:
                self._collect(int(slot), now + k, certified, bool(forced[slot]),
                              bool(at_cap[slot]), t_done)
        self.tick = now + k + 1
        self._replica_ticks += (k + 1) * self.dp
        self._t_last = time.perf_counter()
        return out_mask

    def _collect(self, slot, now, certified, was_forced, at_capacity, t_done):
        req = self.slot_req[slot]
        release = getattr(self.workload, "release", None)
        if at_capacity:
            self._forced_at_capacity += 1
            if self._retries.get(req.id, 0) < self.cfg.max_retries:
                # requeued for a fresh admission (and block reservation);
                # its new arrival is the dispatch's first tick, as the
                # reference's (self.tick has not advanced yet)
                self._retries[req.id] = self._retries.get(req.id, 0) + 1
                self._retried += 1
                self.slot_req[slot] = None
                if release is not None:
                    release(slot)
                req.arrival = self.tick
                self.queue.append(req)
                return
        out = self.workload.output(slot)
        n_tok = int(self._new_tokens[slot])
        if req.prompt is not None:  # llm: trim to EOS / budget
            out = out[: min(n_tok, int(self._max_new[slot]))]
            hits = np.nonzero(out == req.eos)[0]
            if req.eos >= 0 and hits.size:
                out = out[: hits[0] + 1]
            n_tok = int(out.shape[0])
        tpot = (t_done - self._t_first[slot]) / (n_tok - 1) if n_tok > 1 else float("nan")
        admit_tick = int(self._admit_tick[slot])
        self.results[req.id] = RequestResult(
            id=req.id, output=out, arrival=req.arrival,
            admit_tick=admit_tick, retire_tick=now, n_tokens=n_tok,
            # the certified latch is written only on protocol retirement: a
            # forced request must not report its slot's previous occupant's
            certified=RES_INIT if was_forced else float(certified[slot]),
            converged=not was_forced,
            ttft_s=self._t_first[slot] - self._t_queue[slot], tpot_s=tpot,
            retries=self._retries.get(req.id, 0), tenant=req.tenant, sla=req.sla,
            sla_met=None if req.sla is None else admit_tick - req.arrival <= req.sla,
        )
        self.slot_req[slot] = None
        if release is not None:
            release(slot)  # paged pools return the slot's blocks

    # -- drive to completion ------------------------------------------------

    def run(self, requests=None, *, max_ticks: Optional[int] = None):
        """Submit ``requests`` and step until everything submitted has
        retired (at most ``max_ticks`` engine steps, default the config's).
        Returns ``results`` (request id -> RequestResult)."""
        for r in requests or []:
            self.submit(r)
        budget = max_ticks or self.cfg.max_ticks
        steps = 0
        while self.queue or self.pending or any(r is not None for r in self.slot_req):
            if steps >= budget:
                raise RuntimeError(
                    f"serve loop did not drain within {budget} engine steps "
                    f"({len(self.queue) + len(self.pending)} queued, "
                    f"{sum(r is not None for r in self.slot_req)} in flight)"
                )
            self.step()
            steps += 1
        return self.results

    # -- metrics ------------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        res = list(self.results.values())
        wall = (self._t_last - self._t_start) if self._t_start else 0.0
        tokens_out = int(sum(r.n_tokens for r in res))
        return {
            "completed": len(res),
            "ticks": self.tick,
            "decode_ticks": self.decode_ticks,
            "wall_s": wall,
            "tokens_out": tokens_out,
            "throughput_tok_s": tokens_out / wall if wall > 0 else 0.0,
            **_latency_percentiles(res),
            "occupancy": (self._occupancy_sum / self._occupancy_ticks
                          if self._occupancy_ticks else 0.0),
            **_sla_fields(res, self.tick, wall),
            "replica_ticks": self._replica_ticks,
            "tenants": _tenant_summaries(res),
            "converged": int(sum(r.converged for r in res)),
            "forced_at_capacity": self._forced_at_capacity,
            "retried": self._retried,
            "resizes": len(self.resizes),
        }


def _pct_ms(seconds: np.ndarray, q: float) -> float:
    """NaN-safe percentile in milliseconds (NaN when nothing to rank)."""
    finite = seconds[np.isfinite(seconds)]
    return float(np.percentile(finite, q) * 1e3) if finite.size else float("nan")


def _latency_percentiles(res) -> Dict[str, float]:
    ttft = np.asarray([r.ttft_s for r in res], np.float64)
    tpot = np.asarray([r.tpot_s for r in res], np.float64)
    out = {}
    for q in (50, 95, 99):
        out[f"ttft_p{q}_ms"] = _pct_ms(ttft, q)
        out[f"tpot_p{q}_ms"] = _pct_ms(tpot, q)
    return out


def _sla_fields(res, ticks: int, wall: float) -> Dict[str, Any]:
    """Goodput under SLA: ``sla_met`` of the ``sla_total`` requests that
    carry a (tick-domain) TTFT deadline; ``goodput_ok`` adds the completed
    requests without one; rates a thousand ticks and a wall second."""
    sla_total = sum(1 for r in res if r.sla is not None)
    sla_met = sum(1 for r in res if r.sla_met)
    goodput_ok = sla_met + (len(res) - sla_total)
    return {
        "sla_total": sla_total,
        "sla_met": sla_met,
        "goodput_ok": goodput_ok,
        "goodput_per_ktick": goodput_ok / ticks * 1000.0 if ticks > 0 else 0.0,
        "goodput_req_s": goodput_ok / wall if wall > 0 else 0.0,
    }


def _tenant_summaries(res) -> Dict[str, Dict[str, Any]]:
    """Per-tenant breakdown (empty when the traffic has no tenants)."""
    by: Dict[str, list] = {}
    for r in res:
        by.setdefault(r.tenant, []).append(r)
    if set(by) <= {""}:
        return {}
    out = {}
    for name in sorted(by):
        rs = by[name]
        ttft_ticks = np.asarray([r.admit_tick - r.arrival for r in rs], np.float64)
        sla_total = sum(1 for r in rs if r.sla is not None)
        sla_met = sum(1 for r in rs if r.sla_met)
        out[name] = {
            "completed": len(rs),
            "tokens_out": int(sum(r.n_tokens for r in rs)),
            "sla_total": sla_total,
            "sla_met": sla_met,
            "goodput_ok": sla_met + (len(rs) - sla_total),
            "ttft_p99_ticks": float(np.percentile(ttft_ticks, 99)),
            **_latency_percentiles(rs),
        }
    return out
