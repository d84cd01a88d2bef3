"""The multi-tenant traffic model (port of ``repro.serving.tenants``;
numpy only, so the port's arrival ticks and request streams equal the
reference's at the same seed).

- :class:`TenantSpec` and :func:`parse_tenant_specs`: the tenant table
  (the CLI's ``--tenants``): a weight in the arrival mix, a workload, a
  TTFT SLA in ticks, a scheduler priority and an admission quota;
- ``ARRIVALS``: seeded arrival-tick generators (``none``, ``poisson``,
  ``bursty``, ``diurnal``, ``trace``).  ``bursty`` opens burst windows as
  the ``bursty`` delay model opens outage windows (``outage_rate`` /
  ``outage_len``); ``trace`` replays a JSON list of recorded ticks;
- :func:`build_requests` and :class:`TenantScenario`: one seeded request
  stream across the tenant mix, each request sampled by the workload its
  tenant targets (``sample_request``), and one engine per workload over
  it, with their summaries merged.

Everything is in ticks and seeded, so goodput under SLA is a function of
(tenants, arrival spec, seed).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import _latency_percentiles, _sla_fields, _tenant_summaries


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One named tenant of the serving deployment."""

    name: str
    weight: float = 1.0  # share of total arrivals (normalized over tenants)
    workload: str = "llm_decode"  # WORKLOADS entry this tenant targets
    sla: Optional[int] = None  # TTFT deadline in ticks (None = batch tier)
    priority: int = 0  # 'priority' scheduler class
    quota: int = 0  # max in-flight slots (0 = unlimited)
    prompt_len: int = 8  # llm: prompts sampled in [1, prompt_len]
    max_new: int = 16  # budget sampled in [max(1, max_new//2), max_new]
    eps: Optional[float] = None  # fixedpoint: per-request threshold


_TENANT_KEYS = {
    "workload": str,
    "sla": int,
    "prio": int,
    "quota": int,
    "prompt": int,
    "gen": int,
    "eps": float,
}
_TENANT_FIELDS = {
    "prio": "priority", "prompt": "prompt_len", "gen": "max_new",
}


def parse_tenant_specs(spec: str) -> tuple:
    """Parse the CLI/bench tenant table.

    ``spec`` is comma-separated ``name:weight[:key=value...]`` entries,
    e.g. ``chat:3:sla=8:prio=2:gen=12,batch:1:quota=4:gen=24``.  Keys:
    ``workload`` ``sla`` ``prio`` ``quota`` ``prompt`` ``gen`` ``eps``.
    """
    tenants = []
    for entry in spec.split(","):
        parts = [p for p in entry.strip().split(":") if p]
        if not parts:
            continue
        kw: Dict[str, Any] = {"name": parts[0]}
        rest = parts[1:]
        if rest and "=" not in rest[0]:
            kw["weight"] = float(rest.pop(0))
        for item in rest:
            key, _, val = item.partition("=")
            if key not in _TENANT_KEYS:
                raise ValueError(
                    f"unknown tenant key {key!r} in {entry!r}; "
                    f"known: {sorted(_TENANT_KEYS)}"
                )
            kw[_TENANT_FIELDS.get(key, key)] = _TENANT_KEYS[key](val)
        tenants.append(TenantSpec(**kw))
    if not tenants:
        raise ValueError(f"no tenants in spec {spec!r}")
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names in {spec!r}")
    return tuple(tenants)


def quotas_of(tenants: Sequence[TenantSpec]) -> Dict[str, int]:
    """The ``ServeConfig.quotas`` mapping (only tenants with a quota)."""
    return {t.name: t.quota for t in tenants if t.quota}


# -- arrival generators ------------------------------------------------------

ARRIVALS: Dict[str, Callable[..., List[int]]] = {}


def register_arrival(name: str):
    def deco(fn):
        ARRIVALS[name] = fn
        return fn

    return deco


def make_arrival_ticks(spec: str, n: int, seed: int) -> List[int]:
    """``kind[:args]`` -> ``n`` sorted arrival ticks (seeded, tick-domain).

    Kinds: ``none`` (all at t=0), ``poisson:RATE`` (requests/tick),
    ``bursty:BASE,PEAK[,RATE,LEN]``, ``diurnal:PEAK,PERIOD[,FLOOR]``,
    ``trace:FILE`` (JSON arrival-tick list).
    """
    kind, _, arg = spec.partition(":")
    try:
        gen = ARRIVALS[kind]
    except KeyError:
        raise ValueError(
            f"unknown arrival spec {spec!r}; kinds: {sorted(ARRIVALS)}"
        ) from None
    ticks = gen(arg, n, seed)
    if len(ticks) < n:
        raise ValueError(
            f"arrival spec {spec!r} produced {len(ticks)} arrivals, need {n}"
        )
    return sorted(int(t) for t in ticks[:n])


@register_arrival("none")
def _arrive_none(arg: str, n: int, seed: int) -> List[int]:
    """Everything queued at t=0 — peak (burst) load."""
    return [0] * n


@register_arrival("poisson")
def _arrive_poisson(arg: str, n: int, seed: int) -> List[int]:
    """Homogeneous Poisson arrivals at ``RATE`` requests/tick."""
    rate = float(arg)
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate, 1e-9), size=n)
    return np.floor(np.cumsum(gaps)).astype(int).tolist()


def _thin(rate_of, n: int, rng, horizon: int = 1_000_000) -> List[int]:
    """Inhomogeneous Poisson sampling: per-tick counts at ``rate_of(t)``."""
    ticks: List[int] = []
    t = 0
    while len(ticks) < n:
        if t >= horizon:
            raise ValueError(
                f"arrival envelope produced only {len(ticks)}/{n} requests "
                f"within {horizon} ticks — rate too low"
            )
        k = int(rng.poisson(max(0.0, float(rate_of(t)))))
        ticks.extend([t] * k)
        t += 1
    return ticks[:n]


@register_arrival("bursty")
def _arrive_bursty(arg: str, n: int, seed: int) -> List[int]:
    """Correlated traffic bursts: ``BASE,PEAK[,RATE,LEN]``.

    With probability ``RATE`` per tick a window of ``LEN`` ticks opens
    (the ``bursty`` delay model's outage window), during which the arrival
    rate jumps from ``BASE`` to ``PEAK`` (a failing upstream shedding its
    queue onto this service).
    """
    parts = [p for p in arg.split(",") if p]
    base, peak = float(parts[0]), float(parts[1])
    burst_rate = float(parts[2]) if len(parts) > 2 else 0.05
    burst_len = int(float(parts[3])) if len(parts) > 3 else 20
    rng = np.random.default_rng(seed)
    state = {"until": -1}

    def rate_of(t):
        if rng.random() < burst_rate:
            state["until"] = t + burst_len
        return peak if t < state["until"] else base

    return _thin(rate_of, n, rng)


@register_arrival("diurnal")
def _arrive_diurnal(arg: str, n: int, seed: int) -> List[int]:
    """Sinusoidal day/night load: ``PEAK,PERIOD[,FLOOR]`` — the rate swings
    between ``FLOOR`` (default ``PEAK/10``) and ``PEAK`` over ``PERIOD``
    ticks, starting at the valley (the autoscaler's canonical input)."""
    parts = [p for p in arg.split(",") if p]
    peak, period = float(parts[0]), int(float(parts[1]))
    floor = float(parts[2]) if len(parts) > 2 else peak / 10.0
    rng = np.random.default_rng(seed)

    def rate_of(t):
        phase = 0.5 - 0.5 * np.cos(2.0 * np.pi * t / max(1, period))
        return floor + (peak - floor) * phase

    return _thin(rate_of, n, rng)


@register_arrival("trace")
def _arrive_trace(arg: str, n: int, seed: int) -> List[int]:
    """Replay a recorded arrival trace: a JSON file holding a list of
    arrival ticks (or ``{"arrivals": [...]}``) — the measured-production
    analogue of the delay-model ``trace`` entry."""
    with open(arg) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data["arrivals"]
    return [int(t) for t in data]


# -- request materialization -------------------------------------------------


def assign_tenants(
    tenants: Sequence[TenantSpec], n: int, seed: int
) -> List[TenantSpec]:
    """Weighted seeded tenant draw for each of ``n`` arrivals."""
    w = np.asarray([t.weight for t in tenants], np.float64)
    if (w <= 0).any():
        raise ValueError("tenant weights must be positive")
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(tenants), size=n, p=w / w.sum())
    return [tenants[i] for i in idx]


def build_requests(
    tenants: Sequence[TenantSpec],
    workloads: Mapping[str, Any],
    n: int,
    arrival_spec: str,
    seed: int,
) -> Dict[str, List[Any]]:
    """Materialize the scenario's request streams.

    One seeded pass: arrival ticks from ``arrival_spec``, a weighted
    tenant draw per arrival, and each request's payload sampled by the
    *workload object* the tenant targets (``sample_request`` — prompts
    clamped to the pool's shape for LLM tenants, normalized personalization
    vectors for fixed-point tenants).  Returns ``{workload name: [Request]}``
    with globally unique request ids in arrival order.
    """
    missing = {t.workload for t in tenants} - set(workloads)
    if missing:
        raise ValueError(
            f"tenants target workloads {sorted(missing)} but only "
            f"{sorted(workloads)} are deployed"
        )
    arrivals = make_arrival_ticks(arrival_spec, n, seed)
    drawn = assign_tenants(tenants, n, seed + 1)
    rng = np.random.default_rng(seed + 2)
    out: Dict[str, List[Any]] = {name: [] for name in workloads}
    for rid, (tick, tenant) in enumerate(zip(arrivals, drawn)):
        req = workloads[tenant.workload].sample_request(
            tenant, rng, id=rid, arrival=tick
        )
        out[tenant.workload].append(req)
    return out


class TenantScenario:
    """One engine per deployed workload kind, sharing a tenant trace.

    The engines are independent services (separate pools, separate
    termination extents), so they run sequentially and the merged summary
    is exact: counts/ticks/replica-ticks add, percentiles re-rank the
    pooled per-request results, and the per-tenant table concatenates
    (a tenant targets exactly one workload).
    """

    def __init__(self, engines: Mapping[str, Any]):
        if not engines:
            raise ValueError("TenantScenario needs at least one engine")
        self.engines = dict(engines)

    def run(self, requests: Mapping[str, Sequence[Any]], **kw):
        """Drive every engine over its stream; returns {workload: results}."""
        out = {}
        for name in sorted(self.engines):
            out[name] = self.engines[name].run(requests.get(name, ()), **kw)
        return out

    def summary(self) -> Dict[str, Any]:
        res = [
            r for name in sorted(self.engines)
            for r in self.engines[name].results.values()
        ]
        subs = {n: e.summary() for n, e in self.engines.items()}
        ticks = sum(s["ticks"] for s in subs.values())
        wall = sum(s["wall_s"] for s in subs.values())
        return {
            "completed": len(res),
            "ticks": ticks,
            "wall_s": wall,
            "tokens_out": int(sum(r.n_tokens for r in res)),
            **_latency_percentiles(res),
            **_sla_fields(res, ticks, wall),
            "replica_ticks": sum(s["replica_ticks"] for s in subs.values()),
            "tenants": _tenant_summaries(res),
            "converged": int(sum(r.converged for r in res)),
            "engines": subs,
        }
