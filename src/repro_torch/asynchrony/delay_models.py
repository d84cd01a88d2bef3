"""Delay models (port of ``repro.asynchrony.delay_models``, ``DELAY_MODELS``).

A delay model decides, per global tick, which workers iterate and how
stale each worker's view of every other block is: the ``(active,
delays)`` pair the bounded-delay simulator (paper S1) consumes.  Each
model is a frozen dataclass registered by name:

- ``default_params(cfg, p)``: the parameter dict (tensors; the engine
  gives each lane its own copy, ``[B, ...]``, so a sweep can run a grid
  of them);
- ``init_state(p, lanes, device)``: the carried state (empty for
  memoryless models);
- ``sample(params, state, tick, draw, last_active, *, p, max_delay,
  force_every)``: one tick's ``(active [B, p] bool, delays [B, p, p]
  int32, state)`` for ``B`` lanes.  ``draw`` is a
  :class:`repro_torch.asynchrony.draws.Draw` over the lanes' seeds and
  ticks.

Every model ends with :func:`apply_fairness`, the paper's two fairness
conditions by construction: a worker inactive for ``force_every`` ticks
is forced active, and delays are clipped to ``[0, max_delay]``.

Registered models: ``bernoulli``, ``straggler``, ``heterogeneous``,
``bursty`` and ``trace`` (:func:`record_trace` records one from any other
model).  Their draws come from the port's counter-based source, so they
are the reference's distributions, not its numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.asynchrony.draws import ACTIVE, DELAYS, START, TAIL, WHO, CounterSource, Draw


def apply_fairness(active, delays, tick, last_active, *, max_delay: int, force_every: int):
    """Clamp any model's raw sample to the paper's fairness conditions."""
    active = active | (tick[:, None] - last_active >= force_every)
    return active, delays.clamp(0, max_delay).int()


DELAY_MODELS: Dict[str, Any] = {}


def register_delay_model(name: str):
    def deco(cls):
        DELAY_MODELS[name] = cls()
        return cls

    return deco


def get_delay_model(name: str):
    try:
        return DELAY_MODELS[name]
    except KeyError:
        raise ValueError(
            f"unknown delay model {name!r}; registered: {sorted(DELAY_MODELS)}"
        ) from None


class _Memoryless:
    def init_state(self, p: int, lanes: int, device) -> dict:
        return {}


@register_delay_model("bernoulli")
@dataclasses.dataclass(frozen=True)
class BernoulliModel(_Memoryless):
    """iid Bernoulli activity + iid uniform delays."""

    name: str = "bernoulli"

    def default_params(self, cfg, p: int):
        return {"activity": torch.tensor(cfg.activity, dtype=torch.float32)}

    def sample(self, params, state, tick, draw: Draw, last_active, *, p, max_delay, force_every):
        active = draw.bernoulli(ACTIVE, params["activity"][:, None], (p,))
        delays = draw.randint(DELAYS, (p, p), max_delay + 1)
        active, delays = apply_fairness(active, delays, tick, last_active,
                                        max_delay=max_delay, force_every=force_every)
        return active, delays, state


@register_delay_model("straggler")
@dataclasses.dataclass(frozen=True)
class StragglerModel(_Memoryless):
    """A fixed slow subset (workers ``0..n_slow-1``) iterates rarely, and
    *its* blocks reach everyone else with heavy-tailed (truncated
    geometric) delays."""

    name: str = "straggler"

    def default_params(self, cfg, p: int):
        return {
            "n_slow": torch.tensor(max(1, p // 4), dtype=torch.int32),
            "slow_activity": torch.tensor(0.15, dtype=torch.float32),
            "fast_activity": torch.tensor(cfg.activity, dtype=torch.float32),
            # mean of the heavy tail (in ticks), before truncation
            "tail_scale": torch.tensor(max(1.0, 0.75 * cfg.max_delay), dtype=torch.float32),
        }

    def sample(self, params, state, tick, draw: Draw, last_active, *, p, max_delay, force_every):
        slow = torch.arange(p, device=tick.device) < params["n_slow"][:, None]  # [B, p]
        prob = torch.where(slow, params["slow_activity"][:, None],
                           params["fast_activity"][:, None])
        active = draw.bernoulli(ACTIVE, prob, (p,))
        base = draw.randint(DELAYS, (p, p), max_delay + 1)
        u = draw.uniform(TAIL, (p, p)) * (1.0 - 1e-6) + 1e-6
        # in float64, so that the floor lands alike on every device
        heavy = torch.floor(-params["tail_scale"].double()[:, None, None] * torch.log(u.double()))
        # column j = staleness of worker j's block as seen by everyone
        delays = torch.where(slow[:, None, :], heavy.int(), base)
        active, delays = apply_fairness(active, delays, tick, last_active,
                                        max_delay=max_delay, force_every=force_every)
        return active, delays, state


@register_delay_model("heterogeneous")
@dataclasses.dataclass(frozen=True)
class HeterogeneousModel(_Memoryless):
    """Per-worker activity rates and per-source delay ceilings (length-``p``
    params, sweepable)."""

    name: str = "heterogeneous"

    def default_params(self, cfg, p: int):
        return {
            "activity": torch.linspace(0.4, 1.0, p, dtype=torch.float32)
            * torch.tensor(cfg.activity, dtype=torch.float32),
            "dmax": torch.linspace(0.0, cfg.max_delay, p, dtype=torch.float32),
        }

    def sample(self, params, state, tick, draw: Draw, last_active, *, p, max_delay, force_every):
        active = draw.bernoulli(ACTIVE, params["activity"], (p,))
        u = draw.uniform(DELAYS, (p, p))
        # delays[i, j] ~ U{0 .. dmax_j}: source j's network quality
        delays = torch.floor(u * (params["dmax"][:, None, :] + 1.0)).int()
        active, delays = apply_fairness(active, delays, tick, last_active,
                                        max_delay=max_delay, force_every=force_every)
        return active, delays, state


@register_delay_model("bursty")
@dataclasses.dataclass(frozen=True)
class BurstyModel:
    """Correlated outage windows: with rate ``outage_rate`` a tick an outage
    starts, knocking a random ``affected`` fraction of workers out for
    ``outage_len`` ticks (inactive, blocks maximally stale).  Carries
    ``outage_until``: the only stateful model."""

    name: str = "bursty"

    def default_params(self, cfg, p: int):
        return {
            "activity": torch.tensor(cfg.activity, dtype=torch.float32),
            "outage_rate": torch.tensor(0.05, dtype=torch.float32),
            "outage_len": torch.tensor(3 * cfg.force_every, dtype=torch.float32),
            "affected": torch.tensor(0.5, dtype=torch.float32),
        }

    def init_state(self, p: int, lanes: int, device) -> dict:
        return {"outage_until": torch.zeros((lanes, p), dtype=torch.int32, device=device)}

    def sample(self, params, state, tick, draw: Draw, last_active, *, p, max_delay, force_every):
        start = draw.bernoulli(START, params["outage_rate"])  # [B]
        who = draw.bernoulli(WHO, params["affected"][:, None], (p,))
        until = torch.where(start[:, None] & who,
                            tick[:, None] + params["outage_len"].int()[:, None],
                            state["outage_until"])
        out = tick[:, None] < until
        active = draw.bernoulli(ACTIVE, params["activity"][:, None], (p,)) & ~out
        delays = draw.randint(DELAYS, (p, p), max_delay + 1)
        delays = torch.where(out[:, None, :], max_delay, delays)
        # fairness wins over the outage: a starved worker is forced active
        active, delays = apply_fairness(active, delays, tick, last_active,
                                        max_delay=max_delay, force_every=force_every)
        return active, delays, {"outage_until": until}


@register_delay_model("trace")
@dataclasses.dataclass(frozen=True)
class TraceModel(_Memoryless):
    """Replay a recorded delay matrix: params ``{"active": [T, p] bool,
    "delays": [T, p, p] int32}``, indexed by ``(tick - 1) % T``.
    :func:`record_trace` captures one from any other model; the parity
    tests feed the reference's."""

    name: str = "trace"

    def default_params(self, cfg, p: int):
        return record_trace(cfg, p, ticks=256)

    def sample(self, params, state, tick, draw: Draw, last_active, *, p, max_delay, force_every):
        lanes = torch.arange(tick.shape[0], device=tick.device)
        idx = (tick.long() - 1) % params["active"].shape[1]
        active, delays = params["active"][lanes, idx], params["delays"][lanes, idx]
        active, delays = apply_fairness(active, delays, tick, last_active,
                                        max_delay=max_delay, force_every=force_every)
        return active, delays, state


def record_trace(cfg, p: int, *, ticks: int = 256, source: str = "bernoulli",
                 source_params=None, seed=None):
    """Run ``source`` for ``ticks`` ticks (one lane, on the CPU, the
    engine's counter-based draws under ``cfg.seed`` or ``seed``) and return
    its fairness-clamped ``(active, delays)`` history as ``trace``
    params."""
    model = get_delay_model(source)
    params = model.default_params(cfg, p) if source_params is None else source_params
    params = {k: torch.as_tensor(v)[None] for k, v in params.items()}
    state = model.init_state(p, 1, "cpu")
    seed_t = torch.tensor([cfg.seed if seed is None else seed], dtype=torch.int64)
    last_active = torch.zeros((1, p), dtype=torch.int32)
    actives, delays = [], []
    for t in range(1, ticks + 1):
        tick = torch.tensor([t], dtype=torch.int32)
        a, d, state = model.sample(params, state, tick, Draw(CounterSource(), seed_t, tick),
                                   last_active, p=p, max_delay=cfg.max_delay,
                                   force_every=cfg.force_every)
        last_active = torch.where(a, tick[:, None], last_active)
        actives.append(a[0])
        delays.append(d[0])
    return {"active": torch.stack(actives), "delays": torch.stack(delays)}
