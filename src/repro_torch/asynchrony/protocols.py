"""The paper's convergence detection inside a training loop (port of
``repro.asynchrony.protocols``: :class:`ConvergenceMonitor` and the
training-loop policies of the ``inexact``, ``exact`` and ``interval``
detection protocols).

Each data-parallel rank is a row of a stacked ``[dp]`` tensor.  Every
train step each rank contributes one scalar (its policy decides which),
and the contributions are max-reduced through the non-blocking MRD plan:
one stage per step, never blocking the step.  When a cycle completes, the
reduced value is published; the run is certified converged once a
published value falls below the threshold.  The reference's engine-side
protocol surfaces (``init``/``tick``/``finalize``, snapshots) are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.collectives import plans

# Finite 'infinity' for residual latches.
RES_INIT = 1e30

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


# Policies: ``monitor_init(metric0 [p])`` is the per-rank policy state, and
# ``monitor_contribution(mstate, metric [p], step_idx, cycle_length)``
# returns (new state, what each rank contributes this step).


@register_protocol("inexact")
@dataclasses.dataclass(frozen=True)
class InexactProtocol:
    """Paper Algorithm 1: each cycle latches the rank's *current* metric;
    contributions may mix step indices across ranks."""

    name: str = "inexact"

    def monitor_init(self, metric0):
        return {}

    def monitor_contribution(self, mstate, metric, step_idx, cycle_length):
        return mstate, metric


@register_protocol("exact")
@dataclasses.dataclass(frozen=True)
class ExactProtocol:
    """Paper Algorithm 2 in a BSP loop: contributions are latched only at
    steps with ``step_idx % cycle_length == 0``, so every rank reduces the
    metric of the same step (a consistent cut)."""

    name: str = "exact"

    def monitor_init(self, metric0):
        return {"latched": metric0}

    def monitor_contribution(self, mstate, metric, step_idx, cycle_length):
        latched = metric if step_idx % cycle_length == 0 else mstate["latched"]
        return {"latched": latched}, latched


@register_protocol("interval")
@dataclasses.dataclass(frozen=True)
class IntervalProtocol:
    """Windowed Algorithm 1: each rank contributes the max of its last
    ``window`` metrics, so certification covers a whole window."""

    name: str = "interval"

    def monitor_init(self, metric0, window: int = 8):
        return {"win": metric0[:, None].expand(-1, window).float().clone()}

    def monitor_contribution(self, mstate, metric, step_idx, cycle_length):
        win = mstate["win"].clone()
        win[:, step_idx % win.shape[1]] = metric
        return {"win": win}, win.amax(dim=1)


@dataclasses.dataclass(frozen=True)
class ConvergenceMonitor:
    """The paper's detection over ``p`` data-parallel ranks (rows).

    ``mode`` names a :data:`DETECTION_PROTOCOLS` policy: ``inexact``
    (each cycle latches the current metric; the certified value lags by
    ``cycle_length`` steps), ``exact`` (latches only at cycle starts, so
    all ranks reduce the same step's metric) or ``interval`` (the max over
    each rank's last 8 metrics).

    ``state, done, value = monitor.step(state, metric, step_idx)`` with
    ``metric`` [p]; ``done`` and ``value`` are [p] (equal on every rank
    once a cycle has completed)."""

    p: int
    threshold: float
    mode: str = "inexact"

    def _plan(self) -> plans.CollectivePlan:
        return plans.allreduce_plan(schedule="mrd", p=self.p, op="max")

    def _protocol(self):
        return get_protocol(self.mode)

    def init(self, device="cpu") -> dict[str, Any]:
        """Monitor state: the staged plan's state and the per-rank policy
        state, published value and ``done`` latch, one row per rank."""
        metric0 = torch.full((self.p,), RES_INIT, dtype=torch.float32, device=device)
        return {
            "nb": self._plan().init(metric0),
            "m": self._protocol().monitor_init(metric0),
            "value": metric0.clone(),
            "done": torch.zeros((self.p,), dtype=torch.bool, device=device),
        }

    def step(self, state, local_metric, step_idx: int):
        plan = self._plan()
        mstate, contribution = self._protocol().monitor_contribution(
            state["m"], local_metric.float(), step_idx, plan.cycle_length())
        nb = plan.step(state["nb"], contribution)
        value = nb["result"] if nb["flag"] else state["value"]
        done = state["done"] | (nb["flag"] & (value < self.threshold))
        return {"nb": nb, "m": mstate, "value": value, "done": done}, done, value
