"""Request termination (port of ``repro.serving.termination``).

Deciding when each in-flight request is done without a global barrier is
the paper's distributed convergence-detection problem.  With ``dp``
replicas, every replica contributes its local view per slot into a
non-blocking MRD max-reduction over the stacked ``[dp, slots]``
contributions, advanced one stage per engine tick; a slot retires only
when a cycle completes and certifies it.  Non-power-of-two ``dp`` runs the
modified schedule's extra shift stages; ``dp = 1`` has zero stages, so
every tick certifies at once.

Slot recycling needs no tag on the wire: each cycle latches at its start
tick (``t_latch``), and a completed cycle may only retire requests
admitted at or before that latch.

Registered protocols:

- ``eos_maxlen``: LLM decode, done when the last token is the request's
  EOS id or the generation budget is spent;
- ``residual_inexact``: fixed-point requests, the paper's Algorithm 1:
  each replica contributes its block's latest update magnitude; a slot
  certifies when the agreed max falls below the request's eps;
- ``residual_interval``: windowed Algorithm 1, each replica contributing
  the max of its last ``window`` magnitudes (default: one agreement cycle
  + 1), so one small update cannot retire a request.

The residual protocols run the per-(replica, slot) policy of
``repro_torch.asynchrony.protocols`` (``monitor_init`` /
``monitor_contribution`` over ``[dp, slots]``), the code the training
loop's :class:`~repro_torch.asynchrony.protocols.ConvergenceMonitor` runs.

The state lives on the device of the signals the caller passes (the
engine keeps this control plane on the host: it is a few bytes per tick).

Elastic resize: :meth:`_TerminationBase.migrate` carries the state to a
new replica extent along a keep map (``keep[i]``: the old replica now at
new rank ``i``, None for a joiner).  The staged reduction restarts at
stage 0 at the new extent, the certified latch survives, and the residual
protocols' per-replica monitor rows follow the keep map (a joiner starts
from a fresh ``RES_INIT`` row).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch

from repro_torch.asynchrony.protocols import RES_INIT, get_protocol
from repro_torch.collectives import plans

TERMINATION: Dict[str, Any] = {}


def register_termination(name: str):
    def deco(cls):
        TERMINATION[name] = cls()
        return cls

    return deco


def get_termination(name: str):
    try:
        return TERMINATION[name]
    except KeyError:
        raise ValueError(
            f"unknown termination protocol {name!r}; registered: {sorted(TERMINATION)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class TerminationConfig:
    """Static config for a termination protocol."""

    dp: int = 1  # replica count the done decision is agreed across
    eps: float = 1e-6  # default residual threshold (requests may override)
    window: int = 0  # residual_interval: 0 -> one full agreement cycle + 1
    # any repro_torch.collectives SCHEDULES entry; one that cannot step a
    # stage at a time (rabenseifner's reduce-scatter phases, hierarchical's
    # second axis) raises where the plan is first stepped or measured
    schedule: str = "mrd"


def make_signals(*, tokens, new_tokens, eos, max_new, eps, active, admit_tick, tick,
                 residual):
    """The per-tick observations a protocol's ``tick`` consumes: ``[S]``
    tensors (int64 tokens/counters, fp32 per-request ``eps``, bool
    ``active``), the tick (int) and ``residual [dp, S]`` fp32, each
    replica's block update magnitude (zeros for LLM decode)."""
    return {
        "tokens": tokens, "new_tokens": new_tokens, "eos": eos,
        "max_new": max_new, "eps": eps, "active": active,
        "admit_tick": admit_tick, "tick": tick, "residual": residual,
    }


@functools.lru_cache(maxsize=64)
def _max_plan(schedule: str, dp: int) -> plans.CollectivePlan:
    return plans.allreduce_plan(schedule=schedule, p=dp, op="max")


class _TerminationBase:
    """Shared agreement machinery: one staged MRD max-reduction over dp."""

    def _plan(self, cfg: TerminationConfig) -> plans.CollectivePlan:
        return _max_plan(cfg.schedule, cfg.dp)

    def cycle_length(self, cfg: TerminationConfig) -> int:
        return self._plan(cfg).cycle_length()

    def _agree(self, st, cfg, sig, contribution):
        """Advance the reduction one stage -> (nb, t_latch, flag, agreed [S])."""
        t_latch = sig["tick"] if st["nb"]["stage"] == 0 else st["t_latch"]
        nb = self._plan(cfg).step(st["nb"], contribution)
        return nb, t_latch, nb["flag"], nb["result"][0]

    def _guard(self, sig, t_latch):
        """Only requests admitted at or before the cycle's latch may retire."""
        return sig["active"] & (sig["admit_tick"] <= t_latch)

    # -- elastic resize -----------------------------------------------------

    def migrate(self, st, keep, cfg: TerminationConfig, slots: int):
        """The state after the replica extent changes (``cfg`` is the
        config at the new extent).  The staged reduction is abandoned: its
        stage and partial combines mean nothing at the new extent, whose
        cycle length differs.  It restarts at stage 0, so the next tick
        latches ``t_latch`` to the current tick and every admission before
        the resize stays retirable without a new prefill.  What was
        certified survives; a retirement needs a whole new cycle of
        agreement among the new replicas."""
        new = self.init(cfg, slots, device=st["certified"].device)
        new["certified"] = st["certified"]
        return new


def _migrate_replica_rows(old_leaf, fresh_leaf, keep):
    """Per-replica monitor rows (dim 0) along the keep map.  A joiner takes
    the fresh (``RES_INIT``) row, so it cannot help certify a slot before
    it has observed a whole window.  Where a row's shape changes with the
    extent (``window=0`` derives the window from the cycle length), a
    survivor's new window is filled with its running max: its contribution
    can only be at least what it was, never lower."""
    parts = []
    for k in keep:
        if k is None:
            parts.append(fresh_leaf[0])
        elif old_leaf.shape[1:] == fresh_leaf.shape[1:]:
            parts.append(old_leaf[k])
        else:
            row_max = old_leaf[k].amax(dim=-1, keepdim=True)
            parts.append(row_max.expand(fresh_leaf.shape[1:]).to(fresh_leaf.dtype))
    return torch.stack(parts)


@register_termination("eos_maxlen")
class EosMaxlenTermination(_TerminationBase):
    """LLM decode termination: EOS token or generation budget, agreed."""

    name = "eos_maxlen"

    def init(self, cfg: TerminationConfig, slots: int, *, device):
        return {
            "nb": self._plan(cfg).init(torch.zeros((cfg.dp, slots), device=device)),
            "t_latch": 0,
            "certified": torch.zeros((slots,), device=device),
        }

    def tick(self, st, sig, cfg: TerminationConfig):
        local = sig["active"] & (
            (sig["tokens"] == sig["eos"]) | (sig["new_tokens"] >= sig["max_new"])
        )
        contribution = local.float()[None, :].expand(cfg.dp, -1)
        nb, t_latch, flag, agreed = self._agree(st, cfg, sig, contribution)
        retire = (agreed >= 0.5) & self._guard(sig, t_latch) & flag
        certified = torch.where(retire, agreed, st["certified"])
        return {"nb": nb, "t_latch": t_latch, "certified": certified}, retire


class _ResidualTermination(_TerminationBase):
    """Residual-certified termination for fixed-point requests: the
    per-(replica, slot) contribution is the ``policy`` protocol's
    ``monitor_contribution`` over ``[dp, S]``."""

    policy = "inexact"

    def _window(self, cfg: TerminationConfig) -> int:
        return cfg.window if cfg.window else self.cycle_length(cfg) + 1

    def _policy_init(self, cfg: TerminationConfig, slots: int, device):
        metric0 = torch.full((cfg.dp, slots), RES_INIT, dtype=torch.float32, device=device)
        proto = get_protocol(self.policy)
        if self.policy == "interval":
            return proto.monitor_init(metric0, window=self._window(cfg))
        return proto.monitor_init(metric0)

    def init(self, cfg: TerminationConfig, slots: int, *, device):
        return {
            "nb": self._plan(cfg).init(
                torch.full((cfg.dp, slots), RES_INIT, dtype=torch.float32, device=device)),
            "m": self._policy_init(cfg, slots, device),
            "t_latch": 0,
            "certified": torch.full((slots,), RES_INIT, dtype=torch.float32, device=device),
        }

    def tick(self, st, sig, cfg: TerminationConfig):
        slots = sig["active"].shape[0]
        # a slot admitted this tick restarts its policy state (the window
        # refills before the new request can certify)
        admitted_now = sig["admit_tick"] == sig["tick"]
        m = st["m"]
        if admitted_now.any():
            fresh = self._policy_init(cfg, slots, admitted_now.device)
            m = {k: torch.where(admitted_now.reshape((1, slots) + (1,) * (v.ndim - 2)),
                                fresh[k], v) for k, v in m.items()}
        m, contribution = get_protocol(self.policy).monitor_contribution(
            m, sig["residual"], sig["tick"], self.cycle_length(cfg))
        nb, t_latch, flag, agreed = self._agree(st, cfg, sig, contribution)
        retire = (agreed < sig["eps"]) & self._guard(sig, t_latch) & flag
        certified = torch.where(retire, agreed, st["certified"])
        return {"nb": nb, "m": m, "t_latch": t_latch, "certified": certified}, retire

    def migrate(self, st, keep, cfg: TerminationConfig, slots: int):
        new = super().migrate(st, keep, cfg, slots)
        new["m"] = {k: _migrate_replica_rows(st["m"][k], v, keep) for k, v in new["m"].items()}
        return new


@register_termination("residual_inexact")
class ResidualInexactTermination(_ResidualTermination):
    name = "residual_inexact"
    policy = "inexact"


@register_termination("residual_interval")
class ResidualIntervalTermination(_ResidualTermination):
    name = "residual_interval"
    policy = "interval"
