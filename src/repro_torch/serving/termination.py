"""Request termination (port of ``repro.serving.termination``, the
``eos_maxlen`` protocol).

Deciding when each in-flight request is done without a global barrier is
the paper's distributed convergence-detection problem.  With ``dp``
replicas, every replica contributes its local done bit per slot into a
non-blocking MRD max-reduction over the stacked ``[dp, slots]``
contributions, advanced one stage per engine tick; a slot retires only
when a cycle completes and its agreed bit is set.  Non-power-of-two ``dp``
runs the modified schedule's extra shift stages; ``dp = 1`` has zero
stages, so every tick certifies at once.

Slot recycling needs no tag on the wire: each cycle latches at its start
tick (``t_latch``), and a completed cycle may only retire requests
admitted at or before that latch.

The state lives on the device of the signals the caller passes (the
engine keeps this control plane on the host: it is a few bytes per tick).
The reference's residual protocols serve fixed-point requests, which are
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

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


def make_signals(*, tokens, new_tokens, eos, max_new, active, admit_tick, tick):
    """The per-tick observations a protocol's ``tick`` consumes: ``[S]``
    tensors (int64 tokens/counters, bool ``active``) and the tick (int)."""
    return {
        "tokens": tokens, "new_tokens": new_tokens, "eos": eos,
        "max_new": max_new, "active": active, "admit_tick": admit_tick,
        "tick": tick,
    }


class _TerminationBase:
    """Shared agreement machinery: one staged MRD max-reduction over dp."""

    def _plan(self, cfg: TerminationConfig) -> plans.CollectivePlan:
        return plans.allreduce_plan(schedule="mrd", p=cfg.dp, op="max")

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
